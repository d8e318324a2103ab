"""Models served over the port: ResNet-50 (``resnet``) and the MoE
transformer (``transformer``)."""
