"""Multi-rank runs of the port on the CPU: gloo ranks, one process each.

The test side (:func:`launch`, :func:`start`) imports only the standard
library and numpy. It writes a job list and the jobs' inputs, made from
seeds in the test process, to a directory, starts ``world`` ranks of this
file as a script, and reads back what each rank wrote:
``results[job][rank][key]``. Every rank joins through the port's
``initialize_cluster`` (``TPURPC_COORDINATOR``/``TPURPC_NUM_PROCESSES``/
``TPURPC_PROCESS_ID``, or torchrun's variables with
``TPURPC_AUTODETECT=1``), which gives gloo a 60 s timeout, and the test
waits at most ``timeout`` seconds for them before killing them all.

The suite runs several test workers at once, and a launch starts up to 8
rank processes. So that the ranks never starve other tests (many of them
bound by deadlines on loopback), a launch holds a cross-process file lock
from :func:`start` to :func:`finish` (one multi-rank launch at a time
across workers), and every rank lowers its own priority (``os.nice``).

The rank side (run as a script) imports torch and the port only: no JAX,
nothing of ``tpurpc``. Each job builds its mesh over the same world, runs
the port's per-rank program on this rank's block of the inputs and saves
its outputs (this rank's blocks, and gradients) as ``<job>.<rank>.npz``.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
#: how long a test waits for its ranks, seconds
TIMEOUT = 180
#: the lock that lets one multi-rank launch run at a time across workers
LOCK = Path(tempfile.gettempdir()) / "tpurpc_torch_ranks.lock"
#: how long a launch waits for another's lock before it runs regardless
LOCK_WAIT = 900
#: the priority a rank gives itself: other tests' threads go first
RANK_NICE = 10


class Ranks(list):
    """The ranks' ``Popen``s, and the launch lock they hold until
    :func:`finish`."""

    lock_fd = None


def _lock() -> int:
    """Take the launch lock (bounded wait); returns its descriptor, which
    :func:`_unlock` closes."""
    fd = os.open(LOCK, os.O_RDWR | os.O_CREAT, 0o644)
    deadline = time.monotonic() + LOCK_WAIT
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return fd
        except BlockingIOError:
            if time.monotonic() >= deadline:
                return fd   # a stuck holder: run unlocked, never hang
            time.sleep(0.1)


def _unlock(fd) -> None:
    if fd is not None:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


@contextlib.contextmanager
def one_torch_thread():
    """torch on one thread in the test process: the suite runs several
    test workers, and these tests' ranks, at once, and torch's default of a
    thread per core would oversubscribe the machine."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(world: int, jobs: list, inputs: dict, workdir: Path,
          autodetect: bool = False, extra_env: dict = None):
    """Write the jobs and inputs under ``workdir``, take the launch lock and
    start the ranks; returns their ``Popen``s (stdout piped, stderr merged
    into it), which hold the lock until :func:`finish`."""
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "jobs.json").write_text(json.dumps(jobs))
    np.savez(workdir / "inputs.npz", **inputs)
    procs = Ranks()
    procs.lock_fd = _lock()
    try:
        _spawn(procs, world, workdir, autodetect, extra_env)
    except BaseException:
        finish_quietly(procs)
        raise
    return procs


def _spawn(procs, world, workdir, autodetect, extra_env) -> None:
    port = free_port()
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   TPURPC_TORCH_DEVICE="cpu", **(extra_env or {}))
        env.pop("XLA_FLAGS", None)
        if autodetect:
            env.update(TPURPC_AUTODETECT="1", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_RANK=str(rank))
        else:
            env.update(TPURPC_COORDINATOR=f"127.0.0.1:{port}",
                       TPURPC_NUM_PROCESSES=str(world),
                       TPURPC_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(workdir)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))


def finish_quietly(procs) -> None:
    """Kill every rank and give the launch lock back."""
    try:
        for p in procs:
            p.kill()
            p.wait()
    finally:
        fd, procs.lock_fd = procs.lock_fd, None
        _unlock(fd)


def finish(procs, timeout: float = TIMEOUT) -> list:
    """Wait for every rank (killing all of them in any case); each must
    exit 0 and say so. Returns their outputs."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        finish_quietly(procs)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {rank}" in out, (
            f"rank {rank} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def collect(workdir: Path, jobs: list, world: int) -> dict:
    out = {}
    for job in jobs:
        out[job["name"]] = [dict(np.load(workdir / f"{job['name']}.{r}.npz"))
                            for r in range(world)]
    return out


def launch(world: int, jobs: list, inputs: dict, workdir: Path,
           **kw) -> dict:
    """Run ``jobs`` on ``world`` ranks; ``results[job][rank][key]``."""
    finish(start(world, jobs, inputs, workdir, **kw))
    return collect(workdir, jobs, world)


def coords(sizes: dict, world: int) -> list:
    """Each rank's coordinates, row-major in the mesh's axis order."""
    axes = ("dp", "pp", "sp", "tp", "ep")
    shape = [sizes.get(a, 1) for a in axes]
    return [dict(zip(axes, map(int, np.unravel_index(r, shape))))
            for r in range(world)]


def block_index(spec, coord: dict, sizes: dict, shape) -> tuple:
    """The index of rank ``coord``'s block of a global array of ``shape``
    under a partition spec (entries: None, an axis, or a tuple of axes with
    the first major)."""
    idx = []
    for dim, entry in enumerate(spec):
        if entry is None:
            idx.append(slice(None))
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        n, i = 1, 0
        for a in names:
            i = i * sizes.get(a, 1) + coord[a]
            n *= sizes.get(a, 1)
        step = shape[dim] // n
        idx.append(slice(i * step, (i + 1) * step))
    return tuple(idx)


def gather(blocks: list, spec, sizes: dict, shape, world: int):
    """The global array from every rank's block. Ranks that hold the same
    block must hold equal values."""
    out = np.full(shape, np.nan, dtype=blocks[0].dtype)
    seen = {}
    for b, c in zip(blocks, coords(sizes, world)):
        idx = block_index(spec, c, sizes, shape)
        key = str(idx)
        if key in seen:
            np.testing.assert_array_equal(b, seen[key])
        seen[key] = b
        out[idx] = b
    assert not np.isnan(out).any(), "a block is missing"
    return out


# -- the rank side ------------------------------------------------------------

def _rank_main(workdir: Path) -> None:
    import torch
    import torch.distributed as dist

    from tpurpc_torch.parallel import collectives as coll
    from tpurpc_torch.parallel.distributed import (initialize_cluster,
                                                   process_count)
    from tpurpc_torch.parallel.mesh import build_mesh, shard
    from tpurpc_torch.parallel.moe import MoEParams, moe_block
    from tpurpc_torch.parallel.pipeline import (microbatch, pipeline_apply,
                                                unmicrobatch)
    from tpurpc_torch.parallel.ring_attention import ring_attention_block
    from tpurpc_torch.models import transformer as tfm

    torch.set_num_threads(1)
    rank = initialize_cluster()
    world = process_count()
    assert initialize_cluster() == rank          # a second call joins nothing
    jobs = json.loads((workdir / "jobs.json").read_text())
    inputs = np.load(workdir / "inputs.npz")

    def inp(job, key, grad=False):
        t = torch.from_numpy(inputs[f"{job['name']}/{key}"].copy())
        return t.requires_grad_(grad)

    def npy(t):
        return t.detach().numpy()

    def mesh_of(job):
        return build_mesh(world, sizes=job["sizes"], device="cpu")

    def collectives(job):
        mesh = mesh_of(job)
        rng = np.random.default_rng(100 + rank)
        x0 = rng.standard_normal((4, 3)).astype(np.float32)
        w = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
        out = {"x": x0, "w": w.numpy(), "rank": np.int64(mesh.rank),
               "coords": np.array([mesh.coords[a] for a in mesh.axis_names])}
        ops = {"psum": lambda x, a: coll.psum(x, mesh, a),
               "pmean": lambda x, a: coll.pmean(x, mesh, a),
               "all_to_all": lambda x, a: coll.all_to_all(x, mesh, a),
               "shift": lambda x, a: coll.shift(mesh, a, x)[0]}
        for axis in job["axes"]:
            key = axis if isinstance(axis, str) else "+".join(axis)
            out[f"axis_index/{key}"] = np.int64(coll.axis_index(mesh, axis))
            for op, fn in ops.items():
                if op in ("all_to_all", "shift") and not isinstance(axis,
                                                                    str):
                    continue
                x = torch.from_numpy(x0.copy()).requires_grad_(True)
                y = fn(x, axis if isinstance(axis, str) else tuple(axis))
                (y * w).sum().backward()
                out[f"{op}/{key}/y"], out[f"{op}/{key}/g"] = npy(y), npy(
                    x.grad)
        return out

    def ring_attention(job):
        mesh = mesh_of(job)
        q, k, v = (shard(mesh, inp(job, n), None, None, "sp").clone()
                   .requires_grad_(True) for n in "qkv")
        o = ring_attention_block(q, k, v, mesh, causal=job["causal"])
        (o.float() ** 2).sum().backward()
        return {"out": npy(o), "dq": npy(q.grad), "dk": npy(k.grad),
                "dv": npy(v.grad)}

    def moe(job):
        mesh = mesh_of(job)
        router = inp(job, "router", True)
        w_in, w_out = (shard(mesh, inp(job, n), "ep").clone()
                       .requires_grad_(True) for n in ("w_in", "w_out"))
        x = shard(mesh, inp(job, "x"), "ep").clone().requires_grad_(True)
        y, aux = moe_block(MoEParams(router, w_in, w_out), x, mesh,
                           capacity_factor=job["capacity_factor"])
        (y * shard(mesh, inp(job, "cot"), "ep")).sum().backward()
        grouter = coll.psum(router.grad, mesh, "ep")   # router: replicated
        return {"y": npy(y), "aux": npy(aux), "dx": npy(x.grad),
                "drouter": npy(grouter), "dw_in": npy(w_in.grad),
                "dw_out": npy(w_out.grad)}

    def pipeline(job):
        mesh = mesh_of(job)
        W, b = (shard(mesh, inp(job, n), "pp").clone().requires_grad_(True)
                for n in ("W", "b"))

        def stage(params, h):
            for w_, b_ in zip(*params):
                h = torch.tanh(h @ w_ + b_)
            return h

        out = unmicrobatch(pipeline_apply(
            stage, (W, b), microbatch(inp(job, "x"), job["n_micro"]), mesh))
        # the output is replicated over 'pp': each rank seeds 1/pp of it
        (out ** 2).sum().backward(torch.tensor(1.0 / mesh.sizes["pp"]))
        return {"out": npy(out), "dW": npy(W.grad), "db": npy(b.grad)}

    def model_of(job, mesh):
        cfg = tfm.TransformerConfig(**job["cfg"])
        params = {k.split("/", 2)[2]: v for k, v in inputs.items()
                  if k.startswith(f"{job['name']}/param/")}
        model = tfm.Transformer(cfg, mesh)
        model.load_state_dict(tfm.from_jax(params, mesh))
        return cfg, model

    def transformer(job):
        mesh = mesh_of(job)
        cfg, model = model_of(job, mesh)
        tokens, targets = inp(job, "tokens"), inp(job, "targets")
        out = {}
        with torch.no_grad():
            out["logits"] = npy(tfm.build_forward(cfg, mesh)(model, tokens))
        loss = tfm.value_and_grad(tfm.build_loss_fn(cfg, mesh), model,
                                  tokens, targets)
        out["loss"] = npy(loss)
        for name, p in model.named_parameters():
            out[f"grad/{name}"] = npy(p.grad)
        return out

    def train(job):
        mesh = mesh_of(job)
        cfg, model = model_of(job, mesh)
        tokens, targets = inp(job, "tokens"), inp(job, "targets")
        step, make_optimizer = tfm.build_train_step(cfg, mesh, lr=job["lr"])
        opt = make_optimizer(model)
        losses = [npy(step(model, opt, tokens, targets))
                  for _ in range(job["steps"])]
        out = {"losses": np.array(losses)}
        for name, p in model.named_parameters():
            out[f"param/{name}"] = npy(p)
        return out

    def cluster(job):
        """tests/test_distributed.py:107's three checks on a 'dp' mesh."""
        mesh = mesh_of(job)
        local = torch.arange(4.0) + 4 * rank
        rng = np.random.default_rng(7)
        X = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
        W = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
        return {"total": npy(coll.psum(local.sum(), mesh, "dp")),
                "y": npy(shard(mesh, X, "dp") @ W),
                "red": npy(coll.psum(local, mesh, "dp"))}

    def serve(job):
        """tests/test_distributed.py:222: rank 0 serves tensor RPCs; each
        request's batch is broadcast to every rank, split over 'dp', and
        the product gathered back for the reply."""
        mesh = mesh_of(job)
        group = mesh.group("dp")
        W = torch.from_numpy(np.random.default_rng(21).standard_normal(
            (16, 4)).astype(np.float32))

        def step(x):
            x = x.contiguous()
            dist.broadcast(x, src=0)
            y = shard(mesh, x, "dp") @ W
            ys = [torch.empty_like(y) for _ in range(mesh.sizes["dp"])]
            dist.all_gather(ys, y, group=group)
            return torch.cat(ys)

        if rank == 0:
            import time

            from tpurpc_torch.rpc.server import Server
            from tpurpc_torch.torchshim.service import add_tensor_method

            srv = Server(max_workers=2)
            add_tensor_method(srv, "Infer",
                              lambda tree: {"y": step(tree["x"].float())})
            srv.start()
            port = srv.add_insecure_port("127.0.0.1:0")
            print(f"PORT {port}", flush=True)
            done = Path(job["done"])
            while not done.exists():
                time.sleep(0.05)
            srv.stop(grace=5)
        else:
            for _ in range(job["requests"]):
                step(torch.zeros(8, 16))
        return {}

    kinds = {"collectives": collectives, "ring_attention": ring_attention,
             "moe": moe, "pipeline": pipeline, "transformer": transformer,
             "train": train, "cluster": cluster, "serve": serve}
    for job in jobs:
        out = kinds[job["kind"]](job)
        np.savez(workdir / f"{job['name']}.{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    assert not {"jax", "tpurpc"} & set(sys.modules), "a rank imported JAX"
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    os.nice(RANK_NICE)
    _rank_main(Path(sys.argv[1]))
