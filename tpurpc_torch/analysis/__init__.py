"""Analysis helpers of the port (a trimmed copy: the lock factories)."""
