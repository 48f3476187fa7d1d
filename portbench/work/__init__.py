"""Operation and byte counts, one module per kind of step; ``spd_estep``
counts one launch of the port's per-sample factorization kernel."""
