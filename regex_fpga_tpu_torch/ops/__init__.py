"""Device engines of the torch port: tables, the k=1 and k-gram chain
scans on their Hopper kernels (``hopper_dfa``, ``hopper_kgram``), and the
exact fallback (``dfa_engine``)."""
