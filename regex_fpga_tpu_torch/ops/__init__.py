"""Device engines of the torch port: tables, the k=1 and k-gram chain
scans on their Hopper kernels (``hopper_dfa``, ``hopper_kgram``), the exact
fallback (``dfa_engine``), the lazy-DFA chain scan and its host/device loop
(``dfa_take``, ``lazy_scan``, on ``hopper_dfa``), and the active-set NFA
engine (``nfa_engine``, on ``hopper_nfa``)."""
