"""Exact collective-traffic accounting for the distributed scans.

The counterpart of ``regex_fpga_tpu/parallel/comm_model.py``, with the same
byte formulas. Every byte the distributed scans move per collective follows
from the shapes; ``mesh.record_collectives`` records what a scan really issued, and
the tests hold the two to each other.

Collective inventory of ``dfa_scan_fast_dist``, per rank per scan, with
``b_loc = batch / n_data`` streams per data shard and 4-byte int32 elements:

===========================  ===========================================
collective                   payload bytes (per rank)
===========================  ===========================================
seam-tail ring_shift (1x)    ``b_loc * overlap * 4`` (speculation seed)
finals ring_shift (per iter) ``b_loc * 4``
convergence all_reduce       ``4`` per axis (data, then seq), per iter
counts all_reduce over seq   ring allreduce ``2 * (n-1)/n * b_loc * 4``
finals all_gather over seq   ring ``(n-1) * b_loc * 4`` received
===========================  ===========================================

(plus the all_gather over data of the (B,) results, which JAX's sharded
outputs leave implicit). ``dfa_scan_kgram_dist`` is identical in structure
with k-gram steps as the unit.

The projection needs a link rate and a per-phase latency. The JAX package
states a TPU's (its ICI figures); they are no fact about this port's
interconnect, so here both are arguments with no default, as are the
compute rates of ``comm_model_report``.
"""

from __future__ import annotations

__all__ = [
    "fast_dist_comm_bytes",
    "project_efficiency",
    "min_shard_bytes_for_efficiency",
    "comm_model_report",
]


def fast_dist_comm_bytes(
    batch: int,
    shard_bytes: int,
    n_data: int,
    n_seq: int,
    overlap: int = 64,
    iters: int = 2,
    elem_bytes: int = 4,
) -> dict:
    """Exact per-rank collective traffic of one ``dfa_scan_fast_dist``
    call (see module table). ``shard_bytes`` is the per-rank share of the
    stream(s): ``batch/n_data * L/n_seq`` elements. ``iters`` is the Jacobi
    seam-fixpoint iteration count."""
    b_loc = max(batch // max(n_data, 1), 1)
    seed = b_loc * overlap * elem_bytes
    per_iter = b_loc * elem_bytes + 2 * elem_bytes  # finals shift + 2 sums
    counts = (2 * (n_seq - 1) / max(n_seq, 1)) * b_loc * elem_bytes
    gather = (n_seq - 1) * b_loc * elem_bytes
    total = seed + iters * per_iter + counts + gather
    phases = 1 + 2 * iters + 2
    return {
        "per_device_bytes": {
            "seam_tail_ppermute": seed,
            "finals_ppermute_x_iters": iters * b_loc * elem_bytes,
            "convergence_psum_x_iters": iters * 2 * elem_bytes,
            "counts_psum": round(counts, 1),
            "finals_all_gather": gather,
            "total": round(total, 1),
        },
        "collective_phases": phases,
        "bytes_per_scanned_byte": total / max(shard_bytes, 1),
        "shard_bytes": shard_bytes,
    }


def project_efficiency(comm: dict, compute_bps: float, *, link_bps: float,
                       latency_s: float) -> dict:
    """Scaling efficiency = T_compute / (T_compute + T_comm) with
    T_comm = phases * latency + bytes / link_bps (collectives counted as
    not overlapped with compute: the worst case)."""
    t_compute = comm["shard_bytes"] / compute_bps
    t_comm = (comm["collective_phases"] * latency_s
              + comm["per_device_bytes"]["total"] / link_bps)
    return {
        "t_compute_s": t_compute,
        "t_comm_s": t_comm,
        "efficiency": t_compute / (t_compute + t_comm),
        "compute_bps": compute_bps,
        "link_bps": link_bps,
        "latency_s": latency_s,
    }


def min_shard_bytes_for_efficiency(
    target: float,
    batch: int,
    n_data: int,
    n_seq: int,
    compute_bps: float,
    overlap: int = 64,
    iters: int = 2,
    *,
    link_bps: float,
    latency_s: float,
) -> int:
    """Smallest per-rank shard for which projected efficiency >= target.
    T_comm is (nearly) shard-size independent, so this is direct: require
    T_compute >= T_comm * target / (1 - target)."""
    comm = fast_dist_comm_bytes(batch, 1, n_data, n_seq, overlap, iters)
    t_comm = (comm["collective_phases"] * latency_s
              + comm["per_device_bytes"]["total"] / link_bps)
    t_compute_needed = t_comm * target / (1.0 - target)
    return int(t_compute_needed * compute_bps) + 1


def comm_model_report(compute_bps_slow: float, compute_bps_good: float, *,
                      link_bps: float, latency_s: float) -> dict:
    """Projected efficiency of the benched shapes at 8/16/64 ranks, plus the
    minimum shard for the >=85% (and 99%) targets, between two compute rates
    and on the given link."""
    out: dict = {
        "assumptions": {
            "link_bps": link_bps,
            "collective_latency_s": latency_s,
            "iters": 2,
            "overlap": 64,
            "note": "per-collective bytes are exact from shapes; the link "
                    "rate, latency and compute rates are the caller's; "
                    "collectives counted as unoverlapped (worst case)",
        },
        "configs": [],
    }
    batch = 8
    for n_chips, shard in [(8, 1 << 26), (8, 1 << 22), (16, 1 << 26),
                           (64, 1 << 26), (64, 1 << 22)]:
        n_data, n_seq = (2, n_chips // 2) if n_chips > 1 else (1, 1)
        comm = fast_dist_comm_bytes(batch, shard, n_data, n_seq)
        row = {"chips": n_chips, "mesh": f"{n_data}x{n_seq}",
               "shard_bytes_per_device": shard, "comm": comm}
        for day, rate in (("slow_day", compute_bps_slow),
                          ("good_day", compute_bps_good)):
            row[f"efficiency_{day}"] = round(project_efficiency(
                comm, rate, link_bps=link_bps, latency_s=latency_s)
                ["efficiency"], 5)
        out["configs"].append(row)
    for target in (0.85, 0.99):
        out[f"min_shard_bytes_eff_{int(target * 100)}"] = {
            day: min_shard_bytes_for_efficiency(
                target, batch, 2, 4, rate, link_bps=link_bps,
                latency_s=latency_s)
            for day, rate in (("slow_day", compute_bps_slow),
                              ("good_day", compute_bps_good))
        }
    out["statement"] = (
        "projected >=85% weak-scaling efficiency at 8-64 ranks for per-rank "
        f"shards >= {out['min_shard_bytes_eff_85']['good_day']} bytes at the "
        "faster compute rate — the seam design moves O(1) collective phases "
        "and O(overlap + batch + n_seq) ints per rank per scan, independent "
        "of shard length"
    )
    return out
