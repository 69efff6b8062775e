"""The segsum kernel's share of its roofline in the solving pass, in
percent: the least time of its launches in the traced stretch over their
device time.

Launches: 4 a round (the query's literal -> clause sum and its clause ->
literal reply, the messages into clauses and the replies into literals),
at F = 128 f32. The least time of one launch is its bytes at the card's
HBM rate (`peaks.json`): the distinct source rows it gathers, one index a
real edge, the real output rows and their M + 1 row offsets, each once
(the byte count of `chip_smoke.py`'s `kernel_row`, commit ca3446b), counted
from the batch's formulas, not from the program's plans. The kernel's
source rows stay in L2 between launches, so a share can read above the
HBM bound; where it would, this metric has to be recounted, not capped.
"""

KERNEL = "gather_segsum_kernel"
F = 128
LAUNCHES_A_ROUND = {"lit_to_clause": 2, "clause_to_lit": 2}


def launch_bytes(item: dict) -> dict:
    E, C, V = item["n_edges"], item["n_clauses"], item["n_vars"]
    return {
        "lit_to_clause": item["n_lits"] * F * 4 + E * 4 + C * F * 4
        + (C + 1) * 4,
        "clause_to_lit": C * F * 4 + E * 4 + 2 * V * F * 4 + (2 * V + 1) * 4,
    }


def read(run):
    t = run.rec.trace
    items = run.rec.counters.get("stretch_items")
    if t is None or not items:
        return None
    spent = sum(b - a for n, a, b in t.kernels if KERNEL in n) / 1e9
    if spent <= 0:
        return None
    nbytes = sum(item["rounds"] * n * launch_bytes(item)[d]
                 for item in items for d, n in LAUNCHES_A_ROUND.items())
    return 100.0 * nbytes / run.peaks["hbm_bytes_per_s"] / spent
