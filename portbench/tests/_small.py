"""Small sizes of every cell, for runs on the CPU."""

SMALL = {
    "qs-train-dense-bf16": {
        "config": {"feature_maps": 16, "query_maps": 16, "train_rounds": 4},
        "traffic": {"formulas_per_size": 4, "node_budget": 600,
                    "mega_steps": 4}},
    "anf-train-flat": {
        "config": {"feature_maps": 16, "query_maps": 16, "train_rounds": 3},
        "traffic": {"systems": 8, "mega_steps": 4}},
    "qs-solve-flat": {
        "config": {"feature_maps": 16, "query_maps": 16, "test_rounds": 16},
        "traffic": {"formulas_per_size": 3, "node_budget": 600}},
}


def small(workload: str, **traffic) -> dict:
    base = SMALL[workload]
    return {"config": dict(base["config"]),
            "traffic": dict(base["traffic"], **traffic)}
