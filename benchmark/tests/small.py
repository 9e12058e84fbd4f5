"""Small stand-ins of the benchmark's configurations and traffic mixes, for
runs of the harness on the CPU: the same loops, readers and checks at a
size a test run can hold. G stays at 4096 where the port's top-k hit route
needs it."""

import copy

from benchmark import harness


def config(name: str) -> dict:
    cfg = copy.deepcopy(harness.load_json("configs", name))
    cfg["genomes"].update(G=4096, clusters=32, length=12000)
    return cfg


TRAFFIC = {
    "query": {"loop": "fof_query", "index_gzip": True,
              "queries_per_call": 96, "pool": 192,
              "query_mutation": 0.01, "check_calls": 2, "check_rows": 8},
    "lookup": {"loop": "lookup", "index_gzip": True, "pool": 64,
               "query_mutation": 0.01,
               "warmup_requests": 2, "check_rows": 8},
    "ingest": {"loop": "ingest", "pool": 4, "query_mutation": 0.01,
               "check_rebuilds": 1, "check_index_rows": 64},
}


def cell_parts(cell: str) -> tuple[dict, dict]:
    cfg_name, traffic = cell.split(".")
    return config(cfg_name), copy.deepcopy(TRAFFIC[traffic])
