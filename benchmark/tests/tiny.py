"""Traffic of a size the CPU holds, for the tests that drive a whole run,
and BENCHMARK.json with the cell that is kept out of it for now."""

import json

from benchmark import harness

# Left out of BENCHMARK.json while its host-bound rate spreads too widely
# between runs (PERF.md, Open questions); its files stay under benchmark/.
CORNELL = {"name": "cornell_smoke.final", "config": "cornell_smoke",
           "traffic": "final", "chips": 1,
           "why": "offline final frames of the fog Cornell box"}


def traffic(ranks: int = 1, spp: int = 4, update_spp: int = 2,
            width: int = 32, height: int = 18) -> dict:
    return {"width": width, "height": height, "frame_spp": spp,
            "update_spp": update_spp, "ranks": ranks,
            "orbit": {"span_deg": 360.0, "poses": 36},
            "check": {"frames": 2, "pixels": 256}}


def bench() -> dict:
    """BENCHMARK.json with the Cornell cell added back."""
    b = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    if all(w["name"] != CORNELL["name"] for w in b["workloads"]):
        b["workloads"].append(dict(CORNELL))
    return b


def load_cell(workload: str, **kw):
    return harness.load_cell(workload, bench(), **kw)
