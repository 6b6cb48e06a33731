"""A cell at a size the CPU holds, in a throwaway benchmark root: the real
readers and references, a shrunken copy of a configuration, a traffic mix."""

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from cepbench.harness import HERE, find_cell, load_json  # noqa: E402

TINY_CONFIG = {"partitions": 3, "size": 4, "n_types": 4, "chunk_cap": 64,
               "buffer_capacity": 256, "match_capacity": 2048}


def tiny_root(tmp: Path, config: str, traffic: str, **over) -> Path:
    for d in ("metrics", "references", "patterns", "calls"):
        shutil.copytree(HERE / d, tmp / d)
    (tmp / "configs").mkdir()
    (tmp / "traffic").mkdir()
    c = load_json(HERE / "configs" / f"{config}.json")
    o = {**TINY_CONFIG, **over}
    c["session"]["partitions"] = o["partitions"]
    c["session"]["runtime"].update(buffer_capacity=o["buffer_capacity"],
                                   match_capacity=o["match_capacity"])
    c["pattern"]["size"] = o["size"]
    c["stream"].update(n_types=o["n_types"], chunk_cap=o["chunk_cap"])
    (tmp / "configs" / "tiny.json").write_text(json.dumps(c))
    t = load_json(HERE / "traffic" / f"{traffic}.json")
    window = t["call"] == "step_superchunk"
    t.update(pool_chunks=10, warmup_chunks=8 if window else 4,
             trace_chunks=16 if window else 4)
    (tmp / "traffic" / "tiny.json").write_text(json.dumps(t))
    return tmp


def tiny_bench(extra_metrics=()):
    bench = load_json(REPO / "BENCHMARK.json")
    bench["workloads"].append({"name": "tiny", "config": "tiny",
                               "traffic": "tiny", "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny")
    bench["per_layer"].extend(extra_metrics)
    return bench


def tiny_cell(tmp: Path, config="traffic-seq6-order", traffic="closed-chunk",
              extra_metrics=(), **over):
    root = tiny_root(tmp, config, traffic, **over)
    return find_cell(tiny_bench(extra_metrics), "tiny", root=root)
