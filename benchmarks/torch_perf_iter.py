"""Perf hillclimbing for the PyTorch/CUDA port: hypothesis ->
change -> re-count -> measure, on the port's dry-run.

The twin of ``benchmarks/perf_iter.py``: each named variant re-runs the
single-pod dry-run cell (``repro_torch.launch.dryrun.run_cell``, on
``meta`` tensors under H100 terms) with one change and reports the three
roofline terms next to the baseline.  Results append to
``results/torch_perf_iter.json``.

  PYTHONPATH=src python -m benchmarks.torch_perf_iter \\
      --cell deepseek-moe-16b/train_4k --variants baseline,seq_shard,cap1
"""

import argparse
import json
import os
import time

from repro_torch.launch.dryrun import run_cell

VARIANTS = {
    # name -> kwargs for run_cell (the reference's variants)
    "baseline": {},
    # B: cut remat recompute (keep matmul outputs, recompute elementwise)
    "remat_dots": {"remat": "dots"},
    # A: MoE dispatch from sequence-sharded tokens (n_ep x smaller a2a)
    "seq_shard": {"cfg_overrides": {"moe_seq_shard": True}},
    # A: drop expert-capacity headroom 1.25 -> 1.0 (less padded compute)
    "cap1": {"cfg_overrides": {"capacity_factor": 1.0}},
    "seq_shard_cap1": {"cfg_overrides": {"moe_seq_shard": True,
                                         "capacity_factor": 1.0}},
    # C: serving layout — replicate params over the data axis (no FSDP
    # gathers at decode; weights stay resident)
    "serve_replicated": {"rule_overrides": {"embed": None}},
    # prefill: bigger flash KV block (fewer loop steps, more memory)
    "flash4k": {"cfg_overrides": {"attn_kv_block": 4096}},
    # microbatching: halve activation footprint per pass
    "microbatch2": {"microbatches": 2},
    # B: ZeRO-1 layout — params replicated over data (model dims still
    # sharded), optimizer states data-sharded
    "zero1": {"zero1": True},
    # B: sequence parallelism — activations' seq dim over the model axis
    "sp": {"rule_overrides": {"seq": "model"}},
    "zero1_sp": {"zero1": True, "rule_overrides": {"seq": "model"}},
    "zero1_dots": {"zero1": True, "remat": "dots"},
    "zero1_sp_dots": {"zero1": True, "remat": "dots",
                      "rule_overrides": {"seq": "model"}},
    # combined winners (cell-specific)
    "dots_seq_shard_cap1": {"remat": "dots",
                            "cfg_overrides": {"moe_seq_shard": True,
                                              "capacity_factor": 1.0}},
    "zero1_seq_shard": {"zero1": True,
                        "cfg_overrides": {"moe_seq_shard": True}},
}

# Rules whose mechanism the port's dry-run does not model: it runs the
# step at the rank's batch share and full sequence, and no collective
# formula reads the ``seq`` rule, so a variant that sets it reports its
# temp, FLOPs and collectives as if the rule were unset.
UNMODELLED_RULES = ("seq",)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch/shape")
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--out", default="results/torch_perf_iter.json")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split("/")

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for name in args.variants.split(","):
        kw = dict(VARIANTS[name])
        unmodelled = [r for r in kw.get("rule_overrides", {})
                      if r in UNMODELLED_RULES]
        t0 = time.time()
        rec = run_cell(arch, shape, multi_pod=False, **kw)
        rec["variant"] = name
        if unmodelled:
            rec["not_modelled"] = unmodelled
        rec["wall_s"] = round(time.time() - t0, 1)
        results.append(rec)
        if rec["status"] == "ok":
            print(f"{args.cell} [{name:18s}] compute={rec['compute_s']:.4f}s "
                  f"memory={rec['memory_s']:.4f}s "
                  f"collective={rec['collective_s']:.4f}s "
                  f"dom={rec['dominant']} fits={rec['fits']} "
                  f"useful={rec['useful_flops_ratio']:.3f}"
                  + (f" NOT MODELLED: rule {unmodelled}" if unmodelled
                     else ""), flush=True)
        else:
            print(f"{args.cell} [{name}] {rec['status']}: "
                  f"{rec.get('error', '')[:200]}", flush=True)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
