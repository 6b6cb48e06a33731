"""Multi-pod dry-run on a CPU host: count every (architecture x input
shape) on the production meshes, and derive the roofline terms of an
H100 cluster.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell on 512 placeholder devices and reads XLA's analyses.  Eager
torch has no lowering: ``train.train_step.lower_train_step`` /
``lower_serve_step`` run the step on ``meta`` tensors (nothing is
allocated or computed, no device and no process group are touched: the
``meta`` device is the placeholder) and count it with
``launch/cost.py``.  The mesh is its shape alone
(``train_step.ShapeMesh``), so the 256- and 512-rank meshes need no
ranks.

Per cell we record, per rank:
  * memory: argument, output and alias bytes from the shard shapes of the
    reference's trees under the resolved specs, and temp bytes from the
    peak of the step's live storages at the rank's batch share and full
    width (an upper bound where the ``model`` axis is larger than 1: the
    port has no tensor-parallel execution); ``fits`` when argument +
    temp fit an H100's 80 GB;
  * FLOPs (``FlopCounterMode``: matrix products; XLA's count adds
    elementwise work) and bytes accessed (every non-view aten op's inputs
    and outputs, unfused) of the global step over the chip count;
  * collective bytes by kind: what the port's own distributed code sends
    (the compressed all-reduce, expert-parallel all-to-alls), exactly,
    plus one formula per term for the reference's layout
    (``train_step._modelled_collectives``);
  * the sharding fallbacks the divisibility resolver applied;
  * the three roofline terms under H100 SXM terms (below).

Python loops count every block (layers, flash attention's KV blocks, the
SSD chunks), so the reference's probe corrections are 0: ``corrections``
is ``{}``.  ``unroll_layers`` and ``rolled`` change nothing that is
counted.

The meshes on 8-GPU hosts: ranks are numbered row-major over the mesh's
axes and a host holds 8 consecutive ranks.  On the (16, 16) ("data",
"model") mesh a "model" line of 16 ranks spans two hosts and a "data"
line (stride 16) spans 16, so both axes cross hosts; on (2, 16, 16) the
"pod" axis does too.  An axis group that stays within one host moves at
the NVLink rate, one that leaves it at the inter-host rate.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--single-pod-only]
  python -m repro_torch.launch.dryrun --all --out results/dryrun.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Mapping

from ..configs import get_config, list_archs
from ..models.model import Model
from ..train.optimizer import AdamWConfig
from ..train.train_step import ShapeMesh, lower_serve_step, lower_train_step
from .mesh import production_mesh_shape
from .shapes import SHAPES, applicable

# NVIDIA H100 SXM5 terms, per GPU.
PEAK_FLOPS_BF16 = 989e12    # dense BF16 tensor core (H100 datasheet)
PEAK_FLOPS_F32 = 67e12      # FP32 (H100 datasheet)
HBM_BW = 3.35e12            # bytes/s of HBM3 (H100 datasheet)
HBM_BYTES = 80e9            # bytes of HBM3 (H100 datasheet)
NVLINK_BW = 450e9           # bytes/s each way within an 8-GPU host
                            # (NVLink 4: 900 GB/s both ways, datasheet)
INTER_HOST_BW = 50e9        # bytes/s each way per GPU between hosts: one
                            # 400 Gb/s NDR InfiniBand port per GPU (NVIDIA
                            # DGX H100 datasheet)
GPUS_PER_HOST = 8

_PEAK_FLOPS = {"bf16": PEAK_FLOPS_BF16, "f32": PEAK_FLOPS_F32}


def collective_bytes(lowered) -> dict:
    """Output operand bytes per collective kind, per rank: the lowered
    step's ``collectives()`` (there is no HLO text to parse)."""
    return dict(lowered.collectives())


def memory_stats(lowered) -> dict:
    ma = lowered.memory_analysis()
    keys = ["argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"]
    return {k: int(ma[k]) for k in keys if k in ma}


def leaves_host(mesh_shape: Mapping[str, int], axes) -> bool:
    """Whether a group along ``axes`` spans more than one 8-GPU host
    (ranks row-major over the mesh's axes, 8 consecutive ranks a host)."""
    span, stride = 0, 1
    for name in reversed(list(mesh_shape)):
        if name in axes:
            span += (mesh_shape[name] - 1) * stride
        stride *= mesh_shape[name]
    return span >= GPUS_PER_HOST


def collective_seconds(by_axis: Mapping[str, int],
                       mesh_shape: Mapping[str, int]) -> float:
    """Each axis group's bytes at the rate of the links it crosses."""
    return sum(nbytes / (INTER_HOST_BW if leaves_host(mesh_shape,
                                                      key.split("+"))
                         else NVLINK_BW)
               for key, nbytes in by_axis.items())


def roofline_terms(flops, hbm_bytes, coll_bytes, n_chips,
                   peak_flops=PEAK_FLOPS_BF16,
                   coll_bw=INTER_HOST_BW) -> dict:
    """The three terms of a step whose counts are global over ``n_chips``
    (per rank: ``n_chips=1``); collective bytes are per rank already."""
    compute_s = flops / (n_chips * peak_flops)
    memory_s = hbm_bytes / (n_chips * HBM_BW)
    collective_s = coll_bytes / coll_bw
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
    }


def fits(memory: Mapping[str, int]) -> bool:
    """Argument + temp bytes within one H100's HBM."""
    return (memory.get("argument_size_in_bytes", 0)
            + memory.get("temp_size_in_bytes", 0)) <= HBM_BYTES


def model_flops(cfg, spec) -> int:
    """The reference's useful work of a cell: 6 N T for a train step, 2 N T
    for prefill and decode (N active parameters, T tokens)."""
    if spec.kind == "train":
        return 6 * cfg.active_param_count() * spec.global_batch * spec.seq
    if spec.kind == "prefill":
        return 2 * cfg.active_param_count() * spec.global_batch * spec.seq
    return 2 * cfg.active_param_count() * spec.global_batch


def _compile_metrics(cfg, shape, mesh, *, microbatches, remat,
                     rule_overrides, unroll_layers, opt_overrides=None,
                     zero1=False, want_memory=False):
    """Lower and count one variant; return (metrics dict, rules)."""
    model = Model(cfg, device="meta", remat=remat,
                  unroll_layers=unroll_layers)
    spec = SHAPES[shape]
    t0 = time.time()
    if spec.kind == "train":
        opt_kw = dict(total_steps=10000)
        if opt_overrides:
            opt_kw.update(opt_overrides)
        lowered, rules = lower_train_step(
            model, AdamWConfig(**opt_kw), mesh, shape,
            microbatches=microbatches, rule_overrides=rule_overrides,
            zero1=zero1)
    else:
        lowered, rules = lower_serve_step(
            model, mesh, shape, rule_overrides=rule_overrides)
    ca = lowered.cost_analysis()
    coll = collective_bytes(lowered)
    out = {
        "flops": float(ca["flops"]),
        "bytes": float(ca["bytes accessed"]),
        "coll": coll,
        "coll_total": float(sum(coll.values())),
        "coll_s": collective_seconds(lowered.collectives_by_axis(),
                                     mesh.shape),
    }
    if want_memory:
        out["memory"] = memory_stats(lowered)
    out["t_s"] = time.time() - t0
    return out, rules


def run_cell(arch: str, shape: str, multi_pod: bool,
             rule_overrides=None, microbatches: int = 1,
             remat: str = "full", dtype: str = "bf16",
             opt_overrides=None, rolled: bool = False,
             cfg_overrides=None, zero1: bool = False) -> dict:
    """Lower and count one (arch x shape x mesh) cell; return the record:
    the reference's keys, per rank, and ``fits``.  ``rolled`` gives the
    reference's fast-mode record (the counts are the same here)."""
    cfg = get_config(arch, param_dtype=dtype, dtype=dtype,
                     **(cfg_overrides or {}))
    ok, why = applicable(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    mesh = ShapeMesh(production_mesh_shape(multi_pod))
    n_chips = math.prod(mesh.shape.values())
    spec = SHAPES[shape]
    kw = dict(microbatches=microbatches, remat=remat,
              rule_overrides=rule_overrides, opt_overrides=opt_overrides,
              zero1=zero1)
    try:
        main, rules = _compile_metrics(cfg, shape, mesh,
                                       unroll_layers=not rolled,
                                       want_memory=True, **kw)
        mem = main["memory"]
        if rolled:
            return {
                "arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "ok", "n_chips": n_chips, "rolled": True,
                "t_compile_s": round(main["t_s"], 1),
                "hlo_flops_body": main["flops"],
                "collective_bytes_body": main["coll_total"],
                "memory": mem,
                "fallbacks": rules.fallbacks,
                "fits": fits(mem),
            }
        n = cfg.param_count()
        mf = model_flops(cfg, spec)
        flops = main["flops"]
        coll_total = main["coll_total"]
        coll_bw = (coll_total / main["coll_s"] if main["coll_s"]
                   else INTER_HOST_BW)
        return {
            "arch": arch, "shape": shape, "mesh": mesh_name,
            "status": "ok",
            "n_chips": n_chips,
            "t_compile_s": round(main["t_s"], 1),
            "hlo_flops": flops,
            "hlo_bytes": main["bytes"],
            "collectives": main["coll"],
            "collective_bytes": coll_total,
            "corrections": {},
            "memory": mem,
            "fallbacks": rules.fallbacks,
            "params": n,
            "active_params": cfg.active_param_count(),
            "model_flops": mf,
            "useful_flops_ratio": (mf / (flops * n_chips)
                                   if flops else 0.0),
            **roofline_terms(flops, main["bytes"], coll_total, 1,
                             peak_flops=_PEAK_FLOPS[dtype],
                             coll_bw=coll_bw),
            "fits": fits(mem),
        }
    except Exception as e:  # noqa: BLE001 - report per-cell failures
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--rolled", action="store_true",
                    help="fast mode: the reference's rolled record (the "
                         "port's counts are the same either way)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]

    def flush(records):
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp,
                               microbatches=args.microbatches,
                               remat=args.remat, rolled=args.rolled)
                records.append(rec)
                flush(records)  # incremental: survive timeouts/crashes
                status = rec["status"]
                extra = ""
                if status == "ok" and not rec.get("rolled"):
                    extra = (f"count={rec['t_compile_s']}s "
                             f"flops={rec['hlo_flops']:.3g} "
                             f"coll={rec['collective_bytes']:.3g}B "
                             f"dom={rec['dominant']} fits={rec['fits']}")
                elif status == "ok":
                    mem = rec.get("memory", {})
                    gb = (mem.get("argument_size_in_bytes", 0)
                          + mem.get("temp_size_in_bytes", 0)
                          - mem.get("alias_size_in_bytes", 0)) / 1e9
                    extra = (f"count={rec['t_compile_s']}s "
                             f"mem={gb:.1f}GB/dev (rolled)")
                elif status == "error":
                    extra = rec["error"][:120]
                else:
                    extra = "skip"
                print(f"[{rec['mesh']:6s}] {arch:18s} {shape:12s} "
                      f"{status:7s} {extra}", flush=True)
    if args.out:
        flush(records)
        print(f"wrote {args.out}")
    bad = [r for r in records if r["status"] == "error"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
