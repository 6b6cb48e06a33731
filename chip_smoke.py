#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the CEP runtime and its LM stack on one
NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

1. device   — torch's device name, and nvidia-smi's name and power limit;
2. build    — nvcc builds the CUDA kernels from ``src/repro_torch``;
3. kernels  — each of the five kernels against its plain PyTorch version
              on the card, bit for bit, at its path's shapes, at ragged
              shapes, over every op code with ties and negative
              thresholds, on all-op-0 stacks and on stacks led by the
              engine's validity rows (tiles that end at the first row):
              the two joins' bit words and row counts, the row and pair
              counts, and the survivor selection (with overflow, zero
              survivors and a capacity past M*B); median times (CUDA
              events) beside each kernel's bound, and the counts' and the
              tree join's times on validity-led stacks.  The packed join
              and the row count also with a threshold row per batch
              element (rows that differ) at the rulebook's shapes (the
              unpacked join and the pair count at a ragged one), and a
              shared (C,) vector (batch stride 0) against the same values
              as (K, C);
4. main     — ``repro_torch.cep.open(..., plan="order").run(...)`` on the
              K=16 FlowSense alert rule at full width, with the launch
              counters zeroed just before and read just after; then the
              same stream again with ``backend="ref"`` (plain versions, on
              the card), which must give equal integer telemetry;
5. oracle   — a narrow K=4 order-plan stream on the card against the
              brute-force ``RefEngine``;
6. profile  — the first chunks of the main path under ``torch.profiler``:
              device-busy share and the ops with the most device time;
              fails if a device-wide scan (an M*B-cell scan) remains;
7. tree     — phases 4-6 for ``plan="tree"`` (ZStream trees, the unpacked
              join): the full-width run with its own launch counts and its
              plain rerun, the narrow run against ``RefEngine``, and the
              profile of its first chunks;
8. superchunk — for each plan, the same K=16 session with
              ``superchunk=8`` (``core/scan.py``: each chunk of a window is
              one replay of a captured CUDA graph, no host sync inside the
              window); its integer telemetry and per-partition matches
              must equal the per-chunk kernel run of phase 4 / 7 (itself
              held against the plain versions), and over the stream's
              first 16 chunks the window run with ``backend="ref"`` (the
              plain versions, captured and replayed on the card) must
              equal the kernel window.  Prints events/s beside
              the per-chunk run's, peak memory, graph captures and
              replays, in-window events (windows cut at a flag or an
              overflow and continued from the carry of that chunk), and per
              kernel the launches the captures recorded times their
              replays;
9. window profile — 16 chunks of the order window path under
              ``torch.profiler``, after a first run that captured its
              graphs: device-busy share of the wall;
10. serving — a monitored K=16 order session driven chunk by chunk
              through ``Session.step`` over the 64 chunks, and a second one
              through ``Session.step_superchunk`` with S=8, and a third
              with S=8 and ``backend="ref"``: per-chunk match arrays,
              violations, replans and host syncs must be equal;
11. rulebook — ``repro_torch.cep.open_rulebook`` with the FlowSense
              tenant's three rules (alert chain, acknowledgement, combo:
              two buckets, n=3 with negation and n=2 fusing two rules of
              different windows and predicates, so the per-batch
              thresholds are live), K=16, the 64 chunks of phase 4, one
              spare slot per bucket: ``run`` per chunk with the launch
              counters zeroed just before and read just after; zero
              overflow; per-rule counters equal three solo sessions
              (``Session.step``), the ``backend="ref"`` rerun, and the
              ``superchunk=8`` window run; a narrow K=4 run equals
              ``RefEngine``; a fourth rule hot-added into a spare slot
              after 32 chunks of a window run builds no kernel and
              captures no graph, and equals its solo session.  Prints
              events/s and peak memory of the per-chunk and window runs;
              then 16 chunks of the per-chunk rulebook under
              ``torch.profiler`` (as phase 6);
12. trace memo — the process-wide memo of steps and windows
              (``core/fleet.py::_shared_trace``): a second K=16 order
              session and a second tree session with ``superchunk=8`` and
              phase 8's config capture no graph, replay phase 8's graphs
              (launches counted) and equal the per-chunk telemetry; two
              serving sessions (the stream of phase 4 and one of seed
              1000) run their ``step_superchunk`` windows in turns
              through one shared window and equal their solo runs; a
              second FlowSense rulebook with ``superchunk=8`` captures no
              graph and equals phase 11's counters.  Prints the device
              memory the memo holds once no session is open (before and
              after ``clear_trace_memo()``), and per plan the first
              window's seconds of a fresh session with a fresh memo and
              on a memo hit, with the captures saved;
13. mesh    — the ``cep`` device mesh at D = 1
              (``distributed/sharding.py``): the order window and the
              rulebook window with ``mesh=1`` and ``mesh="auto"`` equal
              the unmeshed runs (each meshed session captures its own
              graphs: meshed windows are never memoized), launches
              counted; ``mesh=2`` raises ``ValueError`` on a one-GPU host
              (``NotImplementedError`` on a larger one: D > 1 is not
              ported);
14. adaptive loop — the paper's single-stream Algorithm 1
              (``repro_torch.core.AdaptiveRunner``) at its §5 setup
              (benchmarks/common.py::run_one): the five pattern sets at
              size 8 (the composite's three branches merged with
              ``merge_metrics``), 40 traffic chunks, adaptive match
              capacities, per planner (greedy: order engine; zstream: tree
              engine) under the four policies, with the launch counters
              zeroed just before and read just after; matches must not
              depend on the policy, no overflow may be left after
              escalation, the invariant policy at d=0 makes no false
              positive, and (seq, invariant) rerun with ``backend="ref"``
              gives equal integer metrics.  Prints events/s (host clock),
              replans, deployments, migration chunks, the capacities
              reached and the D+A share per run; then 16 chunks of one
              run under ``torch.profiler``;
15. adaptive oracle — each set at size 4 over 20 chunks, both
              planners, against ``RefEngine``;
16. monitored engine — ``MonitoredEngine`` (K = 1), order and tree
              plans, replanning on each flag: the fused flag equals the
              host mirror every chunk, and flags fire;
17. scenarios — each bundled scenario (``repro_torch.data.scenarios``)
              at its own partitions over its 80 chunks, replayed per
              segment under the adaptive (per chunk and S=8), static and
              pinned configurations, with the semantic replay gates
              (silent control segments, adaptive == static per segment,
              expected drift deployments, the pinned baseline loses
              matches) and the whole run against ``RefEngine``; then the
              FlowSense 3-rule rulebook's control gate and oracle.
              The kernels phase also holds the kernels at the adaptive
              loop's single-stream shapes (K = 1: the packed join and
              row count at M = 8192, B = 128; the tree join and the
              selection at the escalation limit M = B = 32768);
18. lm serving — ``repro_torch.launch.serve.main(["--arch", a,
              "--requests", "16", "--slots", "4"])`` at full width and
              depth (f32, random weights drawn on the card) for
              olmo-1b, mamba2-1.3b and zamba2-1.2b: every request
              completes with 16 tokens, each the argmax of the finite
              logits its prefill or decode step produced; prints prefill
              tokens/s, decode ms per step and tokens/s, peak memory,
              batch replans and deployments; profiles 8 decode steps;
              and, for two requests, how far a teacher-forced forward on
              the card is from the served logits beside how far the same
              forward on the CPU is from the card's (measurements: at
              full depth the reference's init makes olmo's f32 forward
              chaotic, PERF.md);
19. lm families — one config per family at full width, cut to two
              layers (paligemma: one), weights drawn on the CPU and
              copied to the card: forward, prefill and 4 decode steps on
              the card equal the port's CPU run within 2e-3 of the
              largest logit, with greedy tokens equal wherever the CPU's
              top-2 margin is clear; on the card, prefill plus
              teacher-forced decode equals the forward, and a two-slot
              ``ServingEngine`` (one prompt padded to its bucket) equals
              the forward (token families).
20. lm train — ``repro_torch.launch.train.main(["--arch", "olmo-1b",
              "--steps", "20", "--batch", "8", "--seq", "128"])`` at full
              width and depth (f32, TF32 off, remat none, weights drawn on
              the card): every step's ce, grad_norm and lr finite, every
              parameter changed; prints ms per step (the first apart),
              tokens/s, the model FLOP rate (6 N T) beside the f32 peak,
              peak memory; then 3 more steps under ``torch.profiler``
              (device-busy share, top ops, the optimizer's range) and one
              AdamW update timed with CUDA events beside its byte bound;
21. lm train consistency — olmo-1b at full width, 2 layers, weights drawn
              on the card and copied to the CPU: per-leaf gradients card
              vs CPU; 3 train steps (ce, grad_norm, parameter updates);
              remat full and dots against none on the card (bit for bit
              or not); microbatches=2 against 1;
22. lm train resume — the same cut through ``launch.train``: 10 straight
              steps against 5 with ``--ckpt-dir``/``--ckpt-every 5`` and a
              restart with ``--resume`` to 10, parameters bit-equal;
              prints checkpoint snapshot, write and restore seconds and
              bytes; the directory (``build/lm_train_ckpt``) is deleted;
23. lm train moe placement — deepseek-moe-16b at full width, 2 layers,
              ``--adaptive-placement``, 12 steps: every step finite,
              ``expert_load`` (2, 64) summing to T * 6 per layer; at each
              deployment the loss of that step's batch equals the
              unrelocated model's within 1e-5 and every MoE layer's
              weights, router columns, m and v moved by the relocation;
              prints governor replans and deployments.
24. lm train f64 — "lm train consistency"'s cut, weights and batch with
              the model in float64 (``float64_model``: the phase patches
              the dtypes, not the package): logits and per-leaf gradients
              card vs CPU within ``F64_LOGIT_TOL`` / ``F64_GRAD_TOL``, the
              f32 gaps scaled by the formats' rounding;
25. lm train moe resume — deepseek-moe-16b at 1 layer through
              ``launch.train``: 2 straight steps against 1 step + a
              checkpoint + ``--resume`` to 2, parameters bit-equal (the
              MoE combine and dispatch add nothing atomically);
26. dist collective — a one-rank default group (``cpu:gloo,cuda:nccl``,
              TCP store on 127.0.0.1) and ``launch.mesh.make_host_mesh(1,
              1)``: ``compressed_psum_tree`` on the reference test's leaves
              and a 2048 x 2048 one, card (NCCL) vs CPU (gloo) bit for
              bit, the reference's bounds, int8 payloads only;
27. dist compressed train — ``launch.train``'s OLMo-1B at full size
              through ``make_train_step(compressed_grads=True, mesh=...)``
              with error feedback, 6 steps: finite, every parameter
              moved, residuals within 2 scales; ms per step beside "lm
              train"'s, the all-reduce's CUDA-event ms, int8 bytes per
              step, peak memory;
28. dist compressed consistency — one compressed step of the 2-layer
              olmo on the card and on the CPU from the card's gradients:
              residuals bit-equal, parameters within ``DIST_PARAM_TOL``;
              each device's own step printed beside it;
29. dist moe ep — deepseek-moe-16b at 2 layers: the loss's forward and
              backward with every MoE layer on the expert-parallel path
              (n_ep = 1 over NCCL) against the dense path, bit for bit.
              The CEP kernels' launch counters are zeroed before each LM
              and distribution phase and read after it: 0 launches,
              recorded as the "lm serving", "lm families", "lm train",
              "lm train consistency", "lm train f64", "lm train resume",
              "lm train moe placement", "lm train moe resume", "dist
              collective", "dist compressed train", "dist compressed
              consistency" and "dist moe ep" entries of
              ``launches_by_path``;
30. dryrun  — "dryrun cells": ``repro_torch.launch.dryrun.run_cell``
              (``meta`` tensors on the host's CPU, H100 terms) for
              olmo-1b/train_4k, deepseek-moe-16b/train_4k,
              mamba2-1.3b/long_500k and yi-34b/decode_32k on the
              single-pod mesh: each record's three terms, ``dominant``
              and ``fits``; "dryrun anchor": "lm train"'s cell on a (1, 1)
              mesh shape, ``lower_train_step``'s FLOPs equal to
              ``FlopCounterMode``'s count over one step on the card,
              argument + temp bytes within 10% of the step's device peak,
              the compute term beside the measured ms; and with
              ``compressed_grads`` the all-to-all + all-gather bytes equal
              to "dist compressed train"'s int8 wire log per step;
31. examples — each ``examples/torch_*.py`` at its default size on the
              card (its output and seconds): the CEP examples launch the
              packed join and the selection, ``torch_fleet_demo``'s
              per-tenant oracle check passes; "example <name>" entries
              of ``launches_by_path``.

Launch counts: the counters are zeroed just before each path runs and
read just after.  ``LAUNCHES`` counts wrapper calls that launch a kernel;
a graph replay calls no wrapper, so the window paths also count
``GRAPH_LAUNCHES`` (the launches a capture recorded, once per replay), and
each of their kernels must show graph launches.  A window path's
``launches_by_path`` entry is the sum of the two; the rulebook's are
"rulebook" and "rulebook window", the memo phase's "trace memo-order",
"-tree", "-interleave" (both sessions) and "-rulebook", the mesh
phase's "mesh-order" and "mesh-rulebook" (both meshes), the adaptive
loop's "adaptive-greedy" and "adaptive-zstream" (all runs of a
planner).  A kernel's record also
holds its ``single_stream`` shape, times and bound.

The survivor selection's record is a JSON line of its own; the line
before the last is the JSON ``kernels`` record of the four kernels that
replace TPU kernels and the selection; the last line is ``{"ok": true,
"device": {...}}``.
Without a CUDA device the script exits with code 1 and prints no result;
alone, in a directory without the repository, it stops at its first
import of the port (exit code 1).

``python3 chip_smoke.py --bench N`` (a measurement, not the check) runs
only the device and build phases, then for the order and tree sessions
and the serving plane N per-chunk and N window runs of the K=16 stream
in turns (per-chunk, window, window, per-chunk, ...), each held to equal
telemetry and each from an empty memo (so a window run captures its
graphs in its first chunks), and prints each run's events/s over all 64
chunks (graph captures included) and over the chunks after the first 8,
with the medians and ranges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# The FlowSense alert rule (src/repro/data/scenarios/flowsense.py:40-44):
# temperature spike, no acknowledgement, humidity drop, gas alarm.
TEMP, HUMID, GAS, ACK = 0, 1, 2, 3
K_MAIN = 16
CHUNKS_MAIN = 64
BASE_RATE = 40.0
CHUNK_CAP = 512
B_CAP = 1024
M_CAP = 8192

# Monitored tree sessions need explicit invariant caps (the ZStream set's
# size depends on the statistics): the JAX tests'.  A replan whose set
# outgrows them raises, so a run that finishes shows they suffice.
TREE_CAPS = dict(max_invariants=8, max_terms=16)
# One pow2 escalation of a tree step (m_cap 16384) holds a 512 MiB bit
# mask and no running count, so memory no longer limits it.  The cap
# stays at one step so the tree path's work matches the earlier
# measurements in PERF.md; the port's first benchmark is where to raise it.
TREE_MAX_ESCALATIONS = 1
# Chunks per window of the superchunk and serving phases.
SUPERCHUNK = 8
# Chunks of the superchunk phases' plain-version window reruns (a prefix
# of the stream, two windows; the tree path's took 145 s over all 64).
WINDOW_REF_CHUNKS = 16
# --bench times each run's first chunks (graph captures) apart.
BENCH_SPLIT = 8

# The rulebook phase: one spare slot per bucket (the hot add's), and the
# chunk after which the fourth rule is hot-added.
RULEBOOK_SPARE = 1
HOT_ADD_AT = 32

# The single-stream adaptive loop at the paper's §5 setup
# (benchmarks/common.py:32-74 and ::run_one, :108-153): the five pattern
# sets at the widest size of benchmarks/fig69_methods.py:31, the traffic
# dataset, both planners under the four decision policies, adaptive match
# capacities in pow2 buckets between the bounds (escalation up to 4x the
# upper one).
ADAPT_SETS = ("seq", "conj", "neg", "kleene", "composite")
ADAPT_SIZE = 8
ADAPT_CHUNKS = 40
ADAPT_POLICIES = {"static": {}, "unconditional": {},
                  "threshold": dict(t=0.4), "invariant": dict(k=1, d=0.0)}
ADAPT_B_CAP = 128
ADAPT_M_CAP = 512
ADAPT_CAP_BOUNDS = (256, 8192)
RUN_FIELDS = ("chunks", "events", "full_matches", "pm_created", "overflow",
              "closure_expansions", "replans", "deployments",
              "false_positives", "migration_chunks", "condition_checks",
              "regret_samples")
# The adaptive oracle: each set at size 4 over 20 chunks.
ORACLE_SIZE = 4
ORACLE_CHUNKS = 20
SCENARIO_CONFIGS = ("adaptive", "adaptive_s8", "static", "pinned")

# The LM serving launcher at full size (repro/launch/serve.py's defaults:
# cache_len 256, max_new 16, classes [16, 32, 64]), per arch.
LM_SERVE_ARCHS = ("olmo-1b", "mamba2-1.3b", "zamba2-1.2b")
LM_REQUESTS = 16
LM_SLOTS = 4
LM_MAX_NEW = 16
# Decode steps profiled per served arch.
LM_PROFILE_STEPS = 8
# One config per family at full width, cut to LM_LAYERS layers (zamba2:
# one shared-block call), on the card against the port's CPU run: a
# (LM_B, LM_S) batch, prefill, LM_DECODE_STEPS decode steps.  paligemma
# is cut to one layer: its MQA keys draw at scale 1 (the reference's
# fan-in of wk (d, 1, hd) is one kv head), the worst-conditioned f32
# forward of the six; at two layers its card and CPU runs differed by
# more than LM_TOL (PERF.md).
LM_FAMILY_ARCHS = ("olmo-1b", "deepseek-moe-16b", "paligemma-3b",
                   "musicgen-large", "mamba2-1.3b", "zamba2-1.2b")
LM_LAYERS = 2
LM_LAYERS_OF = {"paligemma-3b": 1}
LM_B = 2
LM_S = 16
LM_DECODE_STEPS = 4
# Logits compare within LM_TOL of the largest reference logit: f32 on
# both sides, with other reduction orders (cuBLAS against the CPU's
# GEMMs, a decode step's cache against a forward's full sequence).
LM_TOL = 2e-3
# The LM training phases.  "lm train": the launcher at full size with the
# reference launcher's arguments (olmo-1b, batch 8 x 128, remat none);
# TRAIN_PROFILE_STEPS more steps under torch.profiler.  The model FLOPs
# of a step (6 N T) are set beside float32's non-tensor peak of one H100
# (NVIDIA's data sheet, SXM part, dense): TF32 stays off, so the GEMMs
# run in plain f32.
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_ARGV = ["--arch", "olmo-1b", "--steps", "20", "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
TRAIN_PROFILE_STEPS = 3
# "lm train consistency", "resume" and "moe placement" cut their config
# to TRAIN_LAYERS layers at full width (at full depth the reference's
# init leaves olmo's f32 forward ill-conditioned: PERF.md).  The
# consistency batch is (TRAIN_CHECK_B, TRAIN_CHECK_S) of make_batch.
# Even at two layers that init keeps the model far from unit scale (wq
# and wk drawn at 1/sqrt(H) put attention logits at a std of ~128, and
# the loss starts above log(vocab)), so f32 rounding is amplified: the
# logits of card and CPU differ by 2.8e-4 of the largest and the
# gradients by up to 2.3e-3 of a leaf's largest (PERF.md).  Per-leaf
# gradients compare within TRAIN_GRAD_TOL of the CPU leaf's largest.
# AdamW's first step moves every element by lr times the sign of its
# gradient, so elements whose gradient is within that rounding of zero
# move opposite ways on the two devices, and the runs part from step 1:
# over TRAIN_CHECK_STEPS steps ce and grad_norm compare within TRAIN_TOL
# relative, the parameters' updates in L2 (|| dp_card - dp_cpu || /
# || dp_cpu ||) within TRAIN_UPDATE_TOL.  microbatches=2 against 1 as the
# reference test: one step of AdamWConfig(total_steps=2), parameters
# within 2e-5.
TRAIN_LAYERS = 2
TRAIN_CHECK_B = 4
TRAIN_CHECK_S = 128
TRAIN_CHECK_STEPS = 3
TRAIN_GRAD_TOL = 1e-2
TRAIN_TOL = 2e-2
TRAIN_UPDATE_TOL = 5e-2
TRAIN_MB_TOL = 2e-5
# The MoE placement phase: deepseek-moe-16b, 12 steps with the governor;
# the loss of a deployment's batch before and after the relocation
# compares within PLACEMENT_TOL relative: the combine adds a token's
# expert outputs in ascending physical expert order (the reference's),
# and a relocation changes that order.
PLACEMENT_ARGV = ["--arch", "deepseek-moe-16b", "--adaptive-placement",
                  "--steps", "12", "--batch", str(TRAIN_BATCH), "--seq",
                  str(TRAIN_SEQ)]
PLACEMENT_TOL = 1e-5

# "lm train moe resume": deepseek-moe-16b at MOE_RESUME_LAYERS layers
# through launch.train's --resume: MOE_RESUME_STEPS straight steps against
# half of them, one checkpoint (parameters, m and v: 17.8 GiB at two
# layers, ~40 s to snapshot and write; one layer, an MoE layer like every
# other, keeps the path) and a restart, which skips its own final write.
MOE_RESUME_STEPS = 2
MOE_RESUME_LAYERS = 1
# "lm train f64": the f32 gaps of "lm train consistency" (logits 2.8e-4
# of the largest, gradients up to 2.3e-3 of a leaf's largest, PERF.md)
# times the f64/f32 rounding ratio (2**-29, ~1.9e-9) are ~5e-13 and
# ~4e-12; the gates leave three orders of magnitude above those and stay
# five below the f32 gaps, so a port fault of f32 size cannot pass.
F64_LOGIT_TOL = 1e-9
F64_GRAD_TOL = 1e-8
# The distribution phases over a one-rank NCCL group: the collective's
# extra leaf, the compressed OLMo-1B steps, and the parameters' gate of
# one compressed step card vs CPU from the same gradients: the
# compression is bit-equal by construction, and AdamW's elementwise
# update may differ by an ulp where the card's pow or sqrt rounds
# otherwise (parameters of magnitude < 8: an ulp < 1e-6).
DIST_LEAF = 2048
DIST_STEPS = 6
DIST_PARAM_TOL = 1e-6
# "dryrun cells": launch.dryrun.run_cell on the single-pod mesh; "dryrun
# anchor": argument + temp bytes of the lowered "lm train" step against
# the card's peak over one step, within DRYRUN_MEM_TOL relative.
DRYRUN_CELLS = (("olmo-1b", "train_4k"), ("deepseek-moe-16b", "train_4k"),
                ("mamba2-1.3b", "long_500k"), ("yi-34b", "decode_32k"))
DRYRUN_MEM_TOL = 0.10
# "examples": each examples/torch_*.py at its default size, with the
# kernels a CEP example must launch (order plans: the packed join and the
# survivor selection; no example's pattern has a negation or a Kleene
# closure, so none runs the row count).
_CEP_EXAMPLE = ("window_join_packed", "select_survivors")
EXAMPLES = (("quickstart", _CEP_EXAMPLE), ("fleet_demo", _CEP_EXAMPLE),
            ("monitored_fleet_demo", _CEP_EXAMPLE),
            ("adaptive_cep_demo", _CEP_EXAMPLE), ("serve_lm", ()),
            ("train_lm", ()), ("adaptive_moe_training", ()))
# Numbers a later phase prints beside its own ("lm train"'s ms/step).
RESULTS = {}

SOURCE = "src/repro_torch/kernels/csrc/window_join.cu"
REPLACES = {
    "window_join_packed": "src/repro/kernels/window_join.py:295",
    "window_join_rowcount": "src/repro/kernels/window_join.py:383",
    "window_join": "src/repro/kernels/window_join.py:120",
    "window_join_count": "src/repro/kernels/window_join.py:202",
}
# The survivor selection replaces the reference's jnp.nonzero in _compact,
# not a TPU kernel.
SELECT = "select_survivors"
SELECT_REPLACES = "src/repro/core/engine.py:167"
# The kernels each path must launch.
PATH_KERNELS = {"order": ("window_join_packed", "window_join_rowcount",
                          SELECT),
                "tree": ("window_join", "window_join_rowcount", SELECT)}
# The kernels each planner's adaptive-loop runs must launch.
ADAPT_KERNELS = {"greedy": PATH_KERNELS["order"],
                 "zstream": PATH_KERNELS["tree"]}
INT_FIELDS = ("chunks", "events", "matches", "replans", "deployments",
              "violations", "host_syncs", "overflow", "dropped",
              "neg_rejected", "closure_expansions", "escalations",
              "migration_partition_chunks")


def flowsense_rule():
    from repro_torch.cep import P

    return (P.seq(TEMP, P.neg(ACK), HUMID, GAS)
            .where(P.attr(0) < P.attr(1) + 0.3,
                   P.attr(1) < P.attr(2) + 0.3)
            .within(3.0))


def flowsense_rulebook():
    """The FlowSense tenant rulebook (src/repro/data/scenarios/flowsense.py:
    63, rules at :40-59): the alert chain, the acknowledged spike, and the
    humidity-gas combo."""
    from repro_torch.cep import P

    return [flowsense_rule(),
            P.seq(TEMP, ACK).within(3.0),
            P.and_(HUMID, GAS).where(P.attr(0) < P.attr(1) + 0.3)
            .within(2.0)]


def hot_added_rule():
    """The fourth rule, hot-added into the n=2 bucket's spare slot: a
    humidity drop followed by a gas alarm with ascending readings."""
    from repro_torch.cep import P

    return (P.seq(HUMID, GAS).where(P.attr(0) < P.attr(1) + 0.3)
            .within(2.0))


def streams(k, n_chunks, base_rate, chunk_cap, seed=0):
    from repro_torch.data.cep_streams import StreamConfig, traffic_stream

    cfg = StreamConfig(n_types=4, n_chunks=n_chunks, chunk_cap=chunk_cap,
                       base_rate=base_rate, shift_every=16.0)
    return [traffic_stream(dataclasses.replace(cfg, seed=seed + p))
            for p in range(k)]


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name, t):
    print(f"   {name} seconds: {time.perf_counter() - t:.3f}", flush=True)


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------


def coarse(gen, shape, device):
    """Values on a 0.25 grid, so l == r + theta ties occur often."""
    import torch

    return (torch.randint(-8, 9, shape, generator=gen, device=device)
            .to(torch.float32) * 0.25)


def packed_inputs(gen, k, c, m, b, device):
    import torch

    L = coarse(gen, (k, c, m), device)
    R = coarse(gen, (k, c, b), device)
    ops8 = torch.randint(0, 4, (k, c), generator=gen,
                         device=device).to(torch.int8)
    th = coarse(gen, (c,), device).abs()
    mv = (torch.rand((k, m), generator=gen, device=device) < 0.5)
    bv = (torch.rand((k, b), generator=gen, device=device) < 0.5)
    return L, R, ops8, th, mv, bv


def rowcount_inputs(gen, k, c, m, b, device):
    import torch

    L = coarse(gen, (k, c, m), device)
    R = coarse(gen, (k, c, b), device)
    ops = torch.randint(0, 5, (k, c), generator=gen,  # 4: "else true"
                        device=device).to(torch.int32)
    th = coarse(gen, (c,), device).abs() + 1.0
    return L, R, ops, th


def unpacked_inputs(gen, k, c, m, b, device):
    """Operands of the tree engine's join: every op code 0-4 (4: "else
    true") and thresholds of either sign."""
    import torch

    L = coarse(gen, (k, c, m), device)
    R = coarse(gen, (k, c, b), device)
    ops = torch.randint(0, 5, (k, c), generator=gen,
                        device=device).to(torch.int32)
    th = coarse(gen, (c,), device)
    return L, R, ops, th


def validity_first(args, gen):
    """``args`` (L, R, ops, thresholds) behind the engine's two validity
    rows (``core/engine.py::_validity_rows``): row 0 keeps the leading
    M/8 rows (``l > 1.0 - 0.5``), as the compaction packs live match slots
    first, so every 32 x 32 tile past them dies at the first row; row 1
    keeps about 3/4 of the columns (``1.0 < r + 0.5``)."""
    import torch

    L, R, ops, th = (a.clone() for a in args)
    k, c, m = L.shape
    b = R.shape[2]
    dev = L.device
    L[:, 0] = (torch.arange(m, device=dev) < m // 8).to(torch.float32)
    R[:, 0], ops[:, 0], th[0] = 1.0, 2, 0.5
    if c > 1:
        L[:, 1] = 1.0
        R[:, 1] = (torch.rand((k, b), generator=gen, device=dev)
                   < 0.75).to(torch.float32)
        ops[:, 1], th[1] = 1, 0.5
    return L, R, ops, th


def check_counts(args, what):
    """The row count and the pair count against their plain versions; an
    all-op-0 stack must count B per row and M*B per partition."""
    import torch

    from repro_torch.kernels import ops as kops

    k, c, m = args[0].shape
    b = args[1].shape[2]
    for fn in (kops.window_join_rowcount, kops.window_join_count):
        if not torch.equal(fn(*args), fn(*args, backend="ref")):
            raise AssertionError(f"{fn.__name__} kernel != plain at "
                                 f"{(k, c, m, b)} ({what})")
    if not bool((args[2] == 0).all()):
        return
    if not bool((kops.window_join_rowcount(*args) == b).all()):
        raise AssertionError(f"all-op-0 row count != B at {(k, c, m, b)}")
    if kops.window_join_count(*args).tolist() != [m * b] * k:
        raise AssertionError(f"all-op-0 count != M*B at {(k, c, m, b)}")


def cuda_ms(fn, reps=10, inner=5):
    """Median ms per call over ``reps`` event-timed runs of ``inner``
    calls each, after a warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def roofline(nbytes, n_ops):
    """(ms, what bounds it): the larger of the bytes over the card's
    memory rate and the f32 operations over its non-tensor f32 rate (the
    H100 SXM terms of ``repro_torch.launch.dryrun``)."""
    from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS_F32

    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = n_ops / PEAK_FLOPS_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bit_output_bytes(k, m, b):
    """Bytes of a bit-word join's outputs: (K, M, ceil(B/32)) int32 words
    and (K, M) int32 row counts."""
    return 4 * k * m * -(-b // 32) + 4 * k * m


def packed_bound(L, R, ops8, th, mv, bv):
    """Least time for the packed join on these inputs: each input read
    once and the bit words and row counts written once, against 3 f32
    operations (shift, compare, AND) per active constraint row of each
    valid cell."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel()) + ops8.numel() \
        + mv.numel() + bv.numel() + bit_output_bytes(k, m, b)
    cells = (mv.sum(1).double() * bv.sum(1).double())
    active = (ops8 != 0).sum(1).double()
    ops = float((cells * (3 * active + 1)).sum())
    return roofline(nbytes, ops)


def rowcount_bound(L, R, ops, th):
    """Least time for the row count: inputs read once, counts written
    once, against 3 f32 operations per active row of every (m, b) cell
    plus one add per cell."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel() + ops.numel() + k * m)
    active = ((ops >= 1) & (ops <= 3)).sum(1).double()
    ops_n = float((m * b * (3 * active + 1)).sum())
    return roofline(nbytes, ops_n)


def join_bound(L, R, ops, th):
    """Least time for the unpacked join on these inputs: each input read
    once and the bit words and row counts written once, against 3 f32
    operations (shift, compare, AND) per active constraint row of every
    cell."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel() + ops.numel()) \
        + bit_output_bytes(k, m, b)
    active = ((ops >= 1) & (ops <= 3)).sum(1).double()
    ops_n = float((m * b * 3 * active).sum())
    return roofline(nbytes, ops_n)


def count_bound(L, R, ops, th):
    """Least time for the pair count: inputs read once, K counts written
    once, against 3 f32 operations per active row of every cell plus one
    add per cell."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel() + ops.numel() + k)
    active = ((ops >= 1) & (ops <= 3)).sum(1).double()
    ops_n = float((m * b * (3 * active + 1)).sum())
    return roofline(nbytes, ops_n)


def select_bound(bits, counts, b, out_cap):
    """Least time for the survivor selection on these inputs: the row
    counts read once, the bit words of the rows holding a survivor ranked
    below ``out_cap`` read once, and the (K, out_cap) int64 indices written
    once; its operations (a popcount per word, an index per survivor) are
    negligible beside the bytes."""
    import torch

    k, m, w = bits.shape
    ends = torch.cumsum(counts, dim=1, dtype=torch.int64)
    needed = (counts > 0) & (ends - counts < out_cap)
    nbytes = 4 * counts.numel() + 4 * w * int(needed.sum()) \
        + 8 * k * out_cap
    return roofline(nbytes, 0)


def mask_err(got, want):
    """max_abs_err of a (bit words, row counts) pair: 1 if any mask cell
    differs, else the largest row-count difference."""
    import torch

    if not torch.equal(got[0], want[0]):
        return 1.0
    return float((got[1].to(torch.int64) - want[1].to(torch.int64))
                 .abs().max())


def check_select(bits, counts, b, caps, what):
    """The selection kernel against its plain version for each capacity."""
    import torch

    from repro_torch.kernels import ops as kops

    for cap in caps:
        got = kops.select_survivors(bits, counts, b, cap)
        want = kops.select_survivors(bits, counts, b, cap, backend="ref")
        if not torch.equal(got, want):
            raise AssertionError(f"select_survivors kernel != plain at "
                                 f"{tuple(bits.shape)}, B={b}, out_cap="
                                 f"{cap} ({what})")


def sparse_bits(gen, k, m, b, per_partition, device):
    """Bit words and row counts of a random mask with about
    ``per_partition`` survivors per partition spread over all rows: the
    selection's worst case at a capacity near that count (every row holds
    a survivor, every row's words are read)."""
    import torch

    from repro_torch.kernels import ref

    mask = torch.rand((k, m, b), generator=gen, device=device) \
        < per_partition / (m * b)
    return ref.pack_bits(mask), mask.sum(dim=-1, dtype=torch.int32)


def check_kernels(device, c_packed, c_rowcount, c_join):
    """The five kernels vs their plain versions at their paths' shapes and
    at ragged / extreme shapes; returns the timing records."""
    import torch

    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    # The validity-led stacks draw from their own generator, so the timed
    # inputs below stay the ones earlier runs timed.
    gen2 = torch.Generator(device=device)
    gen2.manual_seed(1)
    shapes = [(K_MAIN, c_packed, M_CAP, B_CAP), (3, 5, 1000, 333),
              (2, 32, 257, 129), (1, 1, 1, 1), (4, 64, 37, 1030)]
    n_select = 0
    for (k, c, m, b) in shapes:
        args = packed_inputs(gen, k, c, m, b, device)
        none = (args[0], args[1], torch.zeros_like(args[2]), *args[3:])
        for a, what in ((args, "mixed ops"), (none, "all-op-0 stack")):
            got = kops.window_join_packed_bits(*a)
            if mask_err(got, kops.window_join_packed_bits(
                    *a, backend="ref")) != 0:
                raise AssertionError(f"packed kernel != plain at "
                                     f"{(k, c, m, b)} ({what})")
            # Overflow (1, 100 or M_CAP below the survivors), a capacity
            # past M*B, and the real one.
            check_select(*got, b, (1, 100, M_CAP, m * b + 7), what)
            n_select += 4
    for (k, c, m, b) in [(K_MAIN, c_rowcount, M_CAP, B_CAP)] + shapes[1:]:
        args = rowcount_inputs(gen, k, c, m, b, device)
        check_counts(args, "mixed ops")
        check_counts(validity_first(args, gen2), "validity rows first")
    tree_shape = (K_MAIN, c_join, M_CAP, M_CAP)
    for (k, c, m, b) in [tree_shape] + shapes[1:]:
        args = unpacked_inputs(gen, k, c, m, b, device)
        none = (args[0], args[1], torch.zeros_like(args[2]), args[3])
        for a, what in ((args, "mixed ops"), (none, "all-op-0 stack"),
                        (validity_first(args, gen2), "validity rows first")):
            got = kops.window_join_bits(*a)
            if mask_err(got, kops.window_join_bits(*a, backend="ref")) != 0:
                raise AssertionError(f"join kernel != plain at "
                                     f"{(k, c, m, b)} ({what})")
            check_counts(a, what)
            check_select(*got, b, (1, M_CAP, m * b + 7), what)
            n_select += 3
    # Zero survivors, and about one survivor per row at the tree shape.
    k, _, m, b = tree_shape
    zero = (torch.zeros((k, m, -(-b // 32)), dtype=torch.int32,
                        device=device),
            torch.zeros((k, m), dtype=torch.int32, device=device))
    check_select(*zero, b, (1, M_CAP), "zero survivors")
    sparse = sparse_bits(gen, k, m, b, M_CAP, device)
    check_select(*sparse, b, (M_CAP // 2, M_CAP, 2 * M_CAP),
                 "one survivor per row")
    n_select += 5
    print(f"   bit-identical to the plain versions at {len(shapes)} packed, "
          f"{len(shapes)} rowcount and {len(shapes)} join/count shapes (all "
          "op codes, ties, negative thresholds, all-none stacks, validity "
          "rows first; all-op-0 counts == B per row, M*B) and in "
          f"{n_select} selections (overflow, zero survivors, capacity past "
          "M*B, ragged B)")

    records = {}
    p_args = packed_inputs(gen, K_MAIN, c_packed, M_CAP, B_CAP, device)
    r_args = rowcount_inputs(gen, K_MAIN, c_rowcount, M_CAP, B_CAP, device)
    u_args = unpacked_inputs(gen, *tree_shape, device)
    for name, fn, args, bound, diff in (
            ("window_join_packed", kops.window_join_packed_bits, p_args,
             packed_bound, mask_err),
            ("window_join_rowcount", kops.window_join_rowcount, r_args,
             rowcount_bound, None),
            ("window_join", kops.window_join_bits, u_args, join_bound,
             mask_err),
            ("window_join_count", kops.window_join_count, u_args,
             count_bound, None),
            (SELECT, kops.select_survivors, (*sparse, b, M_CAP),
             select_bound, None)):
        got = fn(*args)
        want = fn(*args, backend="ref")
        err = (diff(got, want) if diff else
               float((got.to(torch.int64) - want.to(torch.int64))
                     .abs().max()))
        ms = cuda_ms(lambda: fn(*args))
        plain_ms = cuda_ms(lambda: fn(*args, backend="ref"), reps=5,
                           inner=2)
        bound_ms, bound_by = bound(*args)
        shape = (f"(K, M, B, out_cap)={tuple(args[0].shape[:2]) + args[2:]}"
                 if name == SELECT else f"(K, C, M, B)="
                 f"{tuple(args[0].shape) + (args[1].shape[2],)}")
        print(f"   {name} {shape}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max_abs_err {err}")
        records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    # The counts beside the tree join on path-like stacks: the validity
    # rows first, 1/8 of the match slots live.
    g_u = validity_first(u_args, gen2)
    for name, fn, args in (
            ("window_join_rowcount", kops.window_join_rowcount,
             validity_first(r_args, gen2)),
            ("window_join", kops.window_join_bits, g_u),
            ("window_join_count", kops.window_join_count, g_u)):
        ms = cuda_ms(lambda: fn(*args))
        print(f"   {name} (K, C, M, B)="
              f"{tuple(args[0].shape) + (args[1].shape[2],)}, validity rows "
              f"first (1/8 of M live): kernel {ms:.4f} ms")
    # The selection at the order path's shape, from the packed join.
    p_out = kops.window_join_packed_bits(*p_args)
    o_ms = cuda_ms(lambda: kops.select_survivors(*p_out, B_CAP, M_CAP))
    o_bound, _ = select_bound(*p_out, B_CAP, M_CAP)
    print(f"   {SELECT} (K, M, B, out_cap)={(K_MAIN, M_CAP, B_CAP, M_CAP)} "
          f"(packed join output): kernel {o_ms:.4f} ms, bound "
          f"{o_bound:.4f} ms (bytes)")
    return records


def check_per_batch_thresholds(device, c_packed, c_rowcount, batch):
    """The packed join and the row count with a threshold row per batch
    element (rows that differ), bit for bit against their plain versions,
    at the rulebook's shapes (``batch`` = K x rule slots, M_CAP, B_CAP) and
    a ragged one; a shared (C,) vector (batch stride 0) must equal the
    same values given as (K, C).  Prints the kernels' times with per-batch
    and shared thresholds at the rulebook's shapes."""
    import torch

    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    for (k, cp, cr, m, b) in [(batch, c_packed, c_rowcount, M_CAP, B_CAP),
                              (5, 7, 5, 1000, 333)]:
        L, R, ops8, _, mv, bv = packed_inputs(gen, k, cp, m, b, device)
        step = 0.25 * torch.arange(k, device=device)[:, None]
        th = coarse(gen, (k, cp), device).abs() + step
        shared = th[0].contiguous()
        for t, what in ((th, "per batch"), (shared, "shared")):
            if mask_err(kops.window_join_packed_bits(L, R, ops8, t, mv, bv),
                        kops.window_join_packed_bits(
                            L, R, ops8, t, mv, bv, backend="ref")) != 0:
                raise AssertionError(f"packed kernel != plain, {what} "
                                     f"thresholds, at {(k, cp, m, b)}")
        if mask_err(kops.window_join_packed_bits(L, R, ops8, shared, mv, bv),
                    kops.window_join_packed_bits(
                        L, R, ops8, shared.expand(k, cp).contiguous(), mv,
                        bv)) != 0:
            raise AssertionError("packed: stride-0 thresholds != (K, C)")
        rL, rR, rops, _ = rowcount_inputs(gen, k, cr, m, b, device)
        rth = coarse(gen, (k, cr), device) + 0.25 * torch.arange(
            k, device=device)[:, None]
        rshared = rth[0].contiguous()
        for t, what in ((rth, "per batch"), (rshared, "shared")):
            if not torch.equal(kops.window_join_rowcount(rL, rR, rops, t),
                               kops.window_join_rowcount(rL, rR, rops, t,
                                                         backend="ref")):
                raise AssertionError(f"rowcount kernel != plain, {what} "
                                     f"thresholds, at {(k, cr, m, b)}")
        if not torch.equal(
                kops.window_join_rowcount(rL, rR, rops, rshared),
                kops.window_join_rowcount(
                    rL, rR, rops, rshared.expand(k, cr).contiguous())):
            raise AssertionError("rowcount: stride-0 thresholds != (K, C)")
        if k != batch:  # the unpacked join and the pair count take it too
            for fn in (kops.window_join_bits, kops.window_join_count):
                got = fn(rL, rR, rops, rth)
                want = fn(rL, rR, rops, rth, backend="ref")
                if not all(torch.equal(g, w) for g, w in zip(
                        *((got, want) if isinstance(got, tuple)
                          else ((got,), (want,))))):
                    raise AssertionError(f"{fn.__name__} kernel != plain, "
                                         f"per-batch thresholds")
        if k == batch:
            packed = kops.window_join_packed_bits
            rowcount = kops.window_join_rowcount
            times = {
                "packed, per batch": cuda_ms(
                    lambda: packed(L, R, ops8, th, mv, bv)),
                "packed, shared": cuda_ms(
                    lambda: packed(L, R, ops8, shared, mv, bv)),
                "rowcount, per batch": cuda_ms(
                    lambda: rowcount(rL, rR, rops, rth)),
                "rowcount, shared": cuda_ms(
                    lambda: rowcount(rL, rR, rops, rshared)),
            }
            print(f"   rulebook shapes (batch, C, M, B): packed "
                  f"{(k, cp, m, b)}, rowcount {(k, cr, m, b)}: " + ", ".join(
                      f"{n} {v:.4f} ms" for n, v in times.items()))
    print("   per-batch thresholds: packed join and row count (and, at the "
          "ragged shape, the unpacked join and the pair count) "
          "bit-identical to the plain versions; stride-0 shared "
          "thresholds equal (K, C)")


def check_single_stream_kernels(device, c_packed, c_join):
    """The kernels at the shapes of the single-stream adaptive loop (K = 1,
    the §5 setup's b_cap): the packed join and the row count at the largest
    bucket the cost model picks, the tree join and the survivor selection
    at the escalation limit, each bit for bit against its plain version.
    Returns per kernel the shape, the times, the bound and the error."""
    import torch

    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    m_top = ADAPT_CAP_BOUNDS[1]
    m_esc = 4 * ADAPT_CAP_BOUNDS[1]
    p_args = packed_inputs(gen, 1, c_packed, m_top, ADAPT_B_CAP, device)
    r_args = rowcount_inputs(gen, 1, 6, m_top, ADAPT_B_CAP, device)
    u_args = unpacked_inputs(gen, 1, c_join, m_esc, m_esc, device)
    # the selection on the tree join's own output, then its timed input:
    # about one survivor per row
    joined = kops.window_join_bits(*u_args)
    check_select(*joined, m_esc, (1, m_esc // 2, m_esc),
                 "single-stream tree join output")
    sparse = sparse_bits(gen, 1, m_esc, m_esc, m_esc, device)
    check_select(*sparse, m_esc, (m_esc // 2, m_esc, 2 * m_esc),
                 "single-stream, one survivor per row")
    del joined
    records = {}
    for name, fn, args, bound, diff in (
            ("window_join_packed", kops.window_join_packed_bits, p_args,
             packed_bound, mask_err),
            ("window_join_rowcount", kops.window_join_rowcount, r_args,
             rowcount_bound, None),
            ("window_join", kops.window_join_bits, u_args, join_bound,
             mask_err),
            (SELECT, kops.select_survivors, (*sparse, m_esc, m_esc),
             select_bound, None)):
        got = fn(*args)
        want = fn(*args, backend="ref")
        err = (diff(got, want) if diff else
               float((got.to(torch.int64) - want.to(torch.int64))
                     .abs().max()))
        if err != 0:
            raise AssertionError(f"{name} kernel != plain at the "
                                 f"single-stream shape (max_abs_err {err})")
        del got, want
        ms = cuda_ms(lambda: fn(*args))
        plain_ms = cuda_ms(lambda: fn(*args, backend="ref"), reps=3,
                           inner=1)
        bound_ms, bound_by = bound(*args)
        shape = (tuple(args[0].shape[:2]) + args[2:] if name == SELECT
                 else tuple(args[0].shape) + (args[1].shape[2],))
        print(f"   single stream {name} "
              f"{'(K, M, B, out_cap)' if name == SELECT else '(K, C, M, B)'}"
              f"={shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), max_abs_err {err}")
        records[name] = dict(shape=list(shape), ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=err)
    return records


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def path_config(plan, **kw):
    """The session configuration of a path: the same capacities for both
    plan families; tree plans add their invariant caps and escalation
    limit."""
    from repro_torch.cep import RuntimeConfig

    if plan == "tree":
        kw = dict(TREE_CAPS, max_escalations=TREE_MAX_ESCALATIONS, **kw)
    return RuntimeConfig(**kw)


def run_main(device, backend=None, plan="order", superchunk=1,
             sessions=None, n_chunks=CHUNKS_MAIN, mesh=None):
    """The full-width path through ``cep.open(...).run`` over the first
    ``n_chunks`` chunks (K split over ``mesh`` if given); returns the
    telemetry, the wall seconds and the peak device memory (bytes), and
    appends the session to ``sessions`` if given."""
    import torch

    from repro_torch import cep

    cfg = path_config(plan, buffer_capacity=B_CAP, match_capacity=M_CAP,
                      chunk_capacity=CHUNK_CAP, device=device,
                      backend=backend, superchunk=superchunk, mesh=mesh)
    sess = cep.open(flowsense_rule(), partitions=K_MAIN, plan=plan,
                    monitor=True, config=cfg)
    if sessions is not None:
        sessions.append(sess)
    data = streams(K_MAIN, n_chunks, BASE_RATE, CHUNK_CAP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tel = sess.run(data)
    torch.cuda.synchronize()
    return tel, time.perf_counter() - t, torch.cuda.max_memory_allocated()


def same_telemetry(tel, want, what):
    """Every integer telemetry field and the per-partition matches."""
    for f in INT_FIELDS:
        if getattr(tel, f) != getattr(want, f):
            raise AssertionError(f"{what}: {f} {getattr(tel, f)} != "
                                 f"{getattr(want, f)}")
    if tel.per_partition_matches.tolist() != \
            want.per_partition_matches.tolist():
        raise AssertionError(f"{what}: per-partition matches differ")


def check_path(plan):
    """Drives one path with the launch counters zeroed just before and
    read just after, then reruns it with the plain versions; returns the
    launch counts, the telemetry and the events/s."""
    from repro_torch.kernels import ops as kops

    kops.reset_launch_counts()
    tel, secs, peak = run_main("cuda", plan=plan)
    launches = dict(kops.LAUNCHES)
    for name in PATH_KERNELS[plan]:
        if launches[name] <= 0:
            raise AssertionError(f"{plan} path never launched {name}")
    print(f"   plan={plan} K={K_MAIN} FlowSense rule, base_rate="
          f"{BASE_RATE}, b_cap={B_CAP}, m_cap={M_CAP}: {tel.events} events "
          f"in {secs:.3f} s = {tel.events / secs:.1f} events/s, peak "
          f"device memory {peak / 2 ** 30:.3f} GiB")
    print("   " + ", ".join(f"{f}={getattr(tel, f)}" for f in INT_FIELDS))
    print(f"   kernel launches on the {plan} path: {launches}")
    kops.reset_launch_counts()
    ref_tel, ref_secs, ref_peak = run_main("cuda", backend="ref", plan=plan)
    if any(kops.LAUNCHES.values()):
        raise AssertionError("backend='ref' launched a kernel")
    same_telemetry(tel, ref_tel, f"{plan}: kernels vs plain")
    print(f"   plain-version rerun on the card: equal integer telemetry "
          f"({ref_secs:.3f} s = {ref_tel.events / ref_secs:.1f} events/s, "
          f"peak device memory {ref_peak / 2 ** 30:.3f} GiB)")
    return launches, tel, tel.events / secs


def window_launches(path, kernels):
    """A window path's launches per kernel: wrapper launches plus the
    launches replayed from captured graphs; fails if a kernel of the path
    shows no graph launch."""
    from repro_torch.kernels import ops as kops

    for name in kernels:
        if kops.GRAPH_LAUNCHES[name] <= 0:
            raise AssertionError(f"{path}: no graph replay launched {name}")
    print(f"   launches recorded at capture x replays: "
          f"{dict(kops.GRAPH_LAUNCHES)}; wrapper launches (warm-up, eager "
          f"escalation recounts): {dict(kops.LAUNCHES)}")
    return {k: kops.LAUNCHES[k] + kops.GRAPH_LAUNCHES[k]
            for k in kops.LAUNCHES}


def check_superchunk(plan, want, want_rate):
    """The K=16 session with superchunk=8 on the card against the
    per-chunk kernel run ``want``; returns the launch counts."""
    from repro_torch.core import scan
    from repro_torch.kernels import ops as kops

    kops.reset_launch_counts()
    scan.reset_counts()
    box = []
    tel, secs, peak = run_main("cuda", plan=plan, superchunk=SUPERCHUNK,
                               sessions=box)
    launches = window_launches(f"superchunk {plan}", PATH_KERNELS[plan])
    counts = dict(scan.COUNTS)
    same_telemetry(tel, want, f"superchunk {plan} vs per-chunk")
    if counts["replays"] <= 0 or counts["eager_steps"] != 0:
        raise AssertionError(f"superchunk {plan}: window counts {counts}")
    print(f"   plan={plan} superchunk={SUPERCHUNK}: equal integer telemetry "
          f"to the per-chunk run; {tel.events / secs:.1f} events/s "
          f"(per-chunk run: {want_rate:.1f}), peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; windows {counts['windows']}, graph "
          f"captures {counts['captures']}, replays {counts['replays']}, "
          f"in-window events {box[0]._runner.in_window_events}, "
          f"escalations "
          f"{tel.escalations}, replans {tel.replans}")
    # The plain versions through the same window, captured and replayed on
    # the card like the kernels (their survivor selection is capture-safe),
    # over the stream's first WINDOW_REF_CHUNKS chunks, against the kernel
    # window over the same chunks.
    part, _, _ = run_main("cuda", plan=plan, superchunk=SUPERCHUNK,
                          n_chunks=WINDOW_REF_CHUNKS)
    kops.reset_launch_counts()
    scan.reset_counts()
    ref_tel, ref_secs, _ = run_main("cuda", plan=plan, backend="ref",
                                    superchunk=SUPERCHUNK,
                                    n_chunks=WINDOW_REF_CHUNKS)
    check_plain_window(f"superchunk {plan}")
    same_telemetry(ref_tel, part, f"superchunk {plan}: plain window vs "
                   "kernel window")
    print(f"   plain-version window rerun (backend='ref', S={SUPERCHUNK}) on "
          f"the card over the first {WINDOW_REF_CHUNKS} chunks: equal "
          f"integer telemetry to the kernel window over them "
          f"({ref_secs:.3f} s, graph replays {scan.COUNTS['replays']})")
    return launches


def check_plain_window(what):
    """A ``backend="ref"`` window run launched no kernel and ran as graph
    replays (no eager CUDA window exists)."""
    from repro_torch.core import scan
    from repro_torch.kernels import ops as kops

    if any(kops.LAUNCHES.values()) or any(kops.GRAPH_LAUNCHES.values()):
        raise AssertionError(f"{what}: backend='ref' launched a kernel")
    if scan.COUNTS["replays"] <= 0 or scan.COUNTS["eager_steps"] != 0:
        raise AssertionError(f"{what}: plain window counts "
                             f"{dict(scan.COUNTS)}")


def serving_chunks():
    """The 64 stacked chunks of the K=16 stream and their event count."""
    import numpy as np

    from repro_torch.core.fleet import stacked_streams

    chunks = list(stacked_streams(streams(K_MAIN, CHUNKS_MAIN, BASE_RATE,
                                          CHUNK_CAP)))
    return chunks, int(sum(np.asarray(fc.chunk.valid).sum()
                           for fc in chunks))


def check_serving():
    """A monitored K=16 order session driven by ``step``, a second one by
    ``step_superchunk`` (S=8) and a third by ``step_superchunk`` with the
    plain versions, over the same 64 chunks; returns the launch counts of
    the first two runs."""
    from repro_torch.core import scan
    from repro_torch.kernels import ops as kops

    chunks, n_events = serving_chunks()
    out, tels, secs = {}, {}, {}
    for superchunk in (1, SUPERCHUNK):
        kops.reset_launch_counts()
        scan.reset_counts()
        seg_secs, out[superchunk], tels[superchunk], front = bench_run(
            "serving", superchunk, chunks)
        secs[superchunk] = sum(seg_secs)
        if superchunk == 1:
            step_launches = dict(kops.LAUNCHES)
            for name in PATH_KERNELS["order"]:
                if step_launches[name] <= 0:
                    raise AssertionError(f"serving step never launched "
                                         f"{name}")
    launches = window_launches("serving", PATH_KERNELS["order"])
    counts = dict(scan.COUNTS)
    a, b = tels[1], tels[SUPERCHUNK]
    if out[1].tolist() != out[SUPERCHUNK].tolist():
        raise AssertionError("step_superchunk per-chunk matches != step's")
    for f in ("matches", "violations", "replans", "host_syncs", "overflow"):
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"serving {f}: step {getattr(a, f)} != "
                                 f"step_superchunk {getattr(b, f)}")
    if counts["replays"] <= 0 or counts["eager_steps"] != 0:
        raise AssertionError(f"serving window counts {counts}")
    kops.reset_launch_counts()
    scan.reset_counts()
    _, ref_out, ref_tel, _ = bench_run("serving", SUPERCHUNK, chunks,
                                       backend="ref")
    check_plain_window("serving")
    if ref_out.tolist() != out[SUPERCHUNK].tolist():
        raise AssertionError("plain step_superchunk per-chunk matches != "
                             "the kernel window's")
    for f in ("matches", "violations", "replans", "host_syncs", "overflow"):
        if getattr(ref_tel, f) != getattr(b, f):
            raise AssertionError(f"serving {f}: plain window "
                                 f"{getattr(ref_tel, f)} != kernel window "
                                 f"{getattr(b, f)}")
    print(f"   step: {n_events / secs[1]:.1f} events/s; step_superchunk "
          f"(S={SUPERCHUNK}): {n_events / secs[SUPERCHUNK]:.1f} events/s; "
          f"equal per-chunk matches (total {b.matches}), violations "
          f"{b.violations}, replans {b.replans}, host syncs "
          f"{b.host_syncs}; graph replays {counts['replays']}, in-window "
          f"events {front.in_window_events}; the plain-version window "
          f"(backend='ref') equal")
    return step_launches, launches


# ---------------------------------------------------------------------------
# The rulebook
# ---------------------------------------------------------------------------


RULE_FIELDS = ("pm_created", "overflow", "neg_rejected",
               "closure_expansions", "replans", "deployments", "violations",
               "chunks")


def rulebook_counters(rb):
    """Per rule: the (K,) matches and every counter of ``RULE_FIELDS``."""
    return [(e.matches.tolist(), tuple(getattr(e, f) for f in RULE_FIELDS))
            for e in rb._rules]


def run_rulebook(chunks, backend=None, superchunk=1, k=None, caps=None,
                 mesh=None):
    """The FlowSense rulebook through ``open_rulebook(...).run`` over the
    stacked ``chunks`` (K = ``k``, default K_MAIN; ``caps`` = (buffer,
    match, chunk) capacities, default the main path's; K split over
    ``mesh`` if given); returns the book, the wall seconds and the peak
    device memory (bytes)."""
    import torch

    from repro_torch.cep import RuntimeConfig, open_rulebook

    b_cap, m_cap, cap = caps or (B_CAP, M_CAP, CHUNK_CAP)
    rb = open_rulebook(flowsense_rulebook(), partitions=k or K_MAIN,
                       monitor=True,
                       config=RuntimeConfig(
                           buffer_capacity=b_cap, match_capacity=m_cap,
                           chunk_capacity=cap, device="cuda",
                           backend=backend, superchunk=superchunk,
                           mesh=mesh),
                       spare_slots=RULEBOOK_SPARE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rb.run(chunks)
    torch.cuda.synchronize()
    return rb, time.perf_counter() - t, torch.cuda.max_memory_allocated()


def solo_matches(rule, chunks):
    """A monitored K=16 order session stepped over ``chunks`` (the
    rulebook's immediate-deployment semantics): (K,) matches and the
    session's telemetry."""
    import numpy as np

    from repro_torch import cep

    sess = cep.open(rule, partitions=K_MAIN, plan="order", monitor=True,
                    config=path_config("order", buffer_capacity=B_CAP,
                                       match_capacity=M_CAP,
                                       chunk_capacity=CHUNK_CAP,
                                       device="cuda"))
    total = np.zeros(K_MAIN, np.int64)
    for fc in chunks:
        total += sess.step(fc.chunk, fc.t0, fc.t1)
    return total, sess.telemetry()


def check_rulebook():
    """The FlowSense rulebook at full width: the per-chunk kernel run
    (launches counted), zero overflow, three solo sessions, the plain
    rerun, the superchunk window and a hot add; returns the launch counts
    of the per-chunk and window runs, and the per-rule counters."""
    from repro_torch.core import scan
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import window_join

    chunks, n_events = serving_chunks()
    kops.reset_launch_counts()
    rb, secs, peak = run_rulebook(chunks)
    launches = dict(kops.LAUNCHES)
    for name in PATH_KERNELS["order"]:
        if launches[name] <= 0:
            raise AssertionError(f"rulebook never launched {name}")
    tel = rb.telemetry()
    if tel.overflow != 0:
        raise AssertionError(f"rulebook overflow {tel.overflow} at "
                             f"match_capacity={M_CAP}: the comparisons below "
                             "are exact only without truncation")
    print(f"   rulebook: {len(rb.rules)} rules in {rb.n_buckets} buckets, "
          f"K={K_MAIN}, b_cap={B_CAP}, m_cap={M_CAP}, spare slots "
          f"{RULEBOOK_SPARE}: {n_events} events in {secs:.3f} s = "
          f"{n_events / secs:.1f} events/s, peak device memory "
          f"{peak / 2 ** 30:.3f} GiB")
    for rid in rb.rules:
        t = rb.telemetry(rid)
        print(f"   rule {rid}: matches {t.matches}, neg_rejected "
              f"{t.neg_rejected}, overflow {t.overflow}, replans "
              f"{t.replans}, pm_created {rb._rules[rid].pm_created}")
    print(f"   host syncs {tel.host_syncs}; kernel launches: {launches}")
    want = rulebook_counters(rb)

    for rid, rule in enumerate(flowsense_rulebook()):
        total, stel = solo_matches(rule, chunks)
        if total.tolist() != rb.match_counts[rid].tolist() or \
                stel.neg_rejected != rb.telemetry(rid).neg_rejected or \
                stel.overflow != 0:
            raise AssertionError(f"rule {rid} != its solo session")
    print("   per-rule matches and negation vetoes equal three solo "
          "sessions (Session.step), zero overflow")

    kops.reset_launch_counts()
    ref_rb, ref_secs, ref_peak = run_rulebook(chunks, backend="ref")
    if any(kops.LAUNCHES.values()):
        raise AssertionError("rulebook backend='ref' launched a kernel")
    if rulebook_counters(ref_rb) != want:
        raise AssertionError("rulebook: plain-version counters differ")
    print(f"   plain-version rerun: equal per-rule counters ({ref_secs:.3f} "
          f"s, peak device memory {ref_peak / 2 ** 30:.3f} GiB)")

    kops.reset_launch_counts()
    scan.reset_counts()
    win, wsecs, wpeak = run_rulebook(chunks, superchunk=SUPERCHUNK)
    w_launches = window_launches("rulebook window", PATH_KERNELS["order"])
    counts = dict(scan.COUNTS)
    if rulebook_counters(win) != want:
        raise AssertionError("rulebook: superchunk counters differ")
    if counts["replays"] <= 0 or counts["eager_steps"] != 0:
        raise AssertionError(f"rulebook window counts {counts}")
    print(f"   superchunk={SUPERCHUNK}: equal per-rule counters; "
          f"{n_events / wsecs:.1f} events/s (per chunk {n_events / secs:.1f}"
          f"), peak device memory {wpeak / 2 ** 30:.3f} GiB; windows "
          f"{counts['windows']}, graph captures {counts['captures']} "
          f"(trace_count {win.trace_count()}), replays {counts['replays']}, "
          f"in-window events {win.in_window_events}, host syncs "
          f"{win.telemetry().host_syncs}")

    # Hot add into a spare slot mid-stream: row writes only.
    scan.reset_counts()
    hot, _, _ = run_rulebook(chunks[:HOT_ADD_AT], superchunk=SUPERCHUNK)
    lib, so = window_join._lib, window_join.library_path()
    built = sorted(os.listdir(window_join.BUILD_DIR))
    before = (hot.trace_count(), scan.COUNTS["captures"])
    rid = hot.add_rule(hot_added_rule())
    hot.run(chunks[HOT_ADD_AT:])
    after = (hot.trace_count(), scan.COUNTS["captures"])
    if after != before:
        raise AssertionError(f"hot add captured: {before} -> {after}")
    if window_join._lib is not lib or window_join.library_path() != so or \
            sorted(os.listdir(window_join.BUILD_DIR)) != built:
        raise AssertionError("hot add rebuilt or reloaded the kernels")
    total, _ = solo_matches(hot_added_rule(), chunks[HOT_ADD_AT:])
    if total.tolist() != hot.match_counts[rid].tolist():
        raise AssertionError("hot-added rule != its solo session")
    if hot.match_counts[:3].tolist() != rb.match_counts.tolist() or \
            hot.telemetry().overflow != 0:
        raise AssertionError("hot add disturbed the other rules")
    print(f"   hot add of rule {rid} after {HOT_ADD_AT} chunks (window "
          f"run): no kernel build, no graph capture (trace_count "
          f"{after[0]}, captures {after[1]}); equals its solo session "
          f"({int(total.sum())} matches); rules 0-2 undisturbed")
    return launches, w_launches, want


def check_rulebook_oracle():
    """A narrow K=4 rulebook on the card against the brute-force oracle,
    per rule and partition."""
    from repro_torch.cep import RefEngine
    from repro_torch.core.fleet import stacked_streams

    k, n_chunks, rate, cap = 4, 24, 12.0, 64
    rb, _, _ = run_rulebook(
        list(stacked_streams(streams(k, n_chunks, rate, cap, seed=100))),
        k=k, caps=(64, 1024, cap))
    for rid, rule in enumerate(flowsense_rulebook()):
        want = [RefEngine(rule.build()).run(s)
                for s in streams(k, n_chunks, rate, cap, seed=100)]
        if rb.match_counts[rid].tolist() != [r.full_matches for r in want]:
            raise AssertionError(f"rulebook oracle mismatch, rule {rid}: "
                                 f"{rb.match_counts[rid].tolist()} vs "
                                 f"{[r.full_matches for r in want]}")
        if rb.telemetry(rid).neg_rejected != sum(r.neg_rejected
                                                 for r in want):
            raise AssertionError(f"rulebook oracle neg_rejected, rule {rid}")
    print(f"   K={k} b_cap=64: per-rule matches {rb.match_counts.tolist()} "
          f"== oracle; replans {rb.telemetry().replans}")


# ---------------------------------------------------------------------------
# The process-wide memo of steps and windows, and the cep device mesh
# ---------------------------------------------------------------------------


def serving_session(superchunk=SUPERCHUNK):
    """A monitored K=16 order session of the main path's config, for the
    serving plane."""
    from repro_torch import cep

    return cep.open(flowsense_rule(), partitions=K_MAIN, plan="order",
                    monitor=True,
                    config=path_config("order", buffer_capacity=B_CAP,
                                       match_capacity=M_CAP,
                                       chunk_capacity=CHUNK_CAP,
                                       device="cuda", superchunk=superchunk))


def serving_window(sess, chunks, lo):
    """One ``step_superchunk`` window of ``sess`` over chunks ``lo`` to
    ``lo + SUPERCHUNK``: its per-chunk matches as a list."""
    seg = chunks[lo:lo + SUPERCHUNK]
    return sess.step_superchunk([fc.chunk for fc in seg],
                                [(fc.t0, fc.t1) for fc in seg]).tolist()


def first_window_seconds(plan, chunks):
    """A fresh K=16 session of ``plan`` with ``superchunk=8`` over the
    stream's first window: its wall seconds (ending in a device sync) and
    its graph captures."""
    import torch

    from repro_torch import cep
    from repro_torch.core import scan

    sess = cep.open(flowsense_rule(), partitions=K_MAIN, plan=plan,
                    monitor=True,
                    config=path_config(plan, buffer_capacity=B_CAP,
                                       match_capacity=M_CAP,
                                       chunk_capacity=CHUNK_CAP,
                                       device="cuda", superchunk=SUPERCHUNK))
    scan.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    sess.run(chunks[:SUPERCHUNK])
    torch.cuda.synchronize()
    return time.perf_counter() - t, scan.COUNTS["captures"]


def memory_line(what):
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    alloc, res = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    print(f"   {what}: allocated {alloc} bytes ({alloc / 2 ** 20:.3f} MiB), "
          f"reserved {res} bytes ({res / 2 ** 20:.3f} MiB)")
    return alloc


def check_trace_memo(per_chunk, rulebook_want):
    """The process-wide memo (``core/fleet.py::_shared_trace``): second
    sessions of phase 8's config and a second rulebook of phase 11's
    capture nothing and equal the first ones; two serving sessions'
    windows in turns equal their solo runs; the memo's memory, and the
    first window's seconds with a fresh memo and with a hit.  Returns the
    launch counts per path."""
    import numpy as np

    from repro_torch.core import fleet, scan
    from repro_torch.core.fleet import stacked_streams
    from repro_torch.kernels import ops as kops

    launches = {}
    for plan in ("order", "tree"):
        kops.reset_launch_counts()
        scan.reset_counts()
        box = []
        tel, secs, _ = run_main("cuda", plan=plan, superchunk=SUPERCHUNK,
                                sessions=box)
        launches[f"trace memo-{plan}"] = window_launches(
            f"trace memo {plan}", PATH_KERNELS[plan])
        counts = dict(scan.COUNTS)
        if counts["captures"] != 0 or counts["replays"] <= 0 or \
                counts["eager_steps"] != 0:
            raise AssertionError(f"second {plan} session: window counts "
                                 f"{counts}")
        same_telemetry(tel, per_chunk[plan][0], f"second {plan} session")
        print(f"   second {plan} session (superchunk={SUPERCHUNK}, phase "
              f"8's config): 0 graph captures, {counts['replays']} replays, "
              f"equal integer telemetry to the per-chunk run (and so to "
              f"phase 8); {tel.events / secs:.1f} events/s; memo entries "
              f"{len(fleet._TRACE_MEMO)}")

    # Two sessions' windows in turns, against their solo runs.
    a_chunks, _ = serving_chunks()
    b_chunks = list(stacked_streams(streams(K_MAIN, CHUNKS_MAIN, BASE_RATE,
                                            CHUNK_CAP, seed=1000)))
    starts = range(0, CHUNKS_MAIN, SUPERCHUNK)
    solo = []
    for c in (a_chunks, b_chunks):
        sess = serving_session()
        solo.append([serving_window(sess, c, lo) for lo in starts])
    kops.reset_launch_counts()
    scan.reset_counts()
    pair = [serving_session(), serving_session()]
    turns = [[], []]
    for lo in starts:
        for j, c in enumerate((a_chunks, b_chunks)):
            turns[j].append(serving_window(pair[j], c, lo))
    launches["trace memo-interleave"] = window_launches(
        "trace memo interleave", PATH_KERNELS["order"])
    shared = (pair[0]._serving.fleet.superchunk_scan(True)
              is pair[1]._serving.fleet.superchunk_scan(True))
    if not shared or scan.COUNTS["captures"] != 0:
        raise AssertionError(f"interleaved sessions: shared window {shared}, "
                             f"captures {scan.COUNTS['captures']}")
    if turns != solo or solo[0] == solo[1]:
        raise AssertionError("interleaved windows differ from solo runs")
    tels = [s.telemetry() for s in pair]
    print(f"   two serving sessions (streams seed 0 and 1000) in turns, "
          f"{len(starts)} windows each: equal per-chunk matches to their "
          f"solo runs (matches {tels[0].matches} and {tels[1].matches}, "
          f"violations {tels[0].violations} and {tels[1].violations}); one "
          f"shared window, 0 captures")

    kops.reset_launch_counts()
    scan.reset_counts()
    rb, secs, _ = run_rulebook(a_chunks, superchunk=SUPERCHUNK)
    launches["trace memo-rulebook"] = window_launches(
        "trace memo rulebook", PATH_KERNELS["order"])
    if scan.COUNTS["captures"] != 0 or rulebook_counters(rb) != rulebook_want:
        raise AssertionError(f"second rulebook: captures "
                             f"{scan.COUNTS['captures']}, counters equal "
                             f"{rulebook_counters(rb) == rulebook_want}")
    print(f"   second FlowSense rulebook (superchunk={SUPERCHUNK}): "
          f"trace_count {rb.trace_count()} (the shared windows' shapes), 0 "
          f"new captures, equal per-rule counters; "
          f"{sum(int(np.asarray(fc.chunk.valid).sum()) for fc in a_chunks) / secs:.1f} "
          f"events/s")
    del rb, pair, sess, box

    n_entries = len(fleet._TRACE_MEMO)
    held = memory_line(f"device memory with the memo's {n_entries} entries "
                       f"and no open session")
    fleet.clear_trace_memo()
    freed = memory_line("after clear_trace_memo()")
    print(f"   the memo held {held - freed} bytes "
          f"({(held - freed) / 2 ** 20:.3f} MiB) of device memory")

    for plan in ("order", "tree"):
        fresh, fresh_caps = first_window_seconds(plan, a_chunks)
        hit, hit_caps = first_window_seconds(plan, a_chunks)
        if fresh_caps <= 0 or hit_caps != 0:
            raise AssertionError(f"{plan} first window: captures "
                                 f"{fresh_caps} fresh, {hit_caps} on a hit")
        print(f"   {plan} first window (a fresh session, {SUPERCHUNK} "
              f"chunks): {fresh:.4f} s with a fresh memo ({fresh_caps} "
              f"captures), {hit:.4f} s on a memo hit (0 captures): "
              f"{fresh_caps} captures and {fresh - hit:.4f} s saved")
    return launches


def check_mesh(per_chunk, rulebook_want):
    """The ``cep`` device mesh at D = 1: the order window and the
    rulebook window with ``mesh=1`` and ``mesh="auto"`` equal the
    unmeshed runs (meshed windows are never shared, so each captures its
    own graphs); ``mesh=2`` raises on a one-GPU host.  Returns the launch
    counts per path."""
    import torch

    from repro_torch import cep
    from repro_torch.core import scan
    from repro_torch.kernels import ops as kops

    launches = {}
    kops.reset_launch_counts()
    for mesh in (1, "auto"):
        scan.reset_counts()
        box = []
        tel, secs, _ = run_main("cuda", plan="order", superchunk=SUPERCHUNK,
                                sessions=box, mesh=mesh)
        d = box[0]._runner.fleet.mesh.shape["cep"]
        same_telemetry(tel, per_chunk["order"][0], f"order mesh={mesh!r}")
        if scan.COUNTS["captures"] <= 0 or scan.COUNTS["eager_steps"]:
            raise AssertionError(f"mesh={mesh!r}: window counts "
                                 f"{dict(scan.COUNTS)}")
        print(f"   order window, mesh={mesh!r} (D={d}): equal integer "
              f"telemetry to the unmeshed runs; {tel.events / secs:.1f} "
              f"events/s, graph captures {scan.COUNTS['captures']}")
    launches["mesh-order"] = window_launches("mesh order",
                                             PATH_KERNELS["order"])
    chunks, _ = serving_chunks()
    kops.reset_launch_counts()
    for mesh in (1, "auto"):
        scan.reset_counts()
        rb, secs, _ = run_rulebook(chunks, superchunk=SUPERCHUNK, mesh=mesh)
        if rulebook_counters(rb) != rulebook_want or rb.mesh is None:
            raise AssertionError(f"rulebook mesh={mesh!r}: counters differ")
        print(f"   rulebook window, mesh={mesh!r}: equal per-rule counters; "
              f"graph captures {scan.COUNTS['captures']}")
    launches["mesh-rulebook"] = window_launches("mesh rulebook",
                                                PATH_KERNELS["order"])
    want = ValueError if torch.cuda.device_count() < 2 else \
        NotImplementedError
    for what, opener in (
            ("cep.open", lambda: cep.open(
                flowsense_rule(), partitions=K_MAIN, plan="order",
                monitor=True, config=path_config("order", device="cuda"),
                mesh=2)),
            ("open_rulebook", lambda: cep.open_rulebook(
                flowsense_rulebook(), partitions=K_MAIN,
                config=path_config("order", device="cuda", mesh=2)))):
        try:
            opener()
        except want as e:
            print(f"   {what}(mesh=2) on {torch.cuda.device_count()} GPU(s) "
                  f"raises {type(e).__name__}: {e}")
        else:
            raise AssertionError(f"{what}(mesh=2) did not raise")
    return launches


# ---------------------------------------------------------------------------
# The single-stream adaptive loop (paper Algorithm 1) and the scenario suite
# ---------------------------------------------------------------------------


def build_pattern(set_name, size, window=4.0, theta=-0.3):
    """The paper's five pattern sets (§5.1) by size, as
    benchmarks/common.py::build_pattern builds them, from the port's
    pattern constructors."""
    from repro_torch.core.patterns import (PRED_LT, CompositePattern,
                                           Predicate, and_pattern,
                                           chain_predicates, kleene_pattern,
                                           neg_pattern, seq_pattern)

    ids = list(range(size))
    preds = chain_predicates(ids, theta=theta)
    if set_name == "seq":
        return seq_pattern(ids, window, preds)
    if set_name == "conj":
        return and_pattern(ids, window, preds)
    if set_name == "neg":
        # negated event = extra type `size`, absence between pos 0 and 1
        return neg_pattern(
            ids, window, negated_type=size, negated_pos=1,
            predicates=preds,
            negated_predicates=(Predicate(size, 0, PRED_LT, 0, 0, 0.0),))
    if set_name == "kleene":
        return kleene_pattern(ids, window, kleene_pos=size // 2,
                              predicates=preds)
    if set_name == "composite":
        # disjunction of three independent sequences of `size` events
        return CompositePattern(tuple(
            seq_pattern(list(range(b * size, (b + 1) * size)), window,
                        chain_predicates(
                            list(range(b * size, (b + 1) * size)),
                            theta=theta))
            for b in range(3)))
    raise ValueError(set_name)


def stream_types(set_name, size):
    return {"neg": size + 1, "composite": 3 * size}.get(set_name, size)


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def adaptive_streams(set_name, size, n_chunks, take=None):
    """The traffic stream(s) of one §5 run, one per branch (seed 3, then
    3 + branch), truncated to the first ``take`` chunks if given (the same
    stream, since the regime shifts follow ``n_chunks``)."""
    import itertools

    from repro_torch.data.cep_streams import StreamConfig, make_stream

    cfg = StreamConfig(
        n_types=stream_types(set_name, size), n_attrs=1, n_chunks=n_chunks,
        chunk_cap=CHUNK_CAP, base_rate=15.0, seed=3,
        # ~4 regime shifts per run regardless of run length
        shift_every=max(n_chunks / 4.0, 10.0))
    n_branches = 3 if set_name == "composite" else 1
    return [itertools.islice(
        make_stream("traffic", dataclasses.replace(cfg, seed=3 + b)), take)
        for b in range(n_branches)]


def adaptive_run(set_name, size, planner, policy, n_chunks=ADAPT_CHUNKS,
                 device="cuda", backend=None, take=None):
    """One run of benchmarks/common.py::run_one on the port: an
    ``AdaptiveRunner`` per branch (``merge_metrics`` over the composite's
    three); returns the metrics, the wall seconds (ending in a device
    sync) and the match capacities the runs built engines for."""
    from repro_torch.core import AdaptiveRunner, EngineConfig, make_policy
    from repro_torch.core.adaptation import merge_metrics
    from repro_torch.core.patterns import CompositePattern

    pat = build_pattern(set_name, size)
    branches = (pat.branches if isinstance(pat, CompositePattern)
                else (pat,))
    ecfg = EngineConfig(b_cap=ADAPT_B_CAP, m_cap=ADAPT_M_CAP, device=device,
                        backend=backend)
    streams_ = adaptive_streams(set_name, size, n_chunks, take)
    ms, caps = [], set()
    sync(device)
    t = time.perf_counter()
    for branch, stream in zip(branches, streams_):
        runner = AdaptiveRunner(
            branch, planner=planner,
            policy=make_policy(policy, **ADAPT_POLICIES[policy]),
            engine_cfg=ecfg, adaptive_caps=True, cap_bounds=ADAPT_CAP_BOUNDS)
        ms.append(runner.run(stream))
        caps |= set(runner._engines)
    sync(device)
    return merge_metrics(ms), time.perf_counter() - t, sorted(caps)


def same_run_metrics(got, want, what):
    for f in RUN_FIELDS:
        if getattr(got, f) != getattr(want, f):
            raise AssertionError(f"{what}: {f} {getattr(got, f)} != "
                                 f"{getattr(want, f)}")


def check_adaptive(planner, device="cuda", size=ADAPT_SIZE,
                   n_chunks=ADAPT_CHUNKS):
    """Every pattern set under the four policies with one planner, the
    launch counters zeroed just before and read just after; gates: equal
    matches across the policies of each set, no overflow left after
    escalation, no false positive of the invariant policy at d=0, and the
    plain-version rerun of (seq, invariant) with equal integer metrics.
    Returns the launch counts."""
    from repro_torch.kernels import ops as kops

    kops.reset_launch_counts()
    runs = {}
    for set_name in ADAPT_SETS:
        for policy in ADAPT_POLICIES:
            m, wall, caps = adaptive_run(set_name, size, planner, policy,
                                         n_chunks, device)
            runs[set_name, policy] = m, wall
            print(f"   {planner} {set_name}-{size} {policy}: {m.events} "
                  f"events in {wall:.3f} s = {m.events / wall:.1f} events/s;"
                  f" matches {m.full_matches}, pm_created {m.pm_created}, "
                  f"replans {m.replans}, deployments {m.deployments}, "
                  f"false positives {m.false_positives}, migration chunks "
                  f"{m.migration_chunks}, caps {caps}, adaptation overhead "
                  f"{m.adaptation_overhead:.4f}", flush=True)
    launches = dict(kops.LAUNCHES)
    if device == "cuda":
        for name in ADAPT_KERNELS[planner]:
            if launches[name] <= 0:
                raise AssertionError(f"adaptive {planner} never launched "
                                     f"{name}")
    for set_name in ADAPT_SETS:
        got = {p: runs[set_name, p][0] for p in ADAPT_POLICIES}
        matches = [m.full_matches for m in got.values()]
        if len(set(matches)) != 1:
            raise AssertionError(f"{planner} {set_name}: matches depend on "
                                 f"the policy: {matches}")
        if any(m.overflow for m in got.values()):
            raise AssertionError(f"{planner} {set_name}: overflow left "
                                 "after escalation")
        if got["invariant"].false_positives != 0:
            raise AssertionError(f"{planner} {set_name}: invariant policy "
                                 "at d=0 made a false positive")
    print(f"   {planner}: matches equal across the four policies of each "
          f"set, zero overflow, zero false positives at d=0; launches "
          f"{launches}")

    # the plain versions on the card, on (seq, invariant)
    kops.reset_launch_counts()
    ref, ref_wall, ref_caps = adaptive_run(
        "seq", size, planner, "invariant", n_chunks, device, backend="ref")
    if any(kops.LAUNCHES.values()):
        raise AssertionError("adaptive backend='ref' launched a kernel")
    same_run_metrics(ref, runs["seq", "invariant"][0],
                     f"adaptive {planner}: kernels vs plain")
    print(f"   plain-version rerun of seq-{size} invariant over "
          f"{ref.chunks} chunks on the card: equal integer metrics "
          f"({ref_wall:.3f} s, caps {ref_caps})")
    return launches


def check_adaptive_oracle(device="cuda", size=ORACLE_SIZE,
                          n_chunks=ORACLE_CHUNKS):
    """Each pattern set at a narrow size through the loop (invariant
    policy, both planners) against the brute-force oracle on the same
    stream(s)."""
    from repro_torch.core.patterns import CompositePattern
    from repro_torch.core.ref_engine import RefEngine

    for set_name in ADAPT_SETS:
        pat = build_pattern(set_name, size)
        branches = (pat.branches if isinstance(pat, CompositePattern)
                    else (pat,))
        want = sum(RefEngine(b).run(s).full_matches for b, s in zip(
            branches, adaptive_streams(set_name, size, n_chunks)))
        got = []
        for planner in ("greedy", "zstream"):
            m, _, _ = adaptive_run(set_name, size, planner, "invariant",
                                   n_chunks, device)
            if m.full_matches != want or m.overflow:
                raise AssertionError(
                    f"adaptive oracle {planner} {set_name}-{size}: "
                    f"{m.full_matches} matches (overflow {m.overflow}) vs "
                    f"oracle {want}")
            got.append(m.replans)
        print(f"   {set_name}-{size} over {n_chunks} chunks: greedy and "
              f"zstream matches == oracle {want} (replans {got})")


def profile_adaptive(planner, n_chunks=16, top=8):
    """The first chunks of one §5 run (seq, size 8, invariant policy)
    under ``torch.profiler``: the single-stream loop's device-busy share
    and its largest device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        m, wall, _ = adaptive_run("seq", ADAPT_SIZE, planner, "invariant",
                                  take=n_chunks)
    print(f"   {planner}: D+A share of the run "
          f"{m.adaptation_overhead:.4f}")
    report_profile(prof, wall, n_chunks, f"adaptive {planner}", top,
                   forbid_scans=False)


def check_monitored_engine(device="cuda"):
    """``MonitoredEngine`` (K = 1) on the stocks stream of
    tests/test_monitor.py::test_monitored_single_stream_engine, order and
    tree plans, replanning on each flag: the fused flag equals the host
    float32 mirror of the lowered set every chunk (and the float64 host
    policy but on an exact tie), and flags fire."""
    import numpy as np

    from repro_torch.core.compat import legacy_ok
    from repro_torch.core.decision import InvariantPolicy
    from repro_torch.core.engine import EngineConfig, MonitoredEngine
    from repro_torch.core.greedy import greedy_order_plan
    from repro_torch.core.invariants import check_lowered_np
    from repro_torch.core.patterns import chain_predicates, seq_pattern
    from repro_torch.core.stats import Stat, uniform_stat
    from repro_torch.core.zstream import zstream_tree_plan
    from repro_torch.data.cep_streams import StreamConfig, make_stream

    pat = seq_pattern([0, 1, 2], 4.0, chain_predicates([0, 1, 2],
                                                       theta=-0.3))
    for kind, planner, caps in (("order", greedy_order_plan, ()),
                                ("tree", zstream_tree_plan, (8, 16))):
        with legacy_ok():
            eng = MonitoredEngine(kind, pat, EngineConfig(
                b_cap=64, m_cap=512, device=device))
        state, mon = eng.init_state(), eng.init_monitor()
        stat0 = uniform_stat(pat.n)
        plan, dcs = planner(pat, stat0)
        pol = InvariantPolicy(k=1, d=0.0)
        pol.on_replan(plan, dcs, stat0)
        low = pol.compile(pat.n, *caps)
        caps = caps or (low.active.shape[0], low.scale.shape[-1])
        fired = matches = 0
        for rec in make_stream("stocks", StreamConfig(
                n_types=3, n_chunks=15, chunk_cap=128, base_rate=8.0,
                seed=3)):
            state, mon, res, violated, drift, rates, sel = \
                eng.process_chunk(state, mon, rec.chunk, eng.plan_row(plan),
                                  low, rec.t0, rec.t1)
            rates, sel = rates.cpu().numpy(), sel.cpu().numpy()
            synced = Stat(rates.astype(np.float64), sel.astype(np.float64))
            v_np, drift_np = check_lowered_np(low, rates, sel)
            flag = bool(violated)
            if flag != bool(v_np) or not (pol.should_reoptimize(synced)
                                          == flag or abs(drift_np) < 1e-5):
                raise AssertionError(f"monitored engine {kind}: flag "
                                     f"{flag} vs host {bool(v_np)}")
            matches += int(res.full_matches)
            if flag:
                fired += 1
                plan, dcs = planner(pat, synced)
                pol.on_replan(plan, dcs, synced)
                low = pol.compile(pat.n, *caps)
        if fired == 0:
            raise AssertionError(f"monitored engine {kind}: no flag fired")
        print(f"   {kind}: 15 chunks, flags == host mirror every chunk, "
              f"{fired} flags fired and replanned, {matches} matches")


def scenario_session(sc, config, device="cuda"):
    """A fresh session for one runtime configuration of the replay
    (benchmarks/replay_bench.py::_session): the monitored invariant
    policy (per chunk, or 8-chunk windows), the pinned cold plan with
    escalation ("static"), or without ("pinned")."""
    from repro_torch import cep
    from repro_torch.cep import RuntimeConfig

    rt = dict(sc.runtime, device=device)
    monitor, superchunk = False, 1
    if config.startswith("adaptive"):
        monitor = True
        rt["escalate_on_overflow"] = True
        superchunk = SUPERCHUNK if config == "adaptive_s8" else 1
    else:
        rt["policy"] = None
        rt.pop("policy_kw", None)
        rt["escalate_on_overflow"] = config != "pinned"
    return cep.open(sc.pattern, partitions=sc.partitions, monitor=monitor,
                    superchunk=superchunk, config=RuntimeConfig(**rt))


def replay(sc, segs, config, device="cuda"):
    """Segment by segment through one resumable session: per segment
    (segment, wall seconds, telemetry)."""
    sess = scenario_session(sc, config, device)
    rows = []
    for i, (seg, parts) in enumerate(segs):
        sync(device)
        t = time.perf_counter()
        tel = sess.run(parts, resume=i > 0)
        sync(device)
        rows.append((seg, time.perf_counter() - t, tel))
    return rows


def window_peak(sc):
    """The most events of one type inside one pattern window, over every
    partition's stream: what the per-type ring buffers must hold for no
    event of a live window to be overwritten."""
    import numpy as np

    w = sc.pattern.build().window
    peak = 0
    for p in range(sc.partitions):
        recs = list(sc.stream(p))
        ts = np.concatenate([r.chunk.ts[r.chunk.valid] for r in recs])
        tid = np.concatenate([r.chunk.type_id[r.chunk.valid] for r in recs])
        for t in np.unique(tid):
            x = np.sort(ts[tid == t])
            end = np.searchsorted(x, x + w, side="right")
            peak = max(peak, int((end - np.arange(len(x))).max()))
    return peak


def check_scenario_oracle(sc, got, want, device="cuda"):
    """The whole run's per-partition matches against the oracle's.  Equal
    when the scenario's ring buffers hold a window of every type; when
    they do not, a buffer overwrites live events (in the JAX package as
    here), so the run may count fewer (never more), and a rerun with the
    buffers raised to the next power of two above the window peak must
    equal the oracle.  Returns what was checked, for the printout."""
    from repro_torch import cep
    from repro_torch.cep import RuntimeConfig

    peak, b_cap = window_peak(sc), sc.runtime["buffer_capacity"]
    if peak <= b_cap:
        if got != want:
            raise AssertionError(f"{sc.name}: per-partition matches {got} "
                                 f"!= oracle {want}")
        return f"matches {want} == oracle"
    if any(g > w for g, w in zip(got, want)):
        raise AssertionError(f"{sc.name}: matches {got} exceed the oracle's "
                             f"{want}")
    b = 1 << (peak - 1).bit_length()
    rt = dict(sc.runtime, buffer_capacity=b, device=device,
              match_capacity=max(b, sc.runtime["match_capacity"]))
    tel = cep.open(sc.pattern, partitions=sc.partitions, monitor=True,
                   config=RuntimeConfig(**rt)).run(sc.streams())
    if tel.per_partition_matches.tolist() != want:
        raise AssertionError(f"{sc.name}: buffer_capacity={b} matches "
                             f"{tel.per_partition_matches.tolist()} != "
                             f"oracle {want}")
    return (f"matches {got} <= oracle {want} (a window holds up to {peak} "
            f"events of one type, buffer_capacity={b_cap}); with "
            f"buffer_capacity={b}: matches == oracle")


def check_scenarios(device="cuda", names=None):
    """Each bundled scenario at its own partitions over its full length,
    under the four replay configurations, with the semantic gates of
    benchmarks/replay_bench.py:146-167 (zero replans and violations on
    the control segment, per chunk and in windows; adaptive and static
    matches equal per segment; drift deployments at least the scenario's
    expected minimum; the pinned baseline loses matches) and the whole
    run against the oracle per partition; then the FlowSense rulebook's
    control gate and oracle (tests/test_scenarios.py:126-152)."""
    import numpy as np

    from repro_torch.cep import RuntimeConfig, open_rulebook
    from repro_torch.core.ref_engine import RefEngine
    from repro_torch.data import scenarios
    from repro_torch.data.scenarios import flowsense

    for name in names or scenarios.names():
        sc = scenarios.get(name)
        segs = sc.segment_streams()
        runs = {c: replay(sc, segs, c, device) for c in SCENARIO_CONFIGS}

        def by_gate(config, gate):
            return [r for r in runs[config] if r[0].gate == gate]

        for config in ("adaptive", "adaptive_s8"):
            for seg, _, t in by_gate(config, "control"):
                if t.replans or t.violations:
                    raise AssertionError(
                        f"{name} {config} control segment {seg.name}: "
                        f"replans {t.replans}, violations {t.violations}")
        for (seg, _, ta), (_, _, ts) in zip(runs["adaptive"],
                                            runs["static"]):
            if ta.matches != ts.matches:
                raise AssertionError(f"{name} {seg.name}: adaptive "
                                     f"{ta.matches} != static {ts.matches}")
        deployments = sum(t.deployments for _, _, t in
                          by_gate("adaptive", "drift"))
        want_dep = int(sc.expected.get("min_drift_deployments", 1))
        if deployments < want_dep:
            raise AssertionError(f"{name}: {deployments} drift deployments "
                                 f"< {want_dep}")
        m_static = sum(t.matches for _, _, t in by_gate("static", "drift"))
        m_pinned = sum(t.matches for _, _, t in by_gate("pinned", "drift"))
        if not m_pinned < m_static:
            raise AssertionError(f"{name}: pinned {m_pinned} does not lose "
                                 f"matches against static {m_static}")
        got = sum(t.per_partition_matches for _, _, t in runs["adaptive"])
        want = [RefEngine(sc.pattern.build()).run(sc.stream(p)).full_matches
                for p in range(sc.partitions)]
        oracle = check_scenario_oracle(sc, got.tolist(), want, device)
        rates = ", ".join(
            f"{seg.name} adaptive {ta.events / wa:.1f} vs static "
            f"{ts.events / ws:.1f}"
            for (seg, wa, ta), (_, ws, ts) in zip(
                by_gate("adaptive", "drift"), by_gate("static", "drift")))
        print(f"   {name} K={sc.partitions}, {sc.n_chunks} chunks, "
              f"{sum(t.events for _, _, t in runs['adaptive'])} events: "
              f"control silent (per chunk and S={SUPERCHUNK}), adaptive == "
              f"static per segment, drift deployments {deployments} >= "
              f"{want_dep}, pinned drift recall "
              f"{m_pinned / max(1, m_static):.4f}, {oracle}; events/s per "
              f"drift segment (host clock): {rates}",
              flush=True)

    sc = scenarios.get("flowsense")
    rules = flowsense.rulebook_patterns()
    k = sc.partitions
    warm = sc.segments[0].n_chunks
    chunks = [list(sc.stream(p, chunks=warm + 4)) for p in range(k)]
    rb = open_rulebook(rules, partitions=k, monitor=True,
                       config=RuntimeConfig(**sc.runtime, device=device,
                                            escalate_on_overflow=True))
    rb.run([c[:warm] for c in chunks])
    control = rb.run([c[warm:] for c in chunks])
    if control.replans != 0 or rb.telemetry().overflow != 0:
        raise AssertionError(f"flowsense rulebook: control replans "
                             f"{control.replans}, overflow "
                             f"{rb.telemetry().overflow}")
    for i, r in enumerate(rules):
        want = np.array([RefEngine(r.build()).run(chunks[p]).full_matches
                         for p in range(k)], np.int64)
        if not np.array_equal(rb.match_counts[i], want):
            raise AssertionError(f"flowsense rulebook rule {i}: "
                                 f"{rb.match_counts[i]} != oracle {want}")
    print(f"   flowsense 3-rule rulebook, K={k}: control segment silent, "
          f"zero overflow, per-rule matches == oracle "
          f"{rb.match_counts.tolist()}")


# ---------------------------------------------------------------------------
# The LM forward and serving path
# ---------------------------------------------------------------------------


def lm_bound(want):
    """The logit gate: ``LM_TOL`` of ``want``'s largest magnitude (f32 on
    both sides, different reduction orders)."""
    return LM_TOL * float(want.float().abs().max())


def lm_gate(got, want, what):
    """Fails unless max |got - want| is within ``lm_bound(want)``; returns
    max |got - want| / max |want|."""
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    bound = lm_bound(want)
    if not err <= bound:
        raise AssertionError(f"{what}: max |diff| {err} > {bound}")
    return err * LM_TOL / bound


def greedy_agrees(logits, want_logits, what):
    """The greedy tokens of ``logits`` equal ``want_logits``'s wherever the
    latter's top-2 margin exceeds twice ``lm_bound``; returns (checked,
    rows)."""
    bound = lm_bound(want_logits)
    want = want_logits.float().cpu().reshape(-1, want_logits.shape[-1])
    got = logits.float().cpu().reshape(-1, logits.shape[-1])
    top2 = want.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * bound
    if not bool((got.argmax(-1) == want.argmax(-1))[sure].all()):
        raise AssertionError(f"{what}: greedy tokens differ where the "
                             f"margin exceeds {2 * bound}")
    return int(sure.sum()), int(sure.numel())


def recording_engine():
    """``ServingEngine`` that times its calls (each ends in a host read of
    its result, so the host clock covers the device work) and keeps, per
    slot, the logits every prefill and decode step produced for it."""
    import numpy as np

    from repro_torch.serving import ServingEngine

    class RecordingEngine(ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.open, self.closed = {}, []
            self.prefill_s, self.prefill_tokens, self.prefills = 0.0, 0, 0
            self.decode_s = []

        def prefill_one(self, tokens, slot):
            t = time.perf_counter()
            tok = super().prefill_one(tokens, slot)
            self.prefill_s += time.perf_counter() - t
            self.prefill_tokens += len(tokens)
            self.prefills += 1
            self.open[slot] = (np.array(tokens), [self.last_logits.clone()])
            return tok

        def decode(self, tokens):
            t = time.perf_counter()
            nxt = super().decode(tokens)
            self.decode_s.append(time.perf_counter() - t)
            for slot, (_, logits) in self.open.items():
                logits.append(self.last_logits[slot].clone())
            return nxt

        def reset_slot(self, slot):
            super().reset_slot(slot)
            self.closed.append(self.open.pop(slot))

    return RecordingEngine


def profile_lm_decode(eng, arch, top=6):
    """``LM_PROFILE_STEPS`` decode steps of a served engine (all slots
    idle, after a warm step) under ``torch.profiler``: the top-level
    torch ops per step (the host's dispatch work), device-busy share and
    the largest device ops."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    tokens = np.zeros(eng.batch_slots, np.int32)
    eng.decode(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t = time.perf_counter()
        for _ in range(LM_PROFILE_STEPS):
            eng.decode(tokens)
        wall = time.perf_counter() - t
    ops = sum(1 for e in prof.events() if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    print(f"   {arch}: {ops / LM_PROFILE_STEPS:.1f} top-level torch ops per "
          f"decode step")
    report_profile(prof, wall, LM_PROFILE_STEPS, f"{arch} decode", top,
                   forbid_scans=False, unit="steps")


def forced_forward(model, prompt, tokens):
    """The forward's logits over ``prompt`` then ``tokens[:-1]`` at the
    positions that predicted ``tokens`` (teacher forcing)."""
    import numpy as np
    import torch

    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
    chunk = model.cfg.ssm_chunk
    if model.cfg.family in ("ssm", "hybrid") and len(seq) > chunk:
        # The chunked scan takes whole chunks; the model is causal, so
        # padding at the end leaves the earlier positions' logits alone.
        seq = np.pad(seq, (0, (-len(seq)) % chunk))
    with torch.no_grad():
        logits, _ = model.forward({"tokens": seq[None]})
    return logits[0, len(prompt) - 1:len(prompt) - 1 + len(tokens)]


def check_lm_serving(smi):
    """``repro_torch.launch.serve.main`` at full size on the card, per arch
    of ``LM_SERVE_ARCHS``: every request completes with ``LM_MAX_NEW``
    tokens, each the argmax of the finite logits its engine call produced;
    prints prefill tokens/s, decode ms per step, decode tokens/s and peak
    memory.  For two requests it prints how far a teacher-forced forward
    on the card is from the served logits, beside how far the same forward
    on the CPU is from the card's: at full depth the reference's random
    init leaves olmo's f32 forward ill-conditioned (PERF.md), so these are
    measurements; the gated consistency checks run at two layers in
    ``check_lm_families``."""
    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import Model

    engine_cls = recording_engine()
    for arch in LM_SERVE_ARCHS:
        argv = ["--arch", arch, "--requests", str(LM_REQUESTS),
                "--slots", str(LM_SLOTS)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        saved = serve.ServingEngine
        serve.ServingEngine = engine_cls
        try:
            t = time.perf_counter()
            sched = serve.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            serve.ServingEngine = saved
        peak = torch.cuda.max_memory_allocated()
        eng = sched.engine
        if len(sched.completed) != LM_REQUESTS or any(
                len(r.out) != LM_MAX_NEW for r in sched.completed):
            raise AssertionError(f"{arch}: {len(sched.completed)} of "
                                 f"{LM_REQUESTS} requests completed with "
                                 f"{LM_MAX_NEW} tokens")
        records = []
        for req in sched.completed:
            prompt, steps = next(r for r in eng.closed
                                 if np.array_equal(r[0], req.prompt)
                                 and len(r[1]) == len(req.out))
            served = torch.stack(steps)
            if not bool(torch.isfinite(served).all()) or not torch.equal(
                    served.argmax(-1).cpu(), torch.tensor(req.out)):
                raise AssertionError(f"{arch} request {req.rid}: served "
                                     "tokens are not the argmax of finite "
                                     "recorded logits")
            records.append((req, served))
        dec = np.array(eng.decode_s)
        dec_tokens = sum(len(r.out) for r in sched.completed) - eng.prefills
        n_params = sum(p.numel() for p in eng.model.parameters())
        print(f"   {arch} ({eng.cfg.n_layers} layers, {n_params} params, "
              f"f32; {smi}): {len(sched.completed)} requests x "
              f"{LM_MAX_NEW} tokens, each the argmax of its finite logits, "
              f"in {secs:.3f} s (weights drawn on the card included); "
              f"prefill {eng.prefill_tokens} prompt tokens in "
              f"{eng.prefills} calls, {eng.prefill_s:.4f} s = "
              f"{eng.prefill_tokens / eng.prefill_s:.1f} tokens/s; decode "
              f"{len(dec)} steps x {eng.batch_slots} slots, median "
              f"{np.median(dec) * 1e3:.3f} ms/step (mean "
              f"{dec.mean() * 1e3:.3f}, first {dec[0] * 1e3:.3f}), "
              f"{dec_tokens} request tokens in {dec.sum():.4f} s = "
              f"{dec_tokens / dec.sum():.1f} tokens/s; peak device memory "
              f"{peak / 2 ** 30:.3f} GiB ({peak} bytes); batch replans="
              f"{sched.planner.replans} deployments="
              f"{sched.planner.deployments}", flush=True)
        profile_lm_decode(eng, arch)
        cpu = Model(eng.cfg, "cpu")
        cpu.load_state_dict(eng.model.state_dict())
        for req, served in records[:2]:
            card = forced_forward(eng.model, req.prompt, req.out)
            host = forced_forward(cpu, req.prompt, req.out)
            scale = float(card.abs().max())
            agree = int((card.argmax(-1).cpu() == host.argmax(-1)).sum())
            print(f"   {arch} request {req.rid} (prompt {len(req.prompt)}): "
                  f"teacher-forced forward on the card vs the served logits "
                  f"max |diff| / max |logit| "
                  f"{float((served - card).abs().max()) / scale:.3e}; the "
                  f"same forward on the CPU vs the card's "
                  f"{float((host - card.cpu()).abs().max()) / scale:.3e} "
                  f"(argmax equal at {agree} of {len(req.out)})", flush=True)
        del sched, eng, cpu, records
    torch.cuda.empty_cache()


def lm_inputs(cfg, rng):
    """A (``LM_B``, ``LM_S``) batch of the family's inputs, and the decode
    steps' frame embeddings for audio (else None)."""
    import numpy as np

    batch = {}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(LM_B, cfg.n_frontend_tokens, cfg.d_model)).astype(
                np.float32)
    if cfg.frontend_is_embedding:
        batch["embeds"] = rng.normal(size=(LM_B, LM_S, cfg.d_model)).astype(
            np.float32)
        return batch, [rng.normal(size=(LM_B, 1, cfg.d_model)).astype(
            np.float32) for _ in range(LM_DECODE_STEPS)]
    batch["tokens"] = rng.integers(0, cfg.vocab, (LM_B, LM_S)).astype(
        np.int32)
    return batch, None


def lm_prefix(cfg):
    return cfg.n_frontend_tokens if cfg.family == "vlm" else 0


def lm_run(model, batch, embeds, tokens=None):
    """forward, prefill and ``LM_DECODE_STEPS`` decode steps; the decode
    inputs are ``embeds`` (audio), else ``tokens`` if given, else this
    run's greedy tokens.  Returns the logits of each, the tokens fed and
    the forward's metrics."""
    import torch

    seq = LM_S + lm_prefix(model.cfg)
    with torch.no_grad():
        fwd, metrics = model.forward(batch)
    logits, cache = model.prefill(batch, seq + LM_DECODE_STEPS)
    out, fed = [fwd, logits], []
    for i in range(LM_DECODE_STEPS):
        if embeds is not None:
            x = embeds[i]
        else:
            x = (tokens[i] if tokens is not None
                 else logits[:, -1].argmax(-1, keepdim=True).cpu().numpy())
            fed.append(x)
        logits, cache = model.decode_step(cache, x)
        out.append(logits)
    return out, fed, metrics


def lm_consistency(model, batch, forward_logits):
    """test_prefill_decode_consistency at full width: prefill the first
    ``LM_S - n`` positions, decode the last ``n`` teacher-forced, and hold
    the logits to the forward's at those positions; returns the ratio."""
    import torch

    n = LM_DECODE_STEPS
    key = "embeds" if "embeds" in batch else "tokens"
    seq = batch[key]
    head = dict(batch, **{key: seq[:, :LM_S - n]})
    logits, cache = model.prefill(head, LM_S + lm_prefix(model.cfg))
    outs = [logits]
    for t in range(LM_S - n, LM_S):
        logits, cache = model.decode_step(cache, seq[:, t:t + 1])
        outs.append(logits)
    return lm_gate(torch.cat(outs[:-1], 1),
                   forward_logits[:, LM_S - n - 1:LM_S - 1],
                   "prefill/decode vs forward")


def lm_engine_consistency(model, rng):
    """``ServingEngine`` on the card, two slots (an attention family's
    first prompt is padded to its bucket), ``LM_DECODE_STEPS`` steps: each
    slot's logits equal a teacher-forced forward's; returns the ratio."""
    import numpy as np
    import torch

    from repro_torch.serving import ServingEngine

    cfg = model.cfg
    eng = ServingEngine(cfg, model, batch_slots=2, cache_len=64,
                        device=model.device)
    lens = (16, 32) if cfg.family in ("ssm", "hybrid") else (11, 16)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    toks, rec = [], []
    for i, p in enumerate(prompts):
        toks.append([eng.prefill_one(p, i)])
        rec.append([eng.last_logits.clone()])
    for _ in range(LM_DECODE_STEPS):
        nxt = eng.decode(np.array([t[-1] for t in toks], np.int32))
        for i in range(2):
            toks[i].append(int(nxt[i]))
            rec[i].append(eng.last_logits[i].clone())
    worst = 0.0
    for i, p in enumerate(prompts):
        want = forced_forward(model, p, toks[i])
        worst = max(worst, lm_gate(torch.stack(rec[i]), want,
                                   f"engine slot {i} vs forward"))
    return worst


def check_lm_families(smi):
    """One config per family at full width cut to ``LM_LAYERS`` layers
    (``LM_LAYERS_OF`` where listed):
    weights drawn on the CPU from a seeded generator and copied to the
    card; forward, prefill and the decode steps on the card equal the
    port's CPU run within ``LM_TOL`` of the largest CPU logit, with the
    greedy tokens equal wherever the CPU's top-2 margin is clear; on the
    card, prefill + teacher-forced decode equals the forward, and (token
    families) a two-slot ``ServingEngine`` equals the forward."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    for arch in LM_FAMILY_ARCHS:
        cfg = get_config(arch).with_(
            n_layers=LM_LAYERS_OF.get(arch, LM_LAYERS))
        t = time.perf_counter()
        cpu = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        init_s = time.perf_counter() - t
        gpu = Model(cfg, "cuda")
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(LM_FAMILY_ARCHS.index(arch))
        batch, embeds = lm_inputs(cfg, rng)
        t = time.perf_counter()
        want, fed, cpu_metrics = lm_run(cpu, batch, embeds)
        cpu_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, _, gpu_metrics = lm_run(gpu, batch, embeds, fed or None)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t
        worst, checked, rows = 0.0, 0, 0
        for i, (g, w) in enumerate(zip(got, want)):
            what = ("forward", "prefill")[i] if i < 2 else f"decode {i - 1}"
            worst = max(worst, lm_gate(g, w, f"{arch} {what} card vs CPU"))
            c, r = greedy_agrees(g, w, f"{arch} {what}")
            checked, rows = checked + c, rows + r
        same = gpu
        if cfg.family == "moe":
            # Capacity is per call (T tokens), so a forward and a decode
            # step drop different assignments by design; with capacity
            # E/K x the load nothing drops and the two must agree.
            same = Model(cfg.with_(capacity_factor=cfg.n_experts
                                   / cfg.top_k), gpu.device)
            same.load_state_dict(gpu.state_dict())
            with torch.no_grad():
                got[0] = same.forward(batch)[0]
        forced = lm_consistency(same, batch, got[0])
        line = (f"   {arch} [{cfg.family}] {cfg.n_layers} of "
                f"{get_config(arch).n_layers} layers, "
                f"{sum(p.numel() for p in cpu.parameters())} params "
                f"(init on the CPU {init_s:.2f} s): forward, prefill and "
                f"{LM_DECODE_STEPS} decode steps, card vs CPU max |diff| / "
                f"max |logit| {worst:.3e} <= {LM_TOL}, greedy tokens equal "
                f"at {checked} of {rows} rows with a clear margin (CPU "
                f"{cpu_s:.3f} s, card {gpu_s:.3f} s); on the card, prefill "
                f"+ decode vs forward {forced:.3e}")
        if cfg.family in ("dense", "moe", "ssm", "hybrid"):
            line += (f", two-slot engine vs forward "
                     f"{lm_engine_consistency(same, rng):.3e}")
        if cfg.family == "moe":
            line += (" (capacity E/K: no drops); expert loads card vs CPU "
                     "equal: " + str(torch.equal(
                         gpu_metrics["expert_load"].cpu(),
                         cpu_metrics["expert_load"])))
        print(line + f" ({smi})", flush=True)
        del cpu, gpu, same
        torch.cuda.empty_cache()


def run_lm_phases(smi, phases):
    """Each (path, check) of ``phases`` with the CEP kernels' launch
    counters zeroed just before and read just after: the LM paths launch
    none of them.  Returns the launches per path."""
    import torch

    from repro_torch.kernels import ops as kops

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls must not run in TF32")
    launches = {}
    for path, check in phases:
        t = phase(path)
        kops.reset_launch_counts()
        check(smi)
        launches[path] = {k: kops.LAUNCHES[k] + kops.GRAPH_LAUNCHES[k]
                          for k in kops.LAUNCHES}
        if any(launches[path].values()):
            raise AssertionError(f"{path} launched a CEP kernel: "
                                 f"{launches[path]}")
        print(f"   CEP kernel launches on the {path} path: "
              f"{launches[path]}")
        done(path, t)
    return launches


def check_lm_paths(smi):
    """The two LM serving phases (``run_lm_phases``)."""
    return run_lm_phases(smi, (("lm serving", check_lm_serving),
                               ("lm families", check_lm_families)))
# ---------------------------------------------------------------------------
# The LM training path
# ---------------------------------------------------------------------------


def reset_peak(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak_line(device):
    import torch

    if torch.device(device).type != "cuda":
        return "peak device memory not measured (CPU)"
    peak = torch.cuda.max_memory_allocated()
    return f"peak device memory {peak / 2 ** 30:.3f} GiB ({peak} bytes)"


class StepRecorder:
    """Stands in for ``launch.train.make_train_step``: each step runs
    between device syncs on the host clock, and its metrics are read back
    (``ce``, ``grad_norm``, ``lr``, ``expert_load``).  Keeps a slice of
    every parameter from before the first step, the last step's (model,
    opt_state, batch) and the step function's config."""

    def __init__(self, device):
        from repro_torch.train import train_step

        self.device, self.make = device, train_step.make_train_step
        self.seconds, self.metrics, self.first, self.last = [], [], None, None

    def __call__(self, model, opt_cfg, **kw):
        inner = self.make(model, opt_cfg, **kw)
        self.opt_cfg = opt_cfg

        def step(model, opt_state, batch):
            if self.first is None:
                self.first = {n: p.detach().flatten()[:4096].clone()
                              for n, p in model.named_parameters()}
            sync(self.device)
            t = time.perf_counter()
            out = inner(model, opt_state, batch)
            sync(self.device)
            self.seconds.append(time.perf_counter() - t)
            m = out[2]
            self.metrics.append(dict(
                {k: float(m[k]) for k in ("ce", "grad_norm", "lr")},
                **({"expert_load": m["expert_load"].cpu()}
                   if "expert_load" in m else {})))
            self.last = out[:2] + (batch,)
            return out
        return step

    def check_finite(self, what):
        import math

        for i, m in enumerate(self.metrics):
            if not all(math.isfinite(m[k]) for k in ("ce", "grad_norm", "lr")):
                raise AssertionError(f"{what} step {i}: {m}")

    def check_changed(self, model, what):
        import torch

        same = [n for n, p in model.named_parameters()
                if torch.equal(p.detach().flatten()[:4096], self.first[n])]
        if same:
            raise AssertionError(f"{what}: parameters unchanged: {same}")


@contextlib.contextmanager
def patched(module, **names):
    """Sets ``module``'s attributes to ``names`` inside the block and puts
    the old ones back."""
    old = {k: getattr(module, k) for k in names}
    for k, v in names.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def profile_training(model, opt_state, opt_cfg, cfg, dcfg, start, top=8):
    """``TRAIN_PROFILE_STEPS`` train steps under ``torch.profiler``:
    device-busy share, the largest device ops, and the optimizer's device
    time (its ``apply_update`` inside a ``record_function`` range); then
    one update on a step's gradients timed with CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.data.lm_data import make_batch
    from repro_torch.launch.dryrun import HBM_BW
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import apply_update

    def ranged(*a, **kw):
        with record_function("adamw"):
            return apply_update(*a, **kw)

    step_fn = train_step.make_train_step(model, opt_cfg)
    batches = [train_step.batch_to(make_batch(cfg, dcfg, start + i),
                                   model.device)
               for i in range(TRAIN_PROFILE_STEPS + 1)]
    torch.cuda.synchronize()
    with patched(train_step, apply_update=ranged), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            acc_events=True) as prof:
        t = time.perf_counter()
        for b in batches[:-1]:
            model, opt_state, _ = step_fn(model, opt_state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    report_profile(prof, wall, TRAIN_PROFILE_STEPS, f"{cfg.name} train",
                   top, forbid_scans=False, unit="steps", ranges=("adamw",))
    _, _, grads = train_step._grads(model, batches[-1])
    params = dict(model.named_parameters())
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    begin.record()
    apply_update(opt_cfg, params, grads, opt_state)
    end.record()
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() for p in params.values()) * 4 * 7
    print(f"   one apply_update on a step's gradients: "
          f"{begin.elapsed_time(end):.3f} ms (CUDA events); bound "
          f"{1e3 * n_bytes / HBM_BW:.3f} ms (bytes: p, g, m, v "
          f"read, p, m, v written once in f32)")


def check_lm_train(smi, device="cuda"):
    """``launch.train.main(TRAIN_ARGV)``: OLMo-1B at full width and depth,
    20 steps; every step's ce, grad_norm and lr finite and every parameter
    changed.  Prints ms per step (median; the first apart), tokens/s, the
    model FLOP rate beside the f32 peak, and peak memory; then profiles
    ``TRAIN_PROFILE_STEPS`` more steps."""
    import statistics

    import torch

    from repro_torch.data.lm_data import DataConfig
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import PEAK_FLOPS_F32

    rec = StepRecorder(device)
    reset_peak(device)
    t = time.perf_counter()
    with patched(train, make_train_step=rec):
        model, opt_state = train.main(TRAIN_ARGV + ["--device", str(device)])
    secs = time.perf_counter() - t
    memory = peak_line(device)
    rec.check_finite("lm train")
    rec.check_changed(model, "lm train")
    cfg = model.cfg
    n = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(rec.seconds[1:])
    RESULTS["lm train ms"] = med * 1e3
    flops = 6 * n * tokens
    print(f"   {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab}, {n} params, f32, remat none; {smi}): "
          f"{len(rec.seconds)} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"in {secs:.3f} s "
          f"(weights drawn on the card included), every ce, grad_norm and "
          f"lr finite, every parameter changed; ce {rec.metrics[0]['ce']:.4f}"
          f" -> {rec.metrics[-1]['ce']:.4f}; first step "
          f"{rec.seconds[0] * 1e3:.3f} ms, median of the rest "
          f"{med * 1e3:.3f} ms/step (min {min(rec.seconds[1:]) * 1e3:.3f}, "
          f"max {max(rec.seconds[1:]) * 1e3:.3f}), {tokens / med:.1f} "
          f"tokens/s; model FLOPs 6 N T = {flops:.4e} per step, "
          f"{flops / med / 1e12:.2f} TFLOP/s = "
          f"{100 * flops / med / PEAK_FLOPS_F32:.1f}% of the "
          f"{PEAK_FLOPS_F32 / 1e12:.0f} TFLOP/s f32 non-tensor peak (NVIDIA "
          f"H100 SXM data sheet); bound {1e3 * flops / PEAK_FLOPS_F32:.1f} "
          f"ms/step; {memory}", flush=True)
    if torch.device(device).type == "cuda":
        profile_training(model, opt_state, rec.opt_cfg, cfg,
                         DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ),
                         len(rec.seconds))


def leaf_ratios(got, want):
    """Per leaf: max |got - want| / max |want| (0 where want is all 0 and
    got equals it); ``None`` is zeros."""
    import torch

    out = {}
    for n, w in want.items():
        g = got[n]
        w = torch.zeros(()) if w is None else w.float().cpu()
        g = torch.zeros(()) if g is None else g.float().cpu()
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        out[n] = err / scale if scale else (0.0 if err == 0 else float("inf"))
    return out


def port_grads(model, batch):
    """The loss and ``{name: grad or None}`` of one backward."""
    from repro_torch.train.train_step import _grads

    loss, _, grads = _grads(model, batch)
    return float(loss), grads


def check_lm_train_consistency(smi, device="cuda"):
    """olmo-1b at full width cut to ``TRAIN_LAYERS`` layers, weights drawn
    on the card and copied to a CPU ``Model``: per-leaf one-step gradients
    card vs CPU; ``TRAIN_CHECK_STEPS`` train steps (ce, grad_norm per
    step, the final parameters); on the card, remat full and dots against
    none, and microbatches=2 against 1."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import DataConfig, make_batch
    from repro_torch.models import Model
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import batch_to, make_train_step

    cfg = get_config("olmo-1b").with_(n_layers=TRAIN_LAYERS)
    dev = torch.device(device)
    card = Model(cfg, dev, remat="none").init(
        torch.Generator(device=dev).manual_seed(0))
    cpu = Model(cfg, "cpu", remat="none")
    cpu.load_state_dict(card.state_dict())
    dcfg = DataConfig(batch=TRAIN_CHECK_B, seq=TRAIN_CHECK_S)
    batches = [make_batch(cfg, dcfg, s) for s in range(TRAIN_CHECK_STEPS)]
    t = time.perf_counter()
    cpu_loss, want = port_grads(cpu, batch_to(batches[0], "cpu"))
    cpu_s = time.perf_counter() - t
    card_loss, got = port_grads(card, batch_to(batches[0], dev))
    ratios = leaf_ratios(got, want)
    worst = max(ratios, key=ratios.get)
    if ratios[worst] > TRAIN_GRAD_TOL:
        raise AssertionError(f"lm train consistency: gradient of {worst} "
                             f"card vs CPU {ratios[worst]} > {TRAIN_GRAD_TOL}")
    print(f"   olmo-1b {TRAIN_LAYERS} of {get_config('olmo-1b').n_layers} "
          f"layers, {sum(p.numel() for p in cpu.parameters())} params, batch "
          f"{TRAIN_CHECK_B} x {TRAIN_CHECK_S}: loss card {card_loss:.6f} vs "
          f"CPU {cpu_loss:.6f}; per-leaf gradients card vs CPU max |diff| / "
          f"max |CPU grad| <= {ratios[worst]:.3e} ({worst}; gate "
          f"{TRAIN_GRAD_TOL}; {len(ratios)} leaves, "
          f"{sum(g is None for g in want.values())} without a gradient on "
          f"both); CPU backward {cpu_s:.3f} s; largest ratios "
          + ", ".join(f"{n} {ratios[n]:.3e}" for n in sorted(
              ratios, key=ratios.get, reverse=True)[:6]), flush=True)

    for mode in ("full", "dots"):
        card.remat = mode
        _, g = port_grads(card, batch_to(batches[0], dev))
        r = leaf_ratios(g, got)
        bits = sum((a is None and got[n] is None) or (
            a is not None and torch.equal(a, got[n])) for n, a in g.items())
        if max(r.values()) > TRAIN_GRAD_TOL:
            raise AssertionError(f"remat {mode}: gradients differ from none "
                                 f"by {max(r.values())}")
        print(f"   remat {mode} vs none on the card: {bits} of {len(r)} "
              f"leaves bit for bit, max ratio {max(r.values()):.3e}")
    card.remat = "none"
    del got, want, g

    opt_cfg = AdamWConfig(warmup_steps=10, total_steps=20)
    start = {n: p.detach().cpu().clone() for n, p in cpu.named_parameters()}
    runs = {}
    for name, model in (("cpu", cpu), ("card", card)):
        opt = init_state(opt_cfg, dict(model.named_parameters()))
        step = make_train_step(model, opt_cfg)
        ms = []
        t = time.perf_counter()
        for b in batches:
            model, opt, m = step(model, opt, batch_to(b, model.device))
            ms.append((float(m["ce"]), float(m["grad_norm"])))
        runs[name] = (ms, time.perf_counter() - t)
        del opt
    worst_m = max(max(abs(gce / ce - 1), abs(ggn / gn - 1))
                  for (ce, gn), (gce, ggn) in zip(runs["cpu"][0],
                                                  runs["card"][0]))
    num = den = 0.0
    big, n_big = 0.0, 0
    with torch.no_grad():
        for (n, p), q in zip(cpu.named_parameters(), card.parameters()):
            d = q.cpu() - p
            num += float(d.double().square().sum())
            den += float((p - start[n]).double().square().sum())
            big = max(big, float(d.abs().max()))
            n_big += int((d.abs() > 1e-6).sum())
            q.copy_(start[n])  # back to the start for the checks below
    rel = (num / den) ** 0.5
    if worst_m > TRAIN_TOL or rel > TRAIN_UPDATE_TOL:
        raise AssertionError(f"lm train consistency: {TRAIN_CHECK_STEPS} "
                             f"steps card vs CPU: ce/grad_norm {worst_m}, "
                             f"updates {rel}")
    print(f"   {TRAIN_CHECK_STEPS} train steps card vs CPU: ce "
          f"{[round(x[0], 6) for x in runs['card'][0]]} (CPU "
          f"{[round(x[0], 6) for x in runs['cpu'][0]]}), ce and grad_norm "
          f"within {worst_m:.3e} relative (gate {TRAIN_TOL}); parameter "
          f"updates ||card - CPU|| / ||CPU|| {rel:.3e} (gate "
          f"{TRAIN_UPDATE_TOL}), max |diff| {big:.3e}, {n_big} elements "
          f"beyond 1e-6; CPU {runs['cpu'][1]:.3f} s, card "
          f"{runs['card'][1]:.3f} s", flush=True)
    del runs, cpu

    mb_cfg = AdamWConfig(total_steps=2)
    finals = {}
    for mb in (1, 2):
        opt = init_state(mb_cfg, dict(card.named_parameters()))
        card, _, _ = make_train_step(card, mb_cfg, microbatches=mb)(
            card, opt, batch_to(batches[0], dev))
        with torch.no_grad():
            finals[mb] = {n: p.detach().clone()
                          for n, p in card.named_parameters()}
            for n, p in card.named_parameters():
                p.copy_(start[n])
        del opt
    diff = max(float((finals[2][n] - p).abs().max())
               for n, p in finals[1].items())
    if diff > TRAIN_MB_TOL:
        raise AssertionError(f"microbatches=2 vs 1: {diff} > {TRAIN_MB_TOL}")
    print(f"   microbatches=2 vs 1 on the card, one step of "
          f"AdamWConfig(total_steps=2): parameters max |diff| {diff:.3e} "
          f"(gate {TRAIN_MB_TOL}) ({smi})", flush=True)


def timed_checkpoints(log, final_save=True):
    """A ``CheckpointManager`` class that appends (what, step, seconds,
    bytes) to ``log`` for each write (in the writer thread too), snapshot
    and restore; without ``final_save`` its synchronous ``save`` (a run's
    last checkpoint) writes nothing."""
    from repro_torch.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        def save(self, *a, **kw):
            if final_save:
                super().save(*a, **kw)

        def _write(self, step, *rest):
            t = time.perf_counter()
            super()._write(step, *rest)
            d = self._step_dir(step)
            log.append(("write", step, time.perf_counter() - t,
                        sum(os.path.getsize(os.path.join(d, f))
                            for f in os.listdir(d))))

        def _snapshot(self, state):
            t = time.perf_counter()
            out = super()._snapshot(state)
            log.append(("snapshot", None, time.perf_counter() - t,
                        sum(a.nbytes for a in out[0])))
            return out

        def restore(self, like, step=None, device=None):
            t = time.perf_counter()
            out = super().restore(like, step, device)
            sync(device or "cpu")
            log.append(("restore", step, time.perf_counter() - t, None))
            return out
    return Timed


def check_lm_train_resume(smi, device="cuda", arch="olmo-1b", steps=10,
                          every=None, resumed_save=True,
                          layers=TRAIN_LAYERS):
    """``arch`` at ``layers`` layers through ``launch.train``:
    ``steps`` straight steps against ``steps // 2`` steps with a
    checkpoint (asynchronous every ``every`` steps, by default at the
    half, and the final one) and a restart with ``--resume`` to
    ``steps`` (which writes its own final checkpoint only with
    ``resumed_save``); the parameters must be bit-equal.  Prints save and
    restore seconds and bytes; the checkpoint directory is deleted."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    ckpt_dir = os.path.join(ROOT, "build", "lm_train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log = []
    argv = ["--arch", arch, "--device", str(device)]
    half = str(steps // 2)
    out = {}
    try:
        for name, extra in (
                ("straight", ["--steps", str(steps)]),
                ("first", ["--steps", half, "--ckpt-dir", ckpt_dir,
                           "--ckpt-every", str(every or half)]),
                ("resumed", ["--steps", str(steps), "--ckpt-dir",
                             ckpt_dir, "--resume"])):
            manager = timed_checkpoints(log, resumed_save
                                        or name != "resumed")
            with patched(train, get_config=lambda a: get_config(a).with_(
                    n_layers=layers), CheckpointManager=manager):
                sync(device)
                t = time.perf_counter()
                model, opt = train.main(argv + extra)
                sync(device)
                out[name] = (time.perf_counter() - t, int(opt.step),
                             {n: p.detach().cpu() for n, p in
                              model.named_parameters()})
                del model, opt
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    a, b = out["straight"][2], out["resumed"][2]
    differ = [n for n in a if not torch.equal(a[n], b[n])]
    if out["resumed"][1] != steps or differ:
        worst = max((float((a[n] - b[n]).abs().max()), n) for n in differ) \
            if differ else None
        raise AssertionError(f"{arch} resume: step {out['resumed'][1]}, "
                             f"{len(differ)} parameters differ from the "
                             f"straight run (largest {worst})")
    print(f"   {arch} {layers} of {get_config(arch).n_layers} "
          f"layers: {steps} straight steps "
          f"({out['straight'][0]:.3f} s) == {half} steps + checkpoint "
          f"({out['first'][0]:.3f} s) + --resume to {steps} "
          f"({out['resumed'][0]:.3f} s): all {len(a)} parameters bit-equal "
          f"({smi})", flush=True)
    for kind, step, secs, size in log:
        print(f"   checkpoint {kind}" + (f" step {step}" if step else "")
              + f": {secs:.3f} s" + (f", {size} bytes ({size / 2 ** 30:.3f}"
                                     f" GiB, {size / secs / 2 ** 30:.3f} "
                                     f"GiB/s)" if size else ""), flush=True)


def check_lm_train_placement(smi, device="cuda"):
    """deepseek-moe-16b at full width cut to ``TRAIN_LAYERS`` layers,
    ``launch.train.main(PLACEMENT_ARGV)``: every step finite, each step's
    ``expert_load`` (layers, experts) summing to T * top_k per layer; at a
    deployment the loss of that step's batch before and after the
    relocation agrees within ``PLACEMENT_TOL`` and the weights, router
    columns and moments of every MoE layer moved by the relocation."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    rec = StepRecorder(device)
    relocate = train.relocate_experts
    checks, govs = [], []

    def checked(model, opt_state, rel):
        _, _, batch = rec.last
        names = [f"layers.{i}.moe.{k}" for i in range(len(model.layers))
                 for k in train.MOVED]
        params = dict(model.named_parameters())
        before = {(w, n): t[n].detach().clone() for n in names
                  for w, t in (("p", params), ("m", opt_state.m),
                               ("v", opt_state.v))}
        with torch.no_grad():
            loss0 = float(model.loss(batch)[0])
        relocate(model, opt_state, rel)
        with torch.no_grad():
            loss1 = float(model.loss(batch)[0])
        inv = torch.as_tensor(np.argsort(rel), device=model.device)
        moved = all(torch.equal(
            {"p": params, "m": opt_state.m, "v": opt_state.v}[w][n],
            old.index_select(-1 if n.endswith("router") else -3, inv))
            for (w, n), old in before.items())
        checks.append((len(rec.seconds) - 1, loss0, loss1, moved))

    class Governor(train.ExpertPlacementGovernor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            govs.append(self)

    reset_peak(device)
    t = time.perf_counter()
    with patched(train, make_train_step=rec, relocate_experts=checked,
                 ExpertPlacementGovernor=Governor,
                 get_config=lambda a: get_config(a).with_(
                     n_layers=TRAIN_LAYERS)):
        model, opt_state = train.main(PLACEMENT_ARGV + ["--device",
                                                        str(device)])
    secs = time.perf_counter() - t
    cfg, gov = model.cfg, govs[0]
    rec.check_finite("lm train moe placement")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, m in enumerate(rec.metrics):
        load = m["expert_load"]
        if tuple(load.shape) != (cfg.n_layers, cfg.n_experts) or not \
                np.allclose(load.sum(-1).numpy(), tokens * cfg.top_k,
                            rtol=1e-5):
            raise AssertionError(f"moe placement step {i}: expert_load "
                                 f"{tuple(load.shape)} sums "
                                 f"{load.sum(-1).tolist()}")
    how = "at the deployments of the run"
    if not checks:
        # No deployment after the first step (the first plan is adopted
        # without moving weights, as in the reference): relocate to the
        # governor's placement here, through the same path.
        checked(model, opt_state, np.asarray(gov.placement.perm))
        how = ("no deployment after the first step; on a relocation to "
               "the governor's placement after the run")
    for step, loss0, loss1, moved in checks:
        if abs(loss1 - loss0) > PLACEMENT_TOL * abs(loss0) or not moved:
            raise AssertionError(f"moe placement at step {step}: loss "
                                 f"{loss0} -> {loss1}, moved {moved}")
    print(f"   {cfg.name} {cfg.n_layers} of "
          f"{get_config('deepseek-moe-16b').n_layers} layers, "
          f"{sum(p.numel() for p in model.parameters())} params, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, {gov.n_groups} groups: "
          f"{len(rec.seconds)} steps in {secs:.3f} s, median "
          f"{1e3 * sorted(rec.seconds)[len(rec.seconds) // 2]:.3f} ms/step, "
          f"every step finite, expert_load ({cfg.n_layers}, "
          f"{cfg.n_experts}) summing to {tokens * cfg.top_k} per layer; "
          f"governor replans {gov.replans}, deployments {gov.deployments}, "
          f"false positives {gov.false_positives}; {peak_line(device)}",
          flush=True)
    for step, loss0, loss1, moved in checks:
        print(f"   relocation ({how}) at step {step}: loss {loss0:.7f} -> "
              f"{loss1:.7f} (|diff| / loss {abs(loss1 - loss0) / loss0:.3e}, "
              f"gate {PLACEMENT_TOL}); weights, router columns, m and v of "
              f"every MoE layer moved: {moved} ({smi})", flush=True)


class _F64Torch:
    """``torch`` with ``float32`` read as ``float64``: the f64 probe's
    stand-in for the model modules' own f32 constants."""

    def __getattr__(self, name):
        import torch

        return torch.float64 if name == "float32" else getattr(torch, name)


@contextlib.contextmanager
def float64_model():
    """The LM stack in float64 inside the block: the configs' parameter and
    activation dtypes, ``Tensor.float`` and the model modules' float32
    constants all read float64 (the package itself is unchanged)."""
    import torch

    from repro_torch.models import config, layers
    from repro_torch.models import model as model_mod

    f64 = property(lambda self: torch.float64)

    def double(self, *a, **kw):
        return self.double()

    with patched(config.ModelConfig, pdtype=f64, adtype=f64), \
            patched(torch.Tensor, float=double), \
            patched(layers, torch=_F64Torch()), \
            patched(model_mod, torch=_F64Torch()):
        yield


def check_lm_train_f64(smi, device="cuda"):
    """The card-vs-CPU training gap in float64 ("lm train consistency"'s
    cut, weights and batch): olmo-1b at full width, ``TRAIN_LAYERS``
    layers, batch (TRAIN_CHECK_B, TRAIN_CHECK_S), the forward's logits and
    the per-leaf gradients on the card against the CPU.  If the card's
    path is right, the f64 gap is the f32 gap scaled by the ratio of the
    two formats' rounding (2**-52 / 2**-23, ~5e-10): gates
    ``F64_LOGIT_TOL`` and ``F64_GRAD_TOL``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import DataConfig, make_batch
    from repro_torch.models import Model
    from repro_torch.train.train_step import batch_to

    cfg = get_config("olmo-1b").with_(n_layers=TRAIN_LAYERS)
    dev = torch.device(device)
    batch = make_batch(cfg, DataConfig(batch=TRAIN_CHECK_B,
                                       seq=TRAIN_CHECK_S), 0)
    with float64_model():
        card = Model(cfg, dev, remat="none").init(
            torch.Generator(device=dev).manual_seed(0))
        cpu = Model(cfg, "cpu", remat="none")
        cpu.load_state_dict(card.state_dict())
        if any(p.dtype != torch.float64 for p in cpu.parameters()):
            raise AssertionError("f64 probe: parameters are not float64")
        with torch.no_grad():
            want = cpu.forward(batch_to(batch, "cpu"))[0]
            got = card.forward(batch_to(batch, dev))[0]
        if want.dtype != torch.float64 or got.dtype != torch.float64:
            raise AssertionError(f"f64 probe: logits {want.dtype}")
        logit_gap = float((got.cpu() - want).abs().max() / want.abs().max())
        del want, got
        t = time.perf_counter()
        cpu_loss, want = port_grads(cpu, batch_to(batch, "cpu"))
        cpu_s = time.perf_counter() - t
        card_loss, got = port_grads(card, batch_to(batch, dev))
        ratios = leaf_ratios(got, want)
    worst = max(ratios, key=ratios.get)
    print(f"   olmo-1b {TRAIN_LAYERS} of 16 layers in float64, batch "
          f"{TRAIN_CHECK_B} x {TRAIN_CHECK_S}: loss card {card_loss!r} vs "
          f"CPU {cpu_loss!r}; logits card vs CPU max |diff| / max |CPU| "
          f"{logit_gap:.3e} (gate {F64_LOGIT_TOL}); per-leaf gradients "
          f"max |diff| / max |CPU grad| <= {ratios[worst]:.3e} ({worst}; "
          f"gate {F64_GRAD_TOL}; f32 in \"lm train consistency\" above); "
          f"CPU backward {cpu_s:.3f} s; largest ratios "
          + ", ".join(f"{n} {ratios[n]:.3e}" for n in sorted(
              ratios, key=ratios.get, reverse=True)[:6]) + f" ({smi})",
          flush=True)
    if logit_gap > F64_LOGIT_TOL or ratios[worst] > F64_GRAD_TOL:
        raise AssertionError(f"lm train f64: logits {logit_gap}, gradient "
                             f"of {worst} {ratios[worst]}")


def check_lm_training(smi, device="cuda"):
    """The LM training phases with the CEP kernels' launch counters
    zeroed just before and read just after: the training paths launch
    none of them."""
    import functools

    return run_lm_phases(smi, tuple(
        (path, functools.partial(check, device=device)) for path, check in (
            ("lm train", check_lm_train),
            ("lm train consistency", check_lm_train_consistency),
            ("lm train f64", check_lm_train_f64),
            ("lm train resume", check_lm_train_resume),
            ("lm train moe placement", check_lm_train_placement),
            ("lm train moe resume", functools.partial(
                check_lm_train_resume, arch="deepseek-moe-16b",
                steps=MOE_RESUME_STEPS, every=MOE_RESUME_STEPS,
                resumed_save=False, layers=MOE_RESUME_LAYERS)))))


# ---------------------------------------------------------------------------
# Distribution on one host: a one-rank NCCL group
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recording_wire(log):
    """Appends (collective, dtype, bytes) to ``log`` for every tensor
    handed to ``all_to_all_single`` or ``all_gather_into_tensor`` (the
    payload: their input) inside the block."""
    import torch.distributed as dist

    real = {n: getattr(dist, n)
            for n in ("all_to_all_single", "all_gather_into_tensor")}

    def recording(name):
        def call(out, inp, *a, **kw):
            log.append((name, inp.dtype, inp.numel() * inp.element_size()))
            return real[name](out, inp, *a, **kw)
        return call

    with patched(dist, **{n: recording(n) for n in real}):
        yield


def dist_inputs():
    """The reference test's leaves (``rng(0)``: w (64, 32), b (128,)) and
    a 2048 x 2048 one, f32 on the CPU."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    g = {"w": rng.normal(size=(64, 32)), "b": rng.normal(size=(128,)),
         "big": rng.normal(size=(DIST_LEAF, DIST_LEAF))}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in g.items()}


def check_dist_collective(smi, mesh):
    """``compressed_psum_tree`` on ``dist_inputs`` through the card (NCCL)
    and the CPU (gloo) side of one group: means and residuals bit-equal;
    the reference's bounds (mean within 3 quantization steps of the
    input, residual within 2); only int8 handed to the all_to_all and the
    all-gather; the card's all-reduce of the 2048 x 2048 leaf timed with
    CUDA events."""
    import numpy as np
    import torch

    from repro_torch.distributed.collectives import compressed_psum_tree

    g = dist_inputs()
    wire = []
    with recording_wire(wire):
        cpu = compressed_psum_tree(g, (), mesh)
        card = compressed_psum_tree({k: v.cuda() for k, v in g.items()}, (),
                                    mesh)
    for what, want, got in (("mean", cpu[0], card[0]),
                            ("residual", cpu[1], card[1])):
        for k in g:
            a, b = got[k].cpu().numpy(), want[k].numpy()
            if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
                raise AssertionError(f"dist collective: {what} {k} card vs "
                                     f"CPU: {int((a != b).sum())} differ")
    for k, x in g.items():
        scale = float(x.abs().max()) / 127.0
        err = float((card[0][k].cpu() - x).abs().max())
        res = float(card[1][k].abs().max())
        if err > 3 * scale or res > 2 * scale:
            raise AssertionError(f"dist collective {k}: error {err}, "
                                 f"residual {res}, scale {scale}")
    dtypes = {str(dt) for _, dt, _ in wire}
    if dtypes != {"torch.int8"}:
        raise AssertionError(f"dist collective: payload dtypes {dtypes}")
    big = g["big"].cuda()
    compressed_psum_tree({"big": big}, (), mesh)
    ms = []
    for _ in range(5):
        b = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        b.record()
        compressed_psum_tree({"big": big}, (), mesh)
        e.record()
        torch.cuda.synchronize()
        ms.append(b.elapsed_time(e))
    n = big.numel()
    print(f"   {len(g)} leaves ({sum(x.numel() for x in g.values())} "
          f"elements): means and residuals card == CPU bit for bit; within "
          f"the reference's bounds; payload {sorted(dtypes)}, "
          f"{sum(b for _, _, b in wire)} bytes over both runs "
          f"({len(wire)} calls); the {DIST_LEAF} x {DIST_LEAF} leaf on the "
          f"card: {statistics.median(ms):.3f} ms median of 5 (CUDA events; "
          f"min {min(ms):.3f}), int8 payload {2 * n} bytes vs {8 * n} for "
          f"an f32 ring all-reduce ({smi})", flush=True)


def check_dist_compressed_train(smi, mesh, device="cuda"):
    """``launch.train``'s OLMo-1B at full width and depth (``TRAIN_ARGV``'s
    batch) through ``make_train_step(compressed_grads=True, mesh=mesh)``
    with ``AdamWConfig(error_feedback=True)``, ``DIST_STEPS`` steps: every
    step finite, every parameter moved, and after the first step every
    leaf's residual within 2 of its first scale.  Prints ms per step (the
    first apart) beside "lm train"'s, the compressed all-reduce's device
    ms (CUDA events), the int8 bytes per step beside an f32 ring's, and
    peak memory."""
    import functools

    import torch

    from repro_torch.distributed import collectives
    from repro_torch.launch import train
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWConfig

    rec = StepRecorder(device)
    events, wire, worst = [], [], {}
    real_by_leaf = ts.compressed_grads_by_leaf
    real_allreduce = collectives._compressed_allreduce

    def timed(*a, **kw):
        b = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        b.record()
        out = real_by_leaf(*a, **kw)
        e.record()
        events.append((b, e))
        return out

    def gated(x, ef, group, n_shards):
        out = real_allreduce(x, ef, group, n_shards)
        if len(rec.seconds) == 0:  # the first step (reported apart)
            scale1 = float((x.float().reshape(-1) + ef.reshape(-1)).abs()
                           .max()) / 127.0 + 1e-12
            worst[tuple(x.shape)] = max(
                worst.get(tuple(x.shape), 0.0),
                float(out[1].abs().max()) / scale1)
        return out

    def make(model, opt_cfg, **kw):
        return rec(model, opt_cfg, compressed_grads=True, mesh=mesh)

    argv = ["--arch", "olmo-1b", "--steps", str(DIST_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--device",
            str(device)]
    reset_peak(device)
    t = time.perf_counter()
    with patched(train, make_train_step=make, AdamWConfig=functools.partial(
            AdamWConfig, error_feedback=True)), \
            patched(ts, compressed_grads_by_leaf=timed), \
            patched(collectives, _compressed_allreduce=gated), \
            recording_wire(wire):
        model, opt_state = train.main(argv)
    secs = time.perf_counter() - t
    memory = peak_line(device)
    rec.check_finite("dist compressed train")
    rec.check_changed(model, "dist compressed train")
    if opt_state.ef == () or max(worst.values()) > 2.0:
        raise AssertionError(f"dist compressed train: residual / scale "
                             f"{max(worst.values(), default=None)}")
    dtypes = {str(dt) for _, dt, _ in wire}
    if dtypes != {"torch.int8"}:
        raise AssertionError(f"dist compressed train: payload {dtypes}")
    n = sum(p.numel() for p in model.parameters())
    per_step = sum(b for _, _, b in wire) / DIST_STEPS
    RESULTS["dist wire bytes per step"] = per_step
    ar_ms = [b.elapsed_time(e) for b, e in events]
    med = statistics.median(rec.seconds[1:])
    base = RESULTS.get("lm train ms")
    print(f"   olmo-1b ({n} params, f32, remat none, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, error feedback) on a (data 1, model 1) NCCL mesh: "
          f"{DIST_STEPS} compressed steps in {secs:.3f} s, every step "
          f"finite and every parameter moved; first step "
          f"{rec.seconds[0] * 1e3:.3f} ms, median of the rest "
          f"{med * 1e3:.3f} ms/step (min {min(rec.seconds[1:]) * 1e3:.3f}, "
          f"max {max(rec.seconds[1:]) * 1e3:.3f})"
          + (f" vs \"lm train\" {base:.3f} ms/step ({med * 1e3 / base:.3f}x)"
             if base else "")
          + f"; compressed all-reduce {statistics.median(ar_ms[1:]):.3f} ms "
          f"median per step (CUDA events; first {ar_ms[0]:.3f}); "
          f"payload {sorted(dtypes)} {per_step:.0f} bytes per step "
          f"({per_step / n:.4f} B/param) vs {8 * n} for an f32 ring "
          f"all-reduce (8 B/param); residual / first scale <= "
          f"{max(worst.values()):.4f} over {len(worst)} leaves (gate 2); "
          f"{memory} ({smi})", flush=True)


def check_dist_compressed_consistency(smi, mesh, device="cuda"):
    """olmo-1b at full width, ``TRAIN_LAYERS`` layers, batch
    (TRAIN_CHECK_B, TRAIN_CHECK_S), one compressed step with error
    feedback on the card and one on the CPU (gloo) side of the group from
    the card's gradients: residuals bit-equal and parameters within
    ``DIST_PARAM_TOL``.  The step from each device's own gradients is
    printed beside it, ungated: the int8 grid is a step function of the
    gradient, and the two devices' gradients differ by up to
    ``TRAIN_GRAD_TOL`` of a leaf's largest ("lm train consistency"), so
    elements near a grid boundary land on neighbouring levels."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import DataConfig, make_batch
    from repro_torch.models import Model
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWConfig, init_state

    cfg = get_config("olmo-1b").with_(n_layers=TRAIN_LAYERS)
    dev = torch.device(device)
    card = Model(cfg, dev, remat="none").init(
        torch.Generator(device=dev).manual_seed(0))
    start = {n: p.detach().cpu().clone() for n, p in card.named_parameters()}
    batch = make_batch(cfg, DataConfig(batch=TRAIN_CHECK_B,
                                       seq=TRAIN_CHECK_S), 0)
    opt_cfg = AdamWConfig(warmup_steps=10, total_steps=20,
                          error_feedback=True)
    real, kept = ts._grads, {}

    def keep(model, b):
        out = real(model, b)
        kept.update(out[2])
        return out

    def card_grads(model, b):
        with torch.no_grad():
            loss, metrics = model.loss(b)
        return loss, metrics, {n: None if g is None else g.cpu()
                               for n, g in kept.items()}

    runs = {}
    for name, model, grads in (("card", card, keep),
                               ("cpu from card", None, card_grads),
                               ("cpu", None, real)):
        if model is None:
            model = Model(cfg, "cpu", remat="none")
            model.load_state_dict(start)
        opt = init_state(opt_cfg, dict(model.named_parameters()))
        with patched(ts, _grads=grads):
            t = time.perf_counter()
            model, opt, m = ts.make_train_step(
                model, opt_cfg, compressed_grads=True, mesh=mesh)(
                    model, opt, ts.batch_to(batch, model.device))
            sync(model.device)
            secs = time.perf_counter() - t
        runs[name] = ({n: p.detach().cpu() for n, p in
                       model.named_parameters()},
                      {n: e.cpu() for n, e in opt.ef.items()},
                      float(m["ce"]), float(m["grad_norm"]), secs)
        del model, opt
    (p_card, ef_card, ce, gn, card_s) = runs["card"]
    (p_cpu, ef_cpu, _, gn_cpu, cpu_s) = runs["cpu from card"]
    ef_same = sum(torch.equal(ef_card[n], ef_cpu[n]) for n in ef_card)
    p_diff = max(float((p_card[n] - p_cpu[n]).abs().max()) for n in p_card)
    p_same = sum(torch.equal(p_card[n], p_cpu[n]) for n in p_card)
    own, own_ef = runs["cpu"][0], runs["cpu"][1]
    num = den = 0.0
    moved = 0
    for n, p in own.items():
        d = p_card[n] - p
        num += float(d.double().square().sum())
        den += float((p - start[n]).double().square().sum())
        moved += int((d.abs() > 1e-6).sum())
    ef_rel = max(float((ef_card[n] - own_ef[n]).abs().max())
                 / max(float(own_ef[n].abs().max()), 1e-30) for n in own_ef)
    print(f"   olmo-1b {TRAIN_LAYERS} of 16 layers, batch {TRAIN_CHECK_B} x "
          f"{TRAIN_CHECK_S}, one compressed step with error feedback: ce "
          f"{ce:.6f}, grad_norm card {gn:.6e} vs CPU from the card's "
          f"gradients {gn_cpu:.6e}; from the same gradients: residuals "
          f"bit-equal {ef_same} of {len(ef_card)}, parameters bit-equal "
          f"{p_same} of {len(p_card)}, max |diff| {p_diff:.3e} (gate "
          f"{DIST_PARAM_TOL}); each device from its own gradients "
          f"(ungated): updates ||card - CPU|| / ||CPU|| "
          f"{(num / den) ** 0.5:.3e}, {moved} elements beyond 1e-6, "
          f"residuals max |diff| / max |CPU| {ef_rel:.3e}; card "
          f"{card_s:.3f} s, CPU {cpu_s:.3f} s ({smi})", flush=True)
    if ef_same != len(ef_card) or p_diff > DIST_PARAM_TOL:
        raise AssertionError(f"dist compressed consistency: residuals "
                             f"bit-equal {ef_same} of {len(ef_card)}, "
                             f"parameters {p_diff}")


def check_dist_moe_ep(smi, mesh, device="cuda"):
    """deepseek-moe-16b at full width (64 experts, top-6), ``TRAIN_LAYERS``
    layers, batch (TRAIN_BATCH, TRAIN_SEQ): the loss and its gradients
    with every MoE layer on the expert-parallel path over the one-rank
    NCCL mesh (``_moe_ffn_ep`` at n_ep = 1: all_to_alls, gathers and
    gradient sums over one rank) against the dense path, on the card:
    loss, aux, expert loads and every gradient bit-equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import DataConfig, make_batch
    from repro_torch.models import Model
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe
    from repro_torch.train.train_step import _grads, batch_to

    cfg = get_config("deepseek-moe-16b").with_(n_layers=TRAIN_LAYERS)
    dev = torch.device(device)
    model = Model(cfg, dev, remat="none").init(
        torch.Generator(device=dev).manual_seed(0))
    batch = batch_to(make_batch(cfg, DataConfig(batch=TRAIN_BATCH,
                                                seq=TRAIN_SEQ), 0), dev)
    calls = []

    def ep(x, p, cfg_):
        calls.append(1)
        return moe._moe_ffn_ep_global(x, p, cfg_, mesh)

    out = {}
    for name, fn in (("dense", model_mod.moe_ffn), ("ep", ep)):
        with patched(model_mod, moe_ffn=fn):
            sync(dev)
            t = time.perf_counter()
            loss, metrics, grads = _grads(model, batch)
            sync(dev)
            out[name] = (loss, metrics, grads, time.perf_counter() - t)
    if len(calls) != cfg.n_layers:
        raise AssertionError(f"dist moe ep: {len(calls)} EP calls")
    (l0, m0, g0, s0), (l1, m1, g1, s1) = out["dense"], out["ep"]
    same = [n for n in g0 if (g0[n] is None and g1[n] is None)
            or (g0[n] is not None and torch.equal(g0[n], g1[n]))]
    ok = (torch.equal(l0, l1) and torch.equal(m0["aux_loss"], m1["aux_loss"])
          and torch.equal(m0["expert_load"], m1["expert_load"])
          and len(same) == len(g0))
    print(f"   deepseek-moe-16b {TRAIN_LAYERS} of 28 layers "
          f"({sum(p.numel() for p in model.parameters())} params, "
          f"{cfg.n_experts} experts top-{cfg.top_k}), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: expert-parallel (n_ep = 1, NCCL) vs dense on the "
          f"card: loss {float(l1)!r} vs {float(l0)!r}, aux and expert loads "
          f"equal: {ok}; gradients bit-equal {len(same)} of {len(g0)}; "
          f"forward + backward {s1:.3f} s vs {s0:.3f} s ({smi})", flush=True)
    if not ok:
        raise AssertionError("dist moe ep: the expert-parallel path differs "
                             "from the dense path: "
                             f"{sorted(set(g0) - set(same))[:6]}")


def check_distribution(smi):
    """The distribution phases over a one-rank default group (gloo for CPU
    tensors, NCCL for CUDA ones; TCP store on 127.0.0.1) and a (1, 1)
    mesh, with the CEP kernels' launch counters zeroed just before and
    read just after each (the paths launch none).  The group is destroyed
    after."""
    import functools

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group(
        "cpu:gloo,cuda:nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
        world_size=1, rank=0)
    try:
        mesh = make_host_mesh(1, 1, device="cuda")
        print(f"   torch.distributed: NCCL {torch.cuda.nccl.version()}, "
              f"mesh {mesh.shape} on {mesh.device}", flush=True)
        return run_lm_phases(smi, tuple(
            (path, functools.partial(check, mesh=mesh)) for path, check in (
                ("dist collective", check_dist_collective),
                ("dist compressed train", check_dist_compressed_train),
                ("dist compressed consistency",
                 check_dist_compressed_consistency),
                ("dist moe ep", check_dist_moe_ep))))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The dry-run: per-rank accounting on meta tensors, anchored on the card
# ---------------------------------------------------------------------------


def check_dryrun_cells(smi):
    """``launch.dryrun.run_cell`` on ``DRYRUN_CELLS`` (single pod, the
    host's CPU on ``meta`` tensors): each record's three terms,
    ``dominant`` and ``fits``."""
    from repro_torch.launch import dryrun

    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, False)
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun {arch}/{shape}: "
                                 f"{rec.get('error', rec['status'])}")
        mem = rec["memory"]
        print(f"   {arch}/{shape} on {rec['n_chips']} H100s (analytic, "
              f"counted in {rec['t_compile_s']} s): compute "
              f"{rec['compute_s']:.6f} s, memory {rec['memory_s']:.6f} s, "
              f"collective {rec['collective_s']:.6f} s -> "
              f"{rec['dominant']}; FLOPs {rec['hlo_flops']:.4e} per rank, "
              f"useful {rec['useful_flops_ratio']:.3f}; argument "
              f"{mem['argument_size_in_bytes'] / 2 ** 30:.3f} GiB + temp "
              f"{mem['temp_size_in_bytes'] / 2 ** 30:.3f} GiB per rank, "
              f"fits={rec['fits']}; {len(rec['fallbacks'])} fallbacks",
              flush=True)


def check_dryrun_anchor(smi):
    """"lm train"'s cell (OLMo-1B, ``TRAIN_BATCH`` x ``TRAIN_SEQ``, f32,
    remat none) on a (1, 1) mesh shape: ``lower_train_step``'s FLOPs equal
    ``FlopCounterMode``'s count over one real step on the card exactly,
    and its argument + temp bytes are within ``DRYRUN_MEM_TOL`` of the
    device memory that step holds at its peak (from a reset, less what
    was allocated before the model); the compute term beside the step's
    measured ms.  Then ``compressed_grads`` on the same mesh shape: the
    exact all-to-all + all-gather bytes equal the int8 payload per step
    that "dist compressed train"'s ``recording_wire`` logged."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import DataConfig, make_batch
    from repro_torch.launch import dryrun, shapes
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import (ShapeMesh, batch_to,
                                              lower_train_step,
                                              make_train_step)

    shapes.SHAPES["lm_train"] = shapes.ShapeSpec("lm_train", "train",
                                                 TRAIN_SEQ, TRAIN_BATCH)
    cfg = get_config("olmo-1b")
    opt_cfg = AdamWConfig(lr_peak=3e-4, warmup_steps=10, total_steps=20)
    mesh = ShapeMesh({"data": 1, "model": 1})
    lowered, _ = lower_train_step(Model(cfg, device="meta", remat="none"),
                                  opt_cfg, mesh, "lm_train")
    want = lowered.cost_analysis()
    mem = lowered.memory_analysis()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = Model(cfg, "cuda", remat="none").init(
        torch.Generator(device="cuda").manual_seed(0))
    state = init_state(opt_cfg, dict(model.named_parameters()))
    step = make_train_step(model, opt_cfg)
    batches = [batch_to(make_batch(cfg, DataConfig(batch=TRAIN_BATCH,
                                                   seq=TRAIN_SEQ), i), "cuda")
               for i in range(3)]
    with FlopCounterMode(display=False) as fc:
        model, state, _ = step(model, state, batches[0])
    counted = fc.get_total_flops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, state, _ = step(model, state, batches[1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    del model, state, step, batches
    torch.cuda.empty_cache()
    if counted != want["flops"]:
        raise AssertionError(f"dryrun anchor: lowered FLOPs {want['flops']}"
                             f" != counted on the card {counted}")
    if abs(predicted - peak) > DRYRUN_MEM_TOL * peak:
        raise AssertionError(f"dryrun anchor: argument + temp {predicted} "
                             f"vs the card's peak {peak}")
    compute_ms = want["flops"] / dryrun.PEAK_FLOPS_F32 * 1e3
    print(f"   olmo-1b {TRAIN_BATCH} x {TRAIN_SEQ}, f32, remat none, (1, 1) "
          f"mesh ({smi}): lowered FLOPs {want['flops']:.6e} = "
          f"FlopCounterMode over one step on the card {counted:.6e} "
          f"(exact); argument {mem['argument_size_in_bytes']} + temp "
          f"{mem['temp_size_in_bytes']} = {predicted} bytes vs the card's "
          f"step peak {peak} bytes ({predicted / peak:.4f}x, gate "
          f"{DRYRUN_MEM_TOL}); compute term {compute_ms:.3f} ms at "
          f"{dryrun.PEAK_FLOPS_F32 / 1e12:.0f} TFLOP/s f32, memory term "
          f"{want['bytes accessed'] / dryrun.HBM_BW * 1e3:.3f} ms "
          f"({want['bytes accessed']:.4e} bytes accessed, unfused) vs "
          f"{ms:.3f} ms measured for one step (host clock between syncs)"
          + (f", \"lm train\" {RESULTS['lm train ms']:.3f} ms/step"
             if "lm train ms" in RESULTS else ""), flush=True)

    compressed, _ = lower_train_step(
        Model(cfg, device="meta", remat="none"),
        AdamWConfig(total_steps=20, error_feedback=True), mesh, "lm_train",
        compressed_grads=True)
    exact = compressed.exact_collectives()
    payload = exact["all-to-all"] + exact["all-gather"]
    logged = RESULTS.get("dist wire bytes per step")
    if logged is None or payload != logged:
        raise AssertionError(f"dryrun compressed: all-to-all + all-gather "
                             f"{payload} != wire log {logged}")
    print(f"   compressed_grads on the (1, 1) mesh shape: all-to-all "
          f"{exact['all-to-all']} + all-gather {exact['all-gather']} = "
          f"{payload} bytes per step = \"dist compressed train\"'s wire "
          f"log {logged:.0f} (exact); all-reduce {exact['all-reduce']} "
          f"bytes of scale maxima", flush=True)


def check_dryrun(smi):
    """The dry-run phases (no CEP kernel launches)."""
    return run_lm_phases(smi, (("dryrun cells", check_dryrun_cells),
                               ("dryrun anchor", check_dryrun_anchor)))


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------


def check_examples(smi):
    """Each ``examples/torch_*.py`` at its default size on the card, with
    the launch counters zeroed just before and read just after: its
    output and seconds.  The CEP examples must launch the packed join and
    the selection; ``torch_fleet_demo`` asserts every tenant's matches
    equal ``RefEngine``'s.  Returns the launches per example."""
    import importlib.util
    import io

    from repro_torch.kernels import ops as kops

    launches = {}
    for name, kernels in EXAMPLES:
        t = phase(f"example {name}")
        path = os.path.join(ROOT, "examples", f"torch_{name}.py")
        spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        kops.reset_launch_counts()
        buf = io.StringIO()
        cwd = os.getcwd()
        os.chdir(ROOT)
        try:
            with contextlib.redirect_stdout(buf):
                mod.main([])
        finally:
            os.chdir(cwd)
        counts = {k: kops.LAUNCHES[k] + kops.GRAPH_LAUNCHES[k]
                  for k in kops.LAUNCHES}
        launches[f"example {name}"] = counts
        for line in buf.getvalue().splitlines():
            print(f"   | {line}")
        missing = [k for k in kernels if counts[k] <= 0]
        if missing:
            raise AssertionError(f"example {name} never launched {missing}")
        if name == "fleet_demo" and "fleet == oracle on every partition" \
                not in buf.getvalue():
            raise AssertionError("torch_fleet_demo: no oracle check")
        print(f"   launches {counts}")
        done(f"example {name}", t)
    shutil.rmtree(os.path.join(ROOT, "build", "examples"),
                  ignore_errors=True)
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bench_run(path, superchunk, chunks, backend=None):
    """One bench run of a fresh K=16 session over the stacked ``chunks``:
    its first ``BENCH_SPLIT`` chunks (in which a window path captures its
    graphs) and the rest, timed apart.  ``path`` is a plan ("order",
    "tree": ``Session.run``) or "serving" (order plans through ``step``,
    or ``step_superchunk`` with S > 1).  Returns the two segments'
    seconds, the per-chunk matches (serving), the telemetry and the
    runner or serving front.  ``backend="ref"`` runs the plain versions."""
    import numpy as np
    import torch

    from repro_torch import cep

    plan = "order" if path == "serving" else path
    cfg = path_config(plan, buffer_capacity=B_CAP, match_capacity=M_CAP,
                      chunk_capacity=CHUNK_CAP, device="cuda",
                      superchunk=superchunk, backend=backend)
    sess = cep.open(flowsense_rule(), partitions=K_MAIN, plan=plan,
                    monitor=True, config=cfg)
    secs, got = [], []
    for seg in (chunks[:BENCH_SPLIT], chunks[BENCH_SPLIT:]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if path != "serving":
            sess.run(seg, resume=bool(secs))
        elif superchunk == 1:
            got.append(np.stack([sess.step(fc.chunk, fc.t0, fc.t1)
                                 for fc in seg]))
        else:
            got.append(sess.step_superchunk(
                [fc.chunk for fc in seg], [(fc.t0, fc.t1) for fc in seg]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    runner = sess._serving if path == "serving" else sess._runner
    return (secs, np.concatenate(got) if got else None, sess.telemetry(),
            runner)


def bench(n_runs):
    """Per path (order, tree, serving), ``n_runs`` per-chunk and ``n_runs``
    window runs (S=8) in turns, each held to equal telemetry; prints
    events/s per run over all 64 chunks (captures included) and over the
    56 after the first ``BENCH_SPLIT`` (graphs captured), with medians and
    ranges, peak memory, and the window runs' graph replays and in-window
    events."""
    import numpy as np
    import torch

    from repro_torch.core import fleet, scan

    turns = ([1, SUPERCHUNK, SUPERCHUNK, 1] * n_runs)[:2 * n_runs]
    chunks, n_events = serving_chunks()
    n_late = int(sum(np.asarray(fc.chunk.valid).sum()
                     for fc in chunks[BENCH_SPLIT:]))
    for path in ("order", "tree", "serving"):
        rates = {(s, w): [] for s in (1, SUPERCHUNK) for w in ("all", "late")}
        peaks = {1: 0, SUPERCHUNK: 0}
        want = None  # the first run's telemetry and per-chunk matches
        for superchunk in turns:
            # Each run opens a fresh memo, so a window run's first chunks
            # hold its captures, as for a first session in a process.
            fleet.clear_trace_memo()
            scan.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            secs, got, tel, runner = bench_run(path, superchunk, chunks)
            want = want or (tel, got)
            same_telemetry(tel, want[0], f"bench {path} S={superchunk}")
            if got is not None and got.tolist() != want[1].tolist():
                raise AssertionError(f"bench {path} S={superchunk}: "
                                     "per-chunk matches differ")
            rates[superchunk, "all"].append(n_events / sum(secs))
            rates[superchunk, "late"].append(n_late / secs[1])
            peaks[superchunk] = max(peaks[superchunk],
                                    torch.cuda.max_memory_allocated())
            if superchunk > 1:
                cut, counts = runner.in_window_events, dict(scan.COUNTS)
        for (superchunk, which), r in rates.items():
            span = ("all 64 chunks" if which == "all" else
                    f"chunks {BENCH_SPLIT}-{CHUNKS_MAIN - 1}")
            print(f"   bench {path} superchunk={superchunk}, {span}: "
                  f"events/s {[round(x, 1) for x in r]}, median "
                  f"{statistics.median(r):.1f} (range {min(r):.1f}-"
                  f"{max(r):.1f})")
        print(f"   bench {path}: peak device memory per-chunk "
              f"{peaks[1] / 2 ** 30:.3f} GiB, window "
              f"{peaks[SUPERCHUNK] / 2 ** 30:.3f} GiB; the last window "
              f"run's windows {counts['windows']}, graph captures "
              f"{counts['captures']}, replays {counts['replays']}, "
              f"in-window events {cut}")


def profile_main(plan="order", n_chunks=16, top=12, superchunk=1, warm=0):
    """Where a path's time goes: ``n_chunks`` chunks under
    ``torch.profiler``, after ``warm`` chunks run unprofiled (in which a
    window path, ``superchunk`` > 1, captures its graphs); prints the
    device-busy share of the wall time, the ops with the most device self
    time and the join-family kernels the profiler names.  ``plan`` is
    "order", "tree" or "rulebook" (the FlowSense rulebook)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import cep
    from repro_torch.core.fleet import stacked_streams

    cfg = path_config("order" if plan == "rulebook" else plan,
                      buffer_capacity=B_CAP, match_capacity=M_CAP,
                      chunk_capacity=CHUNK_CAP, device="cuda",
                      superchunk=superchunk)
    if plan == "rulebook":
        book = cep.open_rulebook(flowsense_rulebook(), partitions=K_MAIN,
                                 monitor=True, config=cfg,
                                 spare_slots=RULEBOOK_SPARE)

        def run(seg, resume):  # a rulebook's stream state always persists
            book.run(seg)
    else:
        sess = cep.open(flowsense_rule(), partitions=K_MAIN, plan=plan,
                        monitor=True, config=cfg)

        def run(seg, resume):
            sess.run(seg, resume=resume)
    chunks = list(stacked_streams(streams(K_MAIN, warm + n_chunks,
                                          BASE_RATE, CHUNK_CAP)))
    if warm:
        run(chunks[:warm], False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t = time.perf_counter()
        run(chunks[warm:], bool(warm))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    report_profile(prof, wall, n_chunks,
                   f"{plan} window" if superchunk > 1 else plan, top)


def report_profile(prof, wall, n_chunks, what, top, forbid_scans=True,
                   unit="chunks", ranges=()):
    """Prints a profiled stretch's device-busy share of the wall, the ops
    with the most device self time and the join-family kernels named;
    fails if a device-wide scan (an M*B-cell scan) shows up on a fleet
    path (``forbid_scans``).  ``ranges`` names ``record_function`` ranges,
    whose device rows repeat their kernels' time: each is printed apart.
    Returns the device-busy seconds."""
    import torch

    # Device-side rows only (kernels, copies): the op-level rows repeat
    # their kernels' device time, and so do user ranges.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    named = sorted(k for k in ("packed_kernel", "join_kernel",
                               "rowcount_kernel", "select_kernel")
                   if any(k in e.key for e in rows))
    print(f"   profiled {n_chunks} {unit} of the {what} path: wall "
          f"{wall:.3f} s, device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f}% of wall); join-family "
          f"kernels named: {named or 'none'}")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:top]:
        print(f"   device {e.self_device_time_total / 1e3:10.2f} ms  "
              f"calls {e.count:6d}  {e.key[:70]}")
    copies = [e for e in rows if "direct_copy" in e.key]
    print(f"   direct_copy kernels: "
          f"{sum(e.self_device_time_total for e in copies) / 1e3:.2f} ms "
          f"over {sum(e.count for e in copies)} calls")
    # The compaction reads the join's bit words: nothing scans M*B cells
    # (the old running count took PyTorch's device-wide scan).  With one
    # partition (K = 1) PyTorch takes the same scan for every cumsum of a
    # single row (the ingest's N events, the selection's M row counts), so
    # a single-stream path reports its scans instead.
    scans = [e for e in rows if "DeviceScan" in e.key]
    if scans and forbid_scans:
        raise AssertionError(f"device-wide scans on the {what} path: "
                             f"{[e.key for e in scans]}")
    if scans:
        print(f"   DeviceScan kernels (one-row cumsums): "
              f"{sum(e.self_device_time_total for e in scans) / 1e3:.2f} ms "
              f"over {sum(e.count for e in scans)} calls")
    for e in prof.key_averages():
        if e.key in ranges and e.device_type == \
                torch.autograd.DeviceType.CUDA:
            print(f"   range {e.key}: device {e.device_time_total / 1e3:.2f} "
                  f"ms over {e.count} calls = "
                  f"{100 * e.device_time_total / 1e6 / busy:.1f}% of device "
                  f"busy time")
    return busy


def check_oracle(device, plan="order"):
    """K=4 narrow stream on the card vs the brute-force oracle."""
    from repro_torch import cep
    from repro_torch.cep import RefEngine

    k, n_chunks, rate, cap = 4, 24, 12.0, 64
    cfg = path_config(plan, buffer_capacity=64, match_capacity=1024,
                      chunk_capacity=cap, device=device)
    pattern = flowsense_rule()
    tel = cep.open(pattern, partitions=k, plan=plan, monitor=True,
                   config=cfg).run(streams(k, n_chunks, rate, cap, seed=100))
    want = [RefEngine(pattern.build()).run(s)
            for s in streams(k, n_chunks, rate, cap, seed=100)]
    got = tel.per_partition_matches.tolist()
    if got != [r.full_matches for r in want]:
        raise AssertionError(f"oracle mismatch: {got} vs "
                             f"{[r.full_matches for r in want]}")
    if tel.neg_rejected != sum(r.neg_rejected for r in want):
        raise AssertionError("oracle neg_rejected mismatch")
    print(f"   plan={plan} K={k} b_cap=64: matches {got} == oracle, "
          "neg_rejected "
          f"{tel.neg_rejected} == oracle, replans {tel.replans}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.engine import make_spec, packed_row_count
    from repro_torch.core.multipattern import packed_rule_row_count
    from repro_torch.kernels import window_join

    t_all = time.perf_counter()
    t = phase("device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"   torch device: {kind} (count {count}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    done("device", t)

    t = phase("build")
    window_join.build()
    window_join.load_library()
    print(f"   nvcc build seconds: {window_join.BUILD_INFO['seconds']:.2f}")
    for line in str(window_join.BUILD_INFO["log"]).splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"   ptxas: {line.strip()}")
    done("build", t)

    if "--bench" in sys.argv:
        t = phase("bench")
        bench(int(sys.argv[sys.argv.index("--bench") + 1]))
        done("bench", t)
        return 0

    t = phase("kernels")
    pattern = flowsense_rule().build()
    c_packed = packed_row_count(make_spec(pattern))
    # Negation veto rows: 2 validity + 2 window + 2 order anchors.
    c_rowcount = 6
    # Tree join rows: 2 validity + 2 window + 1 order + 2 per predicate.
    c_join = 2 + 2 + 1 + 2 * len(make_spec(pattern).pred_pairs)
    records = check_kernels("cuda", c_packed, c_rowcount, c_join)
    # The rulebook's n=3 bucket: packed rows for every ordered pair, the
    # veto's six rows, K x (one rule + one spare slot) batch elements.
    check_per_batch_thresholds("cuda", packed_rule_row_count(3), 6,
                               K_MAIN * (1 + RULEBOOK_SPARE))
    # The adaptive loop's widest order and tree steps: the size-8 seq
    # pattern's packed rows, and its tree join's (2 validity + 2 window +
    # 1 order + 2 per predicate).
    seq8 = make_spec(build_pattern("seq", ADAPT_SIZE))
    single = check_single_stream_kernels(
        "cuda", packed_row_count(seq8), 2 + 2 + 1 + 2 * len(seq8.pred_pairs))
    done("kernels", t)

    launches, per_chunk = {}, {}
    for plan in ("order", "tree"):
        t = phase(f"main path, plan={plan}")
        launches[plan], *per_chunk[plan] = check_path(plan)
        done(f"main path, plan={plan}", t)

        t = phase(f"oracle, plan={plan}")
        check_oracle("cuda", plan)
        done(f"oracle, plan={plan}", t)

        t = phase(f"profile, plan={plan}")
        profile_main(plan)
        done(f"profile, plan={plan}", t)

    for plan in ("order", "tree"):
        t = phase(f"superchunk, plan={plan}")
        launches[f"superchunk-{plan}"] = check_superchunk(
            plan, *per_chunk[plan])
        done(f"superchunk, plan={plan}", t)

    t = phase("window profile, plan=order")
    profile_main("order", superchunk=SUPERCHUNK, warm=8)
    done("window profile, plan=order", t)

    t = phase("serving")
    launches["serving-step"], launches["serving-superchunk"] = \
        check_serving()
    done("serving", t)

    t = phase("rulebook")
    launches["rulebook"], launches["rulebook window"], rulebook_want = \
        check_rulebook()
    done("rulebook", t)

    t = phase("rulebook oracle")
    check_rulebook_oracle()
    done("rulebook oracle", t)

    t = phase("rulebook profile")
    profile_main("rulebook", top=8)
    done("rulebook profile", t)

    t = phase("trace memo")
    launches.update(check_trace_memo(per_chunk, rulebook_want))
    done("trace memo", t)

    t = phase("mesh")
    launches.update(check_mesh(per_chunk, rulebook_want))
    done("mesh", t)

    for planner in ("greedy", "zstream"):
        t = phase(f"adaptive loop, planner={planner}")
        launches[f"adaptive-{planner}"] = check_adaptive(planner)
        done(f"adaptive loop, planner={planner}", t)

        t = phase(f"adaptive profile, planner={planner}")
        profile_adaptive(planner)
        done(f"adaptive profile, planner={planner}", t)

    t = phase("adaptive oracle")
    check_adaptive_oracle()
    done("adaptive oracle", t)

    t = phase("monitored engine")
    check_monitored_engine()
    done("monitored engine", t)

    t = phase("scenarios")
    check_scenarios()
    done("scenarios", t)

    launches.update(check_lm_paths(smi))
    launches.update(check_lm_training(smi))
    launches.update(check_distribution(smi))
    launches.update(check_dryrun(smi))
    launches.update(check_examples(smi))

    print(f"   total seconds: {time.perf_counter() - t_all:.3f}")
    print(json.dumps({"selection_kernel": dict(
        name=SELECT, route="cuda", source=SOURCE, replaces=SELECT_REPLACES,
        launches=sum(n[SELECT] for n in launches.values()),
        launches_by_path={p: n[SELECT] for p, n in launches.items()},
        library_ms=None, single_stream=single[SELECT],
        **records[SELECT])}))
    # ``launches`` sums a kernel's launches over the paths' runs; the
    # split is in ``launches_by_path``.
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name],
                    launches=sum(n[name] for n in launches.values()),
                    launches_by_path={p: n[name]
                                      for p, n in launches.items()},
                    library_ms=None, **records[name],
                    **({"single_stream": single[name]} if name in single
                       else {}))
               for name in REPLACES]
    kernels.append(dict(
        name=SELECT, route="cuda", source=SOURCE, replaces=SELECT_REPLACES,
        launches=sum(n[SELECT] for n in launches.values()),
        launches_by_path={p: n[SELECT] for p, n in launches.items()},
        library_ms=None, single_stream=single[SELECT], **records[SELECT]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
