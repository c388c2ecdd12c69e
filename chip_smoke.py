#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device   the card (torch and ``nvidia-smi``), torch and CUDA versions;
  build    nvcc builds every kernel of ``src/repro_torch/csrc`` for sm_90a
           and ptxas must report no spills and no stack frame;
  kernels  each kernel against its plain PyTorch version on the card, at
           the paper CNN's conv1/conv2/fc shapes, B in {1, 3, 8}, in the
           number formats it sees (int8 and qformat must be bitwise for
           both conv kernels), both conv kernels also at B = 1024, at
           other shapes (stride 2 with a ragged band; a slab too wide to
           stage; for conv_window odd outputs) and at every launch shape
           of highres_cnn's 224x224 plans (B in {2, 8}), qmatmul bitwise at
           M up to 4,097, K in {37, 320, 4,099, 4,608}, N up to 300, on an
           unaligned view, with scalar scales and with K cut into slices,
           at qwen1.5-0.5b's MLP shapes (M in {1, 4, 32, 64, 256},
           (K, N) in {(1,024, 2,816), (2,816, 1,024)}, f32 and bf16 out),
           and at the MLP shapes of qwen3-14b, gemma2-2b, command-r-35b
           and internvl2-26b (M in {4, 64}, K and N up to 22,528, f32
           and bf16 out), on both sides of its body boundary
           (QMATMUL_BOUNDARY: M in {1, 7, 8, 15, 16, 17, 64, 512}), in
           its raw int32 mode at the LM mesh shard shapes, and captured
           in a CUDA graph (each body, a split K with its zeroed buffer)
           and replayed on new inputs,
           fused_cwp at odd conv maps (a 9x9 map, a 224-wide band with an
           odd row count; odd='drop' and 'pad'; B in {1, 8}), and the
           addition tree bitwise at (R, η) shapes up to its η cap that
           reach each of its paths, plus calls that must raise. Under
           int8 both conv kernels take int8 codes (the served path's
           operands) through their int8 route, counted as such, bitwise
           to the plain version and to the fp32 route on the same codes
           as fp32, at every conv shape above and at S8_SHAPES (depth off
           a multiple of 32, M off a multiple of 8, stride 2 with 2 items
           a block; B in {1, 8, 1024}), on views 1 and 3 bytes into their
           storage, and replayed from a CUDA graph. Every phase below
           counts the int8-route launches apart (``<kernel>_int8``) and
           holds each conv launch under int8 to that route, none under
           the other formats;
  serve    the launcher's CNN path and VisionEngine under qformat and int8
           on the card, every request held against the same engine on the
           CPU; each bucket is served by its CUDA graph, whose captured
           launches times its replays must match the batches served;
  open_loop  ``OpenLoopDriver`` on the card under the wall clock, through
           the normal engines under int8: VisionEngine for mnist_cnn and
           highres_cnn (224², streamed; batch 8, the bucket ladder, a CUDA
           graph a bucket) and the LM Engine for qwen1.5-0.5b at full
           width and OPEN_LOOP_LM_LAYERS layers (capacity 4, its step
           graphs). Each serves its seeded payloads closed loop
           (``run_until_drained``: the reference results and the
           throughput), then open loop at seeded Poisson arrivals of 0.5x
           and 2x that throughput (the 2x run's queue 2 x the lanes):
           every arrival submitted or shed, shed = rejected, completed =
           submitted, no shed at 0.5x and some at 2x, every result equal
           to the closed loop's for the same payload (tokens equal; int8
           logits bitwise to the closed loop of the same batch, since an
           int8 batch shares one activation scale), fused_cwp and qmatmul
           launched; then the 2x schedule under a ``VirtualClock`` on the
           card and on the CPU with the same weights (the CPU's a host
           job; the LM cut to OPEN_LOOP_REPLAY_LAYERS, since the CPU
           quantizes every int8 weight at every call): shed lists,
           dispatch order, steps and latencies equal.
           Latency p50/p99 from submit (the front-end's; an arrival that
           falls due during a step is stamped when it ends, as the
           reference stamps it) and from the scheduled arrival, goodput,
           shed and lane utilization, beside ``nvidia-smi``;
  eager    PaperCNN.forward (conv_window) against the compiled plan
           (fused_cwp) on the card, and against the CPU, in all 3 modes;
  tree     the paper-dataflow conv on the card: each conv stage's product
           matrix at B = 8 reduced by ``tree_reduce_sum`` (addtree), + bias,
           against ``conv2d_ref`` on the CPU, bitwise, in none and int8;
  stream   the 224x224 ``highres_cnn`` (VGGStyleCNN), whose first two
           blocks run as halo-overlapped row bands: at B = 8 in all 3
           modes the streamed plan against the untiled plan, a streamed
           ``fuse=False`` plan (conv_window) and the eager forward on the
           card, and against the CPU at B = 2; each plan's launches equal
           its bands (7 fused_cwp a batch, 1 qmatmul under int8); then the
           launcher (``--arch highres_cnn``) and VisionEngine under
           qformat and int8 on the card and on the CPU;
  boot     the served plans booted as the reference boots them, for
           mnist_cnn (buckets 1/2/4/8) and highres_cnn at 224x224 (B = 8)
           in all 3 modes: malformed plans refused with the CPU's
           Violation codes; autotuned plans against heuristic ones (int8
           and qformat bitwise, fp32 1e-5), with the winners and both
           kernel times; the TuningCache saved, reloaded, and a second
           boot measuring nothing; the ladder saved to an artifact store
           and a second engine booted from it (no trace/fuse/place/tune
           work, its WarmupReport and plan_source printed, logits bitwise
           to the fresh engine's); a corrupted artifact warns, boots fresh
           and serves the same logits; every graph replay bitwise to a
           direct call of its bound plan; a short batch after a full one
           bitwise to a direct call on zero pad lanes; and the device and
           wall time a batch, graph against direct call, at B = 1 and 8;
  times    per kernel and shape, the median device time of 100 launches
           at B = 8 and B = 1024, beside the plain version, one library
           call for the same function, and the card's bound; each B = 1024
           output is first held against the plain version. An empty
           kernel (``torch.cuda._sleep(0)``) timed the same way is the
           launch floor, a copy of 16 floats the floor of a kernel that
           loads and stores. Rows tagged ``highres_cnn``: every distinct
           conv launch shape of its 224x224 plans at B = 8 (fused_cwp at
           each band shape of the served plan's streamed blocks and at
           blocks 2 and 3; conv_window at the fuse=False plan's bands and
           the eager forward's blocks) and the K = 4,608 fc;
           one row tagged ``odd_pool``: fused_cwp on an odd-row 224-wide
           band under odd='pad', beside cuDNN's conv + relu + ceil-mode
           pool; rows tagged with an LM arch (qwen1.5-0.5b and the four
           dense configs above): qmatmul at its MLP matmuls' decode
           (M = 4) and prefill (M = 64) shapes, beside ``torch._int_mm``
           and the two scale multiplies where ``_int_mm`` takes the shape
           (M > 16), first checked bitwise against the plain version
           (timed a call at a time for the dense configs: it sums K in
           chunks of a 256 MiB product); rows tagged zamba2-7b: qmatmul
           at M in {4, 256, 512} x (K, N) in {(3,584, 14,336), (14,336,
           3,584)}, each first bitwise against the plain version; rows
           tagged boundary: qmatmul at qwen1.5-0.5b's wi for M in
           QMATMUL_TIME_M, both sides of its body boundary; rows
           tagged shard: the MLP shard shapes of SHARD_TIME_SHAPES
           (qwen1.5 on model 2 and 4, zamba2-7b on model 2 at M = 4 and
           512), column-parallel wi and the row-parallel wo's int32
           accumulator; a decode row (M <= 4) whose weight fits in the
           50 MB L2 also takes ``cold_ms``, over copies of its weight in
           turn that exceed twice the L2. Each conv row of the paper CNN,
           of highres_cnn and of the odd band has an int8-route row beside
           it (``route`` int8, stage tagged ``int8``): the kernel on int8
           codes, bitwise to its plain version first, its bound counting
           1-byte codes and int8 operations (the fp32 route's time at the
           shape is the fp32 row's ``ms``), and cuDNN's fp32 conv (+ relu
           + pool, TF32 off) on the codes as fp32 as the library
           yardstick; the int8 rows stay out of the kernels line's sums,
           summed there in ``int8_*`` fields of their own;
  plans    ``highres_cnn``'s whole bound plan per batch at B = 1 and 8
           under three stream budgets (untiled, the default 1 MiB,
           256 KiB): device time between CUDA events, and wall time;
  lm       qwen1.5-0.5b at full width and depth (24 layers, d_model
           1,024, vocab 151,936, bf16, random weights from seed 0). Every
           engine serves through its step graphs (``serve/graphs.py``: a
           CUDA graph a prompt length and one for the decode step, the
           weights cast once at build). The launcher (``--capacity 4
           --requests 8 --prompt-len 64 --decode-steps 16``) with a bf16
           and an int8 KV cache, then ``Engine`` under
           ``ExecPolicy(quant="int8")`` over the same requests: each
           graph captured 72 qmatmul launches (24 layers x wi, wg, wo),
           the replays launched 72 a prefill and a decode step, and the
           tokens equal the same engine's run eagerly (``graphs=False``)
           and through the plain qmatmul (``backend="torch"``); cut to
           LM_STEP_LAYERS = 6 layers at full width, the
           engine in bf16 and with an int8 KV cache, graphs against
           eager, the same tokens; the logits of a 64-token prefill and
           of a decode step over 4 full slots at their own positions,
           bitwise kernel vs plain, and bitwise graph replay vs eager in
           bf16, int8 KV and int8; a 2-layer model at full width, fp32
           and int8, card against CPU (each request's prefill logits and
           the first decode step's); the wall, busy and event time of
           that prefill and decode step, eager and as a graph replay, in
           bf16 and int8, with profiles, each graph's capture ms and
           pool bytes.
           Then qwen3-14b, gemma2-2b, command-r-35b and internvl2-26b at
           full width and 2 layers: ``Engine`` under int8, kernel against
           plain (qmatmul launches 3 x 2 a prefill and a decode step,
           tokens and a prefill's and a decode step's logits bitwise), and
           1 layer in fp32 card against CPU; and the launcher at full size
           and depth in bf16 for gemma2-2b (26 layers) and qwen3-14b (40
           layers, 14.8 B parameters, 59 GB of fp32 weights), with its
           tokens/s and the card's peak memory;
  moe      dbrx-132b (16 experts of d_ff 10,752, top-4) and
           llama4-scout-17b-a16e (16 experts of d_ff 8,192, top-1 + a
           shared expert) at full width cut to MOE_LAYERS = 2 layers,
           cast once to bf16 as the engine casts (the router stays
           fp32): ``Engine`` over the launcher's mix (8 requests, 16
           tokens each, capacity 4) through its step graphs and
           eagerly, the same tokens, the assignments dropped in each
           layer of a 64-token prefill, a decode step at capacity 4
           against each row decoded alone (within 2^-4 of 1 + max|logit|, the rows whose routing differs
           counted), the device and wall time of a 64-token prefill and of
           a decode step beside their bytes bound (every expert weight read
           once a layer), eager and as a graph replay with the logits
           bitwise between them, with a torch.profiler breakdown; then one
           ``moe_apply`` at full dbrx width in fp32, card against CPU
           (every assignment clear of a 1e-5 near-tie with the same expert
           and keep, those tokens within 1e-4 of 1 + max|out|, aux within
           1e-6). No kernel launches in the whole phase: the reference's
           MoE reaches no Pallas kernel;
  ssm      the sub-quadratic LMs, prompts a whole number of their scan
           chunks. zamba2-7b (the Mamba2 hybrid: d_model 3,584, one
           shared attention + MLP block after every 6 layers, bf16) at
           full width cut to 7 of its 81 layers (SSM_STEP_LAYERS):
           ``Engine`` under int8 over the launcher's mix at
           ``--prompt-len 512`` through its step graphs and eagerly, the
           same tokens (3 qmatmul launches in each graph, replayed a
           prefill and a decode step: the shared MLP's 3 at its one
           call), the device and wall time of a 512-token prefill and
           of a decode step at capacity 4 in bf16, eager and as a graph
           replay with the logits bitwise between them, beside their
           bytes bound (every weight once, as the engine stores it) with
           a torch.profiler breakdown, a ragged prompt raising; the
           launcher at full size (81 layers, 6.66 B parameters) with a
           bf16 and an int8 KV cache (tokens/s, peak memory); cut to 6
           layers (one group), the int8 engine's tokens and a 512-token
           prefill's and a 4-slot decode step's logits bitwise kernel vs
           plain, and a 256-token prefill's and the first decode step's
           logits card vs CPU in fp32 and int8. rwkv6-1.6b (d_model
           2,048): at full width cut to 4 of its 24 layers, ``Engine``
           in bf16 graphs against eager, the same times, a ragged prompt;
           the launcher at full size at ``--prompt-len 128`` (bf16 and
           int8 KV), then 2 layers fp32 card vs CPU; no kernel launches
           (the reference's RWKV reaches no Pallas kernel).
  train    (a) the paper's MNIST experiment at the reference's defaults
           (300 steps, B = 128), each step a replay of one train graph
           holding 2 conv_window launches (600 replayed), float32
           accuracy above 0.9, the step-0 conv outputs and gradients and
           an evaluation batch's logits kernel vs plain; (b) qwen1.5-0.5b
           at full width cut to TRAIN_LAYERS layers through the training
           launcher's train graph (``--layers``): 20
           steps, a kill after the step-10 checkpoint and a resume whose
           losses are bitwise, ``--microbatches 2``, and ``--eager``
           whose first 5 losses equal the graph run's bitwise; its step
           (the same cut) eager and as a replay (wall, busy, event ms,
           capture, pool);
           (c) seamless-m4t-medium served and trained eagerly; (d) a loss
           and backward of four more archs; a card-vs-CPU loss.
  launch   the launch tooling: (a) the dry run of every (arch x shape)
           at full size on the meta device (``launch/dryrun.py``),
           LAUNCH_JOBS cells at a time in worker processes, each cell's
           JSON under reports/dryrun_torch/: no cell in error, exactly
           the 8 long_500k cells of the full-attention archs skipped
           with the reference's reason; (b) qwen1.5-0.5b's compiled
           steps at full size (the engine's decode graph at capacity 4
           and its 64-token prefill graph, in bf16 and under int8, the
           launcher's train graph at B = 8 x 128), each the median
           of 20 replays between CUDA events beside the same step
           counted on meta: FLOPs by dtype, bytes, the roofline's terms,
           mfu and bound_share (at most 1.05), and the int8 decode's 72
           qmatmul calls, each priced by its shape; (c) the eager int8
           decode step's top 5 ops by counted bytes beside
           torch.profiler's top 5 kernels by device time; (d) the train
           step's predicted peak within 0.5 to 2x of the eager step's
           ``max_memory_allocated``. The whole report goes to
           build/chip_smoke_launch.json.
  mesh     channel parallelism on the one card: an NCCL world of 1
           (mesh (1, 1)) whose VisionEngine serves mnist_cnn in all 3
           modes through its graphs, bitwise to the engine without a
           mesh; then gloo worlds of 2 and 4 ranks sharing cuda:0
           (meshes (1, 2), (1, 4), (2, 2), ``run_spmd``, the three at
           once), each rank
           running mnist_cnn and highres_cnn (224²) placed plans (auto,
           forced ``input`` and ``output``, 3 modes, lattice and random
           data, B = 8) against the unsharded plan (int8 and the lattice
           bitwise but highres ``none``; fp32 rtol 1e-5, atol 1e-6 of
           the largest |logit|; qformat one Q8.8 step), a VisionEngine
           serving eagerly (``graphs: off (gloo)``), every per-shard
           launch shape against its plain version, the per-rank batch
           walls with each collective's share (every rank time-shares
           the card: no scaling evidence), weight bytes a rank; the
           ranks' launches return to the parent; then highres_cnn's
           OCP shards against the whole stage pinned to the shard's
           ``split`` (why fp32 OCP is not bitwise on the card); then the
           per-shard shapes timed alone.
  lm_mesh  qwen1.5-0.5b at full width cut to LM_MESH_SERVE_LAYERS = 4
           layers over a (data, model) mesh of
           DTensors (``repro_torch.sharding``): an NCCL world of 1, mesh
           (1, 1), whose Engine serves 4 of the launcher's requests (4
           new tokens, capacity 4) in bf16 and under int8 through its
           step graphs, tokens and a prefill's and a 4-slot decode
           step's logits bitwise to the engine without a mesh; then
           gloo worlds of 2 and 4 ranks sharing cuda:0 (meshes (1, 2)
           and (2, 2), ``run_spmd``, the two at once, host-staged
           ``StagedGroup``s), each
           rank's Engine serving eagerly (``graphs: off (gloo)``) the
           same requests: int8 tokens and logits bitwise to the
           unsharded int8 engine, qmatmul launched 12 a step on every
           rank, bf16 logits within 2^-4 of 1 + max|logit|; every shard
           launch shape of qmatmul (and its int32-accumulator mode)
           bitwise to its plain version; the step wall and each
           collective's calls, bytes and host seconds per rank; the
           serve launcher (1 x 2, full size) and the train launcher
           (2 x 2, full width cut to LM_MESH_TRAIN_LAYERS layers, then
           again on its checkpoint: the restore onto the mesh's
           shardings and one more step) inside the worlds, printing
           their mesh;
           the model at full width cut to LM_MESH_TRAIN_LAYERS layers in
           fp32 trained LM_MESH_TRAIN_STEPS steps at 8 x 128 against the
           single-rank run (losses rtol 1e-5, params rtol 2e-4 / atol
           2e-5), and on 2 x 2 a checkpoint restored onto (1, 2)
           bitwise. The multi-pod mesh beside them: NCCL world 1 also
           on (pod, data, model) = (1, 1, 1), bitwise to no mesh; gloo
           worlds of 4 ranks on (2, 1, 2) and (2, 2, 1) (LM_POD_WORLDS,
           run with the two above) serving LM_POD_CAPACITY requests at
           capacity LM_POD_CAPACITY, so that every (pod, data) rank
           holds live slots (checked on each rank)
           (int8 tokens and logits bitwise to the unsharded engine at
           that capacity, qmatmul 12 a step at every rank's shard
           shapes, each bitwise to its plain version; bf16 within 2^-4),
           the same training, and one step through
           ``cross_pod_grad_reduce`` (bf16; each pod's gradients on its
           half of the batch over its own (data, model) mesh) against
           the single-rank run of the same arithmetic.
  family_mesh  the other LM families over a (data, model) mesh: an NCCL
           world of 1, mesh (1, 1), whose Engine serves dbrx-132b and
           llama4-scout (full width, MOE_LAYERS layers, bf16; their layer
           is the expert-parallel one on any mesh with a ``model``
           axis), zamba2-7b (6 layers, int8) and rwkv6-1.6b (2 layers)
           through its step graphs, against the engine without a mesh
           (tokens equal, logits bitwise); then gloo worlds of 2 ranks
           (mesh (1, 2): dbrx, llama4-scout, zamba2 under int8, rwkv6,
           seamless-m4t-medium at full size) and 4 ranks (dbrx on
           (1, 4), and at 1 layer on (2, 2), where the batch splits into
           dispatch groups and the aux loss is averaged over ``data``)
           sharing cuda:0 (each world's weights drawn once in this
           process and shared with its ranks through CUDA IPC), each rank
           a prefill of FAMILY_BATCH prompts and FAMILY_STEPS greedy
           decode steps (FAMILY_STEPS_DATA on (2, 2)) on DTensors. zamba2, rwkv6 and seamless are fed the
           one-device loop's tokens and held against its logits: zamba2's
           prefill bitwise, its decode steps within FAMILY_DECODE_ULPS
           bf16 ulps of max|logit|, its tokens equal, qmatmul launched 3
           a shared-block call a step on every rank at its shard shapes,
           each shape bitwise to the plain qmatmul; the others within
           2^-4 of 1 + max|logit|. The MoE archs run on their own tokens
           with their routing recorded (``moe.routing_trace``); after
           the world, ``moe_apply_ep_ref`` at the mesh's shape replays
           that routing, fed those tokens: every row's logits within
           2^-4 of 1 + max|logit| at every step, every dispatch's keep
           mask equal, a token apart only at a near-tie of the
           reference's logits, an expert apart from the reference's own
           routing only within FAMILY_ROUTER_GAP of its k-th router
           logit. Beside each: the MoE layers' owned and dropped
           assignments a rank, the collectives' calls, bytes and host
           seconds; zamba2's (FAMILY_COUNTED) also counted on the meta
           device as rank 0 over a fake process group (the mesh dry
           run's counter), equal call for call and byte for byte.
  mesh_dryrun  the mesh dry run (``launch/dryrun.py``) of every (arch x
           shape) at full size on the meta device as rank 0 of
           pod16x16 and pod2x16x16 over a fake process group, in
           MESH_SWEEP_WORKERS host workers from the script's start: no
           cell in error, exactly the 8 long_500k cells of the
           full-attention archs skipped on each mesh, collectives
           counted in every ok cell; one compact line a (mesh, arch).
  analysis the port's static gate, ``python -m repro_torch.analysis
           --root <repo>`` in a subprocess on this machine's Python: exit
           0, the summary ``0 finding(s)`` (every lint rule over
           ``src/repro_torch`` and this script) and ``verify <plan>: ok``
           for ANALYSIS_PLANS; its seconds. It launches nothing.

The card-vs-CPU checks' CPU sides (the open_loop replays' too), the
dry-run sweep, the mesh dry run's sweep and zamba2's count run in worker
processes started with the script (``start_host_jobs``), the static gate in a subprocess beside
them, and the train
launchers start before the mesh phase, beside the card's phases; each
is taken where its phase needs it.

Then one compact line a model of step times (eager and graph wall, busy
and event ms; capture ms and pool MiB), the launch phase's compact lines
(one an arch of the dry run, the sweep's seconds, one a measured
roofline, the train peak), one line an open-loop run (its latencies,
goodput, shed and lane utilization beside ``nvidia-smi``), the kernels
line (one JSON
object; its times are the paper CNN's served batch at B = 8, its
launches the wrapper launches of the serve, open_loop, eager, tree and
stream phases, of the boot phase, of the lm phase's int8 engine runs
(qwen1.5-0.5b and the four dense configs), of the moe phase (none), of
the ssm phase's int8 zamba2 engine runs through the kernel, of the
train phase's MNIST run, of the launch phase's int8 engine and of the
mesh phase's NCCL world-1 engines on a mesh and placed plans on every
rank, of the lm_mesh phase's world-1 mesh engines and every gloo
rank's serving runs, and of the family_mesh phase's world-1 mesh
engines and every gloo rank's loops, each counted from 0 just before
it; a CUDA
graph's kernels are counted at its warm-up and at its capture, and its
replays by the graph; the lm phase's card-vs-CPU models and its
kernel-vs-plain comparisons are left out), the card's ``nvidia-smi``
name and power limit, and as the last line
``{"ok": true, "device": ...}``. ``--phases boot,kernels`` runs only the
named phases (after device and build) and prints no result.
Any failed check exits non-zero before that line. Without a GPU, or
without the repository beside it, the script exits non-zero and prints
no result. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet (NVIDIA), dense: fp32 on CUDA cores, int8 tensor
# cores, HBM3 bandwidth. Rates assume the full 700 W power limit.
PEAK_FP32 = 67e12
PEAK_FP32_ADD = PEAK_FP32 / 2   # an add is one of an FMA's two operations
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

# every kernel of the port: source, TPU kernel replaced. fused_cwp runs
# every fused stage and every band of a streamed one; conv_window the
# eager forwards and fuse=False plans (bands too); qmatmul the int8 fc;
# addtree the tree_reduce_sum family
KERNELS = {
    "fused_cwp": ("src/repro_torch/csrc/fused_cwp.cu",
                  "src/repro/kernels/fused_cwp/kernel.py:47"),
    "conv_window": ("src/repro_torch/csrc/conv_window.cu",
                    "src/repro/kernels/conv_window/kernel.py:46"),
    "qmatmul": ("src/repro_torch/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul/kernel.py:25"),
    "addtree": ("src/repro_torch/csrc/addtree.cu",
                "src/repro/kernels/addtree/kernel.py:21"),
}
# the paper CNN's stage shapes: (N, H, W, M, K) per conv, (K, N) for fc
CONV1 = (1, 28, 28, 15, 3)
CONV2 = (15, 13, 13, 20, 6)
FC = (320, 10)
# addtree (R, η): prime R = 509, one row, η = 1, up to the η cap (appended
# in phase_kernels)
TREE_SHAPES = [(1, 1), (4, 9), (8, 1), (96, 7), (100, 37), (509, 144),
               (1024, 37), (16, 256), (64, 540), (64, 1350),
               # the kernel's paths: η either side of its short-row
               # threshold (32), R off a multiple of a block's rows (256
               # short, 16 or 8 long), and the product matrices at B = 8
               (257, 9), (300, 32), (13, 33), (9, 16), (13, 540),
               (81_120, 9), (10_240, 540),
               # over 16,896 rows: a whole warp a row
               (20_000, 37), (20_000, 540)]
# fused_cwp beyond the paper's shapes: (N, H, W, M, K), stride, tiling
FUSED_SHAPES = {
    "stride2_ragged_band": ((3, 33, 41, 5, 3), (2, 2),
                            {"fused_conv_block.band": 3}),
    "unstaged": ((64, 6, 230, 6, 3), (1, 1), {}),
}
# conv_window beyond the paper's shapes, each with an odd output: a 5x5
# kernel on conv2's input (9x9), stride 2 (17x21) with a band of 3 tile
# rows over 9, and a slab too wide to stage (5x229)
CONV_SHAPES = {
    "odd_output": ((15, 13, 13, 20, 5), (1, 1), {}),
    "stride2_ragged_band": ((3, 35, 43, 5, 3), (2, 2), {"conv2d.band": 3}),
    "unstaged": ((64, 7, 231, 6, 3), (1, 1), {}),
}
# fused_cwp at odd conv maps (N, H, W, M, K): a 5x5 kernel on conv2's
# 13x13 input (a 9x9 map) and a 224-wide band with an odd row count
# (91x220)
ODD_POOL_SHAPES = {"9x9": (15, 13, 13, 20, 5), "band": (3, 95, 224, 8, 5)}
# the conv kernels' int8 route at its edges, (N, H, W, M, K), stride and
# launch keys: depth off a multiple of 32 (5 x 7 x 7 = 245) with M = 13
# (off a multiple of 8) and 24 output channels a block; stride 2 on an
# odd map with 3-row items, 2 a block; a 2 x 2 kernel (Kw padded to 4)
# over 9 channels at 32 channels a block
S8_SHAPES = {
    "eta245 M13": ((5, 17, 19, 13, 7), (1, 1), {"cpb": 24}),
    "stride2 items": ((3, 35, 43, 5, 3), (2, 2), {"band": 3, "items": 2}),
    "k2 cpb32": ((9, 12, 14, 40, 2), (1, 1), {"cpb": 32}),
}
# qmatmul (M, K, N), tiling overrides: K in {37, 320, 4099} (4099 and 37
# are not word multiples), N from 1 to 300, M from 1 to 4097; the
# tensor-core body on a ragged shape with K split in 128-byte slices, and
# the streaming body with K split in 100-row slices
QMATMUL_SHAPES = [((1, 37, 1), {}), ((8, 320, 10), {}),
                  ((1000, 4099, 33), {}), ((4097, 320, 300), {}),
                  ((8, 4099, 300), {}), ((4097, 37, 10), {}),
                  ((64, 4099, 33), {"qmatmul.body": 1,
                                    "qmatmul.tile_m": 128,
                                    "qmatmul.ksplit": 128}),
                  ((67, 4099, 300), {"qmatmul.body": 0,
                                     "qmatmul.ksplit": 100})]
# both sides of qmatmul's body boundary (tensor-core tiles from M = 8 at
# N >= 64; M = 16 the boundary's first estimate): each M against (K, N)
# pairs that cover K in {37, 320, 4,099, 14,336} and N in {10, 16, 1,408,
# 3,584}
QMATMUL_BOUNDARY = [(m, k, n) for m in (1, 7, 8, 15, 16, 17, 64, 512)
                    for k, n in ((37, 3584), (320, 1408), (4099, 16),
                                 (14336, 10), (14336, 3584))]
# the times phase's rows on both sides of the body boundary, at
# qwen1.5-0.5b's wi (1,024 x 2,816)
QMATMUL_TIME_M = (1, 7, 8, 12, 15, 16, 17)
# qmatmul_acc (the raw int32 accumulator) at the LM mesh shard shapes:
# qwen1.5-0.5b's row-parallel wo on model 2 and 4 at a decode step, a
# 32-token and a 64-token prefill, and zamba2-7b's on model 2 at 4 and 512
QMATMUL_ACC_SHAPES = [(4, 1408, 1024), (2, 2816, 1024), (32, 1408, 1024),
                      (64, 704, 1024), (4, 7168, 3584), (512, 7168, 3584)]
# qmatmul at qwen1.5-0.5b's MLP shapes: M = a prefill's prompt length or
# the decode batch (every slot), (K, N) = wi/wg (1,024, 2,816) and wo
# (2,816, 1,024)
LM_QMATMUL_SHAPES = [(m, k, n) for m in (1, 4, 32, 64, 256)
                     for k, n in ((1024, 2816), (2816, 1024))]
# the lm phase: the launcher's workload on the full-size model
LM_ARCH = "qwen1.5-0.5b"
LM_ARGV = ["--arch", LM_ARCH, "--capacity", "4", "--requests", "8",
           "--prompt-len", "64", "--decode-steps", "16"]
# the dense configs served at full width and 2 layers under int8 in the
# lm phase (each MLP matmul a qmatmul launch at its (K, N)), and the two
# the launcher also serves at full size and depth in bf16
LM_DENSE_ARCHS = ["qwen3-14b", "gemma2-2b", "command-r-35b",
                  "internvl2-26b"]
LM_DENSE_LAYERS = 2
LM_FULL_ARCHS = ["gemma2-2b", "qwen3-14b"]
# qwen1.5's graph-vs-eager engines, kernel-vs-plain logits and step times
# at full width cut to LM_STEP_LAYERS layers (from 24, to keep the script
# in its time; the int8 engine and the launchers serve all 24)
LM_STEP_LAYERS = 6
# the open_loop phase: each engine (VisionEngine for mnist_cnn and
# highres_cnn at OPEN_LOOP_BATCH, the LM Engine for qwen1.5-0.5b at
# OPEN_LOOP_CAPACITY, cut to OPEN_LOOP_LM_LAYERS, all int8) serves its
# payloads closed loop, then open loop at seeded Poisson arrival rates of
# OPEN_LOOP_LOADS times that throughput; prompt lengths are a few, since
# the engine captures a prefill graph a length. 32 prompts, not 16: with 4
# requests in flight, the 2x run's queue of 8 fills only once arrivals
# outrun service by 12, which 16 arrivals at twice the closed loop's rate
# seldom do
OPEN_LOOP_IMAGES = 64
OPEN_LOOP_PROMPTS = 32
OPEN_LOOP_PROMPT_LENS = (16, 32, 48, 64)
OPEN_LOOP_NEW = (8, 32)
OPEN_LOOP_LOADS = (0.5, 2.0)
OPEN_LOOP_BATCH = 8
OPEN_LOOP_CAPACITY = 4
OPEN_LOOP_LM_LAYERS = 24
# the LM's virtual replays (card and CPU, the same weights) at full width
# cut to this depth: the CPU's int8 path quantizes every weight at every
# call, and with the CPU replay at 24 layers the LM's part of the phase
# took 682 s on an H100 machine; no scheduling decision depends on depth
# (a request ends at its max_new_tokens: the engine has no eos token)
OPEN_LOOP_REPLAY_LAYERS = 1
OPEN_LOOP_MAX_STEPS = 100_000
OPEN_LOOP_KEYS = ("offered_rps", "shed", "latency_p50_s", "latency_p99_s",
                  "sched_latency_p50_s", "sched_latency_p99_s",
                  "goodput_rps", "lane_utilization")
# the card's virtual replays, held against the CPU's by
# open_loop_replays_held; the compact lines printed after LAUNCH_LINES
OPEN_LOOP_CARD: dict = {}
OPEN_LOOP_LINES: list[dict] = []
# the moe phase: both MoE models at full width cut to MOE_LAYERS layers
# (deeper cuts fit the card, 3 and 4 layers, but not the script's time)
MOE_ARCHS = ["dbrx-132b", "llama4-scout-17b-a16e"]
MOE_LAYERS = 2
# the ssm phase: the two sub-quadratic LMs, each served at a prompt
# length whose half is a whole number of its scan chunks (zamba2's SSD
# chunk is 256 tokens, rwkv6's WKV chunk 64). zamba2 cut to 6 layers (one
# group: 6 Mamba2 layers and a shared-block call) for its kernel-vs-plain
# checks, where the plain qmatmul at M = 512 costs ~0.1 s a call, and for
# card against CPU (cut from 13 and 7); rwkv6 to 2 for the latter. The
# engines, step times and ragged prompts at full width cut to
# SSM_STEP_LAYERS (zamba2 7 layers: a shared-block call and a tail layer;
# cut from 81, then 27, and rwkv6 from 24, then 12); the launchers serve
# full size.
# Each cut keeps the script in its time
SSM_PROMPT = {"zamba2-7b": 512, "rwkv6-1.6b": 128}
SSM_PLAIN_LAYERS = 6
SSM_STEP_LAYERS = {"zamba2-7b": 7, "rwkv6-1.6b": 4}
SSM_CPU_LAYERS = {"zamba2-7b": 6, "rwkv6-1.6b": 2}
# the train phase: the launcher trains qwen1.5-0.5b at full width cut to
# TRAIN_LAYERS of its 24 layers (cut from 24 to 6, then to 2, to keep the
# script in its time), is killed after its step-10
# checkpoint and resumes; the loss and backward alone (no optimizer:
# weights + gradients) of four more archs at full width and the least
# depth that reaches every block kind, on a (2, 256) token batch (whole
# SSD and WKV chunks)
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_LAYERS = 2
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--layers", str(TRAIN_LAYERS),
              "--steps", "20", "--global-batch", "8", "--seq", "128",
              "--ckpt-every", "10"]
TRAIN_KILL_AT = 10
TRAIN_EAGER_STEPS = 5       # the launcher's eager steps held to the graph's
TRAIN_BWD_ARCHS = {"gemma2-2b": 2, "dbrx-132b": 1, "zamba2-7b": 7,
                   "rwkv6-1.6b": 2}
TRAIN_BWD_BATCH = (2, 256)
# kernel vs plain gradients, relative to 1 + max|g|: fp32 sums in
# another order (the kernel's forward, cuDNN's backward vs im2col)
TOL_GRAD = 1e-5
# the bf16 dense tensor-core peak (H100 SXM data sheet), for the train
# step's operations bound
PEAK_BF16 = 989e12
# a whole bf16 model, relative to 1 + max|logit| (tests/test_torch_lm.py's
# TOL_BF16): a decode step's rows served together against each alone
TOL_BF16 = 2.0 ** -4
# card vs CPU on a 2-layer, full-width fp32 model, relative to
# 1 + max|logit|: fp32 sums in another order (MKL vs cuBLAS, ~1e-6 an
# op), and under int8 an activation code that lands on the other side
# of a rounding boundary moves one product by a quantization step
TOL_LM = {"none": 1e-4, "int8": 2e-2}
# fp32 sums in another order than the plain version's matmul; |y| is
# O(10) here and the reference itself moves by 3.8e-6 between orders
TOL_FP32 = 1e-5
QSTEP = 2.0 ** -8               # one Q8.8 lattice step
MODES = ("none", "qformat", "int8")
# highres_cnn's stream budgets timed in the plans phase (None = the
# default 1 MiB)
PLAN_BUDGETS = {"untiled": 1 << 40, "1MiB": None, "256KiB": 256 * 1024}
# the launch phase: the dry run's cells LAUNCH_JOBS at a time in worker
# processes, one a host core (the sweep is CPU work: ~140 s serially); each compiled step
# timed over LAUNCH_REPLAYS replays; a step's roofline time may not pass
# its measured wall by more than LAUNCH_BOUND_SHARE_MAX (5% for the
# event timing's noise), and the train step's predicted peak must lie
# within LAUNCH_PEAK_RATIO of the measured one
LAUNCH_JOBS = 8
LAUNCH_REPLAYS = 20
LAUNCH_BOUND_SHARE_MAX = 1.05
LAUNCH_PEAK_RATIO = (0.5, 2.0)
# the launch phase's compact lines, printed after STEP_LINES
LAUNCH_LINES: list[dict] = []
# the mesh phase: gloo worlds of ranks sharing cuda:0, mesh shape ->
# world; the models at full width, B = 8, the overrides run; the CPU
# tests' fp32 bar (rtol, atol of the largest |logit|); batches timed a
# rank; the per-shard shapes timed alone: (label, kernel, (N, H, W, M, K))
MESH_WORLDS = {(1, 2): 2, (1, 4): 4, (2, 2): 4}
MESH_ARCHS = ("mnist_cnn", "highres_cnn")
MESH_OVERRIDES = (None, "input", "output")
MESH_BATCH = 8
MESH_RTOL, MESH_ATOL = 1e-5, 1e-6
MESH_TIMED = 5
MESH_TIMEOUT_S = 600
MESH_TIMED_SHAPES = [
    ("highres_cnn block0 ocp4", "fused_cwp", (3, 224, 224, 2, 5)),
    ("highres_cnn block1 icp2xocp2", "conv_window", (4, 110, 110, 8, 3)),
    ("mnist_cnn conv2 ocp4", "fused_cwp", (15, 13, 13, 5, 6)),
]


# the lm_mesh phase: qwen1.5-0.5b over gloo worlds of ranks sharing
# cuda:0, mesh shape -> world; its engines at full width cut to
# LM_MESH_SERVE_LAYERS layers (from 24, to keep the script in its time;
# the serve launcher in the 1 x 2 world serves all 24), the launcher's
# first LM_MESH_REQUESTS prompts, LM_MESH_NEW tokens each at capacity 4;
# training: the model at full width cut to LM_MESH_TRAIN_LAYERS layers in
# fp32, LM_MESH_TRAIN_STEPS steps at (B, S) = LM_MESH_TRAIN_BATCH
LM_MESH_WORLDS = {(1, 2): 2, (2, 2): 4}
LM_MESH_SERVE_LAYERS = 4
LM_MESH_REQUESTS = 4
LM_MESH_NEW = 4
LM_MESH_TRAIN_LAYERS = 2
LM_MESH_TRAIN_STEPS = 2
LM_MESH_TRAIN_BATCH = (8, 128)
LM_MESH_TIMEOUT_S = 900
# the multi-pod worlds of the lm_mesh phase: gloo worlds of 4 ranks on
# cuda:0 over (pod, data, model), run beside LM_MESH_WORLDS; their
# engines at capacity LM_POD_CAPACITY (two slots a rank where pod x data
# is 4) over the launcher's first LM_POD_CAPACITY prompts, every slot live
# (the scheduler fills slots from 0: fewer requests would leave pod 1's
# ranks only empty slots), the same training, then one step
# through cross_pod_grad_reduce (bf16), each pod's gradients taken on its
# half of the batch over its own (data, model) mesh
LM_POD_WORLDS = {(2, 1, 2): 4, (2, 2, 1): 4}
LM_POD_CAPACITY = 8
POD_AXES = ("pod", "data", "model")
# the mesh dry run (launch/dryrun.py) over the grid at both production
# meshes, MESH_SWEEP_WORKERS cells at a time in host workers started with
# the script, the train cells first (the longest)
MESH_SWEEP_WORKERS = 3

# the family_mesh phase: the other LM families over a (data, model) mesh.
# NCCL world 1 (mesh (1, 1)): arch -> (layers, quant, prompt length) at
# full width, each Engine through its step graphs against the engine
# without a mesh; gloo worlds of ranks sharing cuda:0: world -> [(arch,
# layers (None: full depth), mesh shape)], each a prefill of FAMILY_BATCH
# prompts and FAMILY_STEPS greedy decode steps on DTensors, against the
# same loop on one device (the MoE archs first on their own tokens, then
# the one-device expert-parallel arithmetic at the mesh's shape fed those
# tokens, replaying the mesh's routing); seamless-m4t-medium's
# FAMILY_FRAMES encoder frames
FAMILY_WORLD1 = {"dbrx-132b": (MOE_LAYERS, "none", 64),
                 "llama4-scout-17b-a16e": (MOE_LAYERS, "none", 64),
                 "zamba2-7b": (SSM_PLAIN_LAYERS, "int8", 512),
                 "rwkv6-1.6b": (2, "none", 128)}
FAMILY_GLOO = {2: [("dbrx-132b", MOE_LAYERS, (1, 2)),
                   ("llama4-scout-17b-a16e", MOE_LAYERS, (1, 2)),
                   ("zamba2-7b", SSM_PLAIN_LAYERS, (1, 2)),
                   ("rwkv6-1.6b", 2, (1, 2)),
                   ("seamless-m4t-medium", None, (1, 2))],
               4: [("dbrx-132b", MOE_LAYERS, (1, 4)),
                   ("dbrx-132b", 1, (2, 2))]}
FAMILY_PROMPT = {"zamba2-7b": 512, "rwkv6-1.6b": 128}
FAMILY_BATCH = 4
FAMILY_STEPS = 3
# on a mesh with a data axis (dbrx on 2 x 2) one decode step: each step
# gathers the experts over data, 2.3 GB a step through host memory
FAMILY_STEPS_DATA = 1
FAMILY_FRAMES = 128
# zamba2-7b under int8 on a gloo mesh: each decode step's logits within
# this many bf16 ulps of max|logit| of one device's (its bf16 attention
# projections at M = 4 on half the heads round once otherwise: cuBLAS
# splits K, scripts/colpar_bitwise.py); the prefill bitwise
FAMILY_DECODE_ULPS = 4
# an MoE job on a gloo mesh: an expert the mesh took where the one-device
# reference's own routing took another lies this close (router logits)
# below the reference's k-th choice: bf16 noise at a near-tie
FAMILY_ROUTER_GAP = 2.0 ** -4
FAMILY_TIMEOUT_S = 600
# the family_mesh jobs whose collectives are also counted on the meta
# device (the mesh dry run's counter) and held equal to the measured
# the plans ``python -m repro_torch.analysis`` compiles and verifies
ANALYSIS_PLANS = ("mnist_cnn[none]", "mnist_cnn[qformat]", "mnist_cnn[int8]",
                  "highres_cnn[streamed]")
ANALYSIS_TIMEOUT_S = 300
FAMILY_COUNTED = [("zamba2-7b", SSM_PLAIN_LAYERS, (1, 2))]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ helpers

def kernel_modules():
    import repro_torch.kernels.addtree.ops as at
    import repro_torch.kernels.conv_window.ops as cw
    import repro_torch.kernels.fused_cwp.ops as fc
    import repro_torch.kernels.qmatmul.ops as qm
    return {"fused_cwp": fc, "conv_window": cw, "qmatmul": qm, "addtree": at}


def plain_policy(**kw):
    """The plain ``torch`` backend, pinned: the plain side of a
    kernel-vs-plain check on the same device."""
    from repro_torch.ops import ExecPolicy
    return ExecPolicy(
        backend="torch",  # lint: disable=backend-literal (a check's plain side)
        **kw)


# the conv kernels' int8-route launches, counted apart beside each
# kernel's total (which counts both routes)
INT8_ROUTES = ("fused_cwp", "conv_window")


def reset_counts() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0
    for name in INT8_ROUTES:
        kernel_modules()[name].launches_int8 = 0


def counts() -> dict[str, int]:
    """Every kernel's launches, and ``<kernel>_int8`` the int8-route
    launches of the two conv kernels (included in the kernel's own)."""
    mods = kernel_modules()
    out = {k: mod.launches for k, mod in mods.items()}
    out.update({f"{k}_int8": mods[k].launches_int8 for k in INT8_ROUTES})
    return out


def int8_routes_held(label: str, mode: str, grew: dict) -> None:
    """Under int8 every conv launch in ``grew`` took the kernels' int8
    route (no conv call cast its codes to fp32); under the other formats
    none did."""
    for k in INT8_ROUTES:
        want = grew[k] if mode == "int8" else 0
        check(grew[f"{k}_int8"] == want,
              f"{label}: {grew[f'{k}_int8']} of {grew[k]} {k} launches "
              f"took the int8 route under {mode}, expected {want}")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bitwise(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def conv_inputs(gen, bsz, stage, mode, device, codes: bool = False):
    """(x, w, b, scale) for one conv stage in one number format; under
    int8 the codes as fp32 (``split_requant``), or with ``codes`` as the
    int8 codes the served path hands the kernels (``split_int8``)."""
    import torch
    from repro_torch.core.quantize import QFormat
    from repro_torch.ops.impls import (quantize_conv_int8, split_int8,
                                       split_requant)
    n, h, w_, m, k = stage
    x = torch.randn((bsz, n, h, w_), generator=gen)
    w = torch.randn((m, n, k, k), generator=gen) * (n * k * k) ** -0.5
    b = torch.randn((m,), generator=gen) * 0.1
    scale = None
    if mode == "qformat":
        q = QFormat()
        x, w, b = q.quantize(x), q.quantize(w), q.quantize(b)
    elif mode == "int8":
        split = split_int8 if codes else split_requant
        x, w, scale = split(*quantize_conv_int8(x, w))
    return tuple(None if t is None else t.to(device) for t in (x, w, b, scale))


def qmatmul_inputs(gen, m, k, n, device):
    """Random int8 codes over the full range and positive f32 scales."""
    import torch
    xc = torch.randint(-128, 128, (m, k), generator=gen, dtype=torch.int8)
    wc = torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int8)
    xs = torch.rand((m, 1), generator=gen) * 0.05
    ws = torch.rand((1, n), generator=gen) * 0.05
    return tuple(t.to(device) for t in (xc, wc, xs, ws))


def qmatmul_inputs_on(device, seed, m, k, n):
    """``qmatmul_inputs`` drawn on the card by a generator of its own:
    the large-K shapes' int8 weights (up to 185 M codes) in no time."""
    import torch
    g = torch.Generator(device).manual_seed(seed)
    xc = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8,
                       device=device)
    wc = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8,
                       device=device)
    xs = torch.rand((m, 1), generator=g, device=device) * 0.05
    ws = torch.rand((1, n), generator=g, device=device) * 0.05
    return xc, wc, xs, ws


def dense_qmatmul_shapes() -> list[tuple[str, int, int]]:
    """(arch, K, N) of each LM_DENSE_ARCHS config's MLP matmuls under
    int8: wi and wg (d_model, d_ff), wo (d_ff, d_model)."""
    from repro_torch.configs import get_arch
    out = []
    for arch in LM_DENSE_ARCHS:
        c = get_arch(arch).model().cfg
        out += [(arch, c.d_model, c.d_ff), (arch, c.d_ff, c.d_model)]
    return out


def free_card() -> None:
    """Return what the dropped models held to the card before the next
    full-width one is drawn."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def fc_inputs(gen, bsz, device, fc=FC):
    """int8 fc operands of an (K, N) = ``fc`` layer: per-row x codes,
    per-column w codes, and their scales."""
    import torch
    from repro_torch.core.quantize import quantize_int8
    xq = quantize_int8(torch.randn((bsz, fc[0]), generator=gen), axis=-1)
    wq = quantize_int8(torch.randn(fc, generator=gen) * fc[0] ** -0.5, axis=0)
    return tuple(t.to(device) for t in (xq.codes, wq.codes, xq.scale,
                                        wq.scale))


def to_device(params, device):
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return params.to(device)


def launch_shapes(plan) -> list[tuple[str, str, tuple]]:
    """(kernel, stage, (N, H, W, M, K)) of every conv launch one batch of
    ``plan`` makes: one a band of a streamed stage, else one a stage."""
    from repro_torch.core.window import pool_output_size
    from repro_torch.graph.ir import Conv2DNode, FusedConvBlockNode
    from repro_torch.graph.passes import stage_input_spec
    from repro_torch.stream import conv_bands, pooled_bands
    out = []
    for node in plan.graph:
        if not isinstance(node, (Conv2DNode, FusedConvBlockNode)):
            continue
        _, n, h, w = stage_input_spec(plan.graph, node).shape
        m, _, k, _ = node.w.shape
        sh = node.stride[0]
        fused = isinstance(node, FusedConvBlockNode)
        rows = [h]
        if node.tiling is not None and fused:
            po = pool_output_size((h - k) // sh + 1, node.odd)
            rows = [hi - lo for *_, lo, hi in pooled_bands(
                po, node.tiling.tile_rows, k, sh, h)]
        elif node.tiling is not None:
            rows = [hi - lo for *_, lo, hi in conv_bands(
                (h - k) // sh + 1, node.tiling.tile_rows, k, sh)]
        out += [("fused_cwp" if fused else "conv_window", node.w.path[0],
                 (n, r, w, m, k)) for r in rows]
    return out


def plan_launches(plan) -> dict[str, int]:
    """Kernel launches one batch of ``plan`` makes on the card, from its
    graph: a conv kernel a band (or a stage), qmatmul a dense under int8."""
    from repro_torch.graph.ir import DenseNode
    n = {k: 0 for k in KERNELS}
    for kern, _, _ in launch_shapes(plan):
        n[kern] += 1
    # under int8 every conv launch takes the kernels' int8 route
    n.update({f"{k}_int8": n[k] if plan.quant == "int8" else 0
              for k in INT8_ROUTES})
    if plan.quant == "int8":
        n["qmatmul"] = sum(isinstance(v, DenseNode) for v in plan.graph)
    return n


def hold(label, mode, got, want) -> dict:
    """Logits ``got`` against ``want`` to the mode's bar: int8 bitwise,
    qformat one Q8.8 step, fp32 TOL_FP32 relative to the largest |want|."""
    import torch
    torch.cuda.synchronize()
    got, want = got.cpu(), want.cpu()
    check(got.shape == want.shape and bool(torch.isfinite(got).all())
          and bool(torch.isfinite(want).all()),
          f"{label} {mode}: shapes {tuple(got.shape)} / "
          f"{tuple(want.shape)} or non-finite values")
    err = max_abs(got, want)
    tol = {"none": TOL_FP32 * (1 + float(want.abs().max())),
           "qformat": QSTEP, "int8": 0.0}[mode]
    check(err <= tol, f"{label} {mode}: max_abs {err}, tolerance {tol}")
    return {"max_abs": err, "bitwise": bitwise(got, want), "tolerance": tol}


# ------------------------------------------------------------------- phases

def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0].strip()


def phase_device():
    import torch
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi_line(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "capability": list(torch.cuda.get_device_capability(0))}
    emit(info)
    return info


def phase_build():
    from repro_torch.kernels.build import SOURCES, build
    t0 = time.perf_counter()
    report = build()
    seconds = time.perf_counter() - t0
    libs = {}
    local = 0
    for name in SOURCES:
        r = report[name]
        regs = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln
                or "Function properties" in ln]
        for ln in regs:
            local += sum(int(n) for n in re.findall(
                r"(\d+) bytes (?:spill stores|spill loads|stack frame)", ln))
        libs[name] = {"built": r["built"], "seconds": round(r["seconds"], 2),
                      "ptxas": regs}
    emit({"phase": "build", "seconds": round(seconds, 2),
          "local_bytes": local, "libs": libs})
    check(local == 0, f"ptxas reports {local} bytes of spills or stack "
                      f"frame: a kernel keeps values in local memory")


def phase_kernels(device):
    """Each kernel against its plain version on the same card inputs."""
    import torch
    from repro_torch.kernels.addtree.ops import tree_reduce_sum
    from repro_torch.kernels.addtree.ref import tree_reduce_sum_ref
    from repro_torch.kernels.conv_window.ops import conv_window
    from repro_torch.kernels.conv_window.ref import conv2d_window_ref
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    from repro_torch.kernels.qmatmul.ops import qmatmul, qmatmul_acc
    from repro_torch.kernels.qmatmul.ref import qmatmul_acc_ref, qmatmul_ref
    from repro_torch.ops import BackendUnavailableError, ExecPolicy
    from repro_torch.ops import tree_reduce_sum as tree_op
    from repro_torch.ops.tiling import TREE_MAX_ETA

    gen = torch.Generator().manual_seed(0)
    cases = {k: [] for k in KERNELS}

    def record(name, stage, bsz, mode, got, want):
        torch.cuda.synchronize()
        err = max_abs(got, want)
        exact = bitwise(got, want)
        # the tree sums in its plain version's order: bitwise in fp32 too;
        # qformat conv sums are exact, which both conv kernels are held to
        must_be_exact = mode in ("int8", "qformat") or name == "addtree"
        tol = 0.0 if must_be_exact else TOL_FP32 * (1 + float(
            want.abs().max()))
        ok = exact if must_be_exact else err <= tol
        cases[name].append({"stage": stage, "B": bsz, "mode": mode,
                            "max_abs": err, "bitwise": exact,
                            "tolerance": tol, "ok": ok})
        check(ok, f"{name} {stage} B={bsz} {mode}: kernel vs plain max_abs "
                  f"{err} (bitwise={exact}, tolerance {tol})")

    mods = kernel_modules()

    def conv_check(name, stage, bsz, mode, shape, stride=(1, 1),
                   odd="raise", tiling=None):
        """``name`` (fused_cwp or conv_window) against its plain version
        on seeded inputs of ``shape``. int8 codes take the int8 route
        (its launch counted as such) and are held bitwise to the plain
        version and to the fp32 route on the same codes as fp32."""
        pol = ExecPolicy(tiling=tiling or {})
        x, w, b, s = conv_inputs(gen, bsz, shape, mode, device,
                                 codes=mode == "int8")
        if name == "fused_cwp":
            def kern(x, w):
                return fused_cwp(x, w, b, stride=stride, scale=s, odd=odd,
                                 policy=pol)
            want = fused_cwp_ref(x, w, b, stride, odd=odd, scale=s)
        else:
            # the eager int8 path passes no bias into the conv (the
            # requant epilogue runs outside it)
            cb = None if mode == "int8" else b

            def kern(x, w):
                return conv_window(x, w, cb, stride=stride, policy=pol)
            want = conv2d_window_ref(x, w, cb, stride=stride)
        before = mods[name].launches_int8
        got = kern(x, w)
        record(name, stage, bsz, mode, got, want)
        if mode == "int8":
            check(mods[name].launches_int8 == before + 1,
                  f"{name} {stage} B={bsz}: int8 codes did not take the "
                  f"int8 route")
            record(name, f"{stage} fp32 route on the codes", bsz, mode,
                   kern(x.to(torch.float32), w.to(torch.float32)), got)

    for bsz in (1, 3, 8):
        for stage, shape in (("conv1", CONV1), ("conv2", CONV2)):
            for mode in MODES:
                conv_check("fused_cwp", stage, bsz, mode, shape)
                conv_check("conv_window", stage, bsz, mode, shape)
        xc, wc, xs, ws = fc_inputs(gen, bsz, device)
        record("qmatmul", "fc", bsz, "int8", qmatmul(xc, wc, xs, ws),
               qmatmul_ref(xc, wc, xs, ws))
    for mode in MODES:
        for stage, shape in (("conv1", CONV1), ("conv2", CONV2)):
            conv_check("fused_cwp", stage, 1024, mode, shape)
            conv_check("conv_window", stage, 1024, mode, shape)
        for case, (shape, stride, tiling) in FUSED_SHAPES.items():
            conv_check("fused_cwp", case, 2, mode, shape, stride,
                       tiling=tiling)
        for case, (shape, stride, tiling) in CONV_SHAPES.items():
            conv_check("conv_window", case, 2, mode, shape, stride,
                       tiling=tiling)
    # odd conv maps: the last row/column dropped or pooled against -inf
    for name, shape in ODD_POOL_SHAPES.items():
        for bsz in (1, 8):
            for mode in MODES:
                for odd in ("drop", "pad"):
                    conv_check("fused_cwp", f"odd {odd} {name}", bsz, mode,
                               shape, odd=odd)
    # the int8 route's own edges: depth off a multiple of 32 and channels
    # off a multiple of 8 at B = 1, 8, 1024; the item and channel keys
    for name, (shape, stride, tiling) in S8_SHAPES.items():
        for bsz in (1, 8, 1024):
            conv_check("fused_cwp", name, bsz, "int8", shape, stride,
                       odd="pad", tiling={f"fused_conv_block.{k}": v
                                          for k, v in tiling.items()})
            conv_check("conv_window", name, bsz, "int8", shape, stride,
                       tiling={f"conv2d.{k}": v for k, v in tiling.items()})
    # int8 codes one byte into their storage (and weights three): no
    # 4-byte alignment anywhere, each route against the plain version
    x, w, b, s = conv_inputs(gen, 8, CONV2, "int8", device, codes=True)
    xu = torch.empty(x.numel() + 1, dtype=torch.int8, device=device)
    xu = xu[1:].view(x.shape)
    xu.copy_(x)
    wu = torch.empty(w.numel() + 3, dtype=torch.int8, device=device)
    wu = wu[3:].view(w.shape)
    wu.copy_(w)
    record("fused_cwp", "conv2 +1B x +3B w", 8, "int8",
           fused_cwp(xu, wu, b, scale=s), fused_cwp_ref(x, w, b, scale=s))
    record("conv_window", "conv2 +1B x +3B w", 8, "int8",
           conv_window(xu, wu), conv2d_window_ref(x, w))
    # both routes replayed from a CUDA graph: the captured launches read
    # the static inputs' new values
    cases["fused_cwp"] += conv_graph_cases(device)
    # odd='raise' refuses an odd map before any launch
    x, w, b, _ = conv_inputs(gen, 2, ODD_POOL_SHAPES["9x9"], "none", device)
    before = counts()["fused_cwp"]
    try:
        fused_cwp(x, w, b)
    except ValueError:
        check(counts()["fused_cwp"] == before,
              "fused_cwp launched on an odd map under odd='raise'")
    else:
        raise SmokeFailure("fused_cwp took an odd map under odd='raise'")
    for (m, k, n), tiling in QMATMUL_SHAPES:
        xc, wc, xs, ws = qmatmul_inputs(gen, m, k, n, device)
        record("qmatmul", f"{m}x{k}x{n}", m, "int8",
               qmatmul(xc, wc, xs, ws, policy=ExecPolicy(tiling=tiling)),
               qmatmul_ref(xc, wc, xs, ws))
    # a view one byte into its storage: rows not 4-byte aligned, so the
    # kernel's byte loads; and scalar scales, broadcast by the wrapper
    xc, wc, xs, ws = qmatmul_inputs(gen, 37, 320, 10, device)
    xu = torch.empty(37 * 320 + 1, dtype=torch.int8, device=device)
    xu = xu[1:].view(37, 320)
    xu.copy_(xc)
    record("qmatmul", "37x320x10+1B", 37, "int8", qmatmul(xu, wc, xs, ws),
           qmatmul_ref(xu, wc, xs, ws))
    sx = torch.full((8, 1), 0.03125, device=device)
    sw = torch.full((1, 10), 0.0078125, device=device)
    record("qmatmul", "8x320x10 scalar scales", 8, "int8",
           qmatmul(xc[:8], wc, 0.03125, 0.0078125),
           qmatmul_ref(xc[:8], wc, sx, sw))
    for m, k, n in QMATMUL_BOUNDARY:
        xc, wc, xs, ws = qmatmul_inputs_on(device, 600 + m, m, k, n)
        record("qmatmul", f"boundary {m}x{k}x{n}", m, "int8",
               qmatmul(xc, wc, xs, ws), qmatmul_ref(xc, wc, xs, ws))
    for m, k, n in QMATMUL_ACC_SHAPES:
        xc, wc, _, _ = qmatmul_inputs_on(device, 700 + m, m, k, n)
        record("qmatmul", f"acc {m}x{k}x{n}", m, "int8",
               qmatmul_acc(xc, wc), qmatmul_acc_ref(xc, wc))
    cases["qmatmul"] += qmatmul_graph_cases(device)
    # every launch shape of highres_cnn's 224x224 plans, new to both conv
    # kernels (3 input channels at W = 224 and K = 5; the band heights),
    # and its fc at K = 4,608
    for kern, stage, shape in highres_shapes():
        for bsz in (2, 8):
            for mode in MODES:
                conv_check(kern, f"highres {stage} {shape[1]}x{shape[2]}",
                           bsz, mode, shape)
    for bsz in (1, 2, 8):
        xc, wc, xs, ws = fc_inputs(gen, bsz, device, highres_fc())
        record("qmatmul", "highres fc", bsz, "int8", qmatmul(xc, wc, xs, ws),
               qmatmul_ref(xc, wc, xs, ws))
    # qwen1.5-0.5b's MLP matmuls, f32 out and the bf16 the model takes
    # (the kernel writes f32; the wrapper casts after it)
    for m, k, n in LM_QMATMUL_SHAPES:
        xc, wc, xs, ws = qmatmul_inputs(gen, m, k, n, device)
        for dt in (torch.float32, torch.bfloat16):
            record("qmatmul", f"{LM_ARCH} {m}x{k}x{n} {str(dt)[6:]}", m,
                   "int8", qmatmul(xc, wc, xs, ws, out_dtype=dt),
                   qmatmul_ref(xc, wc, xs, ws, dt))
    # the dense configs' MLP matmuls at a decode step (M = 4) and a
    # 64-token prefill: K and N up to 22,528, f32 and bf16 out
    for i, (arch, k, n) in enumerate(dense_qmatmul_shapes()):
        for m in (4, 64):
            xc, wc, xs, ws = qmatmul_inputs_on(device, 100 + i, m, k, n)
            for dt in (torch.float32, torch.bfloat16):
                record("qmatmul", f"{arch} {m}x{k}x{n} {str(dt)[6:]}", m,
                       "int8", qmatmul(xc, wc, xs, ws, out_dtype=dt),
                       qmatmul_ref(xc, wc, xs, ws, dt))
            del xc, wc
    for r, eta in TREE_SHAPES + [(33, TREE_MAX_ETA)]:
        x = torch.randn((r, eta), generator=gen).to(device)
        record("addtree", f"{r}x{eta}", r, "none", tree_reduce_sum(x),
               tree_reduce_sum_ref(x))
    # a view one float into its storage: not 16-byte aligned, so the
    # kernel's 4-byte loads
    for r, eta in ((37, 16), (37, 540)):
        x = torch.randn(r * eta + 1, generator=gen).to(device)[1:].view(
            r, eta)
        record("addtree", f"{r}x{eta}+4B", r, "none", tree_reduce_sum(x),
               tree_reduce_sum_ref(x))
    # what the kernel cannot take raises on the card instead of falling
    # back to a plain version: a 3-D input and a row over the η cap
    for shape in ((2, 4, 9), (2, TREE_MAX_ETA + 1)):
        try:
            tree_op(torch.zeros(shape, device=device))
        except BackendUnavailableError:
            continue
        raise SmokeFailure(f"tree_reduce_sum{shape} on the card did not "
                           f"raise BackendUnavailableError")
    parity = [{"name": k, "replaces": KERNELS[k][1],
               "max_abs": max(c["max_abs"] for c in v),
               "int8_bitwise": all(c["bitwise"] for c in v
                                   if c["mode"] == "int8"),
               "all_bitwise": all(c["bitwise"] for c in v),
               "cases": v} for k, v in cases.items()]
    emit({"phase": "kernels", "parity": parity})
    return {p["name"]: p["max_abs"] for p in parity}


def conv_graph_cases(device) -> list[dict]:
    """fused_cwp's fp32 and int8 routes captured in one CUDA graph at
    conv2's shape (B = 8), replayed on new inputs copied into the static
    ones: each replay bitwise to the plain version (int8) or within
    TOL_FP32 (fp32), and the wrapper counting the launches at capture
    only."""
    import torch
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    mods = kernel_modules()
    gen = torch.Generator().manual_seed(14)
    rows = []
    for mode in ("none", "int8"):
        x, w, b, s = conv_inputs(gen, 8, CONV2, mode, device,
                                 codes=mode == "int8")
        static = x.clone()
        fused_cwp(static, w, b, scale=s)            # warm: build and opt in
        torch.cuda.synchronize()
        before = counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fused_cwp(static, w, b, scale=s)
        grew = {k: counts()[k] - before[k] for k in before}
        check(grew["fused_cwp"] == 1
              and grew["fused_cwp_int8"] == int(mode == "int8"),
              f"fused_cwp graph {mode}: capture counted {grew}")
        for rep in range(3):
            xn, _, _, _ = conv_inputs(gen, 8, CONV2, mode, device,
                                      codes=mode == "int8")
            static.copy_(xn)
            graph.replay()
            torch.cuda.synchronize()
            want = fused_cwp_ref(xn, w, b, scale=s)
            err = max_abs(out, want)
            tol = (0.0 if mode == "int8"
                   else TOL_FP32 * (1 + float(want.abs().max())))
            ok = bitwise(out, want) if mode == "int8" else err <= tol
            check(ok, f"fused_cwp graph {mode} replay {rep}: max_abs {err}")
            rows.append({"stage": f"graph replay {rep}", "B": 8,
                         "mode": mode, "max_abs": err,
                         "bitwise": bitwise(out, want), "tolerance": tol,
                         "ok": ok})
        check(mods["fused_cwp"].launches == before["fused_cwp"] + 1,
              "fused_cwp graph: a replay counted a launch")
        del graph
    return rows


def qmatmul_graph_cases(device) -> list[dict]:
    """One qmatmul launch of each body captured in a CUDA graph (a split
    K's zeroed buffer with it) and replayed three times on new codes
    copied into the same inputs: each replay bitwise to the plain
    version, and the capture the wrapper's only launch."""
    import torch
    from repro_torch.kernels.qmatmul.ops import qmatmul, qmatmul_acc
    from repro_torch.kernels.qmatmul.ref import qmatmul_acc_ref, qmatmul_ref
    from repro_torch.ops.tiling import qmatmul_tiles
    out = []
    for m, k, n, raw in ((4, 1024, 2816, False), (64, 2816, 1024, False),
                         (4, 1408, 1024, True), (512, 7168, 3584, True)):
        t = qmatmul_tiles(m, k, n)
        args = list(qmatmul_inputs_on(device, 800 + m, m, k, n))
        call = ((lambda: qmatmul_acc(args[0], args[1])) if raw
                else (lambda: qmatmul(*args)))
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            call()                               # the warm-up opts in
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = counts()["qmatmul"]
        with torch.cuda.graph(graph):
            got = call()
        check(counts()["qmatmul"] == before + 1,
              f"qmatmul graph {m}x{k}x{n}: the capture launched "
              f"{counts()['qmatmul'] - before} times")
        for rep in range(3):
            new = qmatmul_inputs_on(device, 900 + 10 * m + rep, m, k, n)
            for dst, src in zip(args, new):
                dst.copy_(src)
            graph.replay()
            torch.cuda.synchronize()
            want = (qmatmul_acc_ref(args[0], args[1]) if raw
                    else qmatmul_ref(*args))
            exact = bitwise(got, want)
            out.append({"stage": f"graph {'acc ' if raw else ''}"
                                 f"{m}x{k}x{n} replay {rep}",
                        "B": m, "mode": "int8", "body": t["body"],
                        "splits": t["splits"], "max_abs": max_abs(got, want),
                        "bitwise": exact, "tolerance": 0.0, "ok": exact})
            check(exact, f"qmatmul graph {m}x{k}x{n} replay {rep}: not "
                         f"bitwise to the plain version")
        del graph
    return out


def highres_fc() -> tuple[int, int]:
    from repro_torch.models.vgg import VGGStyleCNNConfig
    cfg = VGGStyleCNNConfig()
    return cfg.fc_in(), cfg.n_classes


def highres_shapes() -> list[tuple[str, str, tuple]]:
    """Every distinct (kernel, stage, shape) of highres_cnn's 224x224
    plans: the served streamed plan (fused_cwp), the streamed fuse=False
    plan and the eager forward (conv_window, untiled)."""
    from repro_torch.models.vgg import VGGStyleCNN
    model = VGGStyleCNN()
    out = []
    for plan in (model.compile(), model.compile(fuse=False),
                 model.compile(fuse=False, stream_budget=1 << 40)):
        for t in launch_shapes(plan):
            if t not in out:
                out.append(t)
    return out


def _compare_logits(mode, got: dict, want: dict) -> dict:
    """Every request's logits, card vs CPU, to the parity table."""
    import numpy as np
    check(sorted(got) == sorted(want), f"{mode}: request ids differ")
    worst, differing, labels_ok = 0.0, 0, True
    for rid in want:
        a = np.asarray(got[rid]["logits"], np.float64)
        b = np.asarray(want[rid]["logits"], np.float64)
        check(a.shape == b.shape == (10,) and np.isfinite(a).all()
              and np.isfinite(b).all(),
              f"{mode}: request {rid} logits {a} (card) / {b} (cpu) are "
              f"not 10 finite values")
        d = np.abs(a - b)
        worst = max(worst, float(d.max()))
        differing += int((d > 0).sum())
        if mode == "none":
            top2 = np.sort(b)[-2:]
            if top2[1] - top2[0] > 1e-4:
                labels_ok &= got[rid]["label"] == want[rid]["label"]
    if mode == "int8":
        ok = differing == 0
    elif mode == "qformat":
        ok = worst <= QSTEP
    else:
        ok = labels_ok and all(
            np.allclose(got[r]["logits"], want[r]["logits"], rtol=TOL_FP32,
                        atol=TOL_FP32) for r in want)
    check(ok, f"serve {mode}: card vs CPU logits max_abs {worst}, "
              f"{differing} differing elements")
    return {"mode": mode, "requests": len(want), "max_abs": worst,
            "differing_elements": differing}


def graph_launch_check(label, eng, grew) -> dict:
    """An engine on the card serves each bucket through one CUDA graph.
    Its wrappers launched each bucket's plan twice at boot (a warm call
    on a side stream, then the capture), and every batch since (the
    boot's first replay included) replayed that graph. So: each graph
    holds its plan's launches, the replays equal the batches, the
    wrappers counted 2 plans a bucket, and the launches the replays made
    equal the plan's per batch."""
    per_bucket = {b: plan_launches(eng._bounds[b].plan) for b in eng.buckets}
    for b, want in per_bucket.items():
        check(eng._graphs[b].kernels == want,
              f"{label}: bucket {b}'s graph holds {eng._graphs[b].kernels}"
              f", its plan launches {want}")
    batches = eng.stats.steps + len(eng.buckets)        # served + prewarm
    check(sum(eng.replays.values()) == batches,
          f"{label}: {eng.replays} replays for {batches} batches")
    wrapped = {k: sum(2 * v[k] for v in per_bucket.values()) for k in grew}
    check(grew == wrapped, f"{label}: wrapper launches {grew}, expected "
                           f"{wrapped} (a warm call and a capture a bucket)")
    executed = eng.graph_launches()
    want = {k: sum(v[k] * eng.replays[b] for b, v in per_bucket.items())
            for k in grew}
    check(executed == want, f"{label}: graph replays launched {executed}, "
                            f"expected {want}")
    return {"batches": batches, "replays": dict(eng.replays),
            "wrapper_launches": grew, "graph_launches": executed}


def serve_launcher(arch, requests) -> dict:
    """``launcher.main`` for ``arch`` at capacity 8 on the card and on the
    CPU: every request's logits held card against CPU, and the card's
    launches those of one CUDA graph a bucket replayed once a batch
    (served + prewarm)."""
    from repro_torch.artifact import clear_graph_cache
    from repro_torch.launch import serve as launcher
    argv = ["--arch", arch, "--capacity", "8", "--requests", str(requests)]
    clear_graph_cache()
    before = counts()
    with contextlib.redirect_stdout(sys.stderr):
        eng, res = launcher.main(argv + ["--device", "cuda"])
        _, res_cpu = launcher.main(argv + ["--device", "cpu"])
    grew = {k: counts()[k] - before[k] for k in before}
    row = _compare_logits("none", res, res_cpu)
    row.update(path="launcher", arch=arch,
               **graph_launch_check(f"launcher {arch}", eng, grew))
    return row


def serve_engines(model, params, images) -> list[dict]:
    """VisionEngine under qformat and int8 (batch 8, bucket ladder) on the
    card and on the CPU with the same weights and images; the card's
    launches those of its graphs' replays, none on the CPU."""
    from repro_torch.artifact import clear_graph_cache
    from repro_torch.ops import ExecPolicy
    from repro_torch.serve import VisionEngine, VisionEngineConfig
    out = []
    for mode in ("qformat", "int8"):
        results = {}
        for dev in ("cuda", "cpu"):
            clear_graph_cache()
            before = counts()
            e = VisionEngine(model, params, VisionEngineConfig(
                batch=8, buckets="auto", policy=ExecPolicy(quant=mode),
                device=dev))
            for img in images:
                e.submit(img)
            results[dev] = e.run()
            grew = {k: counts()[k] - before[k] for k in before}
            if dev == "cuda":
                launch_row = graph_launch_check(f"engine {mode}", e, grew)
            else:
                check(not any(grew.values()),
                      f"engine {mode} on cpu launched kernels: {grew}")
        row = _compare_logits(mode, results["cuda"], results["cpu"])
        row.update(path="engine", arch=model.cfg.name, **launch_row)
        out.append(row)
    return out


def phase_serve(device):
    """The launcher's CNN path, then VisionEngine under qformat and int8,
    each on the card and on the CPU with the same weights."""
    import numpy as np
    from repro_torch.models.cnn import PaperCNN

    out = [serve_launcher("mnist_cnn", 32)]
    model = PaperCNN()
    params = model.init(0, device="cpu")
    rng = np.random.RandomState(2)
    images = [rng.randn(*model.input_shape()[1:]).astype(np.float32)
              for _ in range(32)]
    out += serve_engines(model, params, images)
    emit({"phase": "serve", "runs": out})


# ---------------------------------------------------------------- open_loop

class Recorder:
    """An engine adapter's stand-in that passes every call through and
    records the dispatch order (rids as injected) and the rids each engine
    step was handed."""

    def __init__(self, adapter):
        self.adapter = adapter
        self.kind = adapter.kind
        self.forms_buckets = adapter.forms_buckets
        self.injected: list[int] = []
        self.batches: list[list[int]] = []
        self._since: list[int] = []

    @property
    def stats(self):
        return self.adapter.stats

    @property
    def preferred_batch(self) -> int:
        return self.adapter.preferred_batch

    def free_lanes(self) -> int:
        return self.adapter.free_lanes()

    def inject(self, req) -> None:
        self.adapter.inject(req)
        self.injected.append(req.rid)
        self._since.append(req.rid)

    def step(self) -> None:
        self.adapter.step()
        self.batches.append(self._since)
        self._since = []

    def drain(self):
        return self.adapter.drain()

    def has_inflight(self) -> bool:
        return self.adapter.has_inflight()


class StartClock:
    """The wall clock (``MonotonicClock``) that keeps its first reading
    after ``arm()``: the one ``OpenLoopDriver.run`` takes as its start, to
    which the schedule's times are relative."""

    def __init__(self):
        from repro_torch.serve import MonotonicClock
        self._clock = MonotonicClock()
        self.start = None
        self._armed = False

    def arm(self) -> None:
        self._armed = True

    def now(self) -> float:
        t = self._clock.now()
        if self._armed:
            self.start, self._armed = t, False
        return t

    def sleep(self, dt: float) -> None:
        self._clock.sleep(dt)


def open_loop_workload(name: str, layers: int = OPEN_LOOP_LM_LAYERS):
    """(model, payloads, options, lanes) of one open_loop engine, all from
    numpy seeds: OPEN_LOOP_IMAGES images of the CNN's input shape, or
    OPEN_LOOP_PROMPTS prompts of OPEN_LOOP_PROMPT_LENS tokens (one prefill
    graph a length, within the engine's 8) asking OPEN_LOOP_NEW tokens,
    the LM cut to ``layers``."""
    import numpy as np
    if name == LM_ARCH:
        from repro_torch.configs import get_arch
        full = get_arch(LM_ARCH).model()
        model = type(full)(dataclasses.replace(
            full.cfg, n_layers=layers, name=f"{LM_ARCH} {layers}L"))
        rng = np.random.RandomState(23)
        lens = rng.choice(OPEN_LOOP_PROMPT_LENS, size=OPEN_LOOP_PROMPTS)
        payloads = [rng.randint(0, model.cfg.vocab, size=int(p))
                    .astype(np.int32) for p in lens]
        lo, hi = OPEN_LOOP_NEW
        options = [{"max_new_tokens": int(rng.randint(lo, hi + 1))}
                   for _ in payloads]
        return model, payloads, options, OPEN_LOOP_CAPACITY
    if name == "mnist_cnn":
        from repro_torch.models.cnn import PaperCNN
        model, seed = PaperCNN(), 21
    else:
        from repro_torch.models.vgg import VGGStyleCNN
        model, seed = VGGStyleCNN(), 22
    rng = np.random.RandomState(seed)
    payloads = [rng.randn(*model.input_shape()[1:]).astype(np.float32)
                for _ in range(OPEN_LOOP_IMAGES)]
    return model, payloads, [{} for _ in payloads], OPEN_LOOP_BATCH


def open_loop_params(name: str, model, device):
    """The engine's weights on ``device``: the CNNs' drawn on the CPU from
    seed 0, the LM's on the card from seed 0 (then copied), so every
    process and device serves the same values."""
    import torch
    if name == LM_ARCH:
        params = model.init(0, device=torch.device("cuda", 0))
    else:
        params = model.init(0, device="cpu")
    return to_device(params, device)


def open_loop_engine(name: str, model, params, device, clock):
    """A fresh engine under int8 on ``device`` behind its adapter: the
    VisionEngine at batch OPEN_LOOP_BATCH with the bucket ladder (a CUDA
    graph a bucket on the card), or the LM Engine at capacity
    OPEN_LOOP_CAPACITY whose step graphs are captured before it serves."""
    from repro_torch.ops import ExecPolicy
    from repro_torch.serve import (Engine, EngineConfig, LMAdapter,
                                   VisionAdapter, VisionEngine,
                                   VisionEngineConfig)
    policy = ExecPolicy(quant="int8")
    if name != LM_ARCH:
        eng = VisionEngine(model, params, VisionEngineConfig(
            batch=OPEN_LOOP_BATCH, buckets="auto", policy=policy,
            device=str(device)), clock=clock)
        return eng, VisionAdapter(eng)
    eng = Engine(model, params, EngineConfig(
        capacity=OPEN_LOOP_CAPACITY,
        max_seq=max(OPEN_LOOP_PROMPT_LENS) + OPEN_LOOP_NEW[1],
        policy=policy, device=str(device)), clock=clock)
    for length in OPEN_LOOP_PROMPT_LENS:
        eng.warm_prefill(length)
    eng.warm_decode()
    return eng, LMAdapter(eng)


def open_loop_schedule(seed: int, n: int, rate: float) -> list[float]:
    """``n`` Poisson arrival times at ``rate`` a second."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [float(t) for t in np.cumsum(rng.exponential(1.0 / rate, size=n))]


def open_loop_replay(name: str, device, times: list[float], step_s: float,
                     max_queue: int, threads: int | None = None) -> dict:
    """One engine's schedule (payload i at ``times[i]``) replayed under a
    ``VirtualClock`` that charges ``step_s`` an engine step, on
    ``device`` (the LM cut to OPEN_LOOP_REPLAY_LAYERS); run in place for
    the card and in a host process for the CPU. Returns what decides
    every latency: the shed list, the dispatch order, each step's rids,
    the latencies and the counts."""
    import torch
    from repro_torch.serve import (Frontend, FrontendConfig, OpenLoopDriver,
                                   VirtualClock)
    if threads:
        torch.set_num_threads(threads)
    model, payloads, options, _ = open_loop_workload(
        name, OPEN_LOOP_REPLAY_LAYERS)
    params = open_loop_params(name, model, device)
    clock = VirtualClock()
    eng, adapter = open_loop_engine(name, model, params, device, clock)
    rec = Recorder(adapter)
    fe = Frontend(rec, FrontendConfig(max_queue=max_queue,
                                      step_cost_s=step_s), clock)
    driver = OpenLoopDriver(fe, [(t, p, o) for t, p, o
                                 in zip(times, payloads, options)])
    driver.run(max_steps=OPEN_LOOP_MAX_STEPS)
    s = fe.stats
    return {"shed": driver.shed, "injected": rec.injected,
            "batches": rec.batches, "latencies": s.latencies,
            "steps": s.steps, "submitted": s.submitted,
            "completed": s.completed, "rejected": s.rejected}


def open_loop_run(name, model, params, payloads, options, device, times,
                  max_queue) -> tuple[dict, dict, list[list[int]]]:
    """One open-loop run on a fresh card engine under the wall clock:
    payload i arrives ``times[i]`` seconds after the driver starts.
    Returns (its metrics, {payload index: result}, the payload indices
    each engine step was handed)."""
    from repro_torch.serve import (Frontend, FrontendConfig, OpenLoopDriver,
                                   percentile)
    clock = StartClock()
    eng, adapter = open_loop_engine(name, model, params, device, clock)
    rec = Recorder(adapter)
    fe = Frontend(rec, FrontendConfig(max_queue=max_queue), clock)
    index = {id(p): i for i, p in enumerate(payloads)}
    driver = OpenLoopDriver(fe, [(t, p, o) for t, p, o
                                 in zip(times, payloads, options)])
    clock.arm()
    res = driver.run(max_steps=OPEN_LOOP_MAX_STEPS)
    wall = clock.now() - clock.start
    s = fe.stats
    n = len(times)
    check(s.submitted + len(driver.shed) == n,
          f"open_loop {name}: {s.submitted} submitted + {len(driver.shed)} "
          f"shed of {n} arrivals")
    check(s.rejected == len(driver.shed),
          f"open_loop {name}: {s.rejected} rejected, {len(driver.shed)} shed")
    check(s.completed == s.submitted == len(res),
          f"open_loop {name}: {s.completed} completed, {s.submitted} "
          f"submitted, {len(res)} results")
    of = {rid: index[id(req.payload)] for rid, req in fe.requests.items()}
    sched = [fe.requests[rid].finish_t - clock.start - times[of[rid]]
             for rid in res]
    row = {"arrivals": n, "offered_rps": n / times[-1],
           "max_queue": max_queue, "submitted": s.submitted,
           "shed": len(driver.shed), "completed": s.completed,
           "steps": s.steps, "wall_s": wall,
           "latency_p50_s": s.p50_s, "latency_p99_s": s.p99_s,
           "sched_latency_p50_s": percentile(sched, 50),
           "sched_latency_p99_s": percentile(sched, 99),
           "goodput_rps": s.goodput_rps,
           "lane_utilization": s.lane_utilization}
    del eng
    return (row, {of[rid]: r for rid, r in res.items()},
            [[of[rid] for rid in b] for b in rec.batches])


def open_loop_same_batches(name, model, params, payloads, device,
                           batches: list[list[int]]) -> dict:
    """Each of ``batches`` (payload indices) served closed-loop by a fresh
    card engine, one step a batch: the closed loop's results for the
    batches an open-loop run formed."""
    from repro_torch.serve import Frontend, FrontendConfig, MonotonicClock
    clock = MonotonicClock()
    eng, adapter = open_loop_engine(name, model, params, device, clock)
    fe = Frontend(adapter, FrontendConfig(max_queue=OPEN_LOOP_BATCH), clock)
    out = {}
    for batch in batches:
        rids = [fe.submit(payloads[i]) for i in batch]
        steps = fe.stats.steps
        res = fe.run_until_drained()
        check(fe.stats.steps == steps + 1,
              f"open_loop {name}: a batch of {len(batch)} took "
              f"{fe.stats.steps - steps} steps")
        out.update({i: res[r] for i, r in zip(batch, rids)})
    del eng
    return out


def open_loop_hold(name: str, label: str, got: dict, want: dict) -> int:
    """Results by payload index against ``want``'s: int8 logits bitwise,
    LM tokens equal. Returns how many were held."""
    import numpy as np
    for i, r in got.items():
        if name == LM_ARCH:
            ok = r.generated == want[i].generated
            what = f"tokens {r.generated} vs {want[i].generated}"
        else:
            ok = (np.isfinite(r["logits"]).all() and np.array_equal(
                r["logits"], want[i]["logits"]))
            what = (f"logits max_abs "
                    f"{float(np.abs(r['logits'] - want[i]['logits']).max())}")
        check(ok, f"open_loop {name} {label}: payload {i}: {what}")
    return len(got)


def open_loop_engine_runs(name: str, device, smi: str) -> list[dict]:
    """One engine: the payloads served closed loop (the results and the
    throughput the open-loop rates are set from), then open loop at each
    OPEN_LOOP_LOADS multiple of that throughput (the 2x run's queue 2 x
    the engine's lanes, so that it sheds), every result held against the
    closed loop's for the same payload (int8 logits, whose activation
    scale spans the batch, against the closed loop of the same batch),
    and the card's virtual replay of the 2x schedule (the LM's at
    OPEN_LOOP_REPLAY_LAYERS). The CPU's replay is
    started here (a host job, or in place under --phases) and held by
    ``open_loop_replays_held``."""
    from repro_torch.serve import Frontend, FrontendConfig, MonotonicClock
    model, payloads, options, lanes = open_loop_workload(name)
    params = open_loop_params(name, model, device)
    n = len(payloads)
    clock = MonotonicClock()
    eng, adapter = open_loop_engine(name, model, params, device, clock)
    rec = Recorder(adapter)
    fe = Frontend(rec, FrontendConfig(max_queue=n), clock)
    for p, o in zip(payloads, options):
        fe.submit(p, **o)
    t0 = clock.now()
    closed = dict(fe.run_until_drained(max_steps=OPEN_LOOP_MAX_STEPS))
    wall = clock.now() - t0
    check(sorted(closed) == list(range(n)),
          f"open_loop {name}: closed loop served {sorted(closed)}")
    closed_batches = {tuple(b) for b in rec.batches}
    step_s = wall / fe.stats.steps
    rate = n / wall
    rows = [{"engine": name, "run": "closed", "arrivals": n,
             "steps": fe.stats.steps, "wall_s": wall, "throughput_rps": rate,
             "step_s": step_s, "latency_p50_s": fe.stats.p50_s,
             "latency_p99_s": fe.stats.p99_s,
             "lane_utilization": fe.stats.lane_utilization,
             "nvidia_smi": smi}]
    del eng, fe, rec
    schedules = {}
    for k, load in enumerate(OPEN_LOOP_LOADS):
        times = open_loop_schedule(31 + k, n, load * rate)
        max_queue = (2 * lanes if load > 1
                     else FrontendConfig().max_queue)
        schedules[load] = (times, max_queue)
        row, got, batches = open_loop_run(name, model, params, payloads,
                                          options, device, times, max_queue)
        if load < 1:
            check(row["shed"] == 0,
                  f"open_loop {name} {load}x: shed {row['shed']} arrivals")
        else:
            check(row["shed"] > 0,
                  f"open_loop {name} {load}x: shed nothing at queue "
                  f"{max_queue}")
        same, other = {}, []
        for batch in batches:
            if name == LM_ARCH or tuple(batch) in closed_batches:
                same.update({i: closed[i] for i in batch})
            else:
                other.append(batch)
        if other:
            same.update(open_loop_same_batches(name, model, params,
                                               payloads, device, other))
        row.update(engine=name, run=f"{load}x", load=load,
                   held=open_loop_hold(name, f"{load}x", got, same),
                   nvidia_smi=smi)
        if name != LM_ARCH:
            row.update(batches_as_closed=len(batches) - len(other),
                       batches_replayed=len(other))
        rows.append(row)
    times, max_queue = schedules[max(OPEN_LOOP_LOADS)]
    del params
    free_card()
    card = open_loop_replay(name, device, times, step_s, max_queue)
    lap(f"open_loop {name} on the card")
    key = ("open_loop_replay", name)
    job = (name, "cpu", times, step_s, max_queue)
    if CPU_POOL:
        HOST_JOBS[key] = CPU_POOL[0].submit(open_loop_replay, *job,
                                            threads=HOST_THREADS)
    else:
        from concurrent.futures import Future
        HOST_JOBS[key] = Future()
        HOST_JOBS[key].set_result(open_loop_replay(*job))
        lap(f"open_loop {name} its CPU replay")
    OPEN_LOOP_CARD[name] = card
    rows.append({"engine": name, "run": "virtual 2x (card)",
                 "step_cost_s": step_s, "shed": len(card["shed"]),
                 "steps": card["steps"], "completed": card["completed"]})
    free_card()
    return rows


def open_loop_replays_held() -> dict:
    """Every engine's virtual replay of its 2x schedule, card against CPU:
    the shed lists, the dispatch order, each step's rids and the latencies
    equal exactly."""
    out = {}
    for name, card in sorted(OPEN_LOOP_CARD.items()):
        cpu = HOST_JOBS.pop(("open_loop_replay", name)).result()
        for key in ("shed", "injected", "batches", "latencies", "steps",
                    "submitted", "completed", "rejected"):
            check(card[key] == cpu[key],
                  f"open_loop {name} virtual replay: {key} card "
                  f"{card[key]} vs cpu {cpu[key]}")
        out[name] = {"shed": len(card["shed"]), "steps": card["steps"],
                     "completed": card["completed"],
                     "card_vs_cpu": "equal"}
    OPEN_LOOP_CARD.clear()
    emit({"phase": "open_loop_replay", "engines": out})
    return out


def phase_open_loop(device) -> list[dict]:
    """Open-loop serving through the normal engines on the card:
    mnist_cnn and highres_cnn (224², streamed) on VisionEngine and
    qwen1.5-0.5b at full width on the LM Engine, all under int8
    (``open_loop_engine_runs``); fused_cwp and qmatmul must launch."""
    import torch
    from repro_torch.artifact import clear_graph_cache
    check(torch.cuda.is_available(), "open_loop needs the card")
    clear_graph_cache()
    before = counts()
    smi = smi_line()
    rows = []
    for name in ("mnist_cnn", "highres_cnn", LM_ARCH):
        rows += open_loop_engine_runs(name, device, smi)
    grew = {k: counts()[k] - before[k] for k in before}
    check(grew["fused_cwp"] and grew["qmatmul"],
          f"open_loop: a kernel of its path never launched: {grew}")
    int8_routes_held("open_loop", "int8", grew)
    if not CPU_POOL:                        # --phases: the replays ran here
        open_loop_replays_held()
    for r in rows:
        if "latency_p50_s" in r and r["run"] != "closed":
            OPEN_LOOP_LINES.append({"open_loop": f"{r['engine']} {r['run']}",
                                    **{k: r[k] for k in OPEN_LOOP_KEYS},
                                    "nvidia_smi": smi})
    emit({"phase": "open_loop", "lm_layers": OPEN_LOOP_LM_LAYERS,
          "lm_replay_layers": OPEN_LOOP_REPLAY_LAYERS, "launches": grew,
          "runs": rows})
    return rows


def phase_eager(device):
    """PaperCNN.forward (conv_window) vs the fused plan (fused_cwp) on the
    card, and the card's forward vs the CPU's."""
    import torch
    from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
    from repro_torch.ops import ExecPolicy

    gen = torch.Generator().manual_seed(3)
    params = PaperCNN().init(0, device="cpu")
    params_gpu = {k: ({kk: vv.to(device) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(device))
                  for k, v in params.items()}
    x = torch.randn((8, 1, 28, 28), generator=gen)
    rows = []
    for mode in ("none", "qformat", "int8"):
        model = PaperCNN(PaperCNNConfig(policy=ExecPolicy(quant=mode)))
        before = counts()
        with torch.inference_mode():
            eager = model.forward(params_gpu, x.to(device))
            plan = model.compile(batch=8).bind(params_gpu)(x.to(device))
            cpu = model.forward(params, x)
        torch.cuda.synchronize()
        grew = {k: counts()[k] - before[k] for k in before}
        check(grew["conv_window"] == 2 and grew["fused_cwp"] == 2,
              f"eager {mode}: launches {grew}")
        int8_routes_held(f"eager {mode}", mode, grew)
        e_vs_p, e_vs_cpu = max_abs(eager, plan), max_abs(eager.cpu(), cpu)
        tol = {"none": TOL_FP32 * (1 + float(cpu.abs().max())),
               "qformat": QSTEP, "int8": 0.0}[mode]
        check(e_vs_p <= tol and e_vs_cpu <= tol,
              f"eager {mode}: eager vs plan {e_vs_p}, card vs cpu "
              f"{e_vs_cpu}, tolerance {tol}")
        rows.append({"mode": mode, "eager_vs_plan_max_abs": e_vs_p,
                     "eager_vs_plan_bitwise": bitwise(eager, plan),
                     "card_vs_cpu_max_abs": e_vs_cpu, "launches": grew})
    emit({"phase": "eager", "runs": rows})


def phase_tree(device):
    """The paper-dataflow conv (Eq. 3-8) on the card: every window's
    products as an (B·Ho·Wo·M, η) matrix, the odd-even tree over each row
    through the op entry point (auto-dispatch: the addtree kernel), then
    the bias; held bitwise against ``conv2d_ref`` on the CPU."""
    import torch
    from repro_torch.core.window import conv2d_ref, window_products
    from repro_torch.ops import tree_reduce_sum

    gen = torch.Generator().manual_seed(5)
    rows = []
    for stage, shape in (("conv1", CONV1), ("conv2", CONV2)):
        for mode in ("none", "int8"):
            x, w, b, _ = conv_inputs(gen, 8, shape, mode, "cpu")
            want = conv2d_ref(x, w, b)
            prod = window_products(x.to(device), w.to(device))
            before = counts()["addtree"]
            sums = tree_reduce_sum(prod.reshape(-1, prod.shape[-1]))
            grew = counts()["addtree"] - before
            got = (sums.reshape(prod.shape[:-1]) + b.to(device)).permute(
                0, 3, 1, 2).cpu()
            check(grew == 1, f"tree {stage} {mode}: {grew} addtree launches")
            check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
                  f"tree {stage} {mode}: shape {tuple(got.shape)} or "
                  f"non-finite values")
            err = max_abs(got, want)
            check(bitwise(got, want), f"tree {stage} {mode}: card vs cpu "
                                      f"conv2d_ref max_abs {err}")
            rows.append({"stage": stage, "mode": mode, "B": 8,
                         "rows": prod.numel() // prod.shape[-1],
                         "eta": prod.shape[-1], "max_abs": err,
                         "bitwise": True, "launches": grew})
    emit({"phase": "tree", "runs": rows})


def phase_stream(device):
    """highres_cnn at 224x224, B = 8: the streamed plan (blocks 0 and 1 as
    row bands) against the untiled plan, a streamed fuse=False plan and
    the eager forward on the card, and against the CPU at B = 2; each
    run's launches from its plan's bands; then the launcher and the
    engines on the card and on the CPU."""
    import numpy as np
    import torch
    from repro_torch.models.vgg import VGGStyleCNN, VGGStyleCNNConfig
    from repro_torch.ops import ExecPolicy

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(VGGStyleCNN().input_shape(8), generator=gen)
    cpu_params = VGGStyleCNN().init(0, device="cpu")
    params = to_device(cpu_params, device)
    runs = []
    for mode in MODES:
        model = VGGStyleCNN(VGGStyleCNNConfig(policy=ExecPolicy(quant=mode)))
        plans = {"streamed": model.compile(batch=8),
                 "untiled": model.compile(batch=8, stream_budget=1 << 40),
                 "unfused": model.compile(batch=8, fuse=False)}
        tiled = {k: [n.id for n in p.graph if getattr(n, "tiling", None)]
                 for k, p in plans.items()}
        check(len(tiled["streamed"]) == len(tiled["unfused"]) == 2
              and not tiled["untiled"],
              f"stream {mode}: tiled stages {tiled}")
        out, launches = {}, {}
        for name, plan in plans.items():
            before = counts()
            with torch.inference_mode():
                out[name] = plan.bind(params)(x.to(device))
            torch.cuda.synchronize()
            launches[name] = {k: counts()[k] - before[k] for k in before}
            want = plan_launches(plan)
            check(launches[name] == want,
                  f"stream {mode} {name}: launches {launches[name]}, "
                  f"its plan's bands give {want}")
        before = counts()
        with torch.inference_mode():
            out["eager"] = model.forward(params, x.to(device))
        torch.cuda.synchronize()
        launches["eager"] = {k: counts()[k] - before[k] for k in before}
        check(launches["eager"]["conv_window"] == len(model.cfg.blocks)
              and launches["eager"]["fused_cwp"] == 0,
              f"stream {mode} eager: launches {launches['eager']}")
        int8_routes_held(f"stream {mode} eager", mode, launches["eager"])
        with torch.inference_mode():
            card2 = plans["streamed"].bind(params)(x[:2].to(device))
            cpu2 = plans["streamed"].bind(cpu_params)(x[:2])
        runs.append({
            "mode": mode, "B": 8,
            "bands": {k: [s[2][1] for s in launch_shapes(p)]
                      for k, p in plans.items()},
            "launches": launches,
            "streamed_vs_untiled": hold("streamed vs untiled", mode,
                                        out["streamed"], out["untiled"]),
            "unfused_vs_untiled": hold("unfused streamed vs untiled", mode,
                                       out["unfused"], out["untiled"]),
            "eager_vs_untiled": hold("eager vs untiled", mode, out["eager"],
                                     out["untiled"]),
            "card_vs_cpu_B2": hold("streamed card vs cpu, B = 2", mode,
                                   card2, cpu2)})
    serve = [serve_launcher("highres_cnn", 16)]
    rng = np.random.RandomState(3)
    images = [rng.randn(*VGGStyleCNN().input_shape()[1:]).astype(np.float32)
              for _ in range(12)]
    serve += serve_engines(VGGStyleCNN(), cpu_params, images)
    emit({"phase": "stream", "runs": runs, "serve": serve})


# --------------------------------------------------------------------- lm

def lm_prompts(vocab: int, prompt_len: int = 64, n: int = 8) -> list:
    """The launcher's workload: numpy seed 1, each prompt ``prompt_len``
    or ``prompt_len // 2`` tokens."""
    import numpy as np
    rng = np.random.RandomState(1)
    lens = rng.choice([prompt_len // 2, prompt_len], size=n)
    return [rng.randint(0, vocab, size=int(p)) for p in lens]


def lm_launcher(kv_quant: str, arch: str = LM_ARCH,
                prompt_len: int = 64) -> dict:
    """``launcher.main`` for ``arch`` at full size on the card (the
    lm phase's workload, at ``--prompt-len prompt_len``): every request
    served with its 16 tokens, the reference's report lines, no qmatmul
    launch (the launcher's compute policy is the default, as the
    reference's), and the card's peak memory over the call."""
    import io
    import torch
    from repro_torch.launch import serve as launcher
    buf = io.StringIO()
    before = counts()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(buf):
        eng, res = launcher.main(["--arch", arch] + LM_ARGV[2:6] +
                                 ["--prompt-len", str(prompt_len)] +
                                 LM_ARGV[8:] +
                                 ["--kv-quant", kv_quant,
                                  "--device", "cuda"])
    peak = torch.cuda.max_memory_allocated()
    grew = {k: counts()[k] - before[k] for k in before}
    report = buf.getvalue().strip().splitlines()
    print("\n".join(report), file=sys.stderr)
    vocab = eng.model.cfg.vocab
    check(len(res) == 8 and all(
        len(r.generated) == 16 and all(0 <= t < vocab for t in r.generated)
        for r in res.values()),
        f"lm launcher {arch} kv_quant={kv_quant}: {len(res)} results, "
        f"{[len(r.generated) for r in res.values()]} tokens each")
    check(not any(grew.values()),
          f"lm launcher {arch} kv_quant={kv_quant} launched kernels: {grew}")
    check(report and report[0].startswith(f"arch={arch} capacity=4") and
          any(ln.startswith("served 8 requests") for ln in report),
          f"lm launcher {arch} kv_quant={kv_quant}: report {report}")
    tok_s = re.search(r"\(([\d.]+) tok/s\)", buf.getvalue())
    cfg = eng.model.cfg
    return {"path": "launcher", "arch": arch, "kv_quant": kv_quant,
            "prompt_len": prompt_len, "layers": cfg.n_layers,
            "params": eng.model.param_count(),
            "report": report,
            "tokens_per_s": float(tok_s.group(1)) if tok_s else None,
            "engine_steps": eng.stats.steps, "kv_bytes": eng.kv.nbytes(),
            "max_memory_allocated": peak,
            "device_time_note": "wall clock, host dispatch included"}


def lm_engines(model, params, device, per_pass: int | None = None,
               prompt_len: int = 64, backends=(None, "torch")
               ) -> tuple[dict, dict]:
    """``Engine`` under ExecPolicy(quant="int8") over the launcher's
    requests (``prompt_len`` or half as many tokens), through the qmatmul
    kernel (the default backend on the card) and through its plain
    version (backend="torch"), both on the card (``backends``), each
    through its step graphs; the kernel's also with ``graphs=False``
    (the same steps eagerly on the same buffers). Every prefill and
    decode step of a graph run is a replay: each graph captured
    ``per_pass`` qmatmul launches (default 3 a layer: wi, wg, wo), its
    replays launched ``per_pass`` x (prefills + decode steps), and the
    wrappers counted each graph's twice (its warm-up and its capture);
    the plain run captured none; all runs give the same tokens. Returns
    (the report, the launches of the kernel graph run: the LM path's,
    counted from 0 before its engine was built)."""
    import torch
    from repro_torch.ops import ExecPolicy
    from repro_torch.serve import Engine, EngineConfig

    per_pass = per_pass or 3 * model.cfg.n_layers
    prompts = lm_prompts(model.cfg.vocab, prompt_len)
    runs = {}
    for backend, graphs in [(b, g) for b in backends
                            for g in ((True, False) if b is None
                                      else (True,))]:
        name = (backend or "cuda") + ("" if graphs else "_eager")
        if name == "cuda":
            reset_counts()                  # the LM path starts here
        eng = Engine(model, params, EngineConfig(
            capacity=4, max_seq=prompt_len + 16,
            policy=ExecPolicy(quant="int8", backend=backend),
            device=str(device), graphs=graphs))
        for length in sorted({len(p) for p in prompts}):
            eng.warm_prefill(length)        # captured before the clock
        eng.warm_decode()
        for p in prompts:
            eng.add_request(p, 16)
        t0 = time.perf_counter()
        fin = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = eng.stats
        runs[name] = {
            "tokens": {r.uid: r.generated for r in fin},
            "prefills": s.prefills,
            "decode_steps": s.decode_lane_steps // eng.config.capacity,
            "qmatmul_replayed": eng.graph_launches().get("qmatmul", 0),
            "cache_quant": eng.config.cache_quant, "wall_s": wall,
            "tokens_per_s": (s.prefill_tokens + s.decode_tokens) / wall}
        if graphs:
            runs[name].update(compiled_engine(f"lm engine int8 {name}",
                                              eng))
        if name == "cuda":
            path = counts()
            captured = {k: sum(g.kernels.get(k, 0) for g in eng.graphs())
                        for k in path}
            check(all(g.kernels.get("qmatmul") == per_pass
                      for g in eng.graphs()),
                  f"lm engine int8: graphs captured "
                  f"{[g.kernels for g in eng.graphs()]}, expected "
                  f"{per_pass} qmatmul launches each")
            check(path == {k: 2 * v for k, v in captured.items()},
                  f"lm engine int8: wrapper launches {path}, expected a "
                  f"warm-up and a capture of each graph: {captured} x 2")
        del eng
    k = runs["cuda"]
    want = per_pass * (k["prefills"] + k["decode_steps"])
    check(k["qmatmul_replayed"] == want,
          f"lm engine int8: the replays launched qmatmul "
          f"{k['qmatmul_replayed']} times, expected {per_pass} x "
          f"({k['prefills']} prefills + {k['decode_steps']} decode steps) "
          f"= {want}")
    check(len(k["tokens"]) == 8 and all(
        len(t) == 16 and all(0 <= x < model.cfg.vocab for x in t)
        for t in k["tokens"].values()),
        f"lm engine int8: tokens {k['tokens']}")
    check(k["tokens"] == runs["cuda_eager"]["tokens"],
          f"lm engine int8: graph tokens {k['tokens']} vs eager "
          f"{runs['cuda_eager']['tokens']}")
    p = runs.get("torch")
    if p is not None:
        check(p["qmatmul_replayed"] == 0,
              f"lm engine int8 backend=torch replayed qmatmul "
              f"{p['qmatmul_replayed']} times")
        check(k["tokens"] == p["tokens"],
              f"lm engine int8: kernel tokens {k['tokens']} vs plain "
              f"{p['tokens']}")
    return {"path": "engine", "policy": "int8", "per_pass": per_pass,
            "prompt_len": prompt_len, "expected_launches": want,
            "tokens_vs_plain": "equal" if p is not None else "not run",
            "tokens_graph_vs_eager": "equal", "wrapper_launches": path,
            **{f"{name}_{key}": v for name, r in runs.items()
               for key, v in r.items() if key != "tokens"}}, path


def compiled_engine(label, eng) -> dict:
    """An engine that served through its step graphs: every graph
    captured, the prefill graphs' replays equal to its prefills and the
    decode graph's to its decode steps. Returns the graphs' capture ms
    and pool bytes."""
    graphs = eng.graphs()
    steps = eng.stats.decode_lane_steps // eng.config.capacity
    prefills = sum(g.calls for g in graphs if g is not eng._decode_graph)
    check(all(g.captured or g.released for g in graphs)
          and prefills == eng.stats.prefills
          and eng._decode_graph.calls == steps,
          f"{label}: {prefills} prefill replays for {eng.stats.prefills} "
          f"prefills, {eng._decode_graph.calls} decode replays for "
          f"{steps} steps, captured {[g.captured for g in graphs]}")
    return {"graphs": len(graphs),
            "capture_ms": sum(g.capture_s for g in graphs) * 1e3,
            "pool_bytes": sum(g.pool_bytes for g in graphs)}


def engine_graph_vs_eager(label, model, params, device,
                          prompt_len: int = 64, **config) -> dict:
    """``Engine`` (``config``: kv_quant, policy) through its step graphs
    and with ``graphs=False`` over the launcher's requests (``prompt_len``
    or half, 16 new tokens, capacity 4): the same tokens, every step of
    the graph run a replay; each run's wall time and tokens/s."""
    import torch
    from repro_torch.serve import Engine, EngineConfig
    prompts = lm_prompts(model.cfg.vocab, prompt_len)
    out, toks = {"label": label}, {}
    for graphs in (True, False):
        eng = Engine(model, params, EngineConfig(
            capacity=4, max_seq=prompt_len + 16, device=str(device),
            graphs=graphs, **config))
        for length in sorted({len(p) for p in prompts}):
            eng.warm_prefill(length)
        eng.warm_decode()
        for p in prompts:
            eng.add_request(p, 16)
        t0 = time.perf_counter()
        fin = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = eng.stats
        key = "graph" if graphs else "eager"
        toks[key] = {r.uid: r.generated for r in fin}
        out[f"{key}_wall_s"] = wall
        out[f"{key}_tokens_per_s"] = (s.prefill_tokens
                                      + s.decode_tokens) / wall
        if graphs:
            out.update(compiled_engine(label, eng))
        del eng
    vocab = model.cfg.vocab
    check(len(toks["graph"]) == 8 and all(
        len(t) == 16 and all(0 <= x < vocab for x in t)
        for t in toks["graph"].values()),
        f"{label}: {len(toks['graph'])} requests, tokens {toks['graph']}")
    check(toks["graph"] == toks["eager"],
          f"{label}: graph tokens {toks['graph']} vs eager "
          f"{toks['eager']}")
    out["sample"] = toks["graph"][0][:8]
    out["tokens_graph_vs_eager"] = "equal"
    return out


def lm_step_logits(model, params, prompts, policy, device, first=None,
                   max_seq: int = 48):
    """Each prompt's prefill logits (batch 1, written into its slot of a
    SlotKVCache as the engine does), then one decode step over all slots
    at their own positions with the tokens ``first`` (default: the
    prefills' argmax). Returns (prefill logits, decode logits, first),
    on the CPU."""
    import torch
    from repro_torch.ops import use_policy
    from repro_torch.serve import EngineConfig, SlotKVCache
    from repro_torch.serve.cache import dequantize_leaves
    from repro_torch.serve.steps import make_decode_step

    quant = EngineConfig(policy=policy).cache_quant
    kv = SlotKVCache(model, len(prompts), max_seq, quant=quant,
                     device=device)
    pre = []
    with use_policy(policy), torch.no_grad():
        for slot, p in enumerate(prompts):
            cache = model.init_cache(1, len(p), device=device)
            logits, cache = model.prefill(
                params, {"tokens": torch.as_tensor(p[None], device=device)},
                cache)
            kv.write_prefill(slot, cache, len(p))
            pre.append(logits[0].cpu())
    pre = torch.stack(pre)
    if first is None:
        first = torch.argmax(pre, dim=-1).to(torch.int32)
    cache = dequantize_leaves(kv.codes, kv.scales, model.cfg.dtype) \
        if quant == "int8" else kv.data
    decode = make_decode_step(model, sample=False, policy=policy)
    logits, _ = decode(params, first.to(device),
                       torch.as_tensor(kv.positions(), device=device), cache)
    return pre, logits.cpu(), first


def card_vs_cpu_model(arch: str, layers: int, device):
    """``arch`` cut to ``layers`` layers at full width in fp32, its params
    drawn on the card by a generator of its own (seed 0)."""
    import torch
    from repro_torch.configs import get_arch
    full = get_arch(arch).model()
    model = type(full)(dataclasses.replace(full.cfg, n_layers=layers,
                                           dtype=torch.float32))
    return model, model.init(torch.Generator(device).manual_seed(0),
                             device=device)


def card_vs_cpu_prompts(vocab: int, prompt_lens) -> list:
    import numpy as np
    rng = np.random.RandomState(2)
    return [rng.randint(0, vocab, size=p) for p in prompt_lens]


def card_vs_cpu_host(arch: str, layers: int, modes: tuple,
                     prompt_lens: tuple, nudge: bool,
                     threads: int | None = None) -> dict:
    """The CPU side of ``lm_card_vs_cpu``: the card's seed-0 draw copied
    to the CPU, each mode's prefill and first decode logits there (and,
    with ``nudge``, those of a 1e-5 relative embedding nudge); run in a
    process of its own beside the card's phases (``start_host_jobs``)
    or in place. Returns {mode: {"pre", "dec", "first", "moved"}}."""
    import torch
    from repro_torch.ops import ExecPolicy
    if threads:
        torch.set_num_threads(threads)
    device = torch.device("cuda", 0)
    model, params = card_vs_cpu_model(arch, layers, device)
    cpu_params = to_device(params, "cpu")
    del params
    torch.cuda.empty_cache()
    prompts = card_vs_cpu_prompts(model.cfg.vocab, prompt_lens)
    max_seq = max(prompt_lens) + 16
    if nudge:
        emb = cpu_params["embedding"]
        sign = torch.randint(0, 2, emb.shape, generator=torch.Generator()
                             .manual_seed(1)) * 2 - 1
        nudged = dict(cpu_params, embedding=emb * (1 + 1e-5 * sign))
    out = {}
    for mode in modes:
        pol = ExecPolicy(quant=mode)
        pre, dec, first = lm_step_logits(model, cpu_params, prompts, pol,
                                         "cpu", max_seq=max_seq)
        moved = (lm_step_logits(model, nudged, prompts, pol, "cpu", first,
                                max_seq=max_seq)[:2]
                 if nudge else (None, None))
        out[mode] = {"pre": pre, "dec": dec, "first": first, "moved": moved}
    return out


def lm_card_vs_cpu(device, arch: str = LM_ARCH, layers: int = 2,
                   modes=("none", "int8"),
                   prompt_lens=(32, 16, 32, 16),
                   nudge: bool = True) -> list[dict]:
    """``arch`` cut to ``layers`` layers at full width in fp32 (for
    qwen1.5-0.5b: d_model 1,024, d_ff 2,816, vocab 151,936), drawn on
    the card by a generator of its own and copied to the CPU: each
    request's prefill logits and the first decode step's, under the
    default policy and under int8 (``modes``), card against CPU within
    TOL_LM. With ``nudge``, beside each, how far the CPU's own logits
    move when the embedding moves by a relative 1e-5 (seeded signs): the
    size of a flipped int8 code. The CPU side comes from a host job
    started with the script (``card_vs_cpu_host``) where there is one."""
    import torch
    from repro_torch.ops import ExecPolicy

    key = (arch, layers, tuple(modes), tuple(prompt_lens), nudge)
    job = HOST_JOBS.pop(("card_vs_cpu",) + key, None)
    host = job.result() if job is not None else card_vs_cpu_host(*key)
    model, params = card_vs_cpu_model(arch, layers, device)
    cfg = model.cfg
    max_seq = max(prompt_lens) + 16
    prompts = card_vs_cpu_prompts(cfg.vocab, prompt_lens)
    rows = []
    for mode in modes:
        pol = ExecPolicy(quant=mode)
        h = host[mode]
        cpu_pre, cpu_dec, first, moved = (h["pre"], h["dec"], h["first"],
                                          h["moved"])
        card_pre, card_dec, _ = lm_step_logits(
            model, params, prompts, pol, device, first, max_seq=max_seq)
        row = {"arch": arch, "mode": mode, "layers": layers,
               "d_model": cfg.d_model, "vocab": cfg.vocab,
               "requests": len(prompts), "cpu_side": "host job"
               if job is not None else "in place"}
        for name, got, want, off in (
                ("prefill", card_pre, cpu_pre, moved[0]),
                ("decode", card_dec, cpu_dec, moved[1])):
            check(got.shape == want.shape == (len(prompts), cfg.vocab)
                  and bool(torch.isfinite(got).all())
                  and bool(torch.isfinite(want).all()),
                  f"lm card vs cpu {arch} {mode} {name}: shapes "
                  f"{tuple(got.shape)} / {tuple(want.shape)} or "
                  f"non-finite values")
            err = max_abs(got, want)
            tol = TOL_LM[mode] * (1 + float(want.abs().max()))
            check(err <= tol, f"lm card vs cpu {arch} {mode} {name}: "
                              f"max_abs {err}, tolerance {tol}")
            row[name] = {"max_abs": err, "tolerance": tol,
                         "max_abs_logit": float(want.abs().max()),
                         "top1_agree": int((got.argmax(-1)
                                            == want.argmax(-1)).sum())}
            if off is not None:
                row[name]["cpu_nudged_1e-5_max_abs"] = max_abs(off, want)
        rows.append(row)
    return rows


def filled_engine(model, params, device, policy=None, prompts=None,
                  max_seq: int = 80, kv_quant=None):
    """An engine at capacity 4 under ``policy`` (and ``kv_quant``) with
    every slot prefilled from ``prompts`` (default: the launcher's first
    4): (engine, the next tokens (4,), the slots' positions (4,))."""
    import torch
    from repro_torch.ops import ExecPolicy
    from repro_torch.serve import Engine, EngineConfig
    eng = Engine(model, params, EngineConfig(capacity=4, max_seq=max_seq,
                                             policy=policy or ExecPolicy(),
                                             kv_quant=kv_quant,
                                             device=str(device)))
    for p in (prompts or lm_prompts(model.cfg.vocab))[:4]:
        eng.add_request(p, 16)
    eng._admit()
    check(eng.scheduler.num_running == 4,
          f"{model.cfg.name}: slots not full")
    return (eng, torch.as_tensor(eng._last_token, device=device),
            torch.as_tensor(eng.kv.positions(), device=device))


def lm_logits_bitwise(model, params, device, prompt_len: int = 64) -> dict:
    """Under int8, through the qmatmul kernel and through its plain
    version on the card, the same logits bitwise: one ``prompt_len``-token
    prefill (M = prompt_len), and one decode step over an engine's 4 full
    slots at their own positions (M = 4), each backend from its own
    dequantized copy of the same cache."""
    import torch
    from repro_torch.ops import ExecPolicy, use_policy
    from repro_torch.serve.cache import dequantize_leaves
    from repro_torch.serve.steps import make_decode_step

    prompts = lm_prompts(model.cfg.vocab, prompt_len)
    full = [p for p in prompts if len(p) == prompt_len]
    toks = torch.as_tensor(full[1][None], device=device)
    eng, tokens, pos = filled_engine(model, params, device,
                                     ExecPolicy(quant="int8"), prompts,
                                     max_seq=prompt_len + 16)
    out = {}
    for backend in (None, "torch"):
        pol = ExecPolicy(quant="int8", backend=backend)
        with use_policy(pol), torch.no_grad():
            pre, _ = model.prefill(
                eng.params, {"tokens": toks},
                model.init_cache(1, toks.shape[1], device=device))
        cache = dequantize_leaves(eng.kv.codes, eng.kv.scales,
                                  model.cfg.dtype)
        dec, _ = make_decode_step(model, sample=False, policy=pol)(
            eng.params, tokens, pos, cache)
        out[backend] = {"prefill": pre, "decode": dec}
    torch.cuda.synchronize()
    rows = {}
    for step, m in (("prefill", toks.shape[1]), ("decode", 4)):
        got, want = out[None][step], out["torch"][step]
        err = max_abs(got, want)
        check(bitwise(got, want),
              f"lm int8 {step} logits: kernel vs plain max_abs {err}")
        rows[step] = {"M": m, "max_abs": err, "bitwise": True}
    rows["decode"]["positions"] = pos.tolist()
    return rows


def lm_times(model, params, device) -> list[dict]:
    """qwen1.5's steps as the engine runs them, each as a StepGraph
    replay and eagerly on the same buffers (``step_graphs``): a 64-token
    prefill and a decode step at capacity 4 with every slot live, logits
    bitwise graph vs eager in bf16, with an int8 KV cache and under int8
    compute; both timed in bf16 and under int8."""
    from repro_torch.ops import ExecPolicy

    prompts = [p for p in lm_prompts(model.cfg.vocab) if len(p) == 64]
    rows = []
    for mode, pol, kv in (("bf16", ExecPolicy(), None),
                          ("int8_kv", ExecPolicy(), "int8"),
                          ("int8", ExecPolicy(quant="int8"), None)):
        eng, _, _ = filled_engine(model, params, device, pol, prompts,
                                  kv_quant=kv)
        steps = step_graphs(f"{model.cfg.name} {mode}", model, eng,
                            prompts[0], device, timed=mode != "int8_kv")
        for step, row in steps.items():
            rows.append({"step": step, "mode": mode,
                         "M": 64 if step == "prefill" else 4,
                         "cache_quant": eng.config.cache_quant, **row})
        del eng
    rows.append({"weight_costs": lm_weight_costs(model, params)})
    return rows


# one compact line of step times a model, printed before the result
STEP_LINES: list[dict] = []


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_tree(v) for v in tree)
    return tree.clone()


def step_graphs(label, model, eng, prompt, device, timed=True) -> dict:
    """A prefill of ``prompt`` and a decode step over ``eng``'s filled
    slots at their own positions, each returning its logits, built as
    the engine builds its steps (``engine_decode_step``, the prefill
    from a zeroed batch-1 cache) twice: a StepGraph captured on the card
    and one run eagerly on buffers of its own (``compiled=False``), the
    decode each from its own copy of the slot state. Their first calls'
    logits must be bitwise equal. With ``timed``, ``step_times`` of both
    (the graph's busy time is its replay's kernels). Each step's capture
    ms and graph pool bytes; one compact line in STEP_LINES."""
    import torch
    from repro_torch.ops import use_policy
    from repro_torch.serve.engine import engine_decode_step
    from repro_torch.serve.graphs import StepGraph, tree_tensors

    pol = eng.config.policy
    decode = engine_decode_step(model, eng.config, sample=False)

    def prefill(params, tokens, cache):
        for leaf in tree_tensors(cache):
            leaf.zero_()
        with use_policy(pol), torch.no_grad():
            return model.prefill(params, {"tokens": tokens}, cache)[0]

    def step(params, tokens, pos, state):
        return decode(params, tokens, pos, *state)[0]

    def build(name, compiled):
        if name == "prefill":
            ins, state = {"params": eng.params,
                          "tokens": torch.as_tensor(prompt[None],
                                                    device=device),
                          "cache": model.init_cache(1, len(prompt),
                                                    device=device)}, ()
        else:
            state = _clone_tree(eng.kv.device_state())
            ins = {"params": eng.params,
                   "tokens": torch.as_tensor(eng._last_token, device=device),
                   "pos": torch.as_tensor(eng.kv.positions(), device=device),
                   "state": state}
        return StepGraph(prefill if name == "prefill" else step, ins,
                         state=state, device=device, compiled=compiled,
                         name=f"{label} {name}")

    out, line = {}, {"steps": label}
    for name in ("prefill", "decode"):
        eager, graph = build(name, False), build(name, True)
        want = eager().clone()
        got = graph().clone()
        torch.cuda.synchronize()
        err = max_abs(got, want)
        check(graph.captured and bitwise(got, want),
              f"{label} {name} logits: graph vs eager max_abs {err}")
        row = {"graph_vs_eager_max_abs": err, "bitwise": True,
               "capture_ms": graph.capture_s * 1e3,
               "pool_bytes": graph.pool_bytes,
               "graph_kernels": {k: v for k, v in graph.kernels.items()
                                 if v}}
        line.setdefault("capture_ms", []).append(round(row["capture_ms"],
                                                       1))
        line.setdefault("pool_mb", []).append(
            round(graph.pool_bytes / 2 ** 20, 1))
        if timed:
            row["eager"] = step_times(eager)
            row["graph"] = step_times(graph)
            line[name] = {k: [round(row[k][m], 3) for m in
                              ("wall_ms", "device_busy_ms", "event_ms")]
                          for k in ("eager", "graph")}
        out[name] = row
        del eager, graph
    STEP_LINES.append(line)
    free_card()
    return out


def step_times(fn) -> dict:
    """One LM step ``fn`` timed three ways: its CUDA-event time (one
    call queued alone behind a ~0.25 s spin, the median of 10), its wall
    time (one call to its synchronize, the median of 10), and its device
    busy time (torch.profiler's kernel sum over one call), with that
    profile."""
    import torch
    ms, dry = call_device_ms(fn, reps=10, spin=int(5e8))
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = lm_profile(fn)
    wall = statistics.median(walls)
    busy = prof.get("kernel_us", 0.0) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy,
            "busy_share_of_wall": busy / wall, "event_ms": ms,
            "queue_ran_dry": dry, "profile": prof}


def lm_profile(fn) -> dict:
    """torch.profiler over one call: the device time of the aten ops that
    launched most of it (their own kernels), of the kernels by name
    (qmatmul's come from ctypes, under no aten op), and the device's busy
    share of the call's wall time."""
    import torch
    try:
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ops, kernels = [], []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if not us:
                continue
            row = {"name": e.key[:80], "calls": e.count,
                   "self_device_us": us}
            (ops if e.key.startswith("aten::") else kernels).append(row)
        busy = sum(r["self_device_us"] for r in kernels)
        for rows in (ops, kernels):
            rows.sort(key=lambda r: -r["self_device_us"])
        return {"wall_us": wall_us, "kernel_us": busy,
                "kernel_launches": sum(r["calls"] for r in kernels),
                "busy_share": busy / wall_us, "ops": ops[:15],
                "kernels": kernels[:12]}
    except Exception as e:      # informational: a profiler fault is no check
        return {"error": repr(e)}


def lm_weight_costs(model, params) -> dict:
    """The two per-call weight costs the reference's semantics impose on
    every forward: each fp32 weight cast to the model dtype (the
    ``.astype(x.dtype)`` before each matmul, the tied embedding too), and
    under int8 each MLP weight quantized again (``dense`` quantizes on
    every call). Device ms for the whole model, one forward's worth."""
    import torch
    from repro_torch.core.quantize import quantize_int8
    dt = model.cfg.dtype
    mats = [params["embedding"]] + [
        t for grp in ("attn", "mlp") for t in params["layers"][grp].values()]
    cast_ms, _ = call_device_ms(lambda: [t.to(dt) for t in mats], reps=10,
                                spin=int(2e8))
    mlp = [params["layers"]["mlp"][k][0].to(dt) for k in ("wi", "wg", "wo")]
    quant_ms, _ = device_ms(lambda: [quantize_int8(w, axis=0) for w in mlp],
                            reps=20)
    return {"cast_all_weights_ms": cast_ms,
            "quantize_mlp_weights_ms": quant_ms * model.cfg.n_layers,
            "params": int(sum(t.numel() for t in mats))}


def lm_dense(arch: str, device) -> tuple[dict, dict]:
    """``arch`` at full width and LM_DENSE_LAYERS layers (fp32 weights
    from seed 0 on the card, bf16 compute): ``Engine`` under int8 through
    the qmatmul kernel and through its plain version (tokens equal,
    3 x layers launches a prefill and a decode step), a 64-token
    prefill's and a 4-slot decode step's logits bitwise kernel vs plain,
    then 1 layer in fp32 card against CPU. Returns (the report, the
    kernel engine run's launches)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import TransformerLM

    cfg = dataclasses.replace(get_arch(arch).model().cfg,
                              n_layers=LM_DENSE_LAYERS)
    model = TransformerLM(cfg)
    params = model.init(0, device=device)
    out = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab}
    t0 = time.perf_counter()
    out["engine"], launches = lm_engines(model, params, device)
    out["logits_kernel_vs_plain"] = lm_logits_bitwise(model, params, device)
    del params
    free_card()
    out["card_vs_cpu"] = lm_card_vs_cpu(device, arch, layers=1,
                                        modes=("none",),
                                        prompt_lens=(16, 8), nudge=False)
    free_card()
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def phase_lm(device) -> dict:
    """qwen1.5-0.5b on the card: Engine under int8 through the kernel and
    through the plain qmatmul, the launcher (bf16 and an int8 KV cache),
    and a 2-layer full-width model card vs CPU; the engine in bf16 and
    with an int8 KV cache through its step graphs and eagerly (the same
    tokens); then a prefill's and a full decode step's logits kernel vs
    plain, and graph vs eager with the times. Then each
    LM_DENSE_ARCHS config at full width (``lm_dense``), and the launcher
    at full size for each LM_FULL_ARCHS config. Returns the LM path's
    launches: those of the int8 engines' ``run()``."""
    from repro_torch.configs import get_arch

    model = get_arch(LM_ARCH).model()
    params = model.init(0, device=device)
    # the engines first: the launchers' tokens/s then hold no first-call
    # costs (cuBLAS handles, the allocator's growth)
    out = {"phase": "lm", "arch": LM_ARCH}
    out["engine"], launches = lm_engines(model, params, device)
    lap("lm engines")
    del params
    out["launcher"] = [lm_launcher(q) for q in ("none", "int8")]
    lap("lm launcher x2")
    out["card_vs_cpu"] = lm_card_vs_cpu(device)
    lap("lm card_vs_cpu")
    cut = type(model)(dataclasses.replace(
        model.cfg, n_layers=LM_STEP_LAYERS,
        name=f"{LM_ARCH} {LM_STEP_LAYERS}L"))
    params = cut.init(0, device=device)
    out["graph_vs_eager"] = [engine_graph_vs_eager(
        f"{cut.cfg.name} kv_quant={q}", cut, params, device, kv_quant=q)
        for q in ("none", "int8")]
    out["logits_kernel_vs_plain"] = lm_logits_bitwise(cut, params, device)
    out["times"] = lm_times(cut, params, device)
    out["tolerances"] = TOL_LM
    lap("lm graph_vs_eager, logits, times")
    del params
    free_card()
    out["dense"] = []
    for arch in LM_DENSE_ARCHS:
        row, grew = lm_dense(arch, device)
        out["dense"].append(row)
        launches = {k: v + grew[k] for k, v in launches.items()}
        lap(f"lm dense {arch}")
    for arch in LM_FULL_ARCHS:
        free_card()
        out["launcher"].append(lm_launcher("none", arch))
        lap(f"lm launcher {arch}")
    free_card()
    emit(out)
    return launches


# -------------------------------------------------------------------- moe

def moe_engine(model, params, device) -> dict:
    """``Engine`` over the launcher's synthetic mix (8 requests, prompts
    of 64 or 32 tokens, 16 new tokens each, capacity 4), through its
    step graphs and eagerly: every request served with its tokens, the
    same both ways (``engine_graph_vs_eager``)."""
    return engine_graph_vs_eager(f"moe engine {model.cfg.name}", model,
                                 params, device)


def moe_group_independence(model, params, device) -> dict:
    """A decode step over 4 live slots against each slot's row decoded
    alone (batch 1, its own copy of its cache row): every row's logits
    within TOL_BF16 of 1 + max|logit|, each row a dispatch group of its
    own. Rows whose experts differ between the two runs are counted
    (another batch size may take another GEMM, so bf16 sums may round
    apart)."""
    import torch
    from repro_torch.models.moe import local_routing_trace
    from repro_torch.serve.steps import make_decode_step
    eng, tokens, pos = filled_engine(model, params, device)
    decode = make_decode_step(model, sample=False)
    cache = eng.kv.data
    with local_routing_trace() as log:
        together, _ = decode(eng.params, tokens, pos,
                             {k: v.clone() for k, v in cache.items()})
    routes = [fe for fe, _ in log]
    rows, routed_apart = [], 0
    for i in range(4):
        with local_routing_trace() as log:
            alone, _ = decode(eng.params, tokens[i:i + 1], pos[i:i + 1],
                              {k: v[:, i:i + 1].clone()
                               for k, v in cache.items()})
        apart = any(not torch.equal(fe[0], r[i])
                    for (fe, _), r in zip(log, routes))
        routed_apart += apart
        want = together[i:i + 1].float()
        err = max_abs(alone.float(), want)
        tol = TOL_BF16 * (1 + float(want.abs().max()))
        check(bool(torch.isfinite(alone).all()) and err <= tol,
              f"moe {model.cfg.name} group independence: row {i} alone "
              f"max_abs {err}, tolerance {tol}")
        rows.append({"row": i, "max_abs": err, "tolerance": tol,
                     "routing_differs": apart})
    return {"positions": pos.tolist(), "rows": rows,
            "rows_routed_apart": routed_apart}


def moe_drops(model, params, device) -> dict:
    """One 64-token prefill (batch 1, one dispatch group): the
    assignments dropped past capacity in each layer, and the experts
    each layer's routing reached."""
    import torch
    from repro_torch.models.moe import _capacity, local_routing_trace
    prompt = next(p for p in lm_prompts(model.cfg.vocab) if len(p) == 64)
    with local_routing_trace() as log, torch.no_grad():
        model.prefill(params, {"tokens": torch.as_tensor(
            prompt[None], device=device)},
            model.init_cache(1, 64, device=device))
    check(len(log) == model.cfg.n_layers,
          f"moe {model.cfg.name} drops: {len(log)} routings recorded for "
          f"{model.cfg.n_layers} layers")
    m = model.cfg.moe
    return {"tokens": 64, "top_k": m.top_k,
            "capacity": _capacity(64, m),
            "mean_per_expert": 64 * m.top_k / m.n_experts,
            "dropped_per_layer": [int((~keep).sum()) for _, keep in log],
            "experts_reached_per_layer": [int(fe.unique().numel())
                                          for fe, _ in log]}


def moe_times(model, params, device) -> list[dict]:
    """Device time (one call behind a spin, CUDA events), device busy
    time (torch.profiler's kernel sum), wall time, and a top-ops profile
    of a 64-token prefill and of a decode step at capacity 4, each
    eagerly and as a graph replay with its logits bitwise between the
    two (``step_graphs``), beside the bytes bound: every expert weight
    read once a layer (and the other weights: attention, router, the
    head), at PEAK_BYTES; and the same with only the experts this call's
    routing reached."""
    import torch
    from repro_torch.models.moe import local_routing_trace
    eng, tokens, pos = filled_engine(model, params, device)
    prompt = next(p for p in lm_prompts(model.cfg.vocab) if len(p) == 64)
    toks = torch.as_tensor(prompt[None], device=device)
    state = eng.kv.device_state()
    cfg, m = model.cfg, model.cfg.moe
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    experts = params["layers"]["moe"]
    expert_bytes = sum(nbytes(experts[k]) for k in ("wi", "wg", "wo")
                       if k in experts) // (cfg.n_layers * m.n_experts)
    # every weight but the routed experts' and the input embedding's
    other = (sum(nbytes(t) for t in _leaves_of(params))
             - nbytes(params["embedding"])
             - cfg.n_layers * m.n_experts * expert_bytes)
    fns = {"prefill": lambda: eng._prefill(
               eng.params, {"tokens": toks},
               model.init_cache(1, 64, device=device)),
           "decode": lambda: eng._decode(eng.params, tokens, pos, *state)}
    steps = step_graphs(f"{cfg.name} L={cfg.n_layers}", model, eng,
                        prompt, device)
    rows = []
    for step, fn in fns.items():
        with local_routing_trace() as log:
            fn()
        check(len(log) == cfg.n_layers,
              f"moe {cfg.name} {step}: {len(log)} routings recorded for "
              f"{cfg.n_layers} layers")
        reached = [int(fe.unique().numel()) for fe, _ in log]
        rows_read = 64 if step == "prefill" else 4
        base = other + rows_read * nbytes(params["embedding"][0])
        all_bytes = base + cfg.n_layers * m.n_experts * expert_bytes
        routed_bytes = base + sum(reached) * expert_bytes
        rows.append({"step": step, "M": rows_read, "layers": cfg.n_layers,
                     **steps[step],
                     "bound_ms": all_bytes / PEAK_BYTES * 1e3,
                     "bound_by": "bytes",
                     "expert_bound_ms_per_layer":
                         m.n_experts * expert_bytes / PEAK_BYTES * 1e3,
                     "routed_bound_ms": routed_bytes / PEAK_BYTES * 1e3,
                     "experts_reached_per_layer": reached})
    return rows


def _leaves_of(tree):
    """Every tensor of a params tree."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves_of(v)
        else:
            yield v


def moe_card_vs_cpu_inputs(device):
    """dbrx's MoE config, its full-width fp32 expert params and a (1, 64,
    6,144) input, drawn on the card from seed 3."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    cfg = get_arch("dbrx-132b").model().cfg.moe
    g = torch.Generator(device).manual_seed(3)
    params = moe.moe_init(g, cfg, device)
    x = torch.randn((1, 64, cfg.d_model), generator=g, device=device)
    return cfg, params, x


def moe_card_vs_cpu_host(threads: int | None = None) -> dict:
    """The CPU side of ``moe_card_vs_cpu``: the card's draw copied to the
    CPU, ``moe_apply`` there, its routing. Run in a process of its own
    beside the card's phases (``start_host_jobs``) or in place."""
    import torch
    from repro_torch.models import moe
    if threads:
        torch.set_num_threads(threads)
    cfg, params, x = moe_card_vs_cpu_inputs(torch.device("cuda", 0))
    cpu_params, cpu_x = to_device(params, "cpu"), x.cpu()
    del params, x
    torch.cuda.empty_cache()
    with moe.local_routing_trace() as log:
        out, aux = moe.moe_apply(cpu_params, cpu_x, cfg, None)
    probs, _, _, _ = moe._route(cpu_params, cpu_x, cfg)
    (experts, keep), = log
    return {"out": out, "aux": aux, "probs": probs, "experts": experts[0],
            "keep": keep[0]}


def moe_card_vs_cpu(device) -> dict:
    """One ``moe_apply`` at full dbrx width (d_model 6,144, 16 experts of
    d_ff 10,752, top-4) in fp32 on a (1, 64, 6,144) input, the weights
    drawn on the card and copied to the CPU (12.7 GB): every assignment
    whose k-th to (k+1)-th probability margin exceeds 1e-5 takes the
    same expert and the same keep on both; the tokens that touch no
    near-tie agree within 1e-4 of 1 + max|want|; the aux loss within
    1e-6."""
    import torch
    from repro_torch.models import moe
    job = HOST_JOBS.pop("moe_card_vs_cpu", None)
    host = job.result() if job is not None else moe_card_vs_cpu_host()
    want, want_aux, probs, e_cpu, keep_cpu = (
        host[k] for k in ("out", "aux", "probs", "experts", "keep"))
    cfg, params, x = moe_card_vs_cpu_inputs(device)
    with moe.local_routing_trace() as log:
        got, aux = moe.moe_apply(params, x, cfg, None)
    del params
    srt = torch.sort(probs, dim=-1, descending=True).values
    margin = (srt[..., cfg.top_k - 1] - srt[..., cfg.top_k])[0]   # (S,)
    clear = (margin > 1e-5).repeat_interleave(cfg.top_k)          # (S·k,)
    (e_card, keep_card), = log
    e_card, keep_card = e_card.cpu()[0], keep_card.cpu()[0]
    check(torch.equal(e_card[clear], e_cpu[clear]) and
          torch.equal(keep_card[clear], keep_cpu[clear]),
          "moe card vs cpu: an assignment clear of any near-tie took "
          "another expert or keep")
    tokens = margin > 1e-5
    err = max_abs(got.cpu()[0][tokens], want[0][tokens])
    tol = 1e-4 * (1 + float(want.abs().max()))
    aux_err = abs(float(aux) - float(want_aux))
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"moe card vs cpu: max_abs {err}, tolerance {tol}")
    check(aux_err <= 1e-6, f"moe card vs cpu: aux {float(aux)} vs "
                           f"{float(want_aux)}")
    return {"shape": [1, 64, cfg.d_model], "smallest_margin":
            float(margin.min()), "near_ties": int((~tokens).sum()),
            "dropped": int((~keep_cpu).sum()), "max_abs": err,
            "tolerance": tol, "max_abs_out": float(want.abs().max()),
            "aux": float(want_aux), "aux_abs_err": aux_err}


def phase_moe(device) -> dict:
    """Both MoE models at full width and reduced depth on the card, bf16
    weights (drawn in fp32 from seed 0 on the card, then cast once as the
    engine casts them: the router stays fp32):
    ``Engine`` over the launcher's mix, the drops of a 64-token prefill,
    group independence at capacity 4, the times; then one full-width
    dbrx ``moe_apply`` card against CPU. No kernel launches: the
    reference's MoE reaches no Pallas kernel. Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve.weights import cast_serving_params

    reset_counts()
    out = {"phase": "moe", "models": []}
    for arch in MOE_ARCHS:
        free_card()
        cfg = get_arch(arch).model().cfg
        depth = MOE_LAYERS
        model = TransformerLM(dataclasses.replace(cfg, n_layers=depth))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(0, device=device)
        torch.cuda.synchronize()
        row = {"arch": arch, "layers": depth,
               "param_count": model.param_count(),
               "active_param_count": model.cfg.active_param_count(),
               "init_s": time.perf_counter() - t0,
               "fp32_init_max_memory_allocated":
                   torch.cuda.max_memory_allocated()}
        params = cast_serving_params(model, params, device, donate=True)
        free_card()
        row["bf16_memory_allocated"] = torch.cuda.memory_allocated()
        row["engine"] = moe_engine(model, params, device)
        row["drops"] = moe_drops(model, params, device)
        row["group_independence"] = moe_group_independence(model, params,
                                                           device)
        row["times"] = moe_times(model, params, device)
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["models"].append(row)
        del params
    free_card()
    out["card_vs_cpu"] = moe_card_vs_cpu(device)
    free_card()
    out["launches"] = counts()
    check(not any(out["launches"].values()),
          f"the moe path launched kernels: {out['launches']}")
    emit(out)
    return out["launches"]


# -------------------------------------------------------------------- ssm

def ssm_times(model, params, device, prompt_len: int) -> list[dict]:
    """Wall time (one call to its synchronize), device busy time
    (torch.profiler's kernel sum) and CUDA-event time (one call behind a
    spin) of one ``prompt_len``-token prefill and of one decode step at
    capacity 4 with every slot live, in bf16, as the engine runs them,
    each eagerly and as a graph replay with its logits bitwise between
    the two (``step_graphs``); beside each, the bytes bound: every weight
    read once as the engine stores it (the cast set in bf16, the rest
    fp32), the input embedding only at the call's rows where the head is
    a matrix of its own, at PEAK_BYTES."""
    prompts = lm_prompts(model.cfg.vocab, prompt_len)
    eng, _, _ = filled_engine(model, params, device, prompts=prompts,
                              max_seq=prompt_len + 16)
    prompt = next(p for p in prompts if len(p) == prompt_len)
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    stored = eng.params
    weights = sum(nbytes(t) for t in _leaves_of(stored))
    emb = stored["embedding"]

    def weight_bytes(rows: int) -> int:
        if "lm_head" not in stored:          # tied: the head reads it all
            return weights
        return weights - nbytes(emb) + rows * nbytes(emb[0])

    steps = step_graphs(model.cfg.name, model, eng, prompt, device)
    rows = []
    for step, m in (("prefill", prompt_len), ("decode", 4)):
        rows.append({"step": step, "mode": "bf16", "M": m,
                     "layers": model.cfg.n_layers, **steps[step],
                     "bound_ms": weight_bytes(m) / PEAK_BYTES * 1e3,
                     "bound_by": "bytes", "weight_bytes": weight_bytes(m)})
    return rows


def ssm_ragged(model, params, device, chunk: int) -> str:
    """A prompt of ``chunk + 1`` tokens, not a whole number of scan
    chunks, must raise on the card, before any cache write; returns the
    message."""
    import torch
    toks = torch.zeros((1, chunk + 1), dtype=torch.int32, device=device)
    try:
        with torch.no_grad():
            model.prefill(params, {"tokens": toks},
                          model.init_cache(1, chunk + 1, device=device))
    except ValueError as e:
        return str(e)
    raise SmokeFailure(f"{model.cfg.name}: a {chunk + 1}-token prompt "
                       f"(chunk {chunk}) did not raise")


def ssm_zamba2(device) -> tuple[dict, dict]:
    """zamba2-7b at full width cut to SSM_STEP_LAYERS layers (random
    weights from seed 0): ``Engine`` under int8 through the qmatmul
    kernel, through its step graphs (3 launches captured in each graph
    and replayed a prefill and a decode step at each shared-block call)
    and eagerly (the same tokens), the bf16 times, a ragged prompt; the
    launcher at full size with a bf16 and an int8 KV cache; at
    SSM_PLAIN_LAYERS layers, kernel
    against plain (the engine's tokens, a 512-token prefill's and a
    4-slot decode step's logits, bitwise); at SSM_CPU_LAYERS, card
    against CPU in fp32 and int8. Returns (the report, the launches of
    the kernel engines' ``run()``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch

    arch, plen = "zamba2-7b", SSM_PROMPT["zamba2-7b"]
    full = get_arch(arch).model()
    model = type(full)(dataclasses.replace(
        full.cfg, n_layers=SSM_STEP_LAYERS[arch],
        name=f"{arch} {SSM_STEP_LAYERS[arch]}L"))
    cfg = model.cfg
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device=device)
    torch.cuda.synchronize()
    out = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "param_count": model.param_count(), "prompt_len": plen,
           "init_s": time.perf_counter() - t0}
    out["engine"], launches = lm_engines(model, params, device,
                                         3 * cfg.n_groups, plen,
                                         backends=(None,))
    lap("zamba2 init, engines")
    out["times"] = ssm_times(model, params, device, plen)
    out["ragged"] = ssm_ragged(model, params, device, cfg.mamba_chunk)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    lap("zamba2 times, ragged")
    del params
    free_card()
    out["launcher"] = [lm_launcher(q, arch, plen) for q in ("none", "int8")]
    lap("zamba2 launcher x2")
    free_card()
    cut = type(model)(dataclasses.replace(full.cfg,
                                          n_layers=SSM_PLAIN_LAYERS))
    params = cut.init(0, device=device)
    row = {"layers": SSM_PLAIN_LAYERS, "shared_block_calls":
           cut.cfg.n_groups, "tail_layers": cut.cfg.n_tail}
    row["engine"], grew = lm_engines(cut, params, device,
                                     3 * cut.cfg.n_groups, plen)
    launches = {k: v + grew[k] for k, v in launches.items()}
    row["logits_kernel_vs_plain"] = lm_logits_bitwise(cut, params, device,
                                                      plen)
    out["kernel_vs_plain"] = row
    lap(f"zamba2 {SSM_PLAIN_LAYERS} layers kernel vs plain")
    del params
    free_card()
    out["card_vs_cpu"] = lm_card_vs_cpu(
        device, arch, layers=SSM_CPU_LAYERS[arch], prompt_lens=(256,),
        nudge=False)
    lap("zamba2 card vs cpu")
    free_card()
    return out, launches


def ssm_rwkv6(device) -> dict:
    """rwkv6-1.6b at full width cut to SSM_STEP_LAYERS layers (random
    weights from seed 0): ``Engine`` in bf16 through its step graphs and
    eagerly (the same tokens), the bf16 times, a ragged prompt; the
    launcher at full size with a bf16 and an int8 KV cache, then
    SSM_CPU_LAYERS layers in fp32 card against CPU. No
    kernel launches: the reference's RWKV reaches no Pallas kernel."""
    import torch
    from repro_torch.configs import get_arch

    arch, plen = "rwkv6-1.6b", SSM_PROMPT["rwkv6-1.6b"]
    full = get_arch(arch).model()
    model = type(full)(dataclasses.replace(
        full.cfg, n_layers=SSM_STEP_LAYERS[arch],
        name=f"{arch} {SSM_STEP_LAYERS[arch]}L"))
    free_card()
    before = counts()
    params = model.init(0, device=device)
    out = {"arch": arch, "layers": model.cfg.n_layers,
           "d_model": model.cfg.d_model,
           "param_count": model.param_count(),
           "tensor_params": sum(t.numel() for t in _leaves_of(params)),
           "prompt_len": plen}
    out["engine"] = engine_graph_vs_eager(f"{arch} bf16", model, params,
                                          device, plen)
    out["times"] = ssm_times(model, params, device, plen)
    out["ragged"] = ssm_ragged(model, params, device, model.cfg.chunk)
    del params
    free_card()
    out["launcher"] = [lm_launcher(q, arch, plen) for q in ("none", "int8")]
    free_card()
    out["card_vs_cpu"] = lm_card_vs_cpu(
        device, arch, layers=SSM_CPU_LAYERS[arch], modes=("none",),
        prompt_lens=(128, 64), nudge=False)
    free_card()
    grew = {k: counts()[k] - before[k] for k in before}
    check(not any(grew.values()), f"the rwkv6 path launched kernels: {grew}")
    return out


def phase_ssm(device) -> dict:
    """The sub-quadratic LMs on the card: zamba2-7b (``ssm_zamba2``),
    then rwkv6-1.6b (``ssm_rwkv6``). Returns the ssm path's launches:
    those of zamba2's int8 engine runs through the kernel."""
    t0 = time.perf_counter()
    zamba2, launches = ssm_zamba2(device)
    rwkv6 = ssm_rwkv6(device)
    lap("rwkv6")
    emit({"phase": "ssm", "zamba2": zamba2, "rwkv6": rwkv6,
          "tolerances": TOL_LM, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches


# ------------------------------------------------------------------ train

def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def train_forward_kernel_vs_plain(model, params, batch) -> dict:
    """The training forward's two convs at the step-0 batch (B = 128),
    as ``PaperCNN.forward`` runs them under autograd (the parameters
    require grad): conv1 on the images, then conv2 on the plain route's
    pooled conv1, each through the kernel (``ConvWindowFn``, one
    ``conv_window`` launch, an output autograd sees) and through the
    plain conv on the card, held to the kernels phase's fp32 bar."""
    import torch
    from repro_torch.core.conv import conv2d_apply
    from repro_torch.core.window import maxpool2
    from repro_torch.ops import use_policy
    cfg = model.cfg
    x, out = batch["images"], {}
    for stage, conv_cfg in (("conv1", cfg.conv1_cfg),
                            ("conv2", cfg.conv2_cfg)):
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in params[stage].items()}
        before = counts()["conv_window"]
        got = conv2d_apply(leaves, x, conv_cfg)
        check(counts()["conv_window"] == before + 1
              and got.grad_fn is not None,
              f"train mnist forward {stage}: not one kernel launch that "
              f"autograd sees")
        with use_policy(plain_policy()):
            want = conv2d_apply(  # lint: disable=conv-chain (plain route)
                leaves, x, conv_cfg).detach()
        out[stage] = hold(f"train mnist forward {stage}", "none",
                          got.detach(), want)
        x = maxpool2(torch.relu(want))
    return out


def eval_logits_kernel_vs_plain(params, device) -> dict:
    """The evaluation's first held-out batch (B = 256) in each format,
    through the route ``mnist.evaluate_formats`` takes (two
    ``conv_window`` launches, and under int8 one ``qmatmul``) and through
    the plain ops on the card: the logits held to the kernels phase's
    bars (``hold``: int8 bitwise, Q8.8 one step, fp32 TOL_FP32)."""
    import torch
    from repro_torch.data.pipeline import SyntheticMNIST, shard_batch
    from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
    from repro_torch.ops import ExecPolicy
    from repro_torch.train.mnist import FORMATS
    images = shard_batch(SyntheticMNIST(seed=0).batch(
        256, step=10_000, seed=999), device=device)["images"]
    out = {}
    with torch.no_grad():
        for fmt in FORMATS:
            quant = "none" if fmt == "float32" else fmt
            kern = PaperCNN(PaperCNNConfig(
                policy=None if fmt == "float32" else ExecPolicy(quant=fmt)))
            plain = PaperCNN(PaperCNNConfig(
                policy=plain_policy(quant=quant)))
            before = counts()
            got = kern.forward(params, images)
            grew = {k: counts()[k] - before[k] for k in before}
            want = {"conv_window": 2, "qmatmul": int(fmt == "int8")}
            check(all(grew[k] == n for k, n in want.items()),
                  f"train mnist eval {fmt}: launched {grew}, want {want}")
            int8_routes_held(f"train mnist eval {fmt}", quant, grew)
            out[fmt] = hold(f"train mnist eval {fmt}", quant, got,
                            plain.forward(params, images))
    return out


def train_grads_kernel_vs_plain(model, params, batch) -> dict:
    """One loss and backward of the CNN through the kernel route
    (``conv_window`` under ``ConvWindowFn``) and through the plain conv
    on the card: every parameter has a gradient, conv1's and conv2's
    among them, finite, and the two routes agree within TOL_GRAD."""
    import torch
    from repro_torch.core.tree import tree_items
    from repro_torch.ops import use_policy
    from repro_torch.train.steps import loss_and_grads
    _, _, kern = loss_and_grads(model, params, batch)
    with use_policy(plain_policy()):
        _, _, plain = loss_and_grads(model, params, batch)
    out = {}
    for path, g in tree_items(kern):
        name = "/".join(path)
        want = _tree_get(plain, path)
        check(g is not None and want is not None,
              f"train mnist: no gradient for {name}")
        check(bool(torch.isfinite(g).all()),
              f"train mnist: non-finite gradient for {name}")
        err = max_abs(g, want)
        tol = TOL_GRAD * (1 + float(want.abs().max()))
        check(err <= tol, f"train mnist: d/d{name} kernel vs plain "
                          f"max_abs {err}, tolerance {tol}")
        out[name] = err / (1 + float(want.abs().max()))
    check({"conv1/w", "conv1/b", "conv2/w", "conv2/b"} <= set(out),
          f"train mnist: conv gradients missing: {sorted(out)}")
    return out


def train_conv_times(device, bsz: int = 128) -> dict:
    """At the training batch, each conv of the CNN: the ``conv_window``
    forward launch, the ``ConvWindowFn`` backward (cuDNN input and weight
    gradients, bias sum; conv1's input needs none), and cuDNN's forward
    for the same conv, each the median device time of 100 calls; beside
    each direction its bound (``conv_work``'s for the forward; for the
    backward x, w and the output gradient read once, the gradients
    written once, one conv's operations for each of gw and gx)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv_window import ops as cw
    rows = {}
    gen = torch.Generator().manual_seed(7)
    for stage, shape in (("conv1", CONV1), ("conv2", CONV2)):
        x, w, b, _ = conv_inputs(gen, bsz, shape, "none", device)
        x.requires_grad_(stage == "conv2")
        leaves = [t.requires_grad_(True) for t in (w, b)]
        y = cw.conv_window(x, w, b)
        g = torch.randn(y.shape, generator=gen).to(device)
        inputs = ([x] if x.requires_grad else []) + leaves
        with torch.no_grad():
            fwd, _ = device_ms(lambda: cw.conv_window(x, w, b))
            lib, _ = device_ms(lambda: F.conv2d(x, w, b))
        bwd, _ = device_ms(lambda: torch.autograd.grad(
            y, inputs, g, retain_graph=True))
        n, h, w_, m, k = shape
        fwd_bytes, ops = conv_work(bsz, shape, pooled=False)
        grads = 1 + int(stage == "conv2")
        bwd_bytes = 4 * (bsz * n * h * w_ * grads + 2 * m * n * k * k
                         + m + g.numel())
        rows[stage] = {
            "B": bsz, "forward_ms": fwd, "backward_ms": bwd,
            "cudnn_forward_ms": lib,
            "forward_bound_ms": max(fwd_bytes / PEAK_BYTES,
                                    ops / PEAK_FP32) * 1e3,
            "backward_bound_ms": max(bwd_bytes / PEAK_BYTES,
                                     grads * ops / PEAK_FP32) * 1e3}
    return rows


def train_mnist(device) -> tuple[dict, dict]:
    """(a) The paper's experiment at full size, as
    ``python -m repro_torch.train.mnist`` runs it with the reference's
    defaults: first the step-0 forward's conv outputs and gradients
    kernel vs plain; then, counted from 0, the 300 training steps, each a
    replay of the train graph (2 conv_window launches captured, 2 x 300
    replayed; the wrappers count the warm-up's and the capture's 4) and
    the evaluation in float32, Q8.8 and
    int8 (conv_window and qmatmul launch); float32 accuracy above 0.9;
    then one evaluation batch's logits kernel vs plain in each format.
    Returns (report, launches)."""
    import torch
    from repro_torch.data.pipeline import SyntheticMNIST, shard_batch
    from repro_torch.models.cnn import PaperCNN
    from repro_torch.serve.graphs import graph_launches
    from repro_torch.train import mnist
    model = PaperCNN()
    params = model.init(0, device=device)
    batch = shard_batch(SyntheticMNIST(seed=0).batch(128, step=0),
                        device=device)
    fwd_err = train_forward_kernel_vs_plain(model, params, batch)
    grad_err = train_grads_kernel_vs_plain(model, params, batch)
    reset_counts()
    with contextlib.redirect_stdout(sys.stderr):
        trained, hist = mnist.train(device=device)
    torch.cuda.synchronize()
    in_training = counts()
    graph = hist["graph"]
    replayed = graph_launches([graph])
    steps = len(hist["losses"])
    check(graph.captured and graph.calls == steps
          and graph.kernels["conv_window"] == 2
          and replayed["conv_window"] == 2 * steps,
          f"train mnist: the train graph captured {graph.kernels}, "
          f"replayed {graph.calls} times for {steps} steps: "
          f"{replayed['conv_window']} conv_window launches, expected "
          f"2 x {steps}")
    check(in_training["conv_window"] == 4,
          f"train mnist: conv_window launched {in_training} times in "
          f"training, expected 4 (the graph's warm-up and its capture)")
    reset_counts()
    acc = mnist.evaluate_formats(trained, device=device)
    in_eval = counts()
    check(in_eval["conv_window"] > 0 and in_eval["qmatmul"] > 0,
          f"train mnist: the evaluation launched {in_eval}")
    check(acc["float32"] > 0.9,
          f"train mnist: float32 accuracy {acc['float32']}")
    launches = {k: in_training[k] + in_eval[k] for k in in_training}
    logits_err = eval_logits_kernel_vs_plain(trained, device)
    report = {"steps": len(hist["losses"]), "step_ms": hist["step_ms"],
              "capture_ms": graph.capture_s * 1e3,
              "pool_bytes": graph.pool_bytes,
              "conv_window_replayed": replayed["conv_window"],
              "final_loss": hist["losses"][-1], "accuracy": acc,
              "delta": {f: acc[f] - acc["float32"]
                        for f in ("qformat", "int8")},
              "launches_training": in_training, "launches_eval": in_eval,
              "forward_kernel_vs_plain": fwd_err,
              "eval_logits_kernel_vs_plain": logits_err,
              "grad_rel_err_kernel_vs_plain": max(grad_err.values()),
              "conv": train_conv_times(device),
              "step_split": mnist_step_split(graph)}
    return report, launches


def mnist_step_split(graph) -> dict:
    """Where an MNIST training step's wall goes, after the run (the
    replays go on training the params the checks above used): the host
    drawing one B = 128 batch (numpy, as ``mnist.train`` does every
    step), and the train graph's replay on the batch it holds, timed by
    ``step_times``."""
    from repro_torch.data.pipeline import SyntheticMNIST
    data = SyntheticMNIST(seed=0)
    draws = []
    for i in range(20):
        t0 = time.perf_counter()
        data.batch(128, step=i)
        draws.append((time.perf_counter() - t0) * 1e3)
    replay = step_times(graph)
    replay.pop("profile")
    return {"batch_draw_ms": statistics.median(draws), "replay": replay}


def _launch_train(work: Path, tag: str, *extra: str,
                  kill_after: int | None = None,
                  stop_after: int | None = None) -> dict:
    """``python -m repro_torch.launch.train`` (TRAIN_ARGV + ``extra``)
    in a process of its own, checkpoints under ``work/tag``; with
    ``kill_after`` it is killed as soon as it reports that step's
    checkpoint saved, with ``stop_after`` as soon as it prints that
    step's loss. The report's ``losses``: step -> the loss it printed
    (at full precision)."""
    import os
    argv = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGV,
            "--ckpt", str(work / tag), *extra]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, env=env, cwd=ROOT, text=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if (kill_after is not None and
                    line.startswith(f"saved step {kill_after}")) or (
                    stop_after is not None and
                    line.startswith(f"step {stop_after:5d} ")):
                proc.kill()
                break
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print("\n".join(lines[-4:]), file=sys.stderr, flush=True)
    check(kill_after is not None or stop_after is not None or rc == 0,
          f"train launcher {tag}: exit {rc}: {lines[-8:]}")
    losses = {int(ln.split()[1]): float(ln.split("loss=")[1].split()[0])
              for ln in lines if ln.startswith("step ")}
    return {"tag": tag, "rc": rc, "seconds": time.perf_counter() - t0,
            "losses": losses,
            "lines": [ln for ln in lines
                      if ln.startswith(("arch=", "auto-resumed", "peak",
                                        "saved", "captured"))]}


def train_lm_launcher() -> dict:
    """(b) qwen1.5-0.5b at full width, TRAIN_LAYERS layers, through the
    launcher (four processes at a time), each step a replay of its train
    graph: 20 steps uninterrupted; the same run
    killed after its step-10 checkpoint and invoked again, whose losses
    11-20 must equal the uninterrupted run's bitwise; one step under
    ``--microbatches 2``, whose loss must be step 1's within 1e-5
    relative; and ``--eager`` (the same steps without a graph) stopped
    after TRAIN_EAGER_STEPS, whose losses must equal the graph run's
    bitwise."""
    import shutil
    work = ROOT / "build" / "train_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    from concurrent.futures import ThreadPoolExecutor

    def killed_then_resumed():
        return (_launch_train(work, "killed", kill_after=TRAIN_KILL_AT),
                _launch_train(work, "killed"))

    # four processes at once on the card (each its own checkpoints; the
    # losses do not depend on what else runs), the resume after its kill
    try:
        with ThreadPoolExecutor(4) as pool:
            whole = pool.submit(_launch_train, work, "whole")
            chain = pool.submit(killed_then_resumed)
            mb2 = pool.submit(_launch_train, work, "mb2", "--microbatches",
                              "2", "--steps", "1")
            eager = pool.submit(_launch_train, work, "eager", "--eager",
                                stop_after=TRAIN_EAGER_STEPS)
            runs = [whole.result(), *chain.result(), mb2.result(),
                    eager.result()]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    whole, resumed, mb2, eager = (runs[i]["losses"] for i in (0, 2, 3, 4))
    first = range(1, TRAIN_EAGER_STEPS + 1)
    check(sorted(eager) == list(first) and
          all(eager[s] == whole[s] for s in first),
          f"train launcher: graph losses {[whole[s] for s in first]} vs "
          f"eager {[eager.get(s) for s in first]}")
    check(any(ln.startswith("captured the train step")
              for ln in runs[0]["lines"]),
          f"train launcher: no capture line in {runs[0]['lines']}")
    check(sorted(whole) == list(range(1, 21)),
          f"train launcher: steps {sorted(whole)}")
    check(any(ln == f"auto-resumed from step {TRAIN_KILL_AT}"
              for ln in runs[2]["lines"]),
          f"train launcher: no resume line in {runs[2]['lines']}")
    after = range(TRAIN_KILL_AT + 1, 21)
    check(sorted(resumed) == list(after),
          f"train launcher: the resumed run took steps {sorted(resumed)}")
    check(all(resumed[s] == whole[s] for s in after),
          f"train launcher: resumed losses "
          f"{[resumed[s] for s in after]} vs "
          f"{[whole[s] for s in after]}")
    rel = abs(mb2[1] - whole[1]) / abs(whole[1])
    check(rel <= 1e-5, f"train launcher: --microbatches 2 step-1 loss "
                       f"{mb2[1]} vs {whole[1]} ({rel:.3g} relative)")
    return {"losses": [whole[s] for s in (1, 10, 20)],
            "resumed_bitwise": True, "microbatches2_rel": rel,
            "graph_vs_eager_steps": TRAIN_EAGER_STEPS,
            "graph_vs_eager": "bitwise", "runs": runs}


def train_lm_times(device) -> dict:
    """(b) The launcher's train step on qwen1.5-0.5b at full width cut to
    TRAIN_LAYERS layers (the launch phase times the full-size one), in
    this process, eagerly and as its train graph's replay (both over the
    same static params, optimizer state and batch): wall, device busy
    (torch.profiler) and event time a step, tokens/s, the capture's ms
    and pool bytes, peak memory, beside the step's bound: the larger of
    6 · params · tokens at the bf16 peak and AdamW's bytes (p, g, m, v
    read, p, m, v written, fp32: 28 B a parameter) at the memory rate."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           SyntheticTextIterator)
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serve.graphs import train_graph
    from repro_torch.train import make_train_step
    full = get_arch(TRAIN_ARCH).model()
    model = type(full)(dataclasses.replace(full.cfg, n_layers=TRAIN_LAYERS))
    params = model.init(0, device=device)
    opt = adamw_init(params)
    step = make_train_step(model, AdamWConfig(total_steps=20))
    bsz, seq = 8, 128
    batch = SyntheticTextIterator(SyntheticTextConfig(
        model.cfg.vocab, seq, bsz)).next_batch()
    torch.cuda.reset_peak_memory_stats()
    times, peaks = {}, {}
    for name, compiled in (("eager", False), ("graph", True)):
        g = train_graph(step, params, opt, batch, device=device,
                        compiled=compiled)
        t = step_times(g)
        peaks[name] = torch.cuda.max_memory_allocated()
        times[name] = {k: t[k] for k in ("wall_ms", "device_busy_ms",
                                         "event_ms", "queue_ran_dry")}
        times[name]["tokens_per_s"] = bsz * seq / t["wall_ms"] * 1e3
        if compiled:
            times[name].update(capture_ms=g.capture_s * 1e3,
                               pool_bytes=g.pool_bytes)
            profile = t["profile"]
        del g
    n = model.param_count()
    ops_s = 6 * n * bsz * seq / PEAK_BF16
    bytes_s = 28 * n / PEAK_BYTES
    STEP_LINES.append({"steps": f"{TRAIN_ARCH} {TRAIN_LAYERS}L train "
                                f"B={bsz}x{seq}", **{
        k: [round(v[m], 3) for m in ("wall_ms", "device_busy_ms",
                                     "event_ms")]
        for k, v in times.items()},
        "capture_ms": round(times["graph"]["capture_ms"], 1),
        "pool_mb": round(times["graph"]["pool_bytes"] / 2 ** 20, 1)})
    return {"params": n, "tokens": bsz * seq, **times,
            "max_memory_allocated": peaks,
            "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "operations_ms": ops_s * 1e3, "bytes_ms": bytes_s * 1e3,
            "profile": profile}


def _grads_ok(grads) -> tuple[bool, bool]:
    """(every gradient present, every gradient finite)."""
    import torch
    from repro_torch.core.tree import tree_leaves
    leaves = tree_leaves(grads)
    present = all(g is not None for g in leaves)
    return present, present and all(bool(torch.isfinite(g).all())
                                    for g in leaves)


def train_encdec(device) -> dict:
    """(c) seamless-m4t-medium at full size: a prefill from stub frames
    (B = 4, 512 frames, 128 tokens) and 16 greedy decode steps, finite
    logits of the vocab's width; one loss and backward (every gradient
    present and finite) and one train step (finite loss and params)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import loss_and_grads, make_train_step
    spec = get_arch("seamless-m4t-medium")
    model = spec.model()
    cfg = model.cfg
    params = model.init(0, device=device)
    bsz, t_enc = 4, 512
    s_dec = t_enc // spec.dec_frac
    g = torch.Generator(device).manual_seed(4)
    frames = torch.randn((bsz, t_enc, cfg.d_model), generator=g,
                         device=device)
    toks, labels = (torch.randint(0, cfg.vocab, (bsz, s_dec), generator=g,
                                  device=device) for _ in range(2))
    out = {"params": model.param_count(), "B": bsz, "frames": t_enc,
           "tokens": s_dec}
    cache = model.init_cache(bsz, s_dec + 16, enc_seq=t_enc, device=device)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"frames": frames,
                                               "tokens": toks}, cache)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        check(logits.shape == (bsz, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"train encdec: prefill logits {tuple(logits.shape)}")
        nxt = logits.argmax(-1)
        t0 = time.perf_counter()
        for i in range(16):
            logits, cache = model.decode_step(params, nxt, s_dec + i, cache)
            nxt = logits.argmax(-1)
        torch.cuda.synchronize()
        out["decode_step_ms"] = (time.perf_counter() - t0) * 1e3 / 16
        check(bool(torch.isfinite(logits).all()),
              "train encdec: non-finite decode logits")
    batch = {"frames": frames, "tokens": toks, "labels": labels}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _, grads = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    out["loss_backward_ms"] = (time.perf_counter() - t0) * 1e3
    present, finite = _grads_ok(grads)
    check(present and finite and bool(torch.isfinite(loss)),
          f"train encdec: loss {float(loss)}, gradients present "
          f"{present}, finite {finite}")
    del grads
    step = make_train_step(model, AdamWConfig(total_steps=1))
    t0 = time.perf_counter()
    new, _, metrics = step(params, adamw_init(params), batch)
    torch.cuda.synchronize()
    out["train_step_ms"] = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(metrics["loss"])) and all(
        bool(torch.isfinite(p).all()) for p in tree_leaves(new)),
          "train encdec: a non-finite loss or param after the step")
    out.update(loss=float(loss), step_loss=float(metrics["loss"]),
               grads_present=present, grads_finite=finite,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    return out


def train_backward(arch: str, layers: int | None, device) -> dict:
    """(d) One loss and backward of ``arch`` at full width and
    ``layers`` layers (None: full depth), fp32 weights from seed 0, no
    optimizer: the bytes are reckoned first (weights and gradients,
    fp32), then the loss, every gradient present and finite, the wall
    time and the peak memory."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.train import loss_and_grads
    full = get_arch(arch).model()
    cfg = full.cfg if layers is None else dataclasses.replace(
        full.cfg, n_layers=layers)
    model = type(full)(cfg)
    n = model.param_count()
    check(8 * n < 72e9, f"train backward {arch}: {n} parameters need "
                        f"{8 * n / 1e9:.1f} GB for weights and gradients")
    params = model.init(0, device=device)
    g = torch.Generator(device).manual_seed(5)
    toks, labels = (torch.randint(0, cfg.vocab, TRAIN_BWD_BATCH,
                                  generator=g, device=device)
                    for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, metrics, grads = loss_and_grads(
        model, params, {"tokens": toks, "labels": labels})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    present, finite = _grads_ok(grads)
    check(present and finite and bool(torch.isfinite(loss)),
          f"train backward {arch}: loss {float(loss)}, gradients present "
          f"{present}, finite {finite}")
    return {"arch": arch, "layers": cfg.n_layers, "params": n,
            "weights_and_grads_gb": 8 * n / 1e9, "loss": float(loss),
            **{k: float(v) for k, v in metrics.items() if k != "ce"},
            "grads_present": present, "grads_finite": finite, "ms": ms,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def train_card_vs_cpu(device) -> dict:
    """qwen1.5-0.5b at full width, 2 layers, fp32, drawn on the card and
    copied to the CPU: the loss of a (2, 64) batch card against CPU
    within TOL_LM["none"] of 1 + |loss|."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    full = get_arch(TRAIN_ARCH).model()
    model = type(full)(dataclasses.replace(full.cfg, n_layers=2,
                                           dtype=torch.float32))
    params = model.init(torch.Generator(device).manual_seed(0),
                        device=device)
    g = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(0, model.cfg.vocab, (2, 64), generator=g)
             for k in ("tokens", "labels")}
    with torch.no_grad():
        got = float(model.loss(params, {k: v.to(device)
                                        for k, v in batch.items()})[0])
        want = float(model.loss(to_device(params, "cpu"), batch)[0])
    err = abs(got - want)
    tol = TOL_LM["none"] * (1 + abs(want))
    check(err <= tol, f"train card vs cpu: loss {got} vs {want}, "
                      f"tolerance {tol}")
    return {"arch": TRAIN_ARCH, "layers": 2, "loss": want, "abs_err": err,
            "tolerance": tol}


def phase_train(device) -> dict:
    """(a) the paper's MNIST experiment, (b) qwen1.5-0.5b through the
    training launcher (resume, microbatches) and its step times, (c)
    seamless-m4t-medium served and trained, (d) a loss and backward of
    four more archs, and a card-vs-CPU loss. Prints a short line and
    writes the whole report to build/chip_smoke_train.json.
    Returns the train path's launches: MNIST's training and evaluation,
    counted from 0 after the gradients' kernel-vs-plain check."""
    t0 = time.perf_counter()
    mnist, launches = train_mnist(device)
    lap("mnist")
    free_card()
    job = HOST_JOBS.pop("train_launcher", None)
    report = {"mnist": mnist, "qwen_launcher": job.result()
              if job is not None else train_lm_launcher()}
    lap("qwen launcher runs" + (" (started before the mesh phase)"
                                if job is not None else ""))
    report["qwen_step"] = train_lm_times(device)
    lap("qwen step times")
    free_card()
    report["seamless"] = train_encdec(device)
    lap("seamless")
    free_card()
    report["backward"] = []
    for arch, layers in TRAIN_BWD_ARCHS.items():
        report["backward"].append(train_backward(arch, layers, device))
        free_card()
        lap(f"backward {arch}")
    report["card_vs_cpu"] = train_card_vs_cpu(device)
    lap("card vs cpu")
    report["seconds"] = time.perf_counter() - t0
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_train.json").write_text(json.dumps(report, indent=1))
    step = report["qwen_step"]
    emit({"phase": "train",
          "mnist": {k: mnist[k] for k in
                    ("step_ms", "step_split", "capture_ms",
                     "conv_window_replayed",
                     "accuracy", "delta", "launches_training",
                     "grad_rel_err_kernel_vs_plain", "conv")}
          | {"forward_max_abs": {k: v["max_abs"] for k, v in
                                 mnist["forward_kernel_vs_plain"].items()},
             "eval_logits_max_abs": {
                 k: v["max_abs"] for k, v in
                 mnist["eval_logits_kernel_vs_plain"].items()}},
          "qwen": {k: step[k] for k in
                   ("eager", "graph", "max_memory_allocated", "bound_ms",
                    "bound_by")}
          | {k: report["qwen_launcher"][k] for k in
             ("losses", "resumed_bitwise", "microbatches2_rel",
              "graph_vs_eager")}
          | {"launcher_seconds": [[r["tag"], r["seconds"]] for r in
                                  report["qwen_launcher"]["runs"]]},
          "seamless": {k: v for k, v in report["seamless"].items()},
          "backward": [{k: r[k] for k in ("arch", "layers", "loss", "ms",
                                          "max_memory_allocated")}
                       for r in report["backward"]],
          "card_vs_cpu": report["card_vs_cpu"],
          "seconds": report["seconds"]})
    return launches


# ----------------------------------------------------------------- launch

def launch_sweep() -> dict:
    """(a) The dry run of every (arch × shape) at full size on the meta
    device (``launch/dryrun.py``) in worker processes: HOST_WORKERS
    started with the script beside the card's phases
    (``start_host_jobs``), else LAUNCH_JOBS here. No cell may end in
    ``error``, and exactly the 8
    ``long_500k`` cells of the full-attention archs are ``skipped``, with
    the reference's reason. Each cell's JSON goes under
    reports/dryrun_torch/; one compact line an arch goes to LAUNCH_LINES
    (status, bottleneck, roofline step ms and peak GB a shape), and one
    with the sweep's seconds."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import REPORTS, run_cell

    job = HOST_JOBS.pop("sweep", None)
    if job is not None:                 # started with the script
        recs = [f.result() for f in job["cells"]]
        seconds, jobs = max(job["done"]) - job["t0"], HOST_WORKERS
    else:
        t0 = time.perf_counter()
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(LAUNCH_JOBS, mp_context=ctx) as pool:
            recs = list(pool.map(run_cell, *zip(*cells)))
        seconds, jobs = time.perf_counter() - t0, LAUNCH_JOBS
    errors = [(r["arch"], r["shape"], r["error"]) for r in recs
              if r["status"] == "error"]
    check(not errors, f"dry run cells in error: {errors}")
    skipped = {(r["arch"], r["shape"]): r["reason"] for r in recs
               if r["status"] == "skipped"}
    want = {(a, "long_500k"): get_arch(a).skip_reason("long_500k")
            for a in ARCH_IDS if not get_arch(a).subquadratic}
    check(skipped == want and len(want) == 8,
          f"dry run skipped {sorted(skipped)}, expected {sorted(want)}")
    for a in ARCH_IDS:
        line = {"dryrun": a}
        for r in recs:
            if r["arch"] != a:
                continue
            if r["status"] == "skipped":
                line[r["shape"]] = "skipped"
                continue
            rf = r["roofline"]
            line[r["shape"]] = [rf["bottleneck"],
                                round(rf["step_time_s"] * 1e3, 3),
                                round(r["memory"]["peak_bytes"] / 1e9, 1),
                                round(r["count_s"], 1)]
        LAUNCH_LINES.append(line)
    LAUNCH_LINES.append({"dryrun_sweep_s": round(seconds, 1),
                         "cells": len(recs), "ok": len(recs) - len(skipped),
                         "skipped": len(skipped), "jobs": jobs,
                         "beside_the_card": job is not None,
                         "reports": str(REPORTS.relative_to(ROOT))})
    return {"seconds": seconds, "cells": len(recs),
            "skipped": sorted(skipped)}


def analysis_gate() -> dict:
    """``python -m repro_torch.analysis --root <repo>`` in a subprocess:
    its exit code, its output lines and its wall seconds."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--root", str(ROOT)], cwd=ROOT, env=env,
                       capture_output=True, text=True,
                       timeout=ANALYSIS_TIMEOUT_S)
    return {"rc": r.returncode, "lines": r.stdout.splitlines(),
            "stderr": r.stderr[-2000:], "seconds": time.perf_counter() - t0}


def phase_analysis(device) -> dict:
    """The port's static gate (``analysis_gate``), started with the script
    beside the card's phases or run here: exit 0, no lint finding, and
    every plan of ANALYSIS_PLANS verified. Nothing runs on the card."""
    job = HOST_JOBS.pop("analysis", None)
    r = job.result() if job is not None else analysis_gate()
    summary = next((ln for ln in r["lines"]
                    if ln.startswith("repro_torch.analysis:")), "")
    verified = [ln for ln in r["lines"] if ln.startswith("verify ")]
    check(r["rc"] == 0 and summary.startswith(
              "repro_torch.analysis: 0 finding(s) (0 error(s), "
              "0 warning(s))"),
          f"analysis gate: rc {r['rc']}, {summary!r}: "
          + "\n".join(r["lines"][-20:]) + r["stderr"])
    check(verified == [f"verify {n}: ok" for n in ANALYSIS_PLANS],
          f"analysis gate: {verified}")
    out = {"phase": "analysis", "rc": r["rc"], "summary": summary,
           "verified": verified, "seconds": r["seconds"]}
    emit(out)
    print(f"chip_smoke:   analysis gate {r['seconds']:.1f} s",
          file=sys.stderr, flush=True)
    return out


def phase_mesh_dryrun(device) -> dict:
    """The mesh dry run (``launch/dryrun.py``) of every (arch x shape) at
    full size on the meta device, counted as rank 0 of ``pod16x16`` and of
    ``pod2x16x16`` over a fake process group: started with the script in
    MESH_SWEEP_WORKERS host workers (``start_host_jobs``), else
    LAUNCH_JOBS at a time here. On each mesh no cell may end in
    ``error`` and exactly the 8 ``long_500k`` cells of the full-attention
    archs are ``skipped``; every ok cell counts collectives. One compact
    line a (mesh, arch) to LAUNCH_LINES (bottleneck, roofline step ms,
    collective ms, peak GB, count seconds a shape), one with the sweep's
    seconds. Nothing runs on the card: no launches."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.launch.dryrun import REPORTS, run_cell
    job = HOST_JOBS.pop("mesh_sweep", None)
    if job is not None:                 # started with the script
        recs = [f.result() for f in job["cells"]]
        seconds, jobs = max(job["done"]) - job["t0"], MESH_SWEEP_WORKERS
    else:
        t0 = time.perf_counter()
        cells = mesh_sweep_cells()
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(LAUNCH_JOBS, mp_context=ctx) as pool:
            futs = [pool.submit(run_cell, a, s, multi_pod=mp)
                    for mp, a, s in cells]
            recs = [f.result() for f in futs]
        seconds, jobs = time.perf_counter() - t0, LAUNCH_JOBS
    errors = [(r["mesh"], r["arch"], r["shape"], r["error"]) for r in recs
              if r["status"] == "error"]
    check(not errors, f"mesh dry run cells in error: {errors}")
    want = {(a, "long_500k"): get_arch(a).skip_reason("long_500k")
            for a in ARCH_IDS if not get_arch(a).subquadratic}
    for mesh in ("pod16x16", "pod2x16x16"):
        mine = [r for r in recs if r["mesh"] == mesh]
        skipped = {(r["arch"], r["shape"]): r["reason"] for r in mine
                   if r["status"] == "skipped"}
        check(skipped == want and len(want) == 8,
              f"mesh dry run {mesh} skipped {sorted(skipped)}, expected "
              f"{sorted(want)}")
        silent = [(r["arch"], r["shape"]) for r in mine
                  if r["status"] == "ok"
                  and not r["collectives"]["count_by_op"]]
        check(not silent, f"mesh dry run {mesh}: no collective counted in "
                          f"{silent}")
        for a in ARCH_IDS:
            line = {"mesh_dryrun": mesh, "arch": a}
            for r in mine:
                if r["arch"] != a:
                    continue
                if r["status"] == "skipped":
                    line[r["shape"]] = "skipped"
                    continue
                rf = r["roofline"]
                line[r["shape"]] = [rf["bottleneck"],
                                    round(rf["step_time_s"] * 1e3, 3),
                                    round(rf["collective_s"] * 1e3, 3),
                                    round(r["memory"]["peak_bytes"] / 1e9, 1),
                                    round(r["count_s"], 1)]
            LAUNCH_LINES.append(line)
    uneven = sorted((r["mesh"], r["arch"], r["shape"]) for r in recs
                    if r.get("rank0_is_every_rank") is False)
    LAUNCH_LINES.append({"mesh_dryrun_sweep_s": round(seconds, 1),
                         "cells": len(recs),
                         "ok": sum(r["status"] == "ok" for r in recs),
                         "skipped": sum(r["status"] == "skipped"
                                        for r in recs),
                         "uneven": uneven, "jobs": jobs,
                         "beside_the_card": job is not None,
                         "reports": str(REPORTS.relative_to(ROOT))})
    return {}


def replay_ms(fn, reps: int = LAUNCH_REPLAYS) -> dict:
    """A compiled step's wall: the median of ``reps`` calls, each between
    two CUDA events and synchronized before the next (so a call's host
    launch latency is inside it), and the host clock's median beside."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events, hosts = [], []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        hosts.append((time.perf_counter() - t0) * 1e3)
        events.append(e0.elapsed_time(e1))
    return {"wall_ms": statistics.median(events),
            "host_wall_ms": statistics.median(hosts), "replays": reps}


def launch_row(label, kind, seq, batch, stats, times) -> dict:
    """One step's count beside its measured wall: the RooflineReport's
    terms, ``mfu`` = model_flops / (wall × 989 TFLOP/s) and
    ``bound_share`` = the roofline step time / wall, which may not pass
    LAUNCH_BOUND_SHARE_MAX (a count that lets a step beat its bound is
    wrong)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import MESH, model_flops_for
    from repro_torch.launch.roofline import RooflineReport
    report = RooflineReport(
        arch=LM_ARCH, shape=label, mesh=MESH, chips=1,
        flops_per_device=stats.flops, bytes_per_device=stats.bytes_accessed,
        collective_bytes_per_device=stats.collective_bytes,
        model_flops=model_flops_for(get_arch(LM_ARCH), kind, seq, batch),
        peak_memory_per_device=stats.peak_bytes,
        flops_by_dtype=stats.flops_by_dtype)
    measured = report.measured(times["wall_ms"] / 1e3)
    check(measured["bound_share"] <= LAUNCH_BOUND_SHARE_MAX,
          f"{label}: bound_share {measured['bound_share']:.3f} > "
          f"{LAUNCH_BOUND_SHARE_MAX}: the count lets the step beat its "
          f"bound ({report.to_dict()}, {times})")
    return {"step": label, "count": {
                "flops_by_dtype": stats.flops_by_dtype,
                "bytes": stats.bytes_accessed, "peak_bytes": stats.peak_bytes,
                "qmatmul": dataclasses.asdict(stats.ops["qmatmul"])
                if "qmatmul" in stats.ops else None},
            "roofline": report.to_dict(), **times, **measured}


def launch_roofline(device) -> dict:
    """(b) qwen1.5-0.5b at full size through its compiled steps: the
    engine's decode graph at capacity 4 (every slot filled with a
    64-token prompt) and its 64-token prefill graph, in bf16 and under
    int8 (72 qmatmul a step), and the launcher's train graph at
    B = 8 × 128; each beside the same step counted on the meta device (a
    meta Engine or train graph of the same shapes and policy). The int8
    decode's count must hold 72 qmatmul calls, each priced by its shape.
    (c) The eager int8 decode step: the count's top 5 ops by bytes beside
    torch.profiler's top 5 kernels by device time. (d) The train step's
    predicted peak beside ``max_memory_allocated`` of the eager step,
    within LAUNCH_PEAK_RATIO."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           SyntheticTextIterator)
    from repro_torch.launch.op_stats import count
    from repro_torch.ops import ExecPolicy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.graphs import train_graph
    from repro_torch.train import make_train_step

    meta = torch.device("meta")
    model = get_arch(LM_ARCH).model()
    cfg = model.cfg
    meta_params = model.init(torch.Generator(), device=meta)
    params = model.init(0, device=device)
    prompts = [p for p in lm_prompts(cfg.vocab) if len(p) == 64]
    rows, out = [], {}
    for mode, pol in (("bf16", ExecPolicy()),
                      ("int8", ExecPolicy(quant="int8"))):
        eng, _, _ = filled_engine(model, params, device, pol, prompts)
        meng = Engine(model, meta_params, EngineConfig(
            capacity=4, max_seq=eng.config.max_seq, policy=pol,
            device="meta", graphs=False))
        mg = meng._decode_graph
        _, stats = count(mg.fn, **mg.inputs)
        if mode == "int8":
            calls = [(4, cfg.d_model, cfg.d_ff)] * 2 + \
                [(4, cfg.d_ff, cfg.d_model)]
            calls *= cfg.n_layers
            q = stats.ops.get("qmatmul")
            check(q is not None and q.count == len(calls) == 72
                  and q.flops == sum(2 * m * k * n for m, k, n in calls)
                  and q.bytes == sum(m * k + k * n + 4 * (m + n) + 4 * m * n
                                     for m, k, n in calls),
                  f"int8 decode count: qmatmul {q}, expected 72 calls "
                  f"priced by {calls[:3]}")
        eng.warm_decode()
        times = replay_ms(eng._decode_graph)
        rows.append(launch_row(f"decode {mode} C=4", "decode", 80, 4, stats,
                               times))
        g = eng._prefill_graph(64)
        g(tokens=torch.as_tensor(prompts[0][None]))
        mg = meng._prefill_graph(64)
        _, pstats = count(mg.fn, **mg.inputs)
        rows.append(launch_row(f"prefill {mode} S=64", "prefill", 64, 1,
                               pstats, replay_ms(g)))
        if mode == "int8":
            # (c) per-op cost: the count's top 5 by bytes, the profiler's
            # top 5 kernels by device time, of the decode step run eagerly
            g = eng._decode_graph
            prof = lm_profile(lambda: g.fn(**g.inputs))
            out["per_op"] = {
                "count_top5_by_bytes": [
                    {"op": k, "calls": c.count, "bytes": c.bytes,
                     "flops": c.flops} for k, c in stats.top(5)],
                "profiler_top5_by_device_us": prof.get("kernels", [])[:5],
                "profiler_kernel_us": prof.get("kernel_us")}
        del eng, meng, g, mg
        free_card()
    del params
    free_card()

    # the train step: (d) eager peak, then its graph's replays
    bsz, seq = 8, 128
    step_fn = make_train_step(model, AdamWConfig(total_steps=20))
    batch = SyntheticTextIterator(SyntheticTextConfig(
        cfg.vocab, seq, bsz)).next_batch()
    mg = train_graph(step_fn, meta_params, adamw_init(meta_params),
                     {k: v.to(meta) for k, v in batch.items()}, device=meta,
                     compiled=False)
    _, tstats = count(mg.fn, **mg.inputs)
    params = model.init(0, device=device)
    opt = adamw_init(params)
    eager = train_graph(step_fn, params, opt, batch, device=device,
                        compiled=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager()
    torch.cuda.synchronize()
    measured_peak = torch.cuda.max_memory_allocated()
    ratio = tstats.peak_bytes / measured_peak
    lo, hi = LAUNCH_PEAK_RATIO
    check(lo <= ratio <= hi,
          f"train peak: predicted {tstats.peak_bytes} vs measured "
          f"{measured_peak} (ratio {ratio:.3f} outside {LAUNCH_PEAK_RATIO})")
    out["train_peak"] = {"predicted_bytes": tstats.peak_bytes,
                         "measured_bytes": measured_peak, "ratio": ratio}
    del eager
    free_card()
    graph = train_graph(step_fn, params, opt, batch, device=device)
    graph()
    rows.append(launch_row(f"train B={bsz}x{seq}", "train", seq, bsz,
                           tstats, replay_ms(graph)))
    del graph, params, opt
    free_card()
    out["steps"] = rows
    for r in rows:
        rf = r["roofline"]
        LAUNCH_LINES.append({
            "roofline": r["step"], "wall_ms": round(r["wall_ms"], 4),
            "step_time_ms": round(rf["step_time_s"] * 1e3, 4),
            "bound": rf["bottleneck"],
            "compute_ms": round(rf["compute_s"] * 1e3, 4),
            "memory_ms": round(rf["memory_s"] * 1e3, 4),
            "mfu": round(r["mfu"], 6),
            "bound_share": round(r["bound_share"], 4),
            "flops": rf["flops_per_device"],
            "bytes": rf["bytes_per_device"]})
    LAUNCH_LINES.append({"train_peak_gb": [
        round(out["train_peak"]["predicted_bytes"] / 1e9, 2),
        round(measured_peak / 1e9, 2)], "ratio": round(ratio, 3)})
    return out


def phase_launch(device) -> dict:
    """The launch tooling (ROADMAP §A.12): (a) ``launch_sweep``, (b)-(d)
    ``launch_roofline``. Prints a short line, the compact LAUNCH_LINES at
    the end, and writes the whole report to build/chip_smoke_launch.json.
    Returns the launches of its int8 engine's graphs and eager steps,
    counted from 0 here."""
    t0 = time.perf_counter()
    reset_counts()
    report = {"sweep": launch_sweep()}
    report.update(launch_roofline(device))
    launches = counts()
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t0
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_launch.json").write_text(
        json.dumps(report, indent=1, default=str))
    emit({"phase": "launch", "seconds": report["seconds"],
          "sweep_s": report["sweep"]["seconds"],
          "per_op": report["per_op"], "train_peak": report["train_peak"],
          "launches": launches})
    return launches


# ------------------------------------------------------------------- boot

# the served ladders booted in the boot phase
BOOT_CONFIGS = {"mnist_cnn": {"batch": 8, "buckets": "auto"},
                "highres_cnn": {"batch": 8, "buckets": None}}


def boot_model(name, mode):
    from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
    from repro_torch.models.vgg import VGGStyleCNN, VGGStyleCNNConfig
    from repro_torch.ops import ExecPolicy
    pol = ExecPolicy(quant=mode)
    if name == "mnist_cnn":
        return PaperCNN(PaperCNNConfig(policy=pol))
    return VGGStyleCNN(VGGStyleCNNConfig(policy=pol))


def _replace_node(plan, nid, **changes):
    import dataclasses
    nodes = tuple(dataclasses.replace(n, **changes) if n.id == nid else n
                  for n in plan.graph)
    return dataclasses.replace(
        plan, graph=dataclasses.replace(plan.graph, nodes=nodes))


def boot_verifier() -> list[dict]:
    """Malformed plans bound on the card are refused with the Violation
    codes (and nodes) the same tampering gets on the CPU."""
    import dataclasses
    from repro_torch.analysis import verify_plan
    from repro_torch.core.quantize import QTensor
    from repro_torch.graph.ir import FusedConvBlockNode

    def first_fused(plan, tiled=False):
        return next(n for n in plan.graph
                    if isinstance(n, FusedConvBlockNode)
                    and (n.tiling is not None or not tiled))

    def halo(bound):
        n = first_fused(bound.plan, tiled=True)
        return dataclasses.replace(bound, plan=_replace_node(
            bound.plan, n.id, tiling=dataclasses.replace(
                n.tiling, halo=n.tiling.halo + 1)))

    def stride(bound):
        n = first_fused(bound.plan)
        return dataclasses.replace(bound, plan=_replace_node(
            bound.plan, n.id, stride=(2, 2)))

    def scale(bound):
        nid = next(n.id for n in bound.plan.graph
                   if getattr(n, "kind", "") == "int8_conv_weight")
        folded = dict(bound.folded)
        v = folded[nid]
        folded[nid] = QTensor(v.codes, v.scale.reshape(-1)[:1])
        return dataclasses.replace(bound, folded=folded)

    def fp_weight(bound):
        n = first_fused(bound.plan)
        return dataclasses.replace(bound, plan=_replace_node(
            bound.plan, n.id, inputs=(n.inputs[0], n.inputs[0])))

    cases = {"stream-halo": ("none", 10_000, halo),
             "shape-flow": ("qformat", None, stride),
             "quant-scale-shape": ("int8", None, scale),
             "quant-weight-unlowered": ("int8", None, fp_weight)}
    rows = []
    for code, (mode, budget, tamper) in cases.items():
        model = boot_model("mnist_cnn", mode)
        params = model.init(0, device="cpu")
        plan = model.compile(batch=8, stream_budget=budget)
        got = {}
        for dev in ("cuda", "cpu"):
            bound = plan.bind(to_device(params, dev))
            got[dev] = [(v.code, v.node) for v in verify_plan(
                tamper(bound), raise_on_violation=False)]
        check(got["cuda"] == got["cpu"]
              and code in [c for c, _ in got["cuda"]],
              f"boot verifier {code}: card {got['cuda']}, cpu {got['cpu']}")
        rows.append({"case": code, "mode": mode, "violations": got["cuda"]})
    return rows


def stage_call(op, args, kw, tiles):
    """A zero-argument call of one tunable plan stage at ``tiles``."""
    from repro_torch.kernels.conv_window.ops import conv_window
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.qmatmul.ops import qmatmul
    from repro_torch.ops import ExecPolicy
    from repro_torch.stream.executor import (stream_conv2d,
                                             stream_fused_conv_block)
    fn = {"fused_conv_block": fused_cwp, "conv2d": conv_window,
          "qmatmul": qmatmul, "stream_conv2d": stream_conv2d,
          "stream_fused_conv_block": stream_fused_conv_block}[op]
    pol = ExecPolicy(tiling={f"{op}.{k}": v for k, v in tiles.items()})
    return lambda: fn(*args, policy=pol, **kw)


def boot_winners(bound) -> list[dict]:
    """Per tunable stage of ``bound``: the heuristic's tiles, the baked
    winner, and the stage's device time at each (one kernel launch;
    a streamed stage's whole band loop)."""
    import torch
    from repro_torch.ops.autotune import heuristic_tiles
    rows = []
    for node, op, args, kw in bound.plan._stage_calls(bound.params,
                                                      bound.folded):
        heur = heuristic_tiles(op, *args, **kw)
        baked = bound.tuned.get(node.id)
        win = ({k.split(".", 1)[1]: v for k, v in baked.items()}
               if baked else heur)
        timer = call_device_ms if op.startswith("stream_") else device_ms
        with torch.inference_mode():
            heur_ms = timer(stage_call(op, args, kw, heur))[0]
            tuned_ms = (timer(stage_call(op, args, kw, win))[0] if baked
                        else heur_ms)
        rows.append({"stage": node.w.path[0], "op": op, "heuristic": heur,
                     "winner": win, "heuristic_ms": heur_ms,
                     "tuned_ms": tuned_ms})
    return rows


@contextlib.contextmanager
def tuning_cache_off():
    """The heuristic's tiles for every call in the block: an empty
    TUNING_CACHE, restored after."""
    from repro_torch.ops.tiling import TUNING_CACHE
    saved = TUNING_CACHE.snapshot()
    TUNING_CACHE.clear()
    try:
        yield
    finally:
        TUNING_CACHE.restore(saved)


def _served(eng, images) -> dict:
    for img in images:
        eng.submit(img)
    return eng.run()


def _bitwise_results(label, got: dict, want: dict) -> None:
    import numpy as np
    check(sorted(got) == sorted(want), f"{label}: request ids differ")
    for uid in want:
        check(np.array_equal(got[uid]["logits"], want[uid]["logits"]),
              f"{label}: request {uid} logits differ")


def boot_one(name, mode, work, device) -> dict:
    """One model and mode: a fresh autotuned engine, tuned vs heuristic
    plans, the ladder saved and booted from the store, a corrupted
    store, graph replays and pad lanes, all on the card."""
    import shutil
    import warnings
    import numpy as np
    import torch
    import repro_torch.ops.autotune as autotune
    from repro_torch.artifact import clear_graph_cache, collect_warmup
    from repro_torch.serve import VisionEngine, VisionEngineConfig

    model = boot_model(name, mode)
    params = model.init(0, device="cpu")
    cfg = dict(device="cuda", autotune=True, **BOOT_CONFIGS[name])
    top = cfg["batch"]
    clear_graph_cache()
    t0 = time.perf_counter()
    measured = autotune.measurements
    with collect_warmup() as fresh_rep:
        fresh = VisionEngine(model, params, VisionEngineConfig(**cfg))
    fresh_s = time.perf_counter() - t0
    measured = autotune.measurements - measured
    rng = np.random.RandomState(9)
    tuned = []
    for b in fresh.buckets:
        bound = fresh._bounds[b]
        heur = model.compile(batch=b).bind(bound.params)
        x = torch.from_numpy(rng.randn(*model.input_shape(b)).astype(
            np.float32)).to(device)
        with torch.inference_mode():
            got = bound(x)
            with tuning_cache_off():
                want = heur(x)
            row = hold(f"boot {name} tuned vs heuristic B={b}", mode, got,
                       want)
        tuned.append({"B": b, "stages_baked": len(bound.tuned), **row})

    # the ladder through the artifact store, then a corrupted copy of it
    store = work / name / mode
    fresh.save_artifacts(store)
    clear_graph_cache()
    with collect_warmup() as boot_rep:
        booted = VisionEngine(model, params, VisionEngineConfig(
            artifact_dir=str(store), **cfg))
    check(boot_rep.zero_compile(),
          f"boot {name} {mode}: the artifact boot derived:\n"
          f"{boot_rep.pretty()}")
    check(set(booted.plan_source.values()) == {"artifact+aot"},
          f"boot {name} {mode}: plan_source {booted.plan_source}")
    check(all(booted._bounds[b].tuned == fresh._bounds[b].tuned
              for b in booted.buckets),
          f"boot {name} {mode}: the artifact lost baked tiles")
    bad = work / name / f"{mode}-corrupt"
    shutil.copytree(store, bad)
    (bad / booted.bucket_name(top) / "manifest.json").write_text("{not")
    clear_graph_cache()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        degraded = VisionEngine(model, params, VisionEngineConfig(
            artifact_dir=str(bad), **cfg))
    check(any("falling back" in str(w.message) for w in caught)
          and degraded.plan_source[top] == "fresh",
          f"boot {name} {mode}: a corrupt artifact gave "
          f"{degraded.plan_source}")

    # a full batch of large images, then a short batch: the same logits
    # from all three engines, the short batch's as a direct call of its
    # bucket's bound plan on zero pad lanes
    shape = model.input_shape()[1:]
    full = [(rng.randn(*shape) * 8).astype(np.float32) for _ in range(top)]
    short = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    want = _served(fresh, full + short)
    _bitwise_results(f"boot {name} {mode} artifact vs fresh",
                     _served(booted, full + short), want)
    _bitwise_results(f"boot {name} {mode} corrupt store vs fresh",
                     _served(degraded, full + short), want)
    sb = booted._bucket_for(3)
    xs = torch.zeros(model.input_shape(sb))
    xs[:3] = torch.from_numpy(np.stack(short))
    with torch.inference_mode():
        direct = booted._bounds[sb](xs.to(device)).cpu().numpy()
    for i in range(3):
        check(np.array_equal(direct[i], want[top + i]["logits"]),
              f"boot {name} {mode}: short batch lane {i} differs from a "
              f"direct call on zero pad lanes")
    # every bucket's graph against a direct call of its bound plan
    for b in booted.buckets:
        x = torch.from_numpy(rng.randn(*model.input_shape(b)).astype(
            np.float32)).to(device)
        with torch.inference_mode():
            got = booted._graphs[b].run(x).clone()
            ref = booted._bounds[b](x)
        torch.cuda.synchronize()
        check(bitwise(got, ref), f"boot {name} {mode} bucket {b}: graph "
                                 f"replay vs direct max_abs "
                                 f"{max_abs(got, ref)}")
    return {"model": name, "mode": mode, "fresh_boot_s": fresh_s,
            "fresh_measured": measured,
            "fresh_warmup": fresh_rep.seconds,
            "fresh_warmup_calls": fresh_rep.counts,
            "tuned_vs_heuristic": tuned,
            "winners": boot_winners(fresh._bounds[top]),
            "artifact_plan_source": booted.plan_source,
            "artifact_warmup": boot_rep.seconds,
            "artifact_warmup_calls": boot_rep.counts,
            "corrupt_plan_source": degraded.plan_source,
            "graph_launches": booted.graph_launches(),
            "tuned": {b: booted._bounds[b].tuned for b in booted.buckets}}


def boot_cache_roundtrip(name, work, tuned_int8) -> dict:
    """The TuningCache saved and reloaded; a second autotuned boot of the
    int8 ladder then measures nothing and bakes the same tiles."""
    import repro_torch.ops.autotune as autotune
    from repro_torch.artifact import clear_graph_cache
    from repro_torch.ops.tiling import TUNING_CACHE
    from repro_torch.serve import VisionEngine, VisionEngineConfig
    path = work / f"{name}.tuning.json"
    TUNING_CACHE.save(path)
    n = len(TUNING_CACHE)
    TUNING_CACHE.clear()
    loaded = TUNING_CACHE.load(path)
    check(loaded == n > 0, f"boot {name}: saved {n} tuning entries, "
                           f"loaded {loaded}")
    before = autotune.measurements
    clear_graph_cache()
    model = boot_model(name, "int8")
    again = VisionEngine(model, model.init(0, device="cpu"),
                         VisionEngineConfig(device="cuda", autotune=True,
                                            **BOOT_CONFIGS[name]))
    measured = autotune.measurements - before
    check(not measured, f"boot {name}: the second boot measured "
                        f"{measured} candidates")
    got = {b: again._bounds[b].tuned for b in again.buckets}
    check(got == tuned_int8, f"boot {name}: second boot baked {got}, the "
                             f"first {tuned_int8}")
    return {"model": name, "entries": n, "loaded": loaded,
            "second_boot_measured": measured}


def boot_graph_times(name, mode, bsz, device) -> dict:
    """Device and wall time a batch of one bound plan, replayed as its
    CUDA graph against a direct call, on the same device input."""
    import torch
    from repro_torch.artifact.aot import capture_graph
    model = boot_model(name, mode)
    bound = model.compile(batch=bsz).bind(model.init(0, device=device))
    graph = capture_graph(bound, model.input_shape(bsz))
    x = torch.randn(model.input_shape(bsz), device=device)

    def wall(fn):
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    with torch.inference_mode():
        g_ms, g_dry = call_device_ms(lambda: graph.run(x))
        d_ms, d_dry = call_device_ms(lambda: bound(x))
        g_wall, d_wall = wall(lambda: graph.run(x)), wall(lambda: bound(x))
    return {"model": name, "mode": mode, "B": bsz, "graph_ms": g_ms,
            "direct_ms": d_ms, "graph_wall_ms": g_wall,
            "direct_wall_ms": d_wall,
            "queue_ran_dry": [k for k, d in (("graph", g_dry),
                                             ("direct", d_dry)) if d]}


def phase_boot(device):
    """Boot the served plans as the reference does (see the module
    docstring). The tuning cache it fills is dropped at the end, so the
    later phases time the heuristic tiles."""
    import tempfile
    from repro_torch.ops.tiling import TUNING_CACHE
    t0 = time.perf_counter()
    saved = TUNING_CACHE.snapshot()
    TUNING_CACHE.clear()
    out = {"phase": "boot", "verifier": boot_verifier(), "runs": [],
           "cache": [], "graph_times": []}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_boot_") as tmp:
            work = Path(tmp)
            for name in BOOT_CONFIGS:
                runs = []
                for mode in MODES:
                    before = counts()
                    runs.append(boot_one(name, mode, work, device))
                    int8_routes_held(f"boot {name} {mode}", mode,
                                     {k: counts()[k] - before[k]
                                      for k in before})
                check(sum(r["fresh_measured"] for r in runs) > 0,
                      f"boot {name}: the fresh autotuned boots measured "
                      f"no candidate (autotune.measurements)")
                out["runs"].extend(runs)
                out["cache"].append(boot_cache_roundtrip(
                    name, work, out["runs"][-1]["tuned"]))
        for run in out["runs"]:
            del run["tuned"]            # shown as the winners
        with tuning_cache_off():         # the default plans' tiles
            for name in BOOT_CONFIGS:
                for mode in MODES:
                    for bsz in (1, 8):
                        out["graph_times"].append(
                            boot_graph_times(name, mode, bsz, device))
    finally:
        TUNING_CACHE.restore(saved)
    out["seconds"] = time.perf_counter() - t0
    emit(out)


# ------------------------------------------------------------- the mesh

def mesh_lattice(rng, shape, frac=6, maxcode=31):
    """The reference's lattice (tests/test_shard_plan.py): integer
    multiples of 2^-frac, the first element pinned to 127·2^-frac."""
    import numpy as np
    v = rng.randint(-maxcode, maxcode + 1, size=shape).astype(np.float32)
    v = v * np.float32(2.0 ** -frac)
    v.reshape(-1)[0] = 127 * 2.0 ** -frac
    return v


def mesh_inputs(model, device):
    """{"lattice" | "random": (params, images)} at B = MESH_BATCH, made
    alike on every rank: the lattice from numpy seed 7, the random
    weights from the model's seed-0 init and images from a CPU
    generator."""
    import numpy as np
    import torch
    rng = np.random.RandomState(7)

    def lat(tree):
        if isinstance(tree, dict):
            return {k: lat(v) for k, v in tree.items()}
        return torch.from_numpy(mesh_lattice(rng, tuple(tree.shape))).to(
            device)

    shape = model.input_shape(MESH_BATCH)
    params = model.init(0, device="cpu")
    lattice = (lat(params),
               torch.from_numpy(mesh_lattice(rng, shape)).to(device))
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    return {"lattice": lattice,
            "random": (to_device(params, device), x.to(device))}


def mesh_exact(arch, mode, data) -> bool:
    """Is the placed plan owed bitwise parity with the unsharded plan?
    int8 always (integer codes); on lattice data the sums stay exact but
    under ``none`` on highres_cnn: past its first blocks the activations
    reach ~168 in steps of 2^-18 and finer, past fp32's 24 bits (as
    tests/test_torch_mesh.py finds at 48²), so the order of a sum shows.
    On the CPU an OCP shard sums each channel in the whole stage's order;
    on the card the conv kernel's ``split`` (the lanes that share a
    window's kernel rows, ``ops.tiling.choose_fused_blocks``) follows the
    grid's size, hence M/ocp and the rank's batch rows, and with it the
    order: ``mesh_split_checks`` shows it on the card, at highres_cnn's
    OCP shard shapes."""
    if mode == "int8":
        return True
    return data == "lattice" and not (arch == "highres_cnn"
                                      and mode == "none")


def mesh_sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_hold(label, arch, mode, data, got, want) -> dict:
    """A placed plan's logits against the unsharded plan's: bitwise where
    ``mesh_exact``, else the CPU tests' bars (fp32 rtol 1e-5, atol 1e-6
    of the largest |logit|; qformat one Q8.8 step)."""
    import torch
    mesh_sync(got.device)
    got, want = got.cpu(), want.cpu()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{label}: shape {tuple(got.shape)} or non-finite values")
    err = max_abs(got, want)
    if mesh_exact(arch, mode, data):
        ok, bar = bitwise(got, want), "bitwise"
    elif mode == "qformat":
        ok, bar = err <= QSTEP, QSTEP
    else:
        atol = MESH_ATOL * max(1.0, float(want.abs().max()))
        ok, bar = bool(torch.allclose(got, want, rtol=MESH_RTOL,
                                      atol=atol)), atol
    check(ok, f"{label}: max_abs {err} against the unsharded plan, bar "
              f"{bar}")
    return {"max_abs": err, "bar": bar}


def mesh_shard_shapes(plan) -> list[tuple[str, tuple]]:
    """(kernel, (N, H, W, M, K)) of each placed stage's per-shard launch:
    OCP runs the stage's kernel on M/ocp channels; ICP and BOTH run
    conv_window on the (N/icp, M/ocp) block before the ring."""
    from repro_torch.graph.ir import FusedConvBlockNode
    from repro_torch.graph.passes import stage_input_spec
    out = []
    for nid, grid in plan.grids.items():
        node = plan.graph.node(nid)
        _, n, h, w = stage_input_spec(plan.graph, node).shape
        m, _, k, _ = node.w.shape
        kern = ("fused_cwp" if grid.ki == 1
                and isinstance(node, FusedConvBlockNode) else "conv_window")
        out.append((kern, (n // grid.ki, h, w, m // grid.ko, k)))
    return out


def mesh_kernel_vs_plain(shapes, bsz, fc, device) -> list[dict]:
    """Each per-shard shape's kernel against its plain version on the
    card, in the three number formats (int8 codes on the int8 route and
    qformat bitwise, fp32 TOL_FP32 of 1 + max|y|), and qmatmul at the
    rank's fc shape."""
    import torch
    from repro_torch.kernels.conv_window.ops import conv_window
    from repro_torch.kernels.conv_window.ref import conv2d_window_ref
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    from repro_torch.kernels.qmatmul.ops import qmatmul
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    gen = torch.Generator().manual_seed(12)
    rows = []
    for kern, shape in shapes:
        for mode in MODES:
            x, w, b, s = conv_inputs(gen, bsz, shape, mode, device,
                                     codes=mode == "int8")
            if kern == "fused_cwp":
                got, want = (fused_cwp(x, w, b, scale=s),
                             fused_cwp_ref(x, w, b, scale=s))
            else:
                got, want = conv_window(x, w, None), conv2d_window_ref(
                    x, w, None)
            mesh_sync(device)
            err = max_abs(got, want)
            tol = 0.0 if mode != "none" else TOL_FP32 * (
                1 + float(want.abs().max()))
            check(err <= tol and (mode == "none" or bitwise(got, want)),
                  f"mesh {kern} shard {shape} B={bsz} {mode}: kernel vs "
                  f"plain max_abs {err}, tolerance {tol}")
            rows.append({"kernel": kern, "shape": list(shape), "B": bsz,
                         "mode": mode, "max_abs": err})
    xc, wc, xs, ws = fc_inputs(gen, bsz, device, fc)
    got, want = qmatmul(xc, wc, xs, ws), qmatmul_ref(xc, wc, xs, ws)
    check(bitwise(got, want), f"mesh qmatmul {bsz}x{fc}: kernel vs plain "
                              f"max_abs {max_abs(got, want)}")
    rows.append({"kernel": "qmatmul", "shape": [bsz, *fc], "B": bsz,
                 "mode": "int8", "max_abs": 0.0})
    return rows


def mesh_walls(bound, x) -> dict:
    """Wall ms of one batch through ``bound`` on this rank (median of
    MESH_TIMED, each to its synchronize) and the share of it each
    collective took (COMM_STATS's host seconds over the same calls)."""
    import torch
    from repro_torch.core.parallelism import COMM_STATS
    with torch.inference_mode():
        bound(x)
        mesh_sync(x.device)
        COMM_STATS.reset()
        walls = []
        for _ in range(MESH_TIMED):
            t0 = time.perf_counter()
            bound(x)
            mesh_sync(x.device)
            walls.append(time.perf_counter() - t0)
    total = sum(walls)
    return {"batch_wall_ms": statistics.median(walls) * 1e3,
            "share": {k: v / total for k, v in COMM_STATS.seconds.items()},
            "calls_per_batch": {k: v / MESH_TIMED
                                for k, v in COMM_STATS.calls.items()},
            "bytes_per_batch": {k: v / MESH_TIMED
                                for k, v in COMM_STATS.bytes.items()}}


def mesh_rank(rank, world, shape) -> dict:
    """One rank of a gloo world whose ranks all share cuda:0: the placed
    plans of mnist_cnn and highres_cnn (auto placement and the forced
    input and output schedules, every number format, lattice and random
    data, B = MESH_BATCH) against the unsharded plan; the launches of the
    mesh path alone; each per-shard kernel launch against its plain
    version; the batch walls, collective shares and weight bytes."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.parallelism import COMM_STATS
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.ops import ExecPolicy
    device = torch.device("cuda", 0)
    mesh = make_test_mesh(shape, device="cuda")
    cases, plains = [], {}
    for arch in MESH_ARCHS:
        model = get_arch(arch).model()
        for data, (params, x) in mesh_inputs(model, device).items():
            for mode in MODES:
                with torch.inference_mode():
                    plains[(arch, data, mode)] = model.compile(
                        ExecPolicy(quant=mode), batch=MESH_BATCH).bind(
                        params)(x)
                for ov in MESH_OVERRIDES:
                    cases.append((arch, model, data, params, x, mode, ov))
    mesh_sync(device)
    reset_counts()                      # the mesh path alone from here
    COMM_STATS.reset()
    rows, plans, refused, failures = [], {}, [], []
    for arch, model, data, params, x, mode, ov in cases:
        label = f"mesh {shape} rank {rank} {arch} {data} {mode} {ov}"
        try:
            plan = model.compile(ExecPolicy(quant=mode, channel_parallel=ov),
                                 batch=MESH_BATCH, mesh=mesh)
        except ValueError as e:         # no stage can take the override
            check("applies to none" in str(e), f"{label}: {e}")
            refused.append([arch, data, mode, ov])
            continue
        placements = [str(n.sharding) for n in plan.graph
                      if getattr(n, "sharding", None) is not None]
        before = counts()
        bound = plan.bind(params)
        with torch.inference_mode():
            got = bound(x)
        int8_routes_held(label, mode, {k: counts()[k] - before[k]
                                       for k in before})
        try:                            # every case runs; all misses named
            row = mesh_hold(label, arch, mode, data, got,
                            plains[(arch, data, mode)])
        except SmokeFailure as e:
            failures.append(str(e))
            continue
        rows.append({"arch": arch, "data": data, "mode": mode,
                     "override": ov, "placement": placements, **row})
        plans[(arch, data, mode, ov)] = (plan, bound, x)
    check(not failures, "; ".join(failures))
    launches = counts()
    staged = {k: "gloo, host-staged" if COMM_STATS.staged[k] else "gloo"
              for k in COMM_STATS.calls}
    engine = mesh_engine(mesh, device)
    # timed after the launches were read: the walls, the shares, bytes
    walls, weights = {}, {}
    for arch in MESH_ARCHS:
        for mode in ("none", "int8"):
            plan, bound, x = plans[(arch, "random", mode, None)]
            walls[f"{arch} {mode}"] = mesh_walls(bound, x)
        plan, bound, x = plans[(arch, "random", "none", None)]
        mine = bound.stage_weight_bytes()
        whole = get_arch(arch).model().compile(batch=MESH_BATCH).bind(
            bound.params).stage_weight_bytes()
        weights[arch] = {
            "rank_bytes": sum(mine.values()),
            "whole_bytes": sum(whole.values()),
            "stages": {f"%{nid} {plan.graph.node(nid).sharding}":
                       [mine[nid], whole[nid]] for nid in mine}}
    # each per-shard launch shape of the placed plans against its plain
    # version, at this rank's batch rows (not counted: read above)
    shapes = sorted({s for plan, _, _ in plans.values()
                     for s in mesh_shard_shapes(plan)})
    plan, _, x = next(iter(plans.values()))
    rows_b = bound_rows(plan, x)
    checks = (mesh_kernel_vs_plain(shapes, rows_b, FC, device)
              + mesh_kernel_vs_plain([], rows_b, highres_fc(), device))
    return {"rank": rank, "launches": launches, "rows": rows,
            "refused": refused, "collectives": staged, "walls": walls,
            "weights": weights, "engine": engine,
            "shard_checks": len(checks)}


def mesh_engine(mesh, device) -> dict:
    """VisionEngine on a gloo mesh on the card: it serves eagerly (gloo
    collectives cannot be captured), says so, and its int8 logits for a
    full bucket equal the unsharded bound plan's bitwise."""
    import numpy as np
    import torch
    from repro_torch.models.cnn import PaperCNN
    from repro_torch.ops import ExecPolicy
    from repro_torch.serve import VisionEngine, VisionEngineConfig
    model = PaperCNN()
    params = model.init(0, device="cpu")
    pol = ExecPolicy(quant="int8")
    eng = VisionEngine(model, params, VisionEngineConfig(
        batch=MESH_BATCH, buckets="auto", policy=pol, device="cuda",
        mesh=mesh))
    check(eng.graphs == "off (gloo)" and "graphs: off (gloo)" in eng.pretty(),
          f"mesh engine: graphs {eng.graphs!r}")
    images = np.random.RandomState(4).randn(
        MESH_BATCH, *model.input_shape()[1:]).astype(np.float32)
    uids = [eng.submit(img) for img in images]
    got = eng.run()
    with torch.inference_mode():
        want = model.compile(pol, batch=MESH_BATCH).bind(
            to_device(params, device))(torch.from_numpy(images).to(
                device)).cpu().numpy()
    check(all(np.array_equal(got[u]["logits"], want[i])
              for i, u in enumerate(uids)),
          "mesh engine: int8 logits differ from the unsharded plan's")
    return {"buckets": list(eng.buckets), "graphs": eng.graphs,
            "stats_graphs": eng.stats.graphs, "requests": len(uids)}


def bound_rows(plan, x) -> int:
    """The batch rows this rank's plan computes: its data-axis slice."""
    from repro_torch.core.parallelism import batch_shard
    rows = batch_shard(plan.mesh, x.shape[0])
    return x.shape[0] if rows is None else rows[1] - rows[0]


def mesh_nccl_world1(device) -> tuple[list[dict], dict[str, int]]:
    """World 1 over NCCL on cuda:0, mesh (1, 1): VisionEngine serves
    mnist_cnn at full width in every number format through its CUDA
    graphs, bitwise to the engine without a mesh. The engines without a
    mesh run first; the launch counts, returned, are the mesh engines'
    alone (counted from 0 just before them, read just after)."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.artifact import clear_graph_cache
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models.cnn import PaperCNN
    from repro_torch.ops import ExecPolicy
    from repro_torch.serve import VisionEngine, VisionEngineConfig
    mesh = build_mesh("1x1", None, "cuda")
    out = []
    try:
        check(dist.get_backend() == "nccl",
              f"world 1 resolved to {dist.get_backend()}, not nccl")
        model = PaperCNN()
        params = model.init(0, device="cpu")
        rng = np.random.RandomState(3)
        images = [rng.randn(*model.input_shape()[1:]).astype(np.float32)
                  for _ in range(19)]
        def serve(label, m, mode):
            clear_graph_cache()
            before = counts()
            eng = VisionEngine(model, params, VisionEngineConfig(
                batch=8, buckets="auto", policy=ExecPolicy(quant=mode),
                device="cuda", mesh=m))
            check(eng.graphs == "on", f"nccl world 1 {label}: graphs "
                                      f"{eng.graphs}")
            for img in images:
                eng.submit(img)
            res = eng.run()
            int8_routes_held(f"nccl world 1 {label} {mode}", mode,
                             {k: counts()[k] - before[k] for k in before})
            return res

        plain = {mode: serve("plain", None, mode) for mode in MODES}
        mesh_sync(device)
        reset_counts()                  # the mesh engines alone from here
        placed = {mode: serve("mesh", mesh, mode) for mode in MODES}
        mesh_sync(device)
        launches = counts()
        for mode in MODES:
            for uid, r in plain[mode].items():
                check(np.array_equal(r["logits"],
                                     placed[mode][uid]["logits"]),
                      f"nccl world 1 {mode}: request {uid} differs from "
                      f"the engine without a mesh")
            out.append({"mode": mode, "requests": len(images),
                        "bitwise": True, "graphs": "on"})
    finally:
        dist.destroy_process_group()
    return out, launches


def mesh_split_checks(device) -> list[dict]:
    """Why an OCP shard is not bitwise to the unsharded stage under fp32
    on the card: at each highres_cnn conv stage (224², B = 8 and the 2 × 2
    mesh's 4 rows) and OCP at model 2 and 4, the fused_cwp shard on its
    first M/ocp channels, with its own tiles, is held bitwise against the
    whole stage's launch pinned to the shard's ``split`` (the same
    channels): the per-channel sum depends on ``split`` alone. Beside it,
    the splits the tiler picks for the shard and the whole stage, and the
    shard against the whole stage at its own tiles (0 where the splits
    agree; checked)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.graph.ir import FusedConvBlockNode
    from repro_torch.graph.passes import stage_input_spec
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.ops import ExecPolicy
    from repro_torch.ops.tiling import fused_tiles, platform_key
    gen = torch.Generator().manual_seed(14)
    card = platform_key(device)
    plan = get_arch("highres_cnn").model().compile(batch=MESH_BATCH)
    rows = []
    for node in plan.graph:
        if not isinstance(node, FusedConvBlockNode):
            continue
        _, n, h, w = stage_input_spec(plan.graph, node).shape
        m, _, k, _ = node.w.shape
        for bsz in (MESH_BATCH, MESH_BATCH // 2):
            x, wt, b, _ = conv_inputs(gen, bsz, (n, h, w, m, k), "none",
                                      device)
            whole = fused_cwp(x, wt, b)
            for ko in (2, 4):
                mo = m // ko
                sw = fused_tiles(bsz, n, h, w, m, k, k, 1, 1,
                                 platform=card)["split"]
                ss = fused_tiles(bsz, n, h, w, mo, k, k, 1, 1,
                                 platform=card)["split"]
                shard = fused_cwp(x, wt[:mo].contiguous(), b[:mo].contiguous())
                pinned = fused_cwp(x, wt, b, policy=ExecPolicy(
                    tiling={"fused_conv_block.split": ss}))[:, :mo]
                mesh_sync(device)
                label = (f"highres_cnn %{node.id} ({n}->{m}, {h}²) B={bsz} "
                         f"ocp{ko}")
                check(bitwise(shard, pinned),
                      f"{label}: the shard (split {ss}) differs from the "
                      f"whole stage pinned to split {ss} by "
                      f"{max_abs(shard, pinned)}")
                err = max_abs(shard, whole[:, :mo])
                check(ss != sw or err == 0.0,
                      f"{label}: split {ss} at both, yet the shard differs "
                      f"from the whole stage by {err}")
                rows.append({"stage": label, "split_shard": ss,
                             "split_whole": sw, "max_abs_own_tiles": err,
                             "max_abs_pinned": 0.0})
    return rows


def mesh_shard_times(device) -> list[dict]:
    """Per-shard launch shapes timed alone on the card (B = 8, fp32), each
    beside its plain version, the library call and the bound:
    highres_cnn's block 0 under OCP at model 4 (fused_cwp, M = 2), its
    block 1 under BOTH icp2 x ocp2 (conv_window on the (N/2, M/2) block),
    and mnist_cnn's conv2 under OCP at model 4 (fused_cwp, M = 5)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv_window.ops import conv_window
    from repro_torch.kernels.conv_window.ref import conv2d_window_ref
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    gen = torch.Generator().manual_seed(13)
    rows = []
    for label, kern, shape in MESH_TIMED_SHAPES:
        x, w, b, _ = conv_inputs(gen, 8, shape, "none", device)
        pooled = kern == "fused_cwp"
        nbytes, ops = conv_work(8, shape, pooled)
        if pooled:
            fns = (lambda: fused_cwp(x, w, b), lambda: fused_cwp_ref(x, w, b),
                   lambda: F.max_pool2d(F.relu(F.conv2d(x, w, b)), 2))
        else:
            nbytes -= 4 * 2 * shape[3]          # no bias on a partial
            fns = (lambda: conv_window(x, w, None),
                   lambda: conv2d_window_ref(x, w, None),
                   lambda: F.conv2d(x, w))
        rows.append(_time_row(kern, label, 8, *fns, nbytes, ops / PEAK_FP32,
                              exact=False, model="mesh shard"))
        rows.append(int8_time_row(gen, device, kern, label, 8, shape,
                                  model="mesh shard", bias=pooled))
    return rows


def spmd_worlds(fn, worlds: dict, *args, timeout: float) -> list[tuple]:
    """``run_spmd(fn, world, "gloo", "cuda", shape, *args)`` for every
    (shape, world) of ``worlds`` at once, each from a thread of its own
    (their ranks time-share the card and the host). Returns (shape,
    world, the ranks' results, seconds) in ``worlds``' order."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.launch.mesh import run_spmd

    def one(item):
        shape, world = item
        t0 = time.perf_counter()
        ranks = run_spmd(fn, world, "gloo", "cuda", shape, *args,
                         timeout=timeout)
        return shape, world, ranks, time.perf_counter() - t0

    with ThreadPoolExecutor(len(worlds)) as pool:
        return list(pool.map(one, worlds.items()))


def phase_mesh(device) -> dict:
    """Channel parallelism on one card: NCCL world 1, then gloo worlds 2
    and 4 whose ranks share cuda:0 (meshes (1, 2), (1, 4), (2, 2), run
    at once: ``spmd_worlds``), then the per-shard shapes timed alone. Returns the launches of the mesh
    path summed over every rank (counted from 0 in each)."""
    free_card()                         # the ranks share this card
    world1, world1_launches = mesh_nccl_world1(device)
    total = dict(world1_launches)
    worlds = []
    for shape, world, ranks, seconds in spmd_worlds(
            mesh_rank, MESH_WORLDS, timeout=MESH_TIMEOUT_S):
        for r in ranks:
            check(r["launches"]["fused_cwp"] and r["launches"]["conv_window"]
                  and r["launches"]["qmatmul"],
                  f"mesh {shape} rank {r['rank']}: a kernel of the mesh "
                  f"path never launched: {r['launches']}")
            total = {k: total[k] + r["launches"][k] for k in total}
        worlds.append({
            "mesh": list(shape), "world": world, "backend": "gloo",
            "seconds": seconds,
            "cases": len(ranks[0]["rows"]), "refused": ranks[0]["refused"],
            "placements": sorted({(r["arch"], str(r["override"]),
                                   " ".join(r["placement"]))
                                  for r in ranks[0]["rows"]}),
            "max_abs": max(row["max_abs"] for r in ranks
                           for row in r["rows"]),
            "collectives": ranks[0]["collectives"],
            "launches": [r["launches"] for r in ranks],
            "shard_checks": [r["shard_checks"] for r in ranks],
            "walls": [r["walls"] for r in ranks],
            "weights": [r["weights"] for r in ranks],
            "note": "every rank time-shares one card with the other "
                    "worlds' ranks: these walls say nothing about "
                    "scaling"})
    splits = mesh_split_checks(device)
    times = mesh_shard_times(device)
    emit({"phase": "mesh", "nccl_world1": world1,
          "world1_launches": world1_launches, "worlds": worlds,
          "split_checks": splits, "shard_times": times})
    return total


# ---------------------------------------------------------------- lm_mesh

def lm_mesh_serve(model, params, ctx, quant, device,
                  prompt_len: int = 64, capacity: int = 4,
                  requests: int = LM_MESH_REQUESTS) -> dict:
    """``Engine`` (graphs on where the mesh allows) on ``ctx``'s mesh, or
    without one (``ctx`` None), under ``quant`` ("none": the model's bf16;
    "int8": every MLP matmul a qmatmul and an int8 KV cache) over the
    launcher's first ``requests`` prompts, LM_MESH_NEW tokens each at
    ``capacity``. After its first step (every request admitted, one
    decode step) one more decode step's logits over the live slots, outside
    the run: it writes the K/V the engine's next step writes again (an
    int8 cache is not stored back; a recurrent state is put back), so the
    run goes on as it would. After the run, a prefill's logits (the first
    prompt of the full length). Prompts of ``prompt_len`` tokens or half
    as many (whole scan chunks for the sub-quadratic LMs).
    Returns the tokens, both logits whole (CPU), the live slots after the
    first step (on a mesh, those in this rank's part of the cache), the
    run's wall, steps, prefills, decode steps, and its wrapper launches
    and collectives' calls, bytes and host seconds (the two logits steps
    left out)."""
    import torch
    from repro_torch.core.parallelism import COMM_STATS
    from repro_torch.ops import ExecPolicy, use_policy
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.engine import engine_decode_step
    from repro_torch.sharding.logical import local_part, whole
    cfg = EngineConfig(capacity=capacity, max_seq=prompt_len + 16,
                       device=str(device), policy=ExecPolicy(quant=quant))
    prompts = lm_prompts(model.cfg.vocab, prompt_len)[:requests]
    eng = Engine(model, params, cfg, ctx)
    for p in prompts:
        eng.add_request(p, LM_MESH_NEW)
    grew = dict.fromkeys(counts(), 0)
    comm = {"calls": {}, "bytes": {}, "host_s": {}, "staged": {}}
    wall = 0.0

    def run(fn):
        nonlocal wall
        mesh_sync(device)
        before = counts()
        COMM_STATS.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        for k in grew:
            grew[k] += counts()[k] - before[k]
        for key, d in (("calls", COMM_STATS.calls), ("bytes", COMM_STATS.bytes),
                       ("host_s", COMM_STATS.seconds),
                       ("staged", COMM_STATS.staged)):
            for k, v in d.items():
                comm[key][k] = comm[key].get(k, 0) + v
        return out

    run(eng.step)
    from repro_torch.core.tree import tree_leaves
    state = eng.kv.device_state()
    leaves = [t for tree in state for t in tree_leaves(tree)]
    live = sorted(eng.scheduler.running())
    check(len(live) == min(requests, capacity),
          f"engine: {len(live)} live slots after its first step, expected "
          f"{min(requests, capacity)}")
    if ctx is not None:                 # the cache's dim 1: its slots
        loc, off = local_part(leaves[0])
        live = [i for i in live if off[1] <= i < off[1] + loc.shape[1]]
    saved = [local_part(t)[0].clone() for t in leaves]
    dec = engine_decode_step(model, cfg, ctx, sample=False)(
        eng.params, torch.as_tensor(eng._last_token, device=device),
        torch.as_tensor(eng.kv.positions(), device=device),
        *state)[0]
    dec = whole(dec).float().cpu()
    for t, v in zip(leaves, saved):     # a recurrent state moved: back
        local_part(t)[0].copy_(v)
    fin = run(eng.run)
    s = eng.stats
    full = next(p for p in lm_prompts(model.cfg.vocab, prompt_len)
                if len(p) == prompt_len)
    toks = torch.as_tensor(full[None], device=device)
    with use_policy(cfg.policy), torch.no_grad():
        pre, _ = model.prefill(eng.params, {"tokens": toks},
                               eng._prefill_cache(toks.shape[1]), ctx)
    out = {"tokens": {r.uid: list(r.generated) for r in fin},
           "prefill": whole(pre).float().cpu(), "decode": dec,
           "live_slots": live, "graphs": eng.graph_mode, "wall_s": wall,
           "steps": s.steps,
           "prefills": s.prefills,
           "decode_steps": s.decode_lane_steps // cfg.capacity,
           "step_wall_ms": 1e3 * wall / max(s.steps, 1),
           "launches": grew, "collectives": comm}
    del eng
    return out


def lm_mesh_model():
    """qwen1.5-0.5b at full width cut to LM_MESH_SERVE_LAYERS layers from
    seed 0, drawn on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import TransformerLM
    model = TransformerLM(dataclasses.replace(
        get_arch(LM_ARCH).model().cfg, n_layers=LM_MESH_SERVE_LAYERS))
    return model, model.init(0, device="cuda")


def lm_mesh_world1(device) -> tuple[dict, dict, dict]:
    """NCCL world 1 on cuda:0, meshes (1, 1) and (pod, data, model) =
    (1, 1, 1): the Engine in bf16 and under int8 through its step graphs,
    tokens and a prefill's and a decode step's logits bitwise to the
    engine without a mesh. Returns (the report, the mesh engines'
    launches (counted from 0 just before them), the engines without a
    mesh: what the gloo worlds are held to, by ``(quant, capacity)``:
    capacity 4 for the (data, model) worlds, LM_POD_CAPACITY for the
    multi-pod ones)."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.sharding.logical import ShardingCtx
    mesh = build_mesh("1x1", None, "cuda")
    try:
        check(dist.get_backend() == "nccl",
              f"lm world 1 resolved to {dist.get_backend()}, not nccl")
        rules = get_arch(LM_ARCH).rules()
        ctxs = {"1x1": ShardingCtx(mesh, rules),
                "1x1x1": ShardingCtx(build_mesh("1x1x1", None, "cuda"),
                                     rules)}
        model, params = lm_mesh_model()
        plain = {(q, c): lm_mesh_serve(model, params, None, q, device,
                                       capacity=c, requests=n)
                 for q in ("none", "int8")
                 for c, n in ((4, LM_MESH_REQUESTS),
                              (LM_POD_CAPACITY, LM_POD_CAPACITY))}
        mesh_sync(device)
        reset_counts()                  # the mesh engines alone from here
        placed = {(m, q): lm_mesh_serve(model, params, ctx, q, device)
                  for m, ctx in ctxs.items() for q in ("none", "int8")}
        mesh_sync(device)
        launches = counts()
        rows = []
        for (m, q), a in placed.items():
            b = plain[q, 4]
            label = f"lm world 1 {m} {q}"
            check(a["graphs"] == "on", f"{label}: graphs {a['graphs']}")
            check(a["tokens"] == b["tokens"],
                  f"{label}: tokens {a['tokens']} vs the engine without a "
                  f"mesh {b['tokens']}")
            for step in ("prefill", "decode"):
                check(bitwise(a[step], b[step]),
                      f"{label} {step} logits: max_abs "
                      f"{max_abs(a[step], b[step])} from the engine "
                      f"without a mesh")
            rows.append({"mesh": m, "quant": q, "graphs": "on",
                         "bitwise": True, "requests": len(a["tokens"]),
                         "step_wall_ms": a["step_wall_ms"],
                         "plain_step_wall_ms": b["step_wall_ms"],
                         "launches": a["launches"]})
        del params
    finally:
        dist.destroy_process_group()
    return {"meshes": list(ctxs), "backend": "nccl", "engines": rows}, \
        launches, plain


def lm_mesh_record_shapes():
    """Record each qmatmul launch's (mode, M, K, N) (``qmatmul.ops.
    record_shapes``); returns (the set, a function that ends the
    recording)."""
    from repro_torch.kernels.qmatmul.ops import record_shapes
    stack = contextlib.ExitStack()
    return stack.enter_context(record_shapes()), stack.close


def lm_mesh_shard_checks(shapes, device) -> list[list]:
    """Each recorded shard launch shape, kernel against its plain version
    on fresh random codes, bitwise."""
    from repro_torch.kernels.qmatmul.ops import qmatmul, qmatmul_acc
    from repro_torch.kernels.qmatmul.ref import qmatmul_acc_ref, qmatmul_ref
    out = []
    for i, (mode, m, k, n) in enumerate(sorted(shapes)):
        xc, wc, xs, ws = qmatmul_inputs_on(device, 400 + i, m, k, n)
        if mode == "acc":
            got, want = qmatmul_acc(xc, wc), qmatmul_acc_ref(xc, wc)
        else:
            got, want = qmatmul(xc, wc, xs, ws), qmatmul_ref(xc, wc, xs, ws)
        check(bitwise(got, want), f"lm mesh shard qmatmul {mode} "
                                  f"{m}x{k}x{n}: kernel vs plain max_abs "
                                  f"{max_abs(got, want)}")
        out.append([mode, m, k, n])
    return out


def lm_mesh_train_model():
    """qwen1.5-0.5b at full width cut to LM_MESH_TRAIN_LAYERS layers, in
    fp32 (the reference's bars are fp32 bars)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import TransformerLM
    cfg = dataclasses.replace(get_arch(LM_ARCH).model().cfg,
                              n_layers=LM_MESH_TRAIN_LAYERS,
                              dtype=torch.float32)
    return TransformerLM(cfg)


def lm_mesh_train(model, ctx, device):
    """LM_MESH_TRAIN_STEPS AdamW steps (eps 1e-3, as the CPU parity tests
    take it) on the synthetic stream at B x S = LM_MESH_TRAIN_BATCH from
    seed-0 weights: (losses, params, opt state, the steps' wall)."""
    import torch
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           SyntheticTextIterator)
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.logical import distribute_tree
    from repro_torch.train.steps import make_train_step
    b, s = LM_MESH_TRAIN_BATCH
    data = SyntheticTextIterator(SyntheticTextConfig(
        vocab=model.cfg.vocab, seq_len=s, global_batch=b))
    params = distribute_tree(model.init(0, device=device), model.axes(),
                             ctx)
    opt = adamw_init(params)
    step = make_train_step(model, AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=LM_MESH_TRAIN_STEPS,
        eps=1e-3), ctx)
    losses, t0 = [], time.perf_counter()
    for _ in range(LM_MESH_TRAIN_STEPS):
        batch = {k: v.to(device) for k, v in data.next_batch().items()}
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    return losses, params, opt, time.perf_counter() - t0


def lm_mesh_train_hold(label, losses, params, ref) -> dict:
    """Losses at rtol 1e-5 and every param at rtol 2e-4 / atol 2e-5
    against the single-rank run (``tests/test_distributed.py``'s
    bars); returns the largest excess ratios."""
    import numpy as np
    from repro_torch.core.tree import tree_items
    from repro_torch.sharding.logical import whole
    want_l = np.asarray(ref["losses"])
    got_l = np.asarray(losses)
    lrel = float(np.abs(got_l - want_l).max() / np.abs(want_l).max())
    check(lrel <= 1e-5, f"{label}: losses {losses} vs single rank "
                        f"{ref['losses']} (rel {lrel})")
    worst = 0.0
    for path, p in tree_items(params):
        got = whole(p).detach().cpu().double()
        want = ref["params"]["/".join(path)].double()
        ratio = float(((got - want).abs()
                       / (2e-5 + 2e-4 * want.abs())).max())
        check(ratio <= 1.0, f"{label}: {'/'.join(path)} past rtol 2e-4 / "
                            f"atol 2e-5 (ratio {ratio})")
        worst = max(worst, ratio)
    return {"losses": losses, "loss_rel": lrel, "param_bar_ratio": worst}


def lm_mesh_launchers(shape, work) -> dict:
    """``launch/serve.py`` at full size (mesh 1x2), or ``launch/train.py``
    (mesh 2x2) at full width cut to LM_MESH_TRAIN_LAYERS layers, 8 x 128:
    a step and a checkpoint, then again on that checkpoint (restored onto
    the mesh's shardings) for one more step; inside this world over
    gloo. Each prints its mesh and ``graphs: off (gloo)``. Returns rank
    0's report lines."""
    import io
    import math
    import torch.distributed as dist
    buf = io.StringIO()
    runs = []
    with contextlib.redirect_stdout(buf):
        if shape == (1, 2):
            from repro_torch.launch import serve as launcher
            launcher.main(["--arch", LM_ARCH, "--capacity", "2",
                           "--requests", "2", "--prompt-len", "16",
                           "--decode-steps", "2", "--mesh", "1x2",
                           "--dist-backend", "gloo", "--device", "cuda"])
        else:
            from repro_torch.launch import train as launcher
            for steps in (1, 2):
                runs.append(launcher.main([
                    "--arch", LM_ARCH, "--layers", str(LM_MESH_TRAIN_LAYERS),
                    "--steps", str(steps), "--global-batch", "8",
                    "--seq", "128", "--mesh", "2x2",
                    "--dist-backend", "gloo", "--device", "cuda",
                    "--ckpt", str(work)]))
    lines = buf.getvalue().strip().splitlines()
    if runs:
        check([r["start"] for r in runs] == [0, 1]
              and [sorted(r["losses"]) for r in runs] == [[1], [2]]
              and all(math.isfinite(v) for r in runs
                      for v in r["losses"].values()),
              f"lm mesh 2x2 train launcher: runs {runs}, not step 1 "
              f"then 2 resumed from the step-1 checkpoint")
    if dist.get_rank() == 0:
        want = "mesh={'data': 1, 'model': 2}" if shape == (1, 2) \
            else "mesh={'data': 2, 'model': 2}"
        check(sum(want in ln and "graphs: off (gloo)" in ln
                  for ln in lines) == max(len(runs), 1),
              f"lm mesh {shape} launcher: no {want!r} with graphs off "
              f"(gloo) in {lines}")
        if runs:
            check(any("auto-resumed from step 1" in ln for ln in lines),
                  f"lm mesh 2x2 train launcher: no resume in {lines}")
    return {"argv_mesh": "x".join(map(str, shape)), "lines": lines[:12],
            "losses": [r["losses"] for r in runs]}


def lm_mesh_serve_held(ctx, shape, rank, want, device,
                       capacity: int = 4, requests: int = LM_MESH_REQUESTS
                       ) -> tuple[dict, dict, list]:
    """The LM_MESH_SERVE_LAYERS-layer model's Engine on ``ctx``'s gloo
    mesh in bf16 and under int8 (``lm_mesh_serve`` at ``capacity`` over
    ``requests`` prompts) against ``want`` (the unsharded engines', by
    quant): this rank's part of the cache holds live slots; int8 tokens
    and logits bitwise, qmatmul launched 3 a layer a step; bf16 logits
    within TOL_BF16 of 1 + max|want|. Returns (the runs'
    reports, their launches, every qmatmul shard launch shape checked
    kernel vs plain)."""
    import torch
    model, params = lm_mesh_model()
    runs = {}
    seen, undo = lm_mesh_record_shapes()
    try:
        for q in ("none", "int8"):
            r = lm_mesh_serve(model, params, ctx, q, device,
                              capacity=capacity, requests=requests)
            w = want[q]
            label = f"lm mesh {shape} rank {rank} {q}"
            check(r["live_slots"], f"{label}: no live slot in this rank's "
                                   f"part of the cache")
            check(r["graphs"] == "off (gloo)", f"{label}: graphs "
                                               f"{r['graphs']}")
            errs = {st: max_abs(r[st], w[st])
                    for st in ("prefill", "decode")}
            if q == "int8":
                check(r["tokens"] == w["tokens"],
                      f"{label}: tokens {r['tokens']} vs unsharded "
                      f"{w['tokens']}")
                for st, err in errs.items():
                    check(err == 0.0, f"{label} {st} logits: max_abs {err} "
                                      f"from the unsharded int8 engine")
                per_step = 3 * model.cfg.n_layers
                steps = r["prefills"] + r["decode_steps"]
                check(r["launches"]["qmatmul"] == per_step * steps,
                      f"{label}: qmatmul launched "
                      f"{r['launches']['qmatmul']} times, expected "
                      f"{per_step} x {steps} steps")
            else:
                for st, err in errs.items():
                    bar = TOL_BF16 * (1 + float(w[st].abs().max()))
                    check(err <= bar, f"{label} {st} logits: max_abs {err} "
                                      f"> {bar}")
            del r["prefill"], r["decode"]
            r["max_abs"] = errs
            r["tokens_equal"] = r.pop("tokens") == w["tokens"]
            runs[q] = r
    finally:
        undo()
    torch.cuda.synchronize()
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in counts()}
    del params
    check(bool(seen), f"lm mesh {shape} rank {rank}: no qmatmul launch "
                      f"shape recorded")
    return runs, launches, lm_mesh_shard_checks(seen, device)


def pod_meshes(shape, device_type: str):
    """This rank's pod's (data, model) mesh of a (pod, data, model) world
    of ``shape``: every pod's is built on every rank, in pod order (each
    rank keeps its own)."""
    import torch
    from repro_torch.sharding.groups import mesh_groups
    ranks = torch.arange(shape[0] * shape[1] * shape[2]).reshape(shape)
    meshes = [mesh_groups(shape[1:], POD_AXES[1:], device_type,
                          ranks=ranks[p]) for p in range(shape[0])]
    return next(m for m in meshes if m is not None)


def lm_pod_cross_step(model, mesh, sub, device):
    """One fp32 train step of ``model`` (seed 0) with the cross-pod
    compression on the (pod, data, model) ``mesh``: this pod's loss and
    gradients on its rows of the stream's first batch over its (data,
    model) mesh ``sub``, ``cross_pod_grad_reduce`` (bf16) over ``pod``,
    AdamW as ``lm_mesh_train``'s. Returns ([the pods' mean loss], the new
    params)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.core.tree import tree_map
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.sharding.logical import ShardingCtx, distribute_tree
    from repro_torch.train.compression import (cross_pod_grad_reduce,
                                               init_ef_state)
    from repro_torch.train.steps import loss_and_grads
    n_pods = int(mesh.mesh.shape[0])
    pod = mesh.get_local_rank("pod")
    params = distribute_tree(model.init(0, device=device), model.axes(),
                             ShardingCtx(mesh))

    def on_sub(t):
        check(t.placements[0].is_replicate(), "a parameter split over pod")
        return DTensor.from_local(t.to_local(), sub, t.placements[1:],
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    batch = lm_pod_batch(model, device)
    half = batch["tokens"].shape[0] // n_pods
    rows = {k: v[pod * half:(pod + 1) * half] for k, v in batch.items()}
    loss, _, grads = loss_and_grads(model, tree_map(on_sub, params), rows,
                                    ShardingCtx(sub))
    g = tree_map(lambda t, like: DTensor.from_local(
        t.to_local(), mesh, like.placements, run_check=False,
        shape=like.shape, stride=like.stride()), grads, params)
    g, _ = cross_pod_grad_reduce(g, init_ef_state(g), mesh=mesh,
                                 mode="bf16")
    total = loss.clone()
    dist.all_reduce(total, group=mesh.get_group("pod"))
    cfg = lm_pod_adam()
    new, _, _ = adamw_update(g, adamw_init(params, cfg), params, cfg)
    torch.cuda.synchronize()
    return [float(total / n_pods)], new


def lm_pod_batch(model, device) -> dict:
    """The synthetic stream's first batch at LM_MESH_TRAIN_BATCH."""
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           SyntheticTextIterator)
    b, s = LM_MESH_TRAIN_BATCH
    data = SyntheticTextIterator(SyntheticTextConfig(
        vocab=model.cfg.vocab, seq_len=s, global_batch=b))
    return {k: v.to(device) for k, v in data.next_batch().items()}


def lm_pod_adam():
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=1e-3, warmup_steps=1,
                       total_steps=LM_MESH_TRAIN_STEPS, eps=1e-3)


def lm_pod_cross_reference(device) -> dict:
    """``lm_pod_cross_step`` on one rank: each pod's half of the batch
    and its gradients, their bf16 sum (in bf16, as the pod all-reduce
    sums) halved, AdamW: {"losses": [mean loss], "params": by path, on
    the CPU}."""
    import torch
    from repro_torch.core.tree import tree_items, tree_map
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.train.steps import loss_and_grads
    model = lm_mesh_train_model()
    params = model.init(0, device=device)
    batch = lm_pod_batch(model, device)
    half = batch["tokens"].shape[0] // 2
    parts = [loss_and_grads(model, params,
                            {k: v[p * half:(p + 1) * half]
                             for k, v in batch.items()}, None)
             for p in range(2)]
    two = torch.full((), 2.0, device=device)
    g = tree_map(lambda a, b: (a.to(torch.bfloat16) + b.to(torch.bfloat16)
                               ).to(torch.float32) / two,
                 parts[0][2], parts[1][2])
    cfg = lm_pod_adam()
    new, _, _ = adamw_update(g, adamw_init(params, cfg), params, cfg)
    loss = float((parts[0][0] + parts[1][0]) / two)
    out = {"losses": [loss], "params": {"/".join(p): t.detach().cpu()
                                        for p, t in tree_items(new)}}
    del params, new, parts, g
    free_card()
    return out


def lm_pod_rank(rank, shape, ref_path) -> dict:
    """One rank of a multi-pod gloo world on cuda:0: the
    LM_MESH_SERVE_LAYERS-layer model served LM_POD_CAPACITY requests at
    capacity LM_POD_CAPACITY on the (pod, data, model) mesh, held as
    ``lm_mesh_serve_held`` holds it to the unsharded engines at that
    capacity, every rank's part of the cache holding live slots; the
    fp32 model trained
    LM_MESH_TRAIN_STEPS steps against the single-rank run; one step
    through ``cross_pod_grad_reduce`` against ``lm_pod_cross_reference``
    (losses rtol 1e-5, params rtol 2e-4 / atol 2e-5)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import ShardingCtx
    device = torch.device("cuda", 0)
    ref = torch.load(ref_path, weights_only=False)
    mesh = mesh_groups(shape, POD_AXES, "cuda")
    sub = pod_meshes(shape, "cuda")
    ctx = ShardingCtx(mesh, get_arch(LM_ARCH).rules())
    out, parts = {"rank": rank}, RankParts()
    out["serve"], launches, out["shard_checks"] = lm_mesh_serve_held(
        ctx, shape, rank, {q: ref["serve"][q, LM_POD_CAPACITY]
                           for q in ("none", "int8")}, device,
        capacity=LM_POD_CAPACITY, requests=LM_POD_CAPACITY)
    parts("serve")
    free_card()
    tmodel = lm_mesh_train_model()
    losses, tparams, _, wall = lm_mesh_train(tmodel, ctx, device)
    out["train"] = lm_mesh_train_hold(f"lm mesh {shape} rank {rank} train",
                                      losses, tparams, ref["train"])
    out["train"]["wall_s"] = wall
    del tparams
    free_card()
    parts("train")
    t0 = time.perf_counter()
    losses, cparams = lm_pod_cross_step(tmodel, mesh, sub, device)
    out["cross_pod"] = lm_mesh_train_hold(
        f"lm mesh {shape} rank {rank} cross-pod step", losses, cparams,
        ref["cross_pod"])
    out["cross_pod"]["wall_s"] = time.perf_counter() - t0
    parts("cross_pod")
    out["launches"], out["parts_s"] = launches, parts.seconds
    return out


class RankParts:
    """A rank's seconds by part: each call files the time since the rank
    started or the last call under its name."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, part: str) -> None:
        now = time.perf_counter()
        self.seconds[part] = now - self._t
        self._t = now


def lm_mesh_rank(rank, world, shape, ref_path, work) -> dict:
    """One rank of a gloo world whose ranks share cuda:0, on a
    host-staged DTensor mesh of ``shape`` (a three-axis shape is a
    multi-pod world: ``lm_pod_rank``): qwen1.5-0.5b at full width
    cut to LM_MESH_SERVE_LAYERS layers served in bf16 and under int8
    (``lm_mesh_serve_held``); the launchers; then the
    LM_MESH_TRAIN_LAYERS-layer fp32 model trained LM_MESH_TRAIN_STEPS
    steps against the
    single-rank run, and on 2x2 a checkpoint restored onto (1, 2)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_items
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import (ShardingCtx,
                                              param_shardings, whole)
    import os
    # the world's ranks share the host's cores: one pool of CPU threads a
    # rank, not the whole host's each
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    if len(shape) == 3:
        return lm_pod_rank(rank, shape, ref_path)
    device = torch.device("cuda", 0)
    ref = torch.load(ref_path, weights_only=False)
    mesh = mesh_groups(shape, ("data", "model"), "cuda")
    ctx = ShardingCtx(mesh, get_arch(LM_ARCH).rules())
    out, parts = {"rank": rank}, RankParts()
    out["serve"], launches, out["shard_checks"] = lm_mesh_serve_held(
        ctx, shape, rank, {q: ref["serve"][q, 4] for q in ("none", "int8")},
        device)
    parts("serve")
    out["launcher"] = lm_mesh_launchers(shape, Path(work) / "launch")
    parts("launcher")
    free_card()
    tmodel = lm_mesh_train_model()
    losses, tparams, _, wall = lm_mesh_train(tmodel, ctx, device)
    out["train"] = lm_mesh_train_hold(f"lm mesh {shape} rank {rank} train",
                                      losses, tparams, ref["train"])
    out["train"]["wall_s"] = wall
    parts("train")
    if shape == (2, 2):
        # the params alone: the optimizer state's elastic restore is held
        # on the CPU (tests/test_torch_lm_mesh.py)
        ckpt = Path(work) / "ckpt22"
        CheckpointManager(ckpt).save(LM_MESH_TRAIN_STEPS, params=tparams)
        saved = [whole(t) for _, t in tree_items(tparams)]  # every rank
        sub = mesh_groups((1, 2), ("data", "model"), "cuda")
        if sub is not None:          # ranks 0 and 1 restore onto (1, 2)
            meta = tmodel.init(torch.Generator(), device="meta")
            psh = param_shardings(meta, tmodel.axes(), sub, ctx.rules)
            _, rp, _, _ = CheckpointManager(ckpt).restore(
                params_template=meta, device="cuda", params_shardings=psh)
            for (path, a), b in zip(tree_items(rp), saved):
                check(bitwise(whole(a), b),
                      f"lm mesh 2x2 -> 1x2 restore: {'/'.join(path)} "
                      f"differs")
            out["restore"] = {"from": [2, 2], "onto": [1, 2],
                              "leaves": len(tree_items(rp)),
                              "bitwise": True}
        dist.barrier()
        parts("restore")
    out["launches"], out["parts_s"] = launches, parts.seconds
    return out


def lm_mesh_reference(device, plain, path) -> dict:
    """What the gloo worlds are held to, saved to ``path``: the unsharded
    engines' tokens and logits (world 1's engines without a mesh) and
    the LM_MESH_TRAIN_LAYERS-layer model's single-rank training (losses,
    params on the
    CPU)."""
    import torch
    from repro_torch.core.tree import tree_items
    model = lm_mesh_train_model()
    losses, params, _, wall = lm_mesh_train(model, None, device)
    ref = {"serve": {key: {k: plain[key][k] for k in ("tokens", "prefill",
                                                       "decode")}
                     for key in plain},
           "train": {"losses": losses,
                     "params": {"/".join(p): t.detach().cpu()
                                for p, t in tree_items(params)}}}
    del params
    free_card()
    ref["cross_pod"] = lm_pod_cross_reference(device)
    torch.save(ref, path)
    return {"losses": losses, "wall_s": wall,
            "cross_pod_loss": ref["cross_pod"]["losses"]}


def phase_lm_mesh(device) -> dict:
    """qwen1.5-0.5b over a (data, model) and a (pod, data, model) mesh on
    the one card: NCCL world 1 (meshes (1, 1) and (1, 1, 1), graphs on,
    bitwise to the engine without a mesh), the single-rank training and
    cross-pod runs, then gloo worlds of 2 and 4 ranks sharing cuda:0
    (meshes (1, 2), (2, 2), (2, 1, 2) and (2, 2, 1), run at once:
    ``spmd_worlds``, every collective host-staged) serving and training
    against them. Returns the launches of the mesh path: the world-1
    mesh engines' and every rank's serving runs (each counted from 0)."""
    import tempfile
    free_card()
    world1, total, plain = lm_mesh_world1(device)
    lap("lm_mesh NCCL world 1")
    worlds = []
    with tempfile.TemporaryDirectory(prefix="lm_mesh_",
                                     dir=ROOT / "build") as work:
        ref_path = str(Path(work) / "ref.pt")
        single = lm_mesh_reference(device, plain, ref_path)
        lap("lm_mesh single-rank training")
        del plain
        free_card()
        for shape, world, ranks, seconds in spmd_worlds(
                lm_mesh_rank, {**LM_MESH_WORLDS, **LM_POD_WORLDS},
                ref_path, work, timeout=LM_MESH_TIMEOUT_S):
            for r in ranks:
                check(r["launches"]["qmatmul"],
                      f"lm mesh {shape} rank {r['rank']}: qmatmul never "
                      f"launched")
                total = {k: total[k] + r["launches"][k] for k in total}
            worlds.append({
                "mesh": list(shape), "world": world, "backend": "gloo",
                "axes": list(POD_AXES[-len(shape):]), "seconds": seconds,
                "serve": [r["serve"] for r in ranks],
                "shard_shapes": ranks[0]["shard_checks"],
                "launcher": ranks[0].get("launcher"),
                "train": [r["train"] for r in ranks],
                "cross_pod": [r["cross_pod"] for r in ranks]
                if len(shape) == 3 else None,
                "restore": ranks[0].get("restore"),
                "launches": [r["launches"] for r in ranks],
                "parts_s": [r["parts_s"] for r in ranks],
                "note": "every rank time-shares one card with the other "
                        "worlds' ranks: these walls say nothing about "
                        "scaling"})
        lap(f"lm_mesh gloo worlds {list(LM_MESH_WORLDS)} and "
            f"{list(LM_POD_WORLDS)}, at once")
    emit({"phase": "lm_mesh", "arch": LM_ARCH, "world1": world1,
          "single_rank_train": single,
          "train_model": f"{LM_ARCH} at full width, "
                         f"{LM_MESH_TRAIN_LAYERS} of 24 layers, fp32",
          "worlds": worlds})
    return total


# ------------------------------------------------------------ family_mesh

def family_model(arch: str, layers: int | None):
    """``arch`` at full width, cut to ``layers`` layers (None: full)."""
    from repro_torch.configs import get_arch
    model = get_arch(arch).model()
    if layers is None:
        return model
    return type(model)(dataclasses.replace(model.cfg, n_layers=layers))


def family_inputs(model, arch: str, device) -> dict:
    """FAMILY_BATCH prompts (numpy seed 2) of the arch's prompt length
    (whole scan chunks), and seamless's stub encoder frames."""
    import numpy as np
    import torch
    rng = np.random.RandomState(2)
    s = FAMILY_PROMPT.get(arch, 64)
    batch = {"tokens": torch.as_tensor(rng.randint(
        0, model.cfg.vocab, size=(FAMILY_BATCH, s)), device=device)}
    if arch == "seamless-m4t-medium":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (FAMILY_BATCH, FAMILY_FRAMES, model.cfg.d_model)).astype(
                np.float32), device=device)
    return batch


def family_loop(model, params, ctx, arch: str, quant: str, device,
                feed=None, trace: bool = False, routes=None,
                steps: int = FAMILY_STEPS) -> dict:
    """A prefill of ``family_inputs`` and ``steps`` greedy decode steps
    (eager, on DTensors where ``ctx`` has a mesh): each step's logits
    whole on the CPU, the tokens (each step's argmax), the wall. With
    ``feed`` (another run's tokens) each decode step takes that run's
    token, so that every step's logits answer the same input even where
    an argmax flips. With ``trace`` each step's expert-parallel dispatches
    are recorded (``moe.routing_trace``: ``routes``, one list a step);
    with ``routes`` (one list a step of (T, k) expert choices in dispatch
    order) each step replays them, and records its own beside."""
    import torch
    from repro_torch.models.moe import routing_trace
    from repro_torch.ops import ExecPolicy, use_policy
    from repro_torch.sharding.logical import distribute_tree, whole
    batch = family_inputs(model, arch, device)
    s = batch["tokens"].shape[1]
    cache = model.init_cache(FAMILY_BATCH, s + steps,
                             FAMILY_FRAMES, device=device) \
        if "frames" in batch else \
        model.init_cache(FAMILY_BATCH, s + steps, device=device)
    if ctx is not None:
        cache = distribute_tree(cache, model.cache_axes(), ctx)
    logits, tokens, logs = [], [], []

    def traced(i, fn):
        if not trace and routes is None:
            return fn()
        with routing_trace(None if routes is None else routes[i]) as log:
            out = fn()
        logs.append(log)
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_policy(ExecPolicy(quant=quant)), torch.no_grad():
        out, cache = traced(0, lambda: model.prefill(params, batch, cache,
                                                     ctx))
        for i in range(steps + 1):
            out = whole(out).float()
            logits.append(out.cpu())
            nxt = out.argmax(-1).to(torch.int32)
            tokens.append(nxt.cpu().tolist())
            if feed is not None:
                nxt = torch.as_tensor(feed[i], dtype=torch.int32,
                                      device=device)
            if i < steps:
                out, cache = traced(i + 1, lambda: model.decode_step(
                    params, nxt, s + i, cache, ctx))
    torch.cuda.synchronize()
    return {"logits": logits, "tokens": tokens,
            "wall_s": time.perf_counter() - t0,
            "routes": logs if logs else None}


def family_ep_reference(model, shape):
    """``model`` whose MoE layers run, on one device, the expert-parallel
    arithmetic of a mesh of ``shape`` (``moe_apply_ep_ref``: the data
    shards and model ranks walked in order, the partials summed in rank
    order in the model dtype)."""
    from repro_torch.models.moe import moe_apply_ep_ref
    nd, nm = shape

    class EPReference(type(model)):
        def moe_layer(self, p, x, ctx):
            return moe_apply_ep_ref(p, x, self.cfg.moe, nd, nm)

    return EPReference(model.cfg)


def family_key(arch: str, layers, shape) -> str:
    return f"{arch}|{layers}|{shape[0]}x{shape[1]}"


def family_draw(jobs, device) -> tuple[dict, dict, dict]:
    """Each of a world's jobs' seed-0 weights, drawn on the card once in
    this process and cast as the engine casts them (the world's ranks
    lay them out from this memory, shared with them through CUDA IPC:
    no rank draws a whole model of its own), and the one-device loops
    the sub-quadratic and encoder-decoder jobs are held to (the MoE jobs
    are held after their world ran: ``family_moe_hold``). Returns
    (params, references, their walls), each by job key."""
    from repro_torch.serve.weights import cast_serving_params
    params, refs, walls = {}, {}, {}
    for arch, layers, shape in jobs:
        key = family_key(arch, layers, shape)
        model = family_model(arch, layers)
        params[key] = cast_serving_params(
            model, model.init(0, device=device), device, donate=True)
        free_card()
        if arch not in MOE_ARCHS:
            quant = "int8" if arch == "zamba2-7b" else "none"
            r = family_loop(model, params[key], None, arch, quant, device)
            refs[key] = {"logits": r["logits"], "tokens": r["tokens"]}
            walls[key] = r["wall_s"]
    return params, refs, walls


def family_count(arch: str, layers, shape) -> dict:
    """The collectives ``family_loop`` issues on rank 0 of a gloo world
    on a (data, model) mesh of ``shape`` (a prefill of ``family_inputs``'
    shapes, each step's logits gathered whole, FAMILY_STEPS decode steps
    fed tokens; the weights cast as ``family_draw`` casts them), counted
    on the meta device over a fake process group by the mesh dry run's
    counter (``launch/dryrun.py``, ``launch/op_stats.py``): calls and
    bytes by kind, as ``COMM_STATS`` files them."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import fake_world, lay_out
    from repro_torch.launch.op_stats import count
    from repro_torch.ops import ExecPolicy, use_policy
    from repro_torch.serve.weights import cast_serving_params
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import ShardingCtx, whole
    model = family_model(arch, layers)
    quant = "int8" if arch == "zamba2-7b" else "none"
    s = FAMILY_PROMPT.get(arch, 64)
    t0 = time.perf_counter()
    with fake_world(shape[0] * shape[1]):
        ctx = ShardingCtx(mesh_groups(shape, ("data", "model"), "cpu"),
                          get_arch(arch).rules())
        params = lay_out(cast_serving_params(
            model, model.init(torch.Generator(), device="meta"), "meta"),
            model.axes(), ctx)
        cache = lay_out(model.init_cache(FAMILY_BATCH, s + FAMILY_STEPS,
                                         device="meta"),
                        model.cache_axes(), ctx)
        batch = {"tokens": torch.empty((FAMILY_BATCH, s), dtype=torch.int64,
                                       device="meta")}
        nxt = torch.empty((FAMILY_BATCH,), dtype=torch.int32, device="meta")

        def loop():
            with use_policy(ExecPolicy(quant=quant)), torch.no_grad():
                out, c = model.prefill(params, batch, cache, ctx)
                for i in range(FAMILY_STEPS + 1):
                    whole(out)
                    if i < FAMILY_STEPS:
                        out, c = model.decode_step(params, nxt, s + i, c,
                                                   ctx)
        _, stats = count(loop)
    return {"calls": {k: int(v)
                      for k, v in stats.collective_count_by_op.items()},
            "bytes": {k: int(v)
                      for k, v in stats.collective_bytes_by_op.items()},
            "count_s": time.perf_counter() - t0}


def family_count_hold(job, ranks) -> dict:
    """``family_count`` of ``job`` (from a host worker, else counted here)
    against every rank's measured ``COMM_STATS`` in its world: the calls
    and bytes of each kind equal."""
    counted = HOST_JOBS.pop(("family_count",) + job, None)
    counted = counted.result() if counted is not None \
        else family_count(*job)
    key = family_key(*job)
    rows = [next(r for r in rank["jobs"] if family_key(
        r["arch"], r["layers"], tuple(r["mesh"])) == key) for rank in ranks]
    for rank, row in zip(ranks, rows):
        got = row["collectives"]
        check(got["calls"] == counted["calls"]
              and got["bytes"] == counted["bytes"],
              f"family mesh {key}: counted collectives {counted} vs rank "
              f"{rank['rank']}'s measured {got['calls']} {got['bytes']}")
    print(f"chip_smoke:   family mesh {key}: collectives counted on meta "
          f"{counted['calls']} {counted['bytes']} = each of the "
          f"{len(ranks)} ranks' measured", file=sys.stderr, flush=True)
    return {"job": key, "counted": counted,
            "measured": [{"calls": r["collectives"]["calls"],
                          "bytes": r["collectives"]["bytes"]}
                         for r in rows], "equal": True}


def family_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    import math
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 2.0 ** -133


def family_moe_hold(job, ranks, params, device) -> dict:
    """An MoE job of a gloo world (``ranks``: its ranks' free greedy runs,
    each with its own dispatches' routing) held against the one-device
    expert-parallel arithmetic at the job's mesh shape, run after it with
    the mesh's tokens fed and the mesh's routing replayed
    (``family_ep_reference``, ``moe.routing_trace``) on ``params``, the
    weights the world's ranks laid out: every rank's logits
    equal, and within TOL_BF16 of 1 + max|logit| of the reference's at
    every step, every row; every dispatch's keep mask equal to the
    reference's; a token apart only where the reference's logits of the
    two tokens lie within that bar; where the reference's own routing
    picks other experts than the mesh's (bf16 noise at a near-tie), each
    expert the mesh took instead within FAMILY_ROUTER_GAP of the
    reference's k-th router logit. Returns the readings."""
    import torch
    arch, layers, shape = job
    key = family_key(arch, layers, shape)
    label = f"family mesh {key}"
    got = [r["moe"][key] for r in ranks]
    nm = shape[1]
    nd = shape[0] if FAMILY_BATCH % shape[0] == 0 else 1
    steps = len(got[0]["logits"])
    model = family_model(arch, layers)
    k = model.cfg.moe.top_k
    calls = model.cfg.n_layers
    for rank, g in enumerate(got):
        check(len(g["routes"]) == steps and
              all(len(log) == calls for log in g["routes"]),
              f"{label} rank {rank}: dispatches a step "
              f"{[len(log) for log in g['routes']]}, expected {calls}")
        check(all(torch.equal(a, b) for a, b in zip(g["logits"],
                                                     got[0]["logits"])),
              f"{label}: rank {rank}'s logits differ from rank 0's")
    # the reference's dispatch order: layer call, data shard, model rank
    replay = [[got[(i if nd > 1 else 0) * nm]["routes"][st][c]["top_e"]
               for c in range(calls) for i in range(nd) for _ in range(nm)]
              for st in range(steps)]
    want = family_loop(family_ep_reference(model, shape), params, None,
                       arch, "none", device, feed=got[0]["tokens"],
                       routes=replay, steps=steps - 1)
    errs, bars, apart, flips, max_gap = [], [], [], [], 0.0
    for st in range(steps):
        a, b = got[0]["logits"][st], want["logits"][st]
        check(a.shape == b.shape == (FAMILY_BATCH, model.cfg.vocab)
              and bool(torch.isfinite(a).all()),
              f"{label} step {st}: logits {tuple(a.shape)} or not finite")
        bar = TOL_BF16 * (1 + float(b.abs().max()))
        errs.append(max_abs(a, b))
        bars.append(bar)
        check(errs[-1] <= bar, f"{label} step {st}: logits max_abs "
                               f"{errs[-1]} > {bar}, the routing replayed")
        mine = torch.as_tensor(got[0]["tokens"][st])
        ref = b.argmax(-1)
        off = (mine != ref).nonzero().flatten().tolist()
        apart.append(off)
        for row in off:
            gap = float(b[row, ref[row]] - b[row, mine[row]])
            check(gap <= bar, f"{label} step {st} row {row}: token "
                              f"{int(mine[row])} vs the reference's "
                              f"{int(ref[row])}, {gap} apart (bar {bar})")
        n = 0
        for c in range(calls):
            for i in range(nd):
                for j in range(nm):
                    w = want["routes"][st][(c * nd + i) * nm + j]
                    g = got[(i if nd > 1 else 0) * nm + j]["routes"][st][c]
                    check(torch.equal(g["top_e"],
                                      replay[st][(c * nd + i) * nm]),
                          f"{label} step {st} call {c}: model rank {j} "
                          f"routed otherwise than rank 0 of its shard")
                    check(torch.equal(g["keep"], w["keep"]),
                          f"{label} step {st} call {c} shard {i} rank {j}: "
                          f"keep mask differs from the reference's")
                    if j:
                        continue
                    lp = torch.log(w["probs"])
                    vals, own = torch.sort(lp, dim=-1, descending=True,
                                           stable=True)
                    kth = vals[:, k - 1]
                    for t in range(own.shape[0]):
                        extra = set(g["top_e"][t].tolist()) - \
                            set(own[t, :k].tolist())
                        for e in extra:
                            gap = float(kth[t] - lp[t, e])
                            max_gap = max(max_gap, gap)
                            n += 1
                            check(gap <= FAMILY_ROUTER_GAP,
                                  f"{label} step {st} call {c} token {t}: "
                                  f"the mesh took expert {e}, "
                                  f"{gap} below the reference's k-th "
                                  f"router logit (bar {FAMILY_ROUTER_GAP})")
        flips.append(n)
    drops = []
    for rank, g in enumerate(got):
        j = rank % nm
        owned = sum(int((r["top_e"] // r["e_l"] == j).sum())
                    for log in g["routes"] for r in log)
        kept = sum(int(r["keep"].sum()) for log in g["routes"] for r in log)
        drops.append([owned, owned - kept])
    row = {"arch": arch, "layers": layers, "mesh": list(shape),
           "max_abs": errs, "bar": bars, "tokens_apart": apart,
           "assignments_flipped": flips,
           "max_flip_gap": max_gap, "router_gap_bar": FAMILY_ROUTER_GAP,
           "owned_dropped_a_rank": drops,
           "reference_wall_s": want["wall_s"]}
    print(f"chip_smoke:   {label}: max_abs {errs} (bars {bars}) tokens "
          f"apart {apart} flipped {flips} (max gap {max_gap}) owned/dropped "
          f"{drops}", file=sys.stderr, flush=True)
    return row


def family_rank(rank, world, jobs, ref_path, shared) -> dict:
    """One rank of a gloo world whose ranks share cuda:0: each job's
    model on a host-staged DTensor mesh, its weights laid out from
    ``shared`` (the parent's, by job key, through CUDA IPC; each dropped
    once laid out, so that the parent's memory is released). The MoE archs run greedily on
    their own tokens, each dispatch's routing recorded: their logits,
    tokens and routing go back to be held after the world
    (``family_moe_hold``). The others are fed the one-device reference's
    tokens and held here: zamba2-7b under int8 with the prefill's logits
    bitwise, each decode step's within FAMILY_DECODE_ULPS bf16 ulps of
    max|logit|, the tokens equal and qmatmul launched 3 a shared-block
    call a step on this rank; the rest within TOL_BF16 of 1 + max|logit|.
    Beside each: the collectives' calls, bytes and host seconds; then
    every qmatmul shard launch shape kernel vs plain."""
    import os
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.parallelism import COMM_STATS
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import ShardingCtx, distribute_tree
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    device = torch.device("cuda", 0)
    refs = torch.load(ref_path, weights_only=False)
    meshes = {}
    for _, _, shape in jobs:
        if shape not in meshes:
            meshes[shape] = mesh_groups(shape, ("data", "model"), "cuda")
    seen, undo = lm_mesh_record_shapes()
    rows, moe_runs = [], {}
    launches = dict.fromkeys(counts(), 0)
    try:
        for arch, layers, shape in jobs:
            model = family_model(arch, layers)
            ctx = ShardingCtx(meshes[shape], get_arch(arch).rules())
            key = family_key(arch, layers, shape)
            params = distribute_tree(shared.pop(key), model.axes(), ctx)
            quant = "int8" if arch == "zamba2-7b" else "none"
            COMM_STATS.reset()
            label = f"family mesh {key} rank {rank}"
            moe = arch in MOE_ARCHS
            want = None if moe else refs[key]
            steps = FAMILY_STEPS if shape[0] == 1 else FAMILY_STEPS_DATA
            reset_counts()
            r = family_loop(model, params, ctx, arch, quant, device,
                            feed=None if moe else want["tokens"], trace=moe,
                            steps=steps)
            grew = counts()
            launches = {k: launches[k] + grew[k] for k in launches}
            row = {"arch": arch, "layers": layers, "mesh": list(shape),
                   "quant": quant, "wall_s": r["wall_s"],
                   "steps": 1 + steps, "launches": grew,
                   "collectives": {"calls": dict(COMM_STATS.calls),
                                   "bytes": dict(COMM_STATS.bytes),
                                   "host_s": dict(COMM_STATS.seconds)}}
            if moe:
                moe_runs[key] = {n: r[n] for n in ("logits", "tokens",
                                                   "routes")}
            else:
                errs = [max_abs(a, b) for a, b in zip(r["logits"],
                                                      want["logits"])]
                peaks = [float(b.abs().max()) for b in want["logits"]]
                if quant == "int8":
                    # the prefill bitwise; a decode step's bf16 attention
                    # projections at M = 4 on half the heads take another
                    # cuBLAS kernel than the whole product (split K), a
                    # rounding apart (scripts/colpar_bitwise.py)
                    bars = [0.0] + [FAMILY_DECODE_ULPS * family_ulp(m)
                                    for m in peaks[1:]]
                    per = 3 * model.cfg.n_groups * (1 + steps)
                    check(grew["qmatmul"] == per,
                          f"{label}: qmatmul launched {grew['qmatmul']} "
                          f"times, expected {per}")
                else:
                    bars = [TOL_BF16 * (1 + m) for m in peaks]
                row.update(max_abs=errs, bar=bars,
                           bitwise=all(e == 0.0 for e in errs),
                           tokens_equal=r["tokens"] == want["tokens"])
                check(all(e <= b for e, b in zip(errs, bars)),
                      f"{label}: logits max_abs {errs} past {bars}")
                check(quant != "int8" or row["tokens_equal"],
                      f"{label}: tokens {r['tokens']} vs {want['tokens']}")
                print(f"chip_smoke:   {label}: max_abs {errs} (bars {bars}) "
                      f"tokens_equal {row['tokens_equal']} wall "
                      f"{r['wall_s']:.2f} s", file=sys.stderr, flush=True)
            rows.append(row)
            del params
            free_card()
    finally:
        undo()
        shared.clear()
    return {"rank": rank, "jobs": rows, "launches": launches,
            "moe": moe_runs,
            "shard_checks": lm_mesh_shard_checks(seen, device)}


def family_world1(device) -> tuple[list[dict], dict]:
    """NCCL world 1 on cuda:0, mesh (1, 1): each FAMILY_WORLD1 model's
    Engine through its step graphs against the engine without a mesh:
    tokens equal, a prefill's and a 4-slot decode step's logits bitwise
    (the MoE archs' too, whose layer on a mesh with a ``model`` axis is
    the expert-parallel one: with a dispatch group a row it drops what
    the local path drops). Returns (the rows, the mesh engines'
    launches)."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.serve.weights import cast_serving_params
    from repro_torch.sharding.logical import ShardingCtx
    mesh = build_mesh("1x1", None, "cuda")
    rows, launches = [], dict.fromkeys(counts(), 0)
    try:
        check(dist.get_backend() == "nccl",
              f"family world 1 resolved to {dist.get_backend()}, not nccl")
        for arch, (layers, quant, plen) in FAMILY_WORLD1.items():
            free_card()
            model = family_model(arch, layers)
            ctx = ShardingCtx(mesh, get_arch(arch).rules())
            params = cast_serving_params(model, model.init(0, device=device),
                                         device, donate=True)
            plain = lm_mesh_serve(model, params, None, quant, device, plen)
            placed = lm_mesh_serve(model, params, ctx, quant, device, plen)
            launches = {k: launches[k] + placed["launches"][k]
                        for k in launches}
            label = f"family world 1 {arch}"
            check(placed["graphs"] == "on", f"{label}: graphs "
                                            f"{placed['graphs']}")
            errs = {st: max_abs(placed[st], plain[st])
                    for st in ("prefill", "decode")}
            check(placed["tokens"] == plain["tokens"],
                  f"{label}: tokens {placed['tokens']} vs {plain['tokens']}")
            for st, err in errs.items():
                check(err == 0.0, f"{label} {st} logits: max_abs {err} "
                                  f"from the engine without a mesh")
            if quant == "int8":
                steps = placed["prefills"] + placed["decode_steps"]
                check(placed["launches"]["qmatmul"] > 0,
                      f"{label}: qmatmul never launched ({steps} steps)")
            print(f"chip_smoke:   {label}: max_abs {errs} tokens_equal "
                  f"{placed['tokens'] == plain['tokens']}", file=sys.stderr,
                  flush=True)
            rows.append({"arch": arch, "layers": layers, "quant": quant,
                         "graphs": placed["graphs"], "max_abs": errs,
                         "tokens_equal": placed["tokens"] == plain["tokens"],
                         "step_wall_ms": placed["step_wall_ms"],
                         "plain_step_wall_ms": plain["step_wall_ms"],
                         "launches": placed["launches"]})
            del params
    finally:
        dist.destroy_process_group()
    free_card()
    return rows, launches


def phase_family_mesh(device) -> dict:
    """The MoE, hybrid, RWKV and encoder-decoder LMs over a (data, model)
    mesh on the one card: NCCL world 1 (``family_world1``), then for each
    gloo world of 2 and 4 ranks sharing cuda:0 its jobs' weights and
    one-device references (``family_draw``), the world (``family_rank``:
    meshes (1, 2), (1, 4) and (2, 2), every collective host-staged), its
    MoE jobs held (``family_moe_hold``). Returns the launches of the path: the world-1 mesh
    engines' and every rank's loops (each counted from 0)."""
    import tempfile
    import torch
    from repro_torch.launch.mesh import run_spmd
    free_card()
    world1, total = family_world1(device)
    lap("family_mesh NCCL world 1")
    worlds, ref_walls, held = [], {}, []
    with tempfile.TemporaryDirectory(prefix="family_mesh_",
                                     dir=ROOT / "build") as work:
        ref_path = str(Path(work) / "ref.pt")
        for world, jobs in FAMILY_GLOO.items():
            free_card()
            shared, refs, walls = family_draw(jobs, device)
            torch.save(refs, ref_path)
            ref_walls.update(walls)
            lap(f"family_mesh world {world}'s weights and references")
            free, total_b = torch.cuda.mem_get_info()
            print(f"chip_smoke:   family_mesh before world {world}: this "
                  f"process holds {torch.cuda.memory_reserved()} B, the "
                  f"card has {free} of {total_b} B free", file=sys.stderr,
                  flush=True)
            t0 = time.perf_counter()
            ranks = run_spmd(family_rank, world, "gloo", "cuda", jobs,
                             ref_path, shared, timeout=FAMILY_TIMEOUT_S)
            counted = [family_count_hold(job, ranks) for job in jobs
                       if job in FAMILY_COUNTED]
            held += [c["job"] for c in counted]
            for r in ranks:
                total = {k: total[k] + r["launches"][k] for k in total}
            check(all(r["launches"]["qmatmul"] for r in ranks)
                  or world != 2, "family mesh: qmatmul never launched on "
                                 "a rank of the 2-rank world")
            seconds = time.perf_counter() - t0
            lap(f"family_mesh gloo world {world}")
            moe = [family_moe_hold(job, ranks, shared[family_key(*job)],
                                   device)
                   for job in jobs if job[0] in MOE_ARCHS]
            del shared
            torch.cuda.ipc_collect()
            worlds.append({"world": world, "backend": "gloo",
                           "seconds": seconds, "moe": moe,
                           "counted_collectives": counted,
                           "jobs": [r["jobs"] for r in ranks],
                           "shard_shapes": ranks[0]["shard_checks"],
                           "launches": [r["launches"] for r in ranks],
                           "note": "every rank time-shares one card: these "
                                   "walls say nothing about scaling"})
            lap(f"family_mesh world {world}'s MoE jobs held")
    check(sorted(held) == sorted(family_key(*j) for j in FAMILY_COUNTED)
          and not [k for k in HOST_JOBS
                   if isinstance(k, tuple) and k[0] == "family_count"],
          f"family mesh: collectives counted for {held}, expected every "
          f"job of {FAMILY_COUNTED}, each in one gloo world")
    emit({"phase": "family_mesh", "world1": world1,
          "reference_walls_s": ref_walls, "worlds": worlds,
          "steps": 1 + FAMILY_STEPS, "steps_data_axis": 1 + FAMILY_STEPS_DATA,
          "batch": FAMILY_BATCH})
    return total


def device_ms(fn, reps: int = 100) -> tuple[float, bool]:
    """Median device time of ``reps`` calls of ``fn``, each between two
    CUDA events, all queued behind a spin kernel so the host's launch
    overhead never shows as device time. Returns (ms, queue_ran_dry)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    spin_done = torch.cuda.Event()
    torch.cuda._sleep(int(4e8))                     # ~0.2 s of spinning
    spin_done.record()
    for e0, e1 in pairs:
        e0.record()
        fn()
        e1.record()
    dry = spin_done.query()                         # spin ended too soon
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs), dry


def call_device_ms(fn, reps: int = 20,
                   spin: int = int(2e7)) -> tuple[float, bool]:
    """Median device time of one call of ``fn`` (many launches, such as a
    whole plan), between two CUDA events, each call queued alone behind
    a spin kernel of ``spin`` cycles (the default ~10 ms): the host's
    dispatch does not show, and the launch queue (about a thousand
    pending launches) never fills, as it would with ``device_ms``'s
    hundred calls queued at once. Returns (ms, the spin ended before the
    call was queued)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times, dry = [], False
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        spin_done = torch.cuda.Event()
        torch.cuda._sleep(spin)
        spin_done.record()
        e0.record()
        fn()
        e1.record()
        dry |= spin_done.query()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), dry


def conv_work(bsz, stage, pooled: bool, odd: str = "raise"
              ) -> tuple[float, float]:
    """(bytes, fp32 operations) one conv stage call must move and do:
    inputs read once, output written once (pooled under ``odd``)."""
    n, h, w, m, k = stage
    ho, wo = h - k + 1, w - k + 1
    pad = int(odd == "pad")
    out = (bsz * m * ((ho + pad) // 2) * ((wo + pad) // 2) if pooled
           else bsz * m * ho * wo)
    nbytes = 4 * (bsz * n * h * w + m * n * k * k + 2 * m + out)
    return nbytes, 2.0 * bsz * m * ho * wo * n * k * k


def conv_work_int8(bsz, stage, pooled: bool, odd: str = "raise",
                   vectors: int = 2) -> tuple[float, float]:
    """(bytes, int8 operations) of a conv stage call on the int8 route:
    the codes read once (1 byte each), ``vectors`` fp32 vectors of M
    (scale, bias) and the fp32 output written once."""
    n, h, w, m, k = stage
    ho, wo = h - k + 1, w - k + 1
    pad = int(odd == "pad")
    out = (bsz * m * ((ho + pad) // 2) * ((wo + pad) // 2) if pooled
           else bsz * m * ho * wo)
    nbytes = bsz * n * h * w + m * n * k * k + 4 * (vectors * m + out)
    return nbytes, 2.0 * bsz * m * ho * wo * n * k * k


def int8_time_row(gen, device, name, stage, bsz, shape, *, model,
                  odd="raise", bias=True) -> dict:
    """One int8-route row: ``name`` (fused_cwp or conv_window) on int8
    codes of ``shape``, held bitwise to its plain version first; beside it,
    as the library yardstick, cuDNN's fp32 conv (+ relu + pool) on the
    codes as fp32, TF32 off. The bound counts 1-byte codes and int8
    operations. The fp32 route at the same shape (the route every int8
    call took before the int8 route) is the fp32 row beside this one."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv_window.ops import conv_window
    from repro_torch.kernels.conv_window.ref import conv2d_window_ref
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    x, w, b, sc = conv_inputs(gen, bsz, shape, "int8", device, codes=True)
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    pooled = name == "fused_cwp"
    if pooled:
        def kern():
            return fused_cwp(x, w, b, scale=sc, odd=odd)

        def plain():
            return fused_cwp_ref(x, w, b, scale=sc, odd=odd)

        def lib():
            return F.max_pool2d(F.relu(F.conv2d(xf, wf, b)), 2,
                                ceil_mode=odd == "pad")
    else:
        b = b if bias else None

        def kern():
            return conv_window(x, w, b)

        def plain():
            return conv2d_window_ref(x, w, b)

        def lib():
            return F.conv2d(xf, wf, b)
    got, want = kern(), plain()
    check(bitwise(got, want), f"times {name} {stage} int8 B={bsz}: kernel "
                              f"vs plain max_abs {max_abs(got, want)}")
    del got, want
    nbytes, ops = conv_work_int8(bsz, shape, pooled, odd,
                                 (2 if pooled else 1) if bias else 0)
    row = _time_row(name, f"{stage} int8", bsz, kern, plain, lib, nbytes,
                    ops / PEAK_INT8, exact=True, model=model)
    row["route"] = "int8"
    row["library_note"] = ("cuDNN fp32 conv (+ relu + pool) on the codes "
                           "as fp32, TF32 off")
    return row


def phase_times(device):
    import torch
    import torch.nn.functional as F
    from repro_torch.core.addtree import pairwise_sum
    from repro_torch.kernels.addtree.ops import tree_reduce_sum
    from repro_torch.kernels.conv_window.ops import conv_window
    from repro_torch.kernels.conv_window.ref import conv2d_window_ref
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    from repro_torch.kernels.qmatmul.ops import qmatmul
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref

    gen = torch.Generator().manual_seed(4)
    floor_ms, floor_dry = device_ms(lambda: torch.cuda._sleep(0))
    # a kernel that loads and stores one cache line: 16 floats copied
    src16, dst16 = (torch.ones(16, device=device) for _ in range(2))
    rw_ms, rw_dry = device_ms(lambda: dst16.copy_(src16))
    rows = []
    for bsz in (8, 1024):
        for stage, shape in (("conv1", CONV1), ("conv2", CONV2)):
            x, w, b, _ = conv_inputs(gen, bsz, shape, "none", device)
            for name, kern, plain, lib, pooled in (
                    ("fused_cwp", lambda: fused_cwp(x, w, b),
                     lambda: fused_cwp_ref(x, w, b),
                     lambda: F.max_pool2d(F.relu(F.conv2d(x, w, b)), 2),  # lint: disable=stream-scale (1024 is a batch)
                     True),
                    ("conv_window", lambda: conv_window(x, w, b),
                     lambda: conv2d_window_ref(x, w, b),
                     lambda: F.conv2d(x, w, b), False)):
                nbytes, ops = conv_work(bsz, shape, pooled)
                rows.append(_time_row(name, stage, bsz, kern, plain, lib,
                                      nbytes, ops / PEAK_FP32,
                                      exact=False))
            # the int8 route, as the served int8 path calls it (the eager
            # conv_window without the bias: the epilogue runs outside)
            rows.append(int8_time_row(gen, device, "fused_cwp", stage, bsz,
                                      shape, model="mnist_cnn"))
            rows.append(int8_time_row(gen, device, "conv_window", stage,
                                      bsz, shape, model="mnist_cnn",
                                      bias=False))
        xc, wc, xs, ws = fc_inputs(gen, bsz, device)
        k, n = FC
        nbytes = bsz * k + k * n + 4 * (bsz + n + bsz * n)
        rows.append(_time_row(
            "qmatmul", "fc", bsz, lambda: qmatmul(xc, wc, xs, ws),
            lambda: qmatmul_ref(xc, wc, xs, ws), None, nbytes,
            2.0 * bsz * k * n / PEAK_INT8, exact=True))
        # the tree at each conv stage's product matrix: (B·Ho·Wo·M, η)
        for stage, (n, h, w_, m, k) in (("conv1", CONV1), ("conv2", CONV2)):
            r, eta = bsz * (h - k + 1) * (w_ - k + 1) * m, n * k * k
            x = torch.randn((r, eta), device=device,
                            generator=torch.Generator(device).manual_seed(6))
            rows.append(_time_row(
                "addtree", stage, bsz, lambda: tree_reduce_sum(x),
                lambda: pairwise_sum(x, -1), lambda: torch.sum(x, dim=-1),
                4 * r * (eta + 1), r * (eta - 1) / PEAK_FP32_ADD,
                exact=True))
            del x
    rows += highres_time_rows(gen, device)
    rows += odd_time_row(gen, device)
    rows += lm_time_rows(gen, device)
    emit({"phase": "times", "launch_floor_ms": floor_ms,
          "load_store_floor_ms": rw_ms,
          "floors_queue_ran_dry": [k for k, d in (("launch", floor_dry),
                                                  ("load_store", rw_dry))
                                   if d],
          "peaks": {"fp32_flops": PEAK_FP32,
                                      "fp32_adds": PEAK_FP32_ADD,
                                      "int8_ops": PEAK_INT8,
                                      "bytes_per_s": PEAK_BYTES},
          "library_null_reason": {
              "qmatmul": "torch._int_mm refuses N = 10 (it needs N a "
                         "multiple of 8 and M > 16), and M = 4 (an LM's "
                         "decode step at capacity 4), and no other single "
                         "PyTorch call is an int8 x int8 -> int32 GEMM"},
          "rows": rows})
    return rows


def highres_time_rows(gen, device) -> list[dict]:
    """At B = 8, every distinct conv launch shape of highres_cnn's 224x224
    plans (``highres_shapes``): fused_cwp at each band shape of the
    served plan's streamed blocks and at blocks 2 and 3, beside cuDNN's
    conv + relu + pool; conv_window at the streamed fuse=False plan's
    bands and the eager forward's blocks, beside cuDNN's conv; each with
    its int8-route row; then the int8 fc."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv_window.ops import conv_window
    from repro_torch.kernels.conv_window.ref import conv2d_window_ref
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    from repro_torch.kernels.qmatmul.ops import qmatmul
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref

    rows = []
    for kern, stage, shape in highres_shapes():
        x, w, b, _ = conv_inputs(gen, 8, shape, "none", device)
        pooled = kern == "fused_cwp"
        nbytes, ops = conv_work(8, shape, pooled)
        label = f"{stage} {shape[1]}x{shape[2]}"
        if pooled:
            fns = (lambda: fused_cwp(x, w, b), lambda: fused_cwp_ref(x, w, b),
                   lambda: F.max_pool2d(F.relu(F.conv2d(x, w, b)), 2))
        else:
            fns = (lambda: conv_window(x, w, b),
                   lambda: conv2d_window_ref(x, w, b),
                   lambda: F.conv2d(x, w, b))
        rows.append(_time_row(kern, label, 8, *fns, nbytes, ops / PEAK_FP32,
                              exact=False, model="highres_cnn"))
        # the int8 conv_window takes no bias (the epilogue runs outside)
        rows.append(int8_time_row(gen, device, kern, label, 8, shape,
                                  model="highres_cnn", bias=pooled))
    k, n = highres_fc()
    xc, wc, xs, ws = fc_inputs(gen, 8, device, (k, n))
    rows.append(_time_row(
        "qmatmul", "fc", 8, lambda: qmatmul(xc, wc, xs, ws),
        lambda: qmatmul_ref(xc, wc, xs, ws), None,
        8 * k + k * n + 4 * (8 + n + 8 * n), 2.0 * 8 * k * n / PEAK_INT8,
        exact=True, model="highres_cnn"))
    return rows


def odd_time_row(gen, device) -> list[dict]:
    """fused_cwp on a 224-wide band with an odd conv row count (91 rows)
    under odd='pad', B = 8, beside cuDNN's conv + relu + ceil-mode pool;
    then its int8 route."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    shape = ODD_POOL_SHAPES["band"]
    x, w, b, _ = conv_inputs(gen, 8, shape, "none", device)
    nbytes, ops = conv_work(8, shape, True, "pad")
    label = f"odd pad {shape[1]}x{shape[2]}"
    return [_time_row(
        "fused_cwp", label, 8,
        lambda: fused_cwp(x, w, b, odd="pad"),
        lambda: fused_cwp_ref(x, w, b, odd="pad"),
        lambda: F.max_pool2d(F.relu(F.conv2d(x, w, b)), 2, ceil_mode=True),
        nbytes, ops / PEAK_FP32, exact=False, model="odd_pool"),
        int8_time_row(gen, device, "fused_cwp", label, 8, shape,
                      model="odd_pool", odd="pad")]


def lm_time_rows(gen, device) -> list[dict]:
    """qmatmul at the LMs' MLP shapes: a decode step at capacity 4 (M =
    4) and a 64-token prefill (M = 64), each (K, N) of wi/wg and wo, for
    qwen1.5-0.5b and each LM_DENSE_ARCHS config; qwen1.5-0.5b's whole
    weights at a rank's rows on the multi-pod (2, 2, 1) mesh (M = 2 a
    decode step, 32 a 32-token prefill; drawn last); qwen1.5-0.5b's wi
    at the rows QMATMUL_TIME_M on both sides of the body boundary (tagged
    ``boundary``); and zamba2-7b's shared MLP at M = 4, 256 and 512 (its
    two prompt lengths), each of those
    first held bitwise against the plain version (127² · 14,336 < 2³¹:
    no int32 overflow). The library yardstick is ``torch._int_mm``
    (cuBLAS's int8 GEMM) followed by the two scale multiplies, where it
    takes the shape (M > 16, K and N multiples of 8); its result is first
    held bitwise against the plain version's. The large configs' plain
    version (tens of ms a call, summing K in chunks) is timed a call at a
    time behind a spin."""
    import torch
    from repro_torch.kernels.qmatmul.ops import qmatmul
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref

    cases = [(LM_ARCH, m, k, n, None) for m in (4, 64)
             for k, n in ((1024, 2816), (2816, 1024))]
    cases += [(arch, m, k, n, 200 + i)
              for i, (arch, k, n) in enumerate(dense_qmatmul_shapes())
              for m in (4, 64)]
    cases += [("zamba2-7b", m, k, n, 300 + i)
              for i, (k, n) in enumerate(((3584, 14336), (14336, 3584)))
              for m in (4, 256, 512)]
    cases += [(LM_ARCH + " (2, 2, 1)", m, k, n, None) for m in (2, 32)
              for k, n in ((1024, 2816), (2816, 1024))]
    cases += [("boundary", m, 1024, 2816, None) for m in QMATMUL_TIME_M]
    rows = []
    for arch, m, k, n, seed in cases:
        xc, wc, xs, ws = (qmatmul_inputs(gen, m, k, n, device) if seed is None
                          else qmatmul_inputs_on(device, seed, m, k, n))
        if arch == "zamba2-7b":
            got, want = qmatmul(xc, wc, xs, ws), qmatmul_ref(xc, wc, xs, ws)
            check(bitwise(got, want), f"times qmatmul {m}x{k}x{n}: kernel "
                                      f"vs plain max_abs "
                                      f"{max_abs(got, want)}")
            del got, want
        lib, note = None, "torch._int_mm needs M > 16"
        if m > 16:
            def lib(xc=xc, wc=wc, xs=xs, ws=ws):
                return torch._int_mm(xc, wc).to(torch.float32) * xs * ws
            try:
                same = bitwise(lib(), qmatmul_ref(xc, wc, xs, ws))
            except RuntimeError as e:
                lib, note = None, f"torch._int_mm refused: {e}"
            else:
                check(same, f"torch._int_mm at {m}x{k}x{n} disagrees "
                            f"with the plain qmatmul")
                note = None
        stage = ("decode" if m <= 4 else "prefill") + f" {m}x{k}x{n}"
        row = _time_row(
            "qmatmul", stage, m,
            lambda xc=xc, wc=wc, xs=xs, ws=ws: qmatmul(xc, wc, xs, ws),
            lambda xc=xc, wc=wc, xs=xs, ws=ws: qmatmul_ref(xc, wc, xs,
                                                           ws),
            lib, m * k + k * n + 4 * (m + n + m * n),
            2.0 * m * k * n / PEAK_INT8, exact=True, model=arch,
            plain_one_call=seed is not None)
        row["library_note"] = note
        if m <= 4 and k * n < L2_BYTES:
            row["cold_ms"], row["cold_copies"] = cold_device_ms(
                lambda w, xc=xc, xs=xs, ws=ws: qmatmul(xc, w, xs, ws), wc)
        rows.append(row)
        del xc, wc
    return rows + lm_shard_time_rows(device)


L2_BYTES = 50 * 1024 * 1024     # the H100's L2


def cold_device_ms(call, w) -> tuple[float, int]:
    """``device_ms`` of ``call(w_i)`` over copies of the weight ``w``
    taken in turn, as many as exceed twice the L2, so each call finds its
    weight in device memory, as a real decode step does (the warm
    reading calls on one weight that stays in the L2). Returns (ms, the
    copies)."""
    import itertools
    copies = [w.clone() for _ in range(max(2, -(-2 * L2_BYTES
                                               // w.numel())))]
    turn = itertools.cycle(copies)
    ms, _ = device_ms(lambda: call(next(turn)))
    return ms, len(copies)


# the MLP shard shapes timed in the times phase: (model, d_model, d_ff,
# model axis sizes, row counts M): qwen1.5-0.5b's decode and 64-token
# prefill on model 2 and 4, zamba2-7b's shared MLP's decode and 512-token
# prefill on model 2 (the family_mesh phase's 1 x 2), and qwen1.5-0.5b's
# 32-token prefill on the multi-pod (2, 1, 2) mesh's model 2 (lm_mesh)
SHARD_TIME_SHAPES = [(LM_ARCH, 1024, 2816, (2, 4), (4, 64)),
                     ("zamba2-7b", 3584, 14336, (2,), (4, 512)),
                     (LM_ARCH + " (2, 1, 2)", 1024, 2816, (2,), (32,))]


def lm_shard_time_rows(device) -> list[dict]:
    """qmatmul at the LMs' MLP shard shapes on a (data, model) mesh
    (``SHARD_TIME_SHAPES``): the column-parallel wi/wg (K = d_model, N =
    d_ff / model) with the epilogue, and the row-parallel wo (K = d_ff /
    model, N = d_model) without it (``qmatmul_acc``: the int32
    accumulator the ranks sum). Each first bitwise against its plain
    version, timed a call at a time where the plain product is large;
    the library yardstick ``torch._int_mm`` (+ the scales for the
    epilogue form) where M > 16."""
    import torch
    from repro_torch.kernels.qmatmul.ops import qmatmul, qmatmul_acc
    from repro_torch.kernels.qmatmul.ref import qmatmul_acc_ref, qmatmul_ref
    rows = []
    cases = [(arch, d, f, mn, m, part)
             for arch, d, f, mns, ms in SHARD_TIME_SHAPES
             for mn in mns for m in ms for part in ("wi", "wo")]
    for i, (arch, d, f, model_n, m, part) in enumerate(cases):
        k, n = (d, f // model_n) if part == "wi" else (f // model_n, d)
        xc, wc, xs, ws = qmatmul_inputs_on(device, 500 + i, m, k, n)
        if part == "wi":
            kern = lambda xc=xc, wc=wc, xs=xs, ws=ws: qmatmul(xc, wc, xs, ws)
            plain = lambda xc=xc, wc=wc, xs=xs, ws=ws: qmatmul_ref(
                xc, wc, xs, ws)
            lib = lambda xc=xc, wc=wc, xs=xs, ws=ws: torch._int_mm(
                xc, wc).to(torch.float32) * xs * ws
            nbytes = m * k + k * n + 4 * (m + n + m * n)
        else:
            kern = lambda xc=xc, wc=wc: qmatmul_acc(xc, wc)
            plain = lambda xc=xc, wc=wc: qmatmul_acc_ref(xc, wc)
            lib = lambda xc=xc, wc=wc: torch._int_mm(xc, wc)
            nbytes = m * k + k * n + 4 * m * n
        got, want = kern(), plain()
        check(bitwise(got, want), f"times qmatmul shard {part} {m}x{k}x{n}: "
                                  f"kernel vs plain max_abs "
                                  f"{max_abs(got, want)}")
        note = None
        if m > 16:
            check(bitwise(lib(), want), f"torch._int_mm at shard {m}x{k}x{n} "
                                        f"disagrees with the plain version")
        else:
            lib, note = None, "torch._int_mm needs M > 16"
        del got, want
        stage = (f"{'decode' if m == 4 else 'prefill'} {m}x{k}x{n} "
                 f"{part} model={model_n}"
                 + (" (int32 accumulator)" if part == "wo" else ""))
        row = _time_row("qmatmul", stage, m, kern, plain, lib, nbytes,
                        2.0 * m * k * n / PEAK_INT8, exact=True,
                        model=f"{arch} shard",
                        plain_one_call=m * k * n > 1e9)
        row["library_note"] = note
        if m <= 4 and k * n < L2_BYTES:
            row["cold_ms"], row["cold_copies"] = cold_device_ms(
                (lambda w, xc=xc: qmatmul_acc(xc, w)) if part == "wo" else
                (lambda w, xc=xc, xs=xs, ws=ws: qmatmul(xc, w, xs, ws)), wc)
        rows.append(row)
    return rows


def phase_plans(device):
    """highres_cnn's whole bound plan per batch, at B = 1 and 8, in every
    mode, under each of PLAN_BUDGETS: the device time between CUDA events
    around one call (``call_device_ms``) and the wall time of one call to
    its synchronize."""
    import torch
    from repro_torch.models.vgg import VGGStyleCNN, VGGStyleCNNConfig
    from repro_torch.ops import ExecPolicy

    params = VGGStyleCNN().init(0, device=device)
    gen = torch.Generator().manual_seed(8)
    rows = []
    for bsz in (1, 8):
        x = torch.randn(VGGStyleCNN().input_shape(bsz), generator=gen).to(
            device)
        for mode in MODES:
            model = VGGStyleCNN(VGGStyleCNNConfig(
                policy=ExecPolicy(quant=mode)))
            for label, budget in PLAN_BUDGETS.items():
                plan = model.compile(batch=bsz, stream_budget=budget)
                bound = plan.bind(params)
                with torch.inference_mode():
                    ms, dry = call_device_ms(lambda: bound(x))
                    walls = []
                    for _ in range(20):
                        t0 = time.perf_counter()
                        bound(x)
                        torch.cuda.synchronize()
                        walls.append((time.perf_counter() - t0) * 1e3)
                rows.append({"B": bsz, "mode": mode, "budget": label,
                             "launches": plan_launches(plan),
                             "ms": ms, "wall_ms": statistics.median(walls),
                             "queue_ran_dry": dry})
    emit({"phase": "plans", "model": "highres_cnn", "rows": rows,
          "copies": band_copy_rows(device)})


def band_copy_rows(device) -> list[dict]:
    """What banding adds on the card besides launches, at B = 8 in fp32:
    per streamed stage of the served plan, the copy of each band's input
    slab (an H-slice of (B, N, H, W) is not contiguous, so the kernel's
    wrapper copies it) and the ``torch.cat`` of the bands' outputs."""
    import torch
    from repro_torch.core.window import pool_output_size
    from repro_torch.graph.passes import stage_input_spec
    from repro_torch.models.vgg import VGGStyleCNN
    from repro_torch.stream import pooled_bands

    plan = VGGStyleCNN().compile(batch=8)
    rows = []
    for node in plan.graph:
        if getattr(node, "tiling", None) is None:
            continue
        shape = stage_input_spec(plan.graph, node).shape
        k, sh = node.w.shape[2], node.stride[0]
        x = torch.randn(shape, device=device)
        po = pool_output_size((shape[2] - k) // sh + 1, node.odd)
        bands = pooled_bands(po, node.tiling.tile_rows, k, sh, shape[2])
        slab_ms = 0.0
        for _, _, lo, hi in bands:
            slab_ms += device_ms(
                lambda: x[:, :, lo:hi, :].contiguous())[0]
        outs = [torch.empty((8, node.w.shape[0], p1 - p0, node.out.shape[3]),
                            device=device) for p0, p1, _, _ in bands]
        cat_ms = device_ms(lambda: torch.cat(outs, dim=2))[0]
        rows.append({"stage": node.w.path[0], "bands": len(bands),
                     "slab_copy_ms": slab_ms, "cat_ms": cat_ms,
                     "slab_bytes": 4 * sum(shape[0] * shape[1] * (hi - lo)
                                           * shape[3]
                                           for *_, lo, hi in bands)})
    return rows


def _time_row(name, stage, bsz, kern, plain, lib, nbytes, ops_s, *,
              exact: bool, model: str = "mnist_cnn",
              plain_one_call: bool = False):
    """One timed row of ``model``'s kernel shapes; at B = 1024 the
    kernel's output is first held against the plain version's (bitwise
    where ``exact``). ``plain_one_call``: the plain version is timed a
    call at a time behind a spin (``call_device_ms``), for a call long
    enough that a hundred queued at once would fill the launch queue."""
    import torch
    if bsz == 1024:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs(got, want)
        tol = 0.0 if exact else TOL_FP32 * (1 + float(want.abs().max()))
        check(bitwise(got, want) if exact else err <= tol,
              f"times {name} {stage} B={bsz}: kernel vs plain max_abs "
              f"{err}, tolerance {tol}")
        del got, want
    ms, dry = device_ms(kern)
    plain_ms, plain_dry = (call_device_ms(plain, reps=5, spin=int(1e8))
                           if plain_one_call else device_ms(plain))
    lib_ms, lib_dry = device_ms(lib) if lib is not None else (None, False)
    bytes_s = nbytes / PEAK_BYTES
    return {"name": name, "model": model, "stage": stage, "B": bsz,
            "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "bytes_ms": bytes_s * 1e3, "operations_ms": ops_s * 1e3,
            "queue_ran_dry": [col for col, d in (("ms", dry),
                                                 ("plain_ms", plain_dry),
                                                 ("library_ms", lib_dry))
                              if d]}


def kernels_line(launches, max_err, rows) -> dict:
    """The contract line: per kernel, the main path's launch count, its
    parity error, and its time beside the bound for one served batch
    (B = 8: both conv stages for the conv kernels and for the tree's
    product matrices, the fc for qmatmul). The highres_cnn rows of the
    times phase stay out of it, and so do the conv kernels' int8-route
    rows, summed in fields of their own (``int8_*``, with the main path's
    int8-route launches)."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        rows8 = [r for r in rows if r["name"] == name and r["B"] == 8
                 and r["model"] == "mnist_cnn"]
        mine = [r for r in rows8 if r.get("route") != "int8"]
        int8 = [r for r in rows8 if r.get("route") == "int8"]
        libs = [r["library_ms"] for r in mine]
        bytes_ms = sum(r["bytes_ms"] for r in mine)
        ops_ms = sum(r["operations_ms"] for r in mine)
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if None in libs else sum(libs)})
        if int8:
            b8 = sum(r["bytes_ms"] for r in int8)
            o8 = sum(r["operations_ms"] for r in int8)
            out[-1].update({
                "int8_launches": launches[f"{name}_int8"],
                "int8_ms": sum(r["ms"] for r in int8),
                "int8_plain_ms": sum(r["plain_ms"] for r in int8),
                "int8_bound_ms": max(b8, o8),
                "int8_bound_by": "bytes" if b8 >= o8 else "operations",
                "int8_library_ms": sum(r["library_ms"] for r in int8)})
    return {"kernels": out}


# host work that the card's phases would otherwise wait for, started
# with the script (``start_host_jobs``) and taken where a phase needs it:
# the CPU sides of the card-vs-CPU checks (the moe phase's too) in one
# process of
# HOST_THREADS torch threads, the dry-run sweep in HOST_WORKERS
# processes; the train launchers (card processes) start before the mesh
# phase, whose gloo worlds time-share the card anyway
HOST_JOBS: dict = {}
HOST_POOLS: list = []
CPU_POOL: list = []                 # the process of the CPU sides
HOST_WORKERS = 2
HOST_THREADS = 3


def card_vs_cpu_jobs() -> list[tuple]:
    """The ``lm_card_vs_cpu`` calls of the main path, in the order the
    phases make them: (arch, layers, modes, prompt lengths, nudge)."""
    return ([(LM_ARCH, 2, ("none", "int8"), (32, 16, 32, 16), True)]
            + [(a, 1, ("none",), (16, 8), False) for a in LM_DENSE_ARCHS]
            + [("zamba2-7b", SSM_CPU_LAYERS["zamba2-7b"], ("none", "int8"),
                (256,), False),
               ("rwkv6-1.6b", SSM_CPU_LAYERS["rwkv6-1.6b"], ("none",),
                (128, 64), False)])


def mesh_sweep_cells() -> list[tuple]:
    """(multi_pod, arch, shape) of the mesh dry run's grid at both
    production meshes, the train cells first (they take the longest),
    the multi-pod mesh's first among each kind."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.base import SHAPES
    order = {"train": 0, "prefill": 1, "decode": 2}
    cells = [(mp, a, s) for mp in (True, False) for a in ARCH_IDS
             for s in SHAPES]
    return sorted(cells, key=lambda c: order[SHAPES[c[2]][0]])


def start_host_jobs() -> None:
    """Start the static gate's subprocess, and the card-vs-CPU checks' CPU
    sides, the dry-run sweep, the mesh dry run's sweep and the
    family_mesh jobs' collective counts in spawned worker processes,
    beside the card's phases."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import run_cell
    gate = ThreadPoolExecutor(1)            # a subprocess: a thread waits
    HOST_POOLS.append(gate)
    HOST_JOBS["analysis"] = gate.submit(analysis_gate)
    ctx = multiprocessing.get_context("spawn")
    cpu = ProcessPoolExecutor(1, mp_context=ctx)
    sweep = ProcessPoolExecutor(HOST_WORKERS, mp_context=ctx)
    HOST_POOLS.extend([cpu, sweep])
    CPU_POOL.append(cpu)
    jobs = card_vs_cpu_jobs()
    for key in jobs[:1 + len(LM_DENSE_ARCHS)]:      # the lm phase's
        HOST_JOBS[("card_vs_cpu",) + key] = cpu.submit(
            card_vs_cpu_host, *key, threads=HOST_THREADS)
    HOST_JOBS["moe_card_vs_cpu"] = cpu.submit(moe_card_vs_cpu_host,
                                              threads=HOST_THREADS)
    for key in jobs[1 + len(LM_DENSE_ARCHS):]:      # the ssm phase's
        HOST_JOBS[("card_vs_cpu",) + key] = cpu.submit(
            card_vs_cpu_host, *key, threads=HOST_THREADS)
    job = {"t0": time.perf_counter(), "done": [], "cells": []}
    for a in ARCH_IDS:
        for shape in SHAPES:
            f = sweep.submit(run_cell, a, shape)
            f.add_done_callback(
                lambda _, done=job["done"]: done.append(time.perf_counter()))
            job["cells"].append(f)
    HOST_JOBS["sweep"] = job
    pods = ProcessPoolExecutor(MESH_SWEEP_WORKERS, mp_context=ctx)
    HOST_POOLS.append(pods)
    for key in FAMILY_COUNTED:
        HOST_JOBS[("family_count",) + key] = pods.submit(family_count, *key)
    mesh_job = {"t0": time.perf_counter(), "done": [], "cells": []}
    for mp, a, shape in mesh_sweep_cells():
        f = pods.submit(run_cell, a, shape, multi_pod=mp)
        f.add_done_callback(
            lambda _, done=mesh_job["done"]: done.append(time.perf_counter()))
        mesh_job["cells"].append(f)
    HOST_JOBS["mesh_sweep"] = mesh_job


def start_train_launchers() -> None:
    """``train_lm_launcher`` (four card processes at a time) in a thread,
    its checks made where the train phase takes its result."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(1)
    HOST_POOLS.append(pool)
    HOST_JOBS["train_launcher"] = pool.submit(train_lm_launcher)


def stop_host_jobs(failed: bool) -> None:
    """End every host job's workers: after a failure at once, else once
    their work is taken (none may be left untaken)."""
    left = sorted(str(k) for k in HOST_JOBS)
    HOST_JOBS.clear()
    CPU_POOL.clear()
    for pool in HOST_POOLS:
        if failed:
            for proc in list((getattr(pool, "_processes", None) or {})
                             .values()):
                proc.terminate()
        pool.shutdown(wait=True, cancel_futures=True)
    HOST_POOLS.clear()
    check(failed or not left, f"host jobs never taken: {left}")


_LAP = [0.0]


def lap(part: str) -> None:
    """Print to stderr the seconds a phase's ``part`` took: since the
    phase started or its last lap."""
    now = time.perf_counter()
    print(f"chip_smoke:   {part} {now - _LAP[0]:.1f} s", file=sys.stderr,
          flush=True)
    _LAP[0] = now


def _timed(name, fn):
    """``fn`` with its wall time printed to stderr when it returns."""
    def run(device):
        t0 = _LAP[0] = time.perf_counter()
        out = fn(device)
        print(f"chip_smoke: phase {name} {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        return out
    return run


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after device and "
                         "build (kernels, serve, open_loop, eager, tree, "
                         "stream, boot, "
                         "lm, moe, ssm, train, launch, mesh, lm_mesh, "
                         "family_mesh, mesh_dryrun, analysis, times, "
                         "plans); "
                         "prints no result line")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # the reference pins fp32 precision: no TF32 in any fp32 contraction,
    # the library yardsticks' cuDNN convolutions included
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    phases = {"kernels": phase_kernels, "serve": phase_serve,
              "open_loop": phase_open_loop, "eager": phase_eager, "tree": phase_tree,
              "stream": phase_stream, "boot": phase_boot,
              "lm": phase_lm, "moe": phase_moe, "ssm": phase_ssm,
              "train": phase_train, "launch": phase_launch,
              "mesh": phase_mesh, "lm_mesh": phase_lm_mesh,
              "family_mesh": phase_family_mesh,
              "mesh_dryrun": phase_mesh_dryrun,
              "analysis": phase_analysis,
              "times": phase_times, "plans": phase_plans}
    t_start = time.perf_counter()
    phases = {name: _timed(name, fn) for name, fn in phases.items()}
    failed = True
    try:
        info = phase_device()
        phase_build()
        if args.phases is None:
            start_host_jobs()
        if args.phases is not None:
            for name in args.phases.split(","):
                phases[name](device)
            for line in STEP_LINES + LAUNCH_LINES + OPEN_LOOP_LINES:
                emit(line)
            print("chip_smoke: ran only --phases; no result", file=sys.stderr)
            return 4
        max_err = phases["kernels"](device)
        reset_counts()                      # the main path starts here
        phases["serve"](device)
        phases["open_loop"](device)         # its CPU replays: a host job
        phases["eager"](device)
        phases["tree"](device)
        phases["stream"](device)
        launches = counts()
        check(all(launches.values()),
              f"a kernel of the main path never launched: {launches}")
        reset_counts()                      # this slice's path: the boot
        phases["boot"](device)
        boot = counts()
        check(boot["fused_cwp"] and boot["qmatmul"],
              f"a kernel of the boot path never launched: {boot}")
        lm = phases["lm"](device)               # counted from 0 in there
        check(lm["qmatmul"], f"qmatmul never launched on the LM path: {lm}")
        moe = phases["moe"](device)             # counted from 0: none at all
        ssm = phases["ssm"](device)             # counted from 0 in there
        check(ssm["qmatmul"],
              f"qmatmul never launched on the zamba2 path: {ssm}")
        launch = phases["launch"](device)       # counted from 0 in there
        check(launch["qmatmul"],
              f"qmatmul never launched on the launch path: {launch}")
        start_train_launchers()                 # beside the gloo worlds
        mesh = phases["mesh"](device)           # counted from 0 per rank
        check(mesh["fused_cwp"] and mesh["conv_window"] and mesh["qmatmul"],
              f"a kernel of the mesh path never launched: {mesh}")
        lm_mesh = phases["lm_mesh"](device)     # counted from 0 per rank
        check(lm_mesh["qmatmul"],
              f"qmatmul never launched on the LM mesh path: {lm_mesh}")
        train = phases["train"](device)         # counted from 0 in there
        check(train["conv_window"] and train["qmatmul"],
              f"a kernel of the training path never launched: {train}")
        family = phases["family_mesh"](device)  # counted from 0 per rank
        check(family["qmatmul"],
              f"qmatmul never launched on the family mesh path: {family}")
        phases["mesh_dryrun"](device)           # meta only: no launches
        phases["analysis"](device)              # the host's: no launches
        open_loop_replays_held()                # the host's replays
        emit({"phase": "launches", "main": launches, "boot": boot,
              "lm": lm, "moe": moe, "ssm": ssm, "train": train,
              "launch": launch, "mesh": mesh, "lm_mesh": lm_mesh,
              "family_mesh": family})
        launches = {k: v + boot[k] + lm[k] + moe[k] + ssm[k] + train[k]
                    + launch[k] + mesh[k] + lm_mesh[k] + family[k]
                    for k, v in launches.items()}
        stop_host_jobs(failed=False)
        rows = phases["times"](device)
        phases["plans"](device)
        failed = False
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if failed:
            stop_host_jobs(failed=True)
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    for line in STEP_LINES:             # eager and graph step ms, compact
        emit(line)
    for line in LAUNCH_LINES:           # the dry run and the rooflines
        emit(line)
    for line in OPEN_LOOP_LINES:        # open-loop latencies, the card's
        emit(line)
    emit(kernels_line(launches, max_err, rows))
    print(info["nvidia_smi"])
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
