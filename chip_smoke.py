"""Smoke run of the PyTorch / CUDA port (flowgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the phases below
    python3 chip_smoke.py --profile  # profile the spill paths
    python3 chip_smoke.py --profile --paths "gin hep10k,gin-vn hep10k"  # some of them

``--profile`` runs no phase: it builds the hep10k W=128 streams of PNA, DGN
and GAT (slot spill tail), their hep10k slot streams at W=512 (PNA's and
DGN's also run with intermediates: rows 20 and 22) and GCN's hep10k ELL
stream at W=512 beside them, and the hep10k W=128 streams of GIN,
GIN-VN, GCN, DGN and GAT (ELL spill tail; GAT also with its fused layer),
GIN's molhiv edge-block (plain and fused) and legacy local streams and
PNA's molhiv edge-block stream beside the plain edge-list batches of the
same packing (``--paths``: only the
paths whose "model profile layout" starts with one of its comma-separated
prefixes), warms each path up, traces ``PROFILE_PASSES`` bf16 passes over
the whole stream with ``torch.profiler`` and prints per path the wall time
and the device's busy time per pass (the sum of the device kernels' own
times; one stream, so they do not overlap), the idle share 1 − busy / wall,
the kernel launches per pass, the largest device items with their share of
the busy time and the host operators with the most CPU time. The profiler
adds host time, so the wall times and idle shares are upper bounds.

Phases, each of which raises (non-zero exit) on failure:

1. the device and ``nvidia-smi``'s name and power limit;
2. the twenty-six hand-written kernels built from the twenty-five sources
   of ``flowgnn_tpu_torch/csrc`` (rows 10 and 12 are one kernel, rows 27-30
   one; row 31 and row 12's pass-through are the messages-only forms of
   rows 13 and 10 / 12) and their headers (``hopper.cuh`` holds the
   wgmma, mbarrier and bulk-copy blocks of rows 1-5, 8, 9, 10, 12, 13, 15,
   18, 20, 22, 23, 25 and 26, ``gin_mlp.cuh`` the bf16 GIN MLP of rows 1, 8, 10,
   12, 13 and 25, ``gin_layer.cuh`` the per-layer GIN kernel of rows 10, 12,
   13 and 25 (three lane walks) and its messages-only form (row 31, row 12's
   pass-through), ``gin_model.cuh`` the whole-model GIN
   kernel of rows 1 and 8,
   ``gcn_model.cuh`` the GCN one of rows 2, 9, 15 and 14 (whole model, one
   layer, messages only), ``pna_model.cuh`` the PNA
   one of rows 3 and 20 (whole model, one layer), ``dgn_model.cuh`` the DGN
   one of rows 4, 22 (slots) and 18 (ELL), ``lanes.cuh`` the lane walks of
   GCN and GIN and the ELL runs of rows 14, 15, 17, 18 and 23,
   ``gat_messages.cuh`` the GAT message walk of rows 17, 23 (ELL runs) and
   21 (slot rows), ``linear_wgmma.cuh`` the bf16 product of rows 2-5, 9,
   15, 18, 20, 22 and 23), one
   ``nvcc`` per source, all started together (build time and each
   compiler's register / shared-memory report); each library's count of
   tensor-core (HGMMA, HMMA, IMMA), bulk-copy / TMA (UBLKCP, UTMALDG) and
   FFMA instructions in its SASS (``cuobjdump -sass``), rows 1-5, 8, 9, 10,
   12, 13, 15, 18, 20, 22, 23, 25 and 26 required to hold HGMMA and a bulk copy
   (row 26: or a TMA load);
3. each slot kernel against its plain torch version on the card, at the
   main path's shapes (a real bucket's slot layout at full width: GIN D=100,
   H=200, L=5, with and without the analytic-VN column; GCN D=100, L=5;
   PNA D=80, L=4, T=40; DGN D=100, L=4, T=50; GAT 4 heads × 16, L=5, T=1)
   with seeded random operands: f32 at rtol = atol = 1e-4 (summation order
   only), bf16 at 5e-2 (tolerances as in ``agree``); then the tensor-core
   GIN kernels at each width of ``GIN_WIDTHS`` (D=36 / H=72, D=100 / H=200,
   D=100 / H=512), f32 and bf16 (printing the bf16 launch's weight ring):
   row 1 at W=128 (molhiv), W=256 (a synthetic bucket with 250-node graphs)
   and W=512 (the hep10k slot bucket holding the largest graph), GIN and
   GIN-VN; row 8 on the hep10k W=512 ELL bucket holding the largest graph;
   row 13 on layer 0 of the hep10k W=128 ELL bucket with the longest spill
   tail; then rows 2, 3, 4 and 5 (GCN, PNA, DGN, GAT) above W=128, f32 and
   bf16 (printing the bf16 launch's weight ring): W=256 (a synthetic bucket
   of 250-node graphs) and W=512 (the hep10k slot bucket holding the
   largest graph); then what the occupancy calculator says of rows 2, 4
   and 5's bf16 and f32 forms at W=128 and W=512 (shared memory a block,
   blocks an SM, clusters in flight);
3b. each ELL kernel (GIN with and without the VN column, GCN, full width;
   row 9's bf16 next conv on wgmma) against its plain version the same way,
   on ELL buckets at W=128 (molhiv), W=256 and W=384 (synthetic, one large
   graph each) and W=512 (the hep10k bucket holding its largest graph, ≥ 385
   nodes); then what the occupancy calculator says of row 9's bf16 and f32
   forms at W=128 and W=512 (shared memory a block, blocks an SM, clusters
   in flight);
3c. each per-layer slot kernel (PNA's ``pna_local_stats_ell``, DGN's
   ``dgn_local_layer_slots``, GAT's ``gat_local_message_slots``) and the
   spill scatter ``windowed_segment_sum`` against its plain version on
   layer 0's operands of the hep10k W=128 bucket with the longest spill
   tail, f32 and bf16;
3d. each per-layer ELL kernel (``gin_local_layer_ell``, row 13, for GIN and
   GIN-VN, in bf16 through the tensor-core MLP; ``gcn_local_message_ell``,
   row 14, and ``gcn_local_layer_ell``, row 15, for GCN) and the spill
   scatter against its plain version on layer 0's operands of the hep10k
   W=128 ELL bucket with the longest spill tail (rows 13, 14, 24) and of a
   molhiv W=128 ELL bucket (rows 13, 15), f32 and bf16; then row 14 (the
   messages-only form of row 9's cluster kernel) on layer 0's operands of
   the synthetic ELL buckets of phase 3e's row 15 (W = 256, 512 and 1024;
   k = 2 at W=1024), and what the occupancy calculator says of its forms;
3e. rows 20 (``pna_local_layer``), 18 (``dgn_local_layer_ell``), 16
   (``dgn_local_message_ell``) and 17 (``gat_local_message_ell``) against
   their plain versions on layer 0's operands at full width, f32 and bf16:
   row 20 on a PNA molhiv slot bucket, row 18 on a DGN molhiv ELL bucket
   (W=128, block 512), rows 16 and 24 on the DGN hep10k W=128 ELL bucket with
   the longest spill tail, row 17 on a GAT molhiv ELL bucket and on the GAT
   hep10k W=128 ELL bucket with the longest tail (with row 24); then rows
   20 and 22 (the one-layer forms of rows 3 and 4, on clusters of W/128
   blocks) on layer 0's operands at W=128 (molhiv bucket 0), W=256 (a
   synthetic bucket of 250-node graphs), W=512 (the hep10k slot bucket
   holding the largest graph) and W=1024 (a synthetic bucket of 900-node
   graphs), f32 and bf16, row 22 with and without a seeded ``m_spill``, row
   19 (row 3's stats-only form) on row 20's operands there;
   rows 18 and 15 (rows 4's and 9's one-layer forms over ELL; row 15 on a
   non-final and on the last layer) and row 16 (row 4's channels-only form,
   on row 18's operands) on synthetic ELL buckets at W=256, 512 and 1024
   (k=2); row 21 on the GAT hep10k slot bucket at W=512 holding the largest
   graph, divided and as raw sums; printing the bf16 launch's weight ring
   and what the occupancy calculator says of the six rows' forms at W=128
   and W=512; and DGN over a W=256 bucket
   whose hub nodes have an in-window in-degree of 12 (past the 8 slots), so
   that it spills: row 22 and row 24 on its layer 0 against their plain
   versions, and ``dgn.forward`` over it, counted (row 22 and row 24 once a
   layer) and checked against the plain edge-list path as in phase 4;
3f. rows 10 (``gin_local_layer``), 12 (``gin_local_layer_ell_lanes``) and 25
   (``gin_layer_fused``) on layer 0's operands of a GIN molhiv bucket in the
   legacy local, ELL and edge-block layout, row 23 (``gat_local_layer_ell``)
   on a GAT molhiv ELL bucket and on the GAT hep10k W=128 ELL bucket with the
   longest spill tail (with row 24), and row 24 on an edge-block bucket at
   each reduction width (GAT 68, GIN 100, PNA 160, DGN 200), f32 and bf16;
   row 24 also on seeded operands with a window whose run is longer than
   its list (``LONG_RUN``: a hub row of more lanes than the list, the other
   rows in groups, lanes in random order), at W=128 and W=512, two launches
   equal bit for bit;
   then rows 10, 12 and 25 at each width of ``GIN_WIDTHS`` and row 23 at
   each head geometry of ``GAT_WIDTHS`` (4 × 16 and 3 × 16), on the lanes of
   a molhiv ELL bucket (W=128) and of a synthetic one of 900-node graphs
   (W=1024), with and without the spill operand (``m_spill``, row 23's
   ``spill_both``), seeded random operands, printing the bf16 launch's weight
   ring, and what the occupancy calculator says of rows 13, 10 / 12, 25 and
   23 (``LAYER_OCCUPANCY``);
4. the main path: GIN, GIN-VN, GCN, PNA, DGN and GAT, each over the
   4113-graph synthetic molhiv stream at full width with seeded synthetic
   weights, f32 and bf16, through ``registry`` → ``pack_dataset`` →
   ``as_batches_uniform(local_slots)`` → ``registry.get(name).forward``.
   Every kernel's launch count is set to 0 just before each run and read
   just after: each bucket must have launched its path's kernels (the
   model's whole-model kernel once, or its per-layer kernels once per
   layer) and no other kernel at all. Each bucket's predictions must match
   the port's plain edge-list path in f32 on the card (f32 1e-4, bf16 5e-2,
   see ``run_main_path``);
4b. the ELL path: GIN, GIN-VN and GCN over the 2048-graph synthetic hep10k
   stream at W=512 (``as_batches_uniform(local_ell)``, k=1, no spill), f32
   and bf16, counted and checked as in phase 4; then over the molhiv stream
   at W=128, whose predictions must match the slot path's (f32 1e-4). And
   the hep10k slot path, the JAX bench's layout for GIN, GIN-VN, PNA, DGN
   and GAT there, and GCN's: ``local_slots`` at W=512 (``HEP_SLOT_WINDOW``;
   no bucket spills; GIN's, GIN-VN's and GCN's the ELL W=512 packing), one
   launch of the model's whole-model slot kernel (rows 1, 2, 3, 4, 5) per
   bucket and no other kernel, counted and checked as in phase 4, its f32
   predictions also, graph by graph, against the ELL W=512 path's (PNA,
   DGN, GAT: the W=128 spill path's of phase 4c) at 1e-4;
4c. the spill path: PNA, DGN and GAT over the same hep10k sample at W=128
   (``as_batches_uniform(local_slots, window=128)``, the JAX bench's
   ``--ell-window 128``), whose window-crossing edges ride the spill tail:
   per layer the model's per-layer slot kernel and the spill scatter,
   counted and checked as in phase 4;
4d. the per-layer ELL path: GIN, GIN-VN and GCN over the hep10k sample at
   W=128 in ``local_ell`` (block 384, as the JAX bench derives it from
   ``--ell-window 128``), whose crossing edges ride the ELL spill tail: per
   layer row 13 (GCN: row 14) and the spill scatter; and GIN and GCN over the
   molhiv ELL stream with ``return_intermediates``: per layer row 13 or row
   15. Counted and checked as in phase 4, every intermediate too (the rows
   of real nodes);
4e. PNA over the molhiv slot stream with ``return_intermediates``: per
   layer row 20, every intermediate checked (the slot layout's rows mapped
   back to the plain batch's); PNA and DGN over the hep10k slot stream at
   W=512 with ``return_intermediates``: per layer and bucket row 20 or row
   22 and no other kernel, every intermediate checked, and their f32
   predictions graph by graph against the whole-model W=512 path's of
   phase 4b (rows 3 and 4) at 1e-4; DGN and GAT over the molhiv ELL stream at
   W=128 / block 512: per layer row 18 or row 17, and their predictions
   against the slot path's too (f32 1e-4); DGN and GAT over the hep10k
   sample in ``local_ell`` at W=128 / block 512 with the ELL spill tail: per
   layer rows 16 + 24 or 17 + 24; GAT over the molhiv slot stream with
   ``return_intermediates``: per layer row 21, divided in the kernel, every
   intermediate checked. Counted and checked as in phase 4;
4f. the edge-block layout (``--layout blocked``): all six models over the
   molhiv stream in unaligned packing through ``as_batches_uniform(
   blocked=True)``: per layer the windowed scatter (row 24) over every
   128-row window and nothing else; GIN with ``fused=True``: row 25 per layer
   and row 24 never. The legacy local layout: GIN and GIN-VN over the aligned
   W=128 molhiv stream in ``blocked="local"``, and over one bucket with four
   300-node graphs whose crossing edges ride the 8192-lane tail: row 10 per
   layer. Row 12 through ``gin_local_layer_ell(ee=...)`` layer by layer over
   GIN's molhiv ELL stream, every layer's h against the row-13 path's too.
   GAT with ``fuse_layers`` over the molhiv ELL stream and the hep10k W=128
   ELL spill stream: row 23 for every layer but the last, row 17 for the
   last, row 24 per layer on a spill tail; its predictions against the
   unfused ELL path's too. Counted and checked as in phase 4;
5. CUDA-event timings after warm-up, per model and dtype: µs/graph over the
   whole stream for the kernel path and for the plain edge-list path, and
   each kernel alone against its plain version on the same operands (a
   per-layer kernel on each bucket's layer-0 operands, once per layer), with
   its bound (the larger of its FLOPs over the card's peak for the dtype and
   its bytes over the memory rate; the rows of a pad lane, which no kernel
   reads, are not counted) and, for the spill scatter, PyTorch's
   ``index_add_`` of the same values; the per-layer kernels whose loop of
   wrapper calls can time their host work (rows 14-19, 21 and 24) also as
   the device time of the stream's launches replayed from a CUDA graph
   (``REPLAYED``);
5b. the same for the hep10k ELL path, the molhiv stream through the ELL
   kernels at W=128, and the hep10k spill path;
5c. the same for the per-layer ELL paths of phase 4d;
5d. the same for the paths of phase 4e;
5e. the same for the paths of phase 4f; the windowed scatter on the
   edge-block layout beside ``index_add_`` of the same values;
5f. rows 8, 1, 13, 9, 3, 2, 4, 5, 20, 22, 23, 10, 12, 25, 18 and 15 alone on
   their cells (``TURN_CELLS``),
   each kernel's bf16 form (its product on wgmma) and its f32 form (FMA) in
   turns: bf16, f32, f32, bf16; launches, ms per stream, bound and share of
   the bound;
5g. rows 9, 3, 4, 5, 20, 22, 23, 10, 12, 25, 18, 15, 17, 21, 14 and 24 by
   stage on their cells (``SPLIT_CELLS``), bf16 and f32: each kernel alone
   whole and with its product (row 23 both products, rows 10, 12, 25 the MLP;
   rows 17, 21, 14 and 24 have none), its messages, stats, channels or sums,
   or both knocked out (the wrappers' ``knockout``, which
   only this phase passes), each the device time of the stream's launches
   replayed from a CUDA graph (the wrappers' host work left out), and the
   share of each;
6. the bench tools (``flowgnn_tpu_torch.bench``). 6a: row 26
   (``chained_matmul``) on every ``matmul_shapes.SHAPES`` row at full size
   in its dtype, equal to layers·K on all-ones operands and to its plain
   version on seeded ones (int8 exactly, bf16 at 1e-4). 6b: rows 27-30
   (``gat_mega_ablate``, row 5's body in four forms) on the 1028-graph
   molhiv GAT bucket at full width, every (form, variant) against its plain
   version at W=128 (f32 1e-4, bf16 5e-2, or 1.5× what the plain version
   needs against its f64 run), each form's full, nogather, noglue and
   nopool at W=512 (clusters of four) the same way, each form's ``full``
   against row 5's kernel at both (f32 1e-4), each form's occupancy. Then
   each tool's ``main`` as a user runs it, counted (``run_bench_tools``):
   ``matmul_shapes``'s table and the ablation table over every variant in
   bf16 at W=128 and at W=512 (by graph replay); then per shape the kernel,
   its plain version and cuBLAS (TF/s, share of the peak), and the
   ablation record's kernel (loop and graph replay) and plain times;
7. the bench entry and the messages-only forms of rows 13 and 12. 7a: row
   31 (``gin_local_message_ell``) and row 12's pass-through
   (``gin_local_message_ell_lanes``) against their plain versions on layer
   0's operands of GIN's first molhiv ELL bucket and of its hep10k W=128 ELL
   bucket with the longest spill tail, f32 (1e-4) and bf16 (5e-2), and what
   the occupancy calculator says of them beside row 13. Then GIN over the
   hep10k W=128 ELL stream layer by layer with its messages from row 31 and
   the rest of row 13's layer in plain torch (``row31_forward``, as the JAX
   halo branch runs it): counted (row 31 and the spill scatter once a layer
   and bucket), checked as in phase 4 and against the row-13 path, timed as
   in phase 5. 7c: row 12's pass-through alone on the same stream (loop,
   graph replay, plain version, bound). 7b: the bench entry's ``main``
   (``python -m flowgnn_tpu_torch.bench.bench``) in-process over
   ``ENTRY_RUNS`` (all six models on molhiv, molpcba and hep10k at their
   default streams, and GIN on hep10k at W=128, whose slot stream falls back
   to ELL), ``ENTRY_REPS`` passes a trial: each record parsed, its figures
   finite and positive, the geometric-mean line last; the stage benches
   counted (row 19 and row 12's pass-through); the phase's seconds;
8. the streaming runtime and the host application. 8a: ``runtime.stream.
   InferenceStream`` for all six models over the molhiv stream at full
   width, weight sets flipped halfway, f32 and bf16: one CUDA graph per
   (signature, weight set), counted (the whole-model kernel, rows 1-5, at
   the captures only: an eager pass and the capture each), some graph
   replayed for buckets of other content; ``run`` and ``run_pipelined``
   agree, each bucket's replayed predictions are held to its eager forward
   and to the f32 plain path as in phase 4, the two weight sets differ;
   GIN over more weight sets than the weight-chunk cache keeps, run twice
   (``check_stream``). 8b: ``bench.host_app``'s ``main`` in-process for each
   model (``run_host_app``), its record parsed and its figures finite and
   positive, counted; the phase's seconds;
9. the experiment CLI (``python -m flowgnn_tpu_torch.cli``) in-process, every
   launch count set to 0 before each command and read after (``run_cli``).
   9a: ``run --model all`` over the 4113-graph molhiv stream (its ``synth``
   dataset), bf16, three trials: each model's whole-model slot kernel (rows
   1-5) launched once a bucket and pass and nothing else, each
   ``<model>_output.txt`` 4113 lines in order and held to the f32 plain path
   as in phase 4, ``results.json`` and each ``summary.<model>.csv`` parsed,
   their figures finite and positive, each model's µs/graph printed. 9b: GIN
   on the 2048-graph hep10k sample (slots at W=512: row 1 counted) and GCN
   on 1028 graphs with ``--layout blocked`` (row 24 once a layer, bucket and
   pass). 9c: GIN with ``--trace``: the Chrome trace names row 1's kernel
   once a bucket among its device events. 9d: ``tune`` for GIN (ELL, W =
   128, 256) and GAT (slots, W = 128, 384), each record ranked, finite and
   positive. 9e: 1028 seeded molhiv graphs written as OGB raw CSVs (binary
   labels; two tasks with blanks, gzipped), ``convert`` with and without
   ``--eigen``, read back equal; ``accuracy`` for GIN and DGN (ROC-AUC) and
   GIN's AP on the two-task set: each metric finite, the model's kernel
   counted, its scores held to the f32 plain path; the phase's seconds;
10. the fixed mode (the ap_fixed emulation, ``Precision(fixed=...)``, each
   model at its registry grid: DGN ap_fixed<16,3>, the rest <16,6>; f32),
   every launch count set to 0 before each pass and read after. 10a: all
   six models over the 4113-graph molhiv stream in the edge-block layout:
   row 24 launched once per layer and bucket and no other kernel, the
   predictions finite, on the grid, in range, equal bits in a second pass,
   within ``FIXED_ULPS`` grid ulps of the same pass with row 24's plain
   version on the card (GIN and GIN-VN bit-equal), and their envelope max
   |fixed − float| / max(1, |float|) against the f32 plain path printed
   beside the JAX test's 0.15 (DGN 0.6), gated for ``FIXED_ENVELOPE``'s
   models (``run_fixed``). 10b: the same stream in the slot layout, where
   no kernel launches (the plain loop), each graph within ``FIXED_ULPS`` of
   10a's. Each pass timed (µs/graph, CUDA events, eager) beside the f32
   plain path and the f32 edge-block kernel path, with the card's name and
   power limit. 10c: ``InferenceStream`` in the fixed mode for GIN and DGN
   over 8192 molhiv graphs, two weight sets flipped halfway: one CUDA graph
   captured per (signature, weight set), no launch, ``run`` and
   ``run_pipelined`` and each bucket's eager forward within ``FIXED_ULPS``
   (``check_fixed_stream``); the phase's seconds.

No phase runs at a cut depth, and phase 8b runs the host application on
8192 graphs at one trial (its defaults are 16384 and three: cut to keep the
phase near 90 s): the whole run takes about nine minutes on an H100, phase
9 about 40 s of it, phase 10 about 15 s. The line before the last is a JSON object with one record per
kernel; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside the repository, it exits non-zero before printing
either.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import subprocess
import sys
import time

from flowgnn_tpu_torch.bench.timing import cuda_ms, graph_ms

SEED = 0
NODE_CAP, GRAPH_CAP = 32768, 2048  # the JAX bench's bucket capacities
STREAM_GRAPHS = 4113  # molhiv's graph count
HEP_GRAPHS = 2048  # the JAX bench's default hep10k sample (bench.py)
SPILL_WINDOW = 128  # the JAX bench's --ell-window 128 on hep10k
# The JAX bench's slot window on hep10k: every graph fits its default ELL
# window, so GIN, GIN-VN, PNA, GAT and DGN take local_slots there
# (bench.py:180-194), in one whole-model launch per bucket (rows 1, 3, 5 and
# 4); GCN's slot path at that window runs row 2 once per bucket.
HEP_SLOT_WINDOW = 512
HEP_SLOT_MODELS = ("gin", "gin-vn", "gcn", "pna", "dgn", "gat")
MODELS = ("gin", "gin-vn", "gcn", "pna", "dgn", "gat")
ELL_MODELS = ("gin", "gin-vn", "gcn")
SPILL_MODELS = ("pna", "dgn", "gat")
SLOTS, ELL = "local_slots", "local_ell"
HEP_SLOTS = "local_slots W=512"  # the hep10k slot stream at HEP_SLOT_WINDOW
# The per-layer ELL paths' stream keys: hep10k at W=128 with an ELL spill
# tail, and molhiv's ELL stream run with return_intermediates; and molhiv's
# slot stream run with return_intermediates (PNA's row 20).
ELL_LAYER, ELL_INTER = "local_ell W=128", "local_ell intermediates"
SLOT_INTER = "local_slots intermediates"
# The hep10k slot stream at W=512 run with return_intermediates: PNA's row 20
# and DGN's row 22 once per layer and bucket, where rows 3 and 4 run once per
# bucket without intermediates.
HEP_SLOT_INTER = "local_slots W=512 intermediates"
HEP_INTER_MODELS = ("pna", "dgn")
# The edge-block layout (as_batch(blocked=True), unaligned packing), the
# same with GIN's fused layer, the legacy local layout, GIN's ELL stream
# driven layer by layer with per-lane bond embeddings (row 12), and GAT's
# ELL streams with its fused layer (row 23).
BLOCKED, FUSED, LOCAL = "blocked", "blocked fused", "local"
ELL_EE = "local_ell ee"
# Phase 7: GIN's ELL stream driven layer by layer with its messages from row
# 31 (the messages-only form of row 13) and row 13's epilogue in plain torch.
ELL_MSG = "local_ell messages"
ROW31 = "gin_local_message_ell"  # row 13's messages-only form
PASS = "gin_local_message_ell_lanes"  # row 12's messages-only form: the ELL stage bench's
ELL_FUSED, ELL_LAYER_FUSED = "local_ell fused", "local_ell W=128 fused"
PLAIN = "plain edge list"  # --profile: a stream's plain batches, beside its layout's
BIG = "molhiv + 300-node graphs"  # one bucket whose large graphs cross windows
INTER_MODELS = ("gin", "gcn")
# The models with an ELL path: GIN, GIN-VN and GCN through their whole-model
# or per-layer ELL kernels, DGN and GAT through their per-layer ones.
LAYER_MODELS = ELL_MODELS + ("dgn", "gat")
# H100 SXM peaks (NVIDIA's data sheet): dense bf16 on the tensor cores,
# float32 outside them, and the HBM3 rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MEM_BYTES_PER_S = 3.35e12
# Each model's kernels: its whole-model slot kernel, its whole-model ELL
# kernel, its per-layer slot kernel with a spill tail and without one (a
# slot batch the whole-model kernel does not take; None: the plain loop).
MODEL_KERNELS = {
    "gin": ("gin_local_model_slots", "gin_local_model", None, None),
    "gin-vn": ("gin_local_model_slots", "gin_local_model", None, None),
    "gcn": ("gcn_local_model_slots", "gcn_local_model", None, None),
    "pna": ("pna_local_model", None, "pna_local_stats_ell", "pna_local_layer"),
    "dgn": ("dgn_local_model", None, "dgn_local_layer_slots", "dgn_local_layer_slots"),
    "gat": ("gat_local_model_slots", None, "gat_local_message_slots", "gat_local_message_slots"),
}
# Each model's per-layer ELL kernel: (without a spill tail, with one).
ELL_LAYER_KERNELS = {
    "gin": ("gin_local_layer_ell",) * 2, "gin-vn": ("gin_local_layer_ell",) * 2,
    "gcn": ("gcn_local_layer_ell", "gcn_local_message_ell"),
    "dgn": ("dgn_local_layer_ell", "dgn_local_message_ell"),
    "gat": ("gat_local_message_ell",) * 2,
}
SCATTER = "windowed_segment_sum"  # the spill tail's, beside every per-layer kernel
# Paths whose TPU kernels round where the plain edge-list path does not: DGN's
# ELL rows 16 and 18 round each lane's eig_u·h_u to bf16 before the factored
# m2 = Σ eig_u·h_u − eig_v·Σ h_u, which cancels, and |m2 − ews·h|·inva
# multiplies the residual by up to 8192. In bf16 their gate also takes 1.5×
# what the path needs with every kernel replaced by its plain version, and
# the kernel path is held to that path at 5e-2 (``run_main_path``). So is
# DGN's per-layer slot path with intermediates on hep10k at W=512: row 22
# rounds the two channels to bf16 (its m2 the factored one in f32), the plain
# path each lane's (eig_u − eig_v)·h_u and its bf16 sums, and a few entries
# of each layer's h, whose |m2 − ews·h| cancels and is multiplied by up to
# 8192, land apart on the two; there every intermediate's gate takes 1.5×
# what the path with its kernels' plain versions needs. So is row 31's layer
# loop (ELL_MSG): row 31 rounds each row's message sum to bf16 before the
# spill tail's messages are added, as the JAX halo branch does, where row 13
# and the plain path add them unrounded.
KERNEL_ROUNDING = {("dgn", "molhiv", ELL), ("dgn", "hep10k", ELL_LAYER),
                   ("dgn", "hep10k", HEP_SLOT_INTER), ("gin", "hep10k", ELL_MSG)}
PROFILE_PASSES = 3  # traced passes per path (--profile)
PER_LAYER = {"pna_local_stats_ell", "dgn_local_layer_slots", "gat_local_message_slots", SCATTER,
             "gin_local_layer_ell", "gcn_local_message_ell", "gcn_local_layer_ell",
             "pna_local_layer", "dgn_local_layer_ell", "dgn_local_message_ell",
             "gat_local_message_ell", "gin_local_layer", "gin_local_layer_ell_lanes",
             "gin_layer_fused", "gat_local_layer_ell", ROW31}
ROW12 = "gin_local_layer_ell_lanes"
LL = "flowgnn_tpu/ops/pallas/local_layer.py"
BENCH = "flowgnn_tpu_torch.bench"
# Kernel → (its module in flowgnn_tpu_torch.ops, source, the TPU kernel it
# replaces, the (model, profile, layout) path whose bf16 stream gives the
# record's times and bound).
KERNELS = {
    "gin_local_model_slots": ("local_layer", "flowgnn_tpu_torch/csrc/gin_local_model_slots.cu",
                              f"{LL}:944", ("gin", "molhiv", SLOTS)),
    "gcn_local_model_slots": ("local_layer", "flowgnn_tpu_torch/csrc/gcn_local_model_slots.cu",
                              f"{LL}:1178", ("gcn", "molhiv", SLOTS)),
    "pna_local_model": ("local_layer", "flowgnn_tpu_torch/csrc/pna_local_model.cu",
                        f"{LL}:2062", ("pna", "molhiv", SLOTS)),
    "dgn_local_model": ("local_layer", "flowgnn_tpu_torch/csrc/dgn_local_model.cu",
                        f"{LL}:3104", ("dgn", "molhiv", SLOTS)),
    # One kernel for the three GAT megakernels, which compute one function.
    "gat_local_model_slots": (
        "local_layer", "flowgnn_tpu_torch/csrc/gat_local_model_slots.cu",
        f"{LL}:2567 (gat_local_model_pairs), :2350 (gat_local_model_slots), "
        ":2835 (gat_local_model_dense)", ("gat", "molhiv", SLOTS),
    ),
    "gin_local_model": ("local_layer", "flowgnn_tpu_torch/csrc/gin_local_model.cu",
                        f"{LL}:576", ("gin", "hep10k", ELL)),
    "gcn_local_model": ("local_layer", "flowgnn_tpu_torch/csrc/gcn_local_model.cu",
                        f"{LL}:767", ("gcn", "hep10k", ELL)),
    "pna_local_stats_ell": ("local_layer", "flowgnn_tpu_torch/csrc/pna_local_stats_slots.cu",
                            f"{LL}:1898", ("pna", "hep10k", SLOTS)),
    "dgn_local_layer_slots": ("local_layer", "flowgnn_tpu_torch/csrc/dgn_local_layer_slots.cu",
                              f"{LL}:3000", ("dgn", "hep10k", SLOTS)),
    "gat_local_message_slots": ("local_layer",
                                "flowgnn_tpu_torch/csrc/gat_local_message_slots.cu",
                                f"{LL}:2250", ("gat", "hep10k", SLOTS)),
    SCATTER: ("spmm", "flowgnn_tpu_torch/csrc/windowed_segment_sum.cu",
              "flowgnn_tpu/ops/pallas/spmm.py:62", ("pna", "hep10k", SLOTS)),
    # Row 13 with its GIN epilogue; row 11 (wps windows per step) merged in.
    "gin_local_layer_ell": (
        "local_layer", "flowgnn_tpu_torch/csrc/gin_local_layer_ell.cu",
        f"{LL}:385 (local_scatter_apply_ell_attr, gin_local_layer_ell epilogue :506), "
        ":165 (_local_scatter_apply_ell_wps)", ("gin", "hep10k", ELL_LAYER),
    ),
    "gcn_local_message_ell": ("local_layer", "flowgnn_tpu_torch/csrc/gcn_local_message_ell.cu",
                              f"{LL}:1333", ("gcn", "hep10k", ELL_LAYER)),
    "gcn_local_layer_ell": ("local_layer", "flowgnn_tpu_torch/csrc/gcn_local_layer_ell.cu",
                            f"{LL}:1417", ("gcn", "molhiv", ELL_INTER)),
    "pna_local_layer": ("local_layer", "flowgnn_tpu_torch/csrc/pna_local_layer_slots.cu",
                        f"{LL}:1968", ("pna", "molhiv", SLOT_INTER)),
    "dgn_local_layer_ell": ("local_layer", "flowgnn_tpu_torch/csrc/dgn_local_layer_ell_model.cu",
                            f"{LL}:1737", ("dgn", "molhiv", ELL)),
    "dgn_local_message_ell": ("local_layer", "flowgnn_tpu_torch/csrc/dgn_local_layer_ell.cu",
                              f"{LL}:1539", ("dgn", "hep10k", ELL_LAYER)),
    "gat_local_message_ell": ("local_layer", "flowgnn_tpu_torch/csrc/gat_local_message_ell.cu",
                              f"{LL}:1612", ("gat", "hep10k", ELL_LAYER)),
    # Rows 10 and 12: one kernel behind two wrappers.
    "gin_local_layer": (
        "local_layer", "flowgnn_tpu_torch/csrc/gin_local_layer_blocks.cu",
        f"{LL}:40 (local_scatter_apply, gin_local_layer epilogue :118)", ("gin", "molhiv", LOCAL),
    ),
    ROW12: ("local_layer", "flowgnn_tpu_torch/csrc/gin_local_layer_blocks.cu",
            f"{LL}:305 (local_scatter_apply_ell)", ("gin", "molhiv", ELL_EE)),
    "gat_local_layer_ell": ("local_layer", "flowgnn_tpu_torch/csrc/gat_local_layer_ell.cu",
                            f"{LL}:3284", ("gat", "hep10k", ELL_LAYER_FUSED)),
    "gin_layer_fused": (
        "fused_layer", "flowgnn_tpu_torch/csrc/gin_layer_fused.cu",
        "flowgnn_tpu/ops/pallas/fused_layer.py:26 (windowed_scatter_apply, gin_layer_fused "
        "epilogue :97)", ("gin", "molhiv", FUSED),
    ),
    # Phase 7: the messages-only forms of rows 13 and 12; row 31 on GIN's
    # hep10k W=128 ELL stream driven through it, row 12's pass-through on the
    # bench entry's ELL stage (its record on the same stream).
    ROW31: ("local_layer", "flowgnn_tpu_torch/csrc/gin_local_message_ell.cu",
            f"{LL}:479 (gin_local_message_ell, row 13's pallas_call :456)",
            ("gin", "hep10k", ELL_MSG)),
    PASS: ("local_layer", "flowgnn_tpu_torch/csrc/gin_local_message_lanes.cu",
           f"{LL}:305 (local_scatter_apply_ell, with the pass-through epilogue of "
           "flowgnn_tpu/bench/spmm_stage.py:84)", None),
    # The bench tools' kernels (phase 6): a module path, and no model path.
    "chained_matmul": (f"{BENCH}.matmul_shapes", "flowgnn_tpu_torch/csrc/chained_matmul.cu",
                       "flowgnn_tpu/bench/matmul_shapes.py:49", None),
    "gat_mega_ablate": (f"{BENCH}.ablate_gat_mega", "flowgnn_tpu_torch/csrc/gat_mega_ablate.cu",
                        "flowgnn_tpu/bench/ablate_gat_mega.py:50, :224, :428, :558", None),
}
# Phase 6: the matmul-shape record's SHAPES row, the ablation's bucket and its
# record's (form, variant), and the timing reps of the two tools' main runs.
CHAIN_RECORD = 0  # "gin gather/scatter [896,384]@[384,128]", bf16
ABLATION_GRAPHS = 1028  # the JAX tool's default bucket
ABLATION_RECORD = ("v3", "full")
# Phase 6b's cluster window: every form's full, nogather, noglue and nopool
# there (those it has), and the tool's main run once more at it.
ABLATION_WIDE = 512
ABLATION_WIDE_VARIANTS = ("full", "nogather", "noglue", "nopool")
TOOL_REPS, TOOL_TRIALS = 20, 2
# Phase 7b: the bench entry's runs, in-process, each with these reps and
# trials: all six models on each dataset profile's default stream, and GIN
# on hep10k at W=128, whose slot stream spills and falls back to ELL (the
# ELL stage bench: row 12's pass-through).
ENTRY_RUNS = (["--dataset", "molhiv"], ["--dataset", "molpcba"], ["--dataset", "hep10k"],
              ["--dataset", "hep10k", "--model", "gin", "--ell-window", "128"])
ENTRY_REPS, ENTRY_TRIALS = 2, 3  # few reps: phases 1-7a take ~7.5 min of the run
# Phase 7a: the messages-only forms' libraries and their occupancy geometry
# (row 31: (D, vocab); the pass-through: (D,)), beside row 13's.
MESSAGE_OCCUPANCY = {"gin_local_message_ell": (100, 13), "gin_local_message_lanes": (100,),
                     "gin_local_layer_ell": (100, 200, 13)}


# Phase 8: the streaming runtime over the molhiv stream with two weight sets
# (synthetic seeds SEED and SEED + 1) flipped halfway; GIN's stream also over
# MANY_SETS weight sets, one 64-graph bucket each, more than the weight-chunk
# cache keeps (ops.local_layer.MLP_TILE_SETS); and the host application's main
# on HOST_APP_GRAPHS graphs, its weight sets flipped halfway, one trial (its
# defaults are 16384 graphs and 3 trials: cut to keep the phase near 90 s).
MANY_SETS, MANY_GRAPHS = 10, 64
HOST_APP_GRAPHS = 8192
HOST_APP_FIGURES = ("value", "sequential_us_per_graph", "pipeline_speedup", "buckets",
                    "dispatches", "dispatch_floor_ms", "pack_ms_per_bucket",
                    "replay_ms_per_bucket", "device_share", "captured_graphs")
# Phase 9: the experiment CLI (flowgnn_tpu_torch.cli) in-process. 9a: run over
# all six models on the 4113-graph molhiv stream (its synth dataset), CLI_TRIALS
# trials; 9b: GIN on the hep10k sample at W=512 and GCN's edge-block layout;
# 9c: a traced run; 9d: tune; 9e: convert and accuracy on CLI_OGB_GRAPHS
# graphs written as OGB raw CSVs. CLI_SMALL: the graphs of 9b's blocked run,
# 9c and 9d.
CLI_TRIALS = 3
CLI_SMALL = 1028
CLI_OGB_GRAPHS = 1028
CLI_TUNES = (("gin", "128,256"), ("gat", "128,384"))
ROW1_SYMBOL = "gin_model_kernel"  # row 1's (and row 8's) CUDA kernel, csrc/gin_model.cuh
# Phase 10: the fixed mode (the ap_fixed emulation, each model at its
# registry grid, f32 compute). FIXED_ULPS: the largest difference, in grid
# ulps, that 10a's predictions may show against the same pass with row 24's
# plain version on the card (which sums with index_add_'s atomics in any
# order, where row 24 sums each row in lane order), and that 10b's and 10c's
# may show against 10a's and the stream's eager forward: GIN's and GIN-VN's
# messages are grid values whose sums are exact in f32 in any order, so 0;
# the other models' messages are products, whose f32 sums round by order,
# and a floor that moves carries into later layers.
FIXED_ULPS = {"gin": 0, "gin-vn": 0, "gcn": 4, "pna": 4, "dgn": 32, "gat": 4}
# The JAX test's envelope, max |fixed − float| / max(1, |float|), fixed
# against the f32 plain path (tests/test_fixed_point.py:50-53), gated where
# the CPU tests show the seeded weights inside it (tests/test_torch_fixed.py):
# GIN's and GIN-VN's leave it (their float predictions reach 9 and 3319 on
# molhiv, GIN-VN's virtual-node sums saturate), and are printed only.
FIXED_ENVELOPE = {"gcn": 0.15, "pna": 0.15, "dgn": 0.6, "gat": 0.15}
# Phase 10c: the stream in the fixed mode over this many molhiv graphs, two
# weight sets flipped halfway, for these models.
FIXED_STREAM_GRAPHS = 8192
FIXED_STREAM_MODELS = ("gin", "dgn")


# Phase 2: the libraries whose SASS must hold tensor-core (HGMMA) and
# bulk-copy or TMA instructions (UBLKCP / UTMALDG), and the instructions
# counted in every library's SASS.
SASS_NEEDS = {"chained_matmul": ("HGMMA", "UBLKCP|UTMALDG"),
              **{k: ("HGMMA", "UBLKCP") for k in ("gin_local_model", "gin_local_model_slots",
                                                  "gin_local_layer_ell", "gcn_local_model",
                                                  "gcn_local_model_slots", "pna_local_model",
                                                  "dgn_local_model", "gat_local_model_slots",
                                                  "pna_local_layer_slots",
                                                  "dgn_local_layer_slots",
                                                  "dgn_local_layer_ell_model",
                                                  "gcn_local_layer_ell",
                                                  "gin_local_layer_blocks", "gin_layer_fused",
                                                  "gat_local_layer_ell", "gat_mega_ablate")}}
SASS_OPS = ("HGMMA", "UBLKCP", "UTMALDG", "HMMA", "IMMA", "FFMA")
# Phase 3: the (D, H) at which the tensor-core GIN kernels (rows 1, 8, 13)
# are held to their plain versions: H' and D' padded, the models' own, and
# H=512, whose 16 weight chunks a layer stream through a shorter ring.
GIN_WIDTHS = ((36, 72), (100, 200), (100, 512))
# Phase 3f: row 23's (H·D, heads) beside GIN_WIDTHS for rows 10, 12 and 25:
# the model's 4 × 16, and 3 × 16, whose K' pads 48 to 64.
GAT_WIDTHS = ((64, 4), (48, 3))
# Phase 3f: rows 10, 12, 23 and 25 at W=128 (molhiv) and at W=1024, a
# synthetic ELL bucket of graphs of this many nodes.
BLOCK_BIG = 900
# Phase 3f: the per-layer kernels' occupancy geometry (``local_layer.
# layer_occupancy``): GIN (D, H) (row 13 (D, H, vocab)) at the models' H
# and at H=512, GAT (H·D, heads).
LAYER_OCCUPANCY = {"gin_local_layer_ell": ((100, 200, 13), (100, 512, 13)),
                   "gin_local_layer_blocks": ((100, 200), (100, 512)),
                   "gin_layer_fused": ((100, 200), (100, 512)),
                   "gat_local_layer_ell": ((64, 4), (48, 3))}
# Phase 5f: each tensor-core kernel's cells, timed bf16 (wgmma) and f32 (FMA)
# in turns.
TURN_CELLS = {
    "gin_local_model": [("gin", "hep10k", ELL), ("gin-vn", "hep10k", ELL),
                        ("gin", "molhiv", ELL), ("gin-vn", "molhiv", ELL)],
    "gin_local_model_slots": [("gin", "molhiv", SLOTS), ("gin-vn", "molhiv", SLOTS),
                              ("gin", "hep10k", HEP_SLOTS)],
    "gin_local_layer_ell": [("gin", "hep10k", ELL_LAYER), ("gin-vn", "hep10k", ELL_LAYER),
                            ("gin", "molhiv", ELL_INTER)],
    "gcn_local_model": [("gcn", "hep10k", ELL), ("gcn", "molhiv", ELL)],
    "pna_local_model": [("pna", "molhiv", SLOTS), ("pna", "hep10k", HEP_SLOTS)],
    **{MODEL_KERNELS[name][0]: [(name, "molhiv", SLOTS), (name, "hep10k", HEP_SLOTS)]
       for name in ("gcn", "dgn", "gat")},
    # Rows 20 and 22 on their record cells and on the hep10k W=512 stream.
    "pna_local_layer": [("pna", "molhiv", SLOT_INTER), ("pna", "hep10k", HEP_SLOT_INTER)],
    "dgn_local_layer_slots": [("dgn", "hep10k", SLOTS), ("dgn", "hep10k", HEP_SLOT_INTER)],
    # Rows 23, 10, 12 and 25 on their cells; row 18 on DGN's molhiv ELL stream,
    # row 15 on GCN's, run with intermediates.
    "gat_local_layer_ell": [("gat", "hep10k", ELL_LAYER_FUSED), ("gat", "molhiv", ELL_FUSED)],
    "dgn_local_layer_ell": [("dgn", "molhiv", ELL)],
    "gcn_local_layer_ell": [("gcn", "molhiv", ELL_INTER)],
    "gin_local_layer": [("gin", "molhiv", LOCAL), ("gin-vn", "molhiv", LOCAL)],
    ROW12: [("gin", "molhiv", ELL_EE)],
    "gin_layer_fused": [("gin", "molhiv", FUSED)],
}
# Phase 5g: the kernels split by stage, on these cells: each timed whole and
# with its product (bit 0), its messages, stats or channels (bit 1), or both
# knocked out; rows 17, 21, 14, 16, 19 and 24, which have no product
# (MESSAGES_ONLY), with their messages, channels, stats or sums out.
SPLIT_CELLS = {"gcn_local_model": [("gcn", "hep10k", ELL), ("gcn", "molhiv", ELL)],
               **{MODEL_KERNELS[name][0]: [(name, "molhiv", SLOTS), (name, "hep10k", HEP_SLOTS)]
                  for name in ("pna", "dgn", "gat")},
               **{k: TURN_CELLS[k] for k in ("pna_local_layer", "dgn_local_layer_slots",
                                             "gat_local_layer_ell", "gin_local_layer", ROW12,
                                             "gin_layer_fused", "dgn_local_layer_ell",
                                             "gcn_local_layer_ell")},
               "gat_local_message_ell": [("gat", "hep10k", ELL_LAYER), ("gat", "molhiv", ELL)],
               "gat_local_message_slots": [("gat", "hep10k", SLOTS), ("gat", "molhiv", SLOT_INTER)],
               "gcn_local_message_ell": [("gcn", "hep10k", ELL_LAYER)],
               "dgn_local_message_ell": [("dgn", "hep10k", ELL_LAYER)],
               "pna_local_stats_ell": [("pna", "hep10k", SLOTS)],
               SCATTER: [("pna", "hep10k", SLOTS), ("gcn", "hep10k", ELL_LAYER),
                         ("gin", "molhiv", BLOCKED)]}
MESSAGES_ONLY = ("gat_local_message_ell", "gat_local_message_slots", "gcn_local_message_ell",
                 "dgn_local_message_ell", "pna_local_stats_ell", SCATTER)
# Phases 5 to 5e: the per-layer kernels whose loop of wrapper calls can time
# the wrappers' host work, also timed by graph replay: rows 14, 15, 16, 17,
# 18, 19, 21 and 24.
REPLAYED = ("gcn_local_message_ell", "gcn_local_layer_ell", "dgn_local_message_ell",
            "gat_local_message_ell", "dgn_local_layer_ell", "pna_local_stats_ell",
            "gat_local_message_slots", SCATTER, ROW31)
# Phase 3: the cluster slot kernels' windows beside molhiv's W=128 (rows 2,
# 3, 4 and 5): a synthetic bucket of 250-node graphs (W=256) and the hep10k
# slot bucket with the largest graph (W=512).
CLUSTER_BIG = 250
CLUSTER_MODELS = ("gcn", "pna", "dgn", "gat")
# Phase 3: each cluster kernel's occupancy geometry at the models' widths
# (``local_layer.occupancy``, keyed by library): GCN (D, vocab), DGN (D,),
# GAT (H·D, heads), PNA's rows 20 and 19 (D,) (row 19 at 8 slots).
OCCUPANCY = {"gcn_local_model": (100, 13), "gcn_local_model_slots": (100, 13),
             "dgn_local_model": (100,), "gat_local_model_slots": (64, 4),
             "pna_local_layer_slots": (80,), "dgn_local_layer_slots": (100,),
             "dgn_local_layer_ell_model": (100,), "gcn_local_layer_ell": (100, 13),
             "gcn_local_message_ell": (100, 13), "dgn_local_layer_ell": (100,),
             "pna_local_stats_slots": (80,)}
# Phase 3e: rows 20, 22 and 19 at every window their clusters take, beside
# molhiv's W=128 and the hep10k bucket's W=512: (the large graphs' nodes,
# the window) of the synthetic buckets; rows 18, 15 and 16 on such ELL
# buckets at W = 256, 512 and 1024 (k = 2 there).
LAYER_WINDOWS = ((250, 256), (900, 1024))
ELL_LAYER_WINDOWS = ((250, 256), (400, 512), (900, 1024))
# Rows 19 and 16's operands, the part of rows 20 and 18's that they take.
STATS_KEYS = ("slot_src", "h", "window", "slots", "min_init", "max_init")
CHANNEL_KEYS = ("ell_meta", "h", "eig", "window")
# Phase 3e: DGN's spilling W=256 bucket, its hub nodes' in-window in-degree
# past the 8 slots.
HUB_DEGREE = 12
# Phase 3f: row 24's long run, in lists of the kernel's chunk: (the hub row's
# lanes, the other rows' lanes, the sentinel lanes), as multiples of it, and
# the windows it runs at.
LONG_RUN = ((1.25, 3, 0.3), (128, 512))


def cuobjdump_path() -> str:
    """``cuobjdump`` from ``$CUDA_HOME``, the default toolkit, PATH or the
    ``triton`` package's copy."""
    import os
    import shutil

    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "cuobjdump"), os.X_OK):
            return os.path.join(home, "bin", "cuobjdump")
    found = shutil.which("cuobjdump")
    if found:
        return found
    import importlib.util

    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        path = os.path.join(os.path.dirname(spec.origin), "backends", "nvidia", "bin", "cuobjdump")
        if os.access(path, os.X_OK):
            return path
    raise RuntimeError("cuobjdump not found")


def sass_counts(so) -> dict:
    """Per instruction of ``SASS_OPS``, how many times it stands in the
    library's SASS (``cuobjdump -sass``)."""
    import re

    sass = subprocess.run([cuobjdump_path(), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


def check_sass(libs) -> None:
    """Phase 2's SASS check: each library's instruction counts printed; the
    tensor-core kernels (``SASS_NEEDS``) must hold their instructions."""
    for so in libs:
        name = so.name.rsplit("-", 1)[0]
        counts = sass_counts(so)
        print(f"# sass {name}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
        for need in SASS_NEEDS.get(name, ()):
            check(sum(counts[op] for op in need.split("|")) > 0,
                  f"{name}: no {need} instruction in its SASS")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper the models (and ``row31_forward``, through
    ``ops.local_layer``, and ``segment_sum_blocked``, through ``ops.spmm``)
    call replaced by its plain version, which runs on the card as plain
    torch (no launch is counted)."""
    from flowgnn_tpu_torch.models import base, dgn, gat, gcn, gin, pna
    from flowgnn_tpu_torch.ops import local_layer, spmm

    saved = [(mod, k, getattr(mod, k)) for mod in (base, dgn, gat, gcn, gin, pna, local_layer,
                                                    spmm)
             for k in KERNELS if hasattr(mod, k)]
    for mod, k, _ in saved:
        setattr(mod, k, kernel_fn(k, plain=True))
    try:
        yield
    finally:
        for mod, k, fn in saved:
            setattr(mod, k, fn)


def kernel_fn(kname: str, plain: bool = False):
    """A kernel's wrapper, or its plain version."""
    import importlib

    mod = KERNELS[kname][0]
    mod = importlib.import_module(mod if "." in mod else f"flowgnn_tpu_torch.ops.{mod}")
    return getattr(mod, f"{kname}_ref" if plain else kname)


def model_module(name: str):
    from flowgnn_tpu_torch.models import dgn, gat, gcn, gin, pna

    return {"gin": gin, "gin-vn": gin, "gcn": gcn, "pna": pna, "dgn": dgn, "gat": gat}[name]


def num_layers(name: str) -> int:
    from flowgnn_tpu_torch.models import registry

    return registry.get(name).num_layers


def forward_kw(key: tuple) -> dict:
    """The forward's keyword arguments on a path: intermediates on ELL_INTER,
    SLOT_INTER, HEP_SLOT_INTER, ELL_EE and ELL_MSG (whose layer loops return
    them), GIN's fused layer on FUSED, GAT's on ELL_FUSED and
    ELL_LAYER_FUSED."""
    if key[2] in (ELL_INTER, SLOT_INTER, HEP_SLOT_INTER, ELL_EE, ELL_MSG):
        return dict(return_intermediates=True)
    if key[2] == FUSED:
        return dict(fused=True)
    return dict(fuse_layers=True) if key[2] in (ELL_FUSED, ELL_LAYER_FUSED) else {}


def path_forward(key: tuple):
    """The entry a path drives: the model's ``forward``, or on ELL_EE and
    ELL_MSG the layer-by-layer loops over row 12 and row 31."""
    from flowgnn_tpu_torch.models import registry

    return {ELL_EE: row12_forward, ELL_MSG: row31_forward}.get(key[2],
                                                              registry.get(key[0]).forward)


def row12_forward(params: dict, batch: dict, prec, return_intermediates: bool = True):
    """GIN over an ELL batch, layer by layer through
    ``gin_local_layer_ell(ee=...)`` (row 12): each ELL lane's bond embedding
    from ``bond_embed``, where row 13 sums the table rows inside the kernel,
    as the JAX ``gin_local_layer_ell`` without ``edge_attr`` is driven;
    returns the predictions and the intermediates, as ``gin.forward`` does."""
    from flowgnn_tpu_torch.models import base, gin
    from flowgnn_tpu_torch.ops.local_layer import gin_local_layer_ell

    eps_all = gin.eps1_all(params, prec)
    meta, spill = base.ell_meta(batch), base.ell_spill(batch)
    h = base.atom_embed(params["node_embedding"], batch["node_feat"], prec)
    inter = [h]
    for l in range(params["mlp1_w"].shape[0]):
        h = gin_local_layer_ell(**gin.ell_layer_operands(params, batch, prec, l, h, meta, spill,
                                                         eps_all, lane_ee=True))
        inter.append(h)
    h_graph = base.mean_pool(h, batch, prec)
    out = base.linear(h_graph, params["pred_w"], params["pred_b"], prec)
    return out, {"layers": inter, "h_graph": h_graph}


def row31_forward(params: dict, batch: dict, prec, return_intermediates: bool = True):
    """GIN over an ELL batch, layer by layer, each layer's messages from
    ``gin_local_message_ell`` (row 31) and the rest of row 13's layer in
    plain torch (``local_layer.gin_epilogue``: the spill tail's and VN's
    messages, (1+ε)·h and the MLP), as the JAX GIN's halo branch runs row
    31 beside its boundary exchange; returns the predictions and the
    intermediates, as ``gin.forward`` does."""
    from flowgnn_tpu_torch.models import base, gin
    from flowgnn_tpu_torch.ops import local_layer

    eps_all = gin.eps1_all(params, prec)
    meta, spill = base.ell_meta(batch), base.ell_spill(batch)
    h = base.atom_embed(params["node_embedding"], batch["node_feat"], prec)
    inter = [h]
    for l in range(params["mlp1_w"].shape[0]):
        ops = gin.ell_layer_operands(params, batch, prec, l, h, meta, spill, eps_all)
        m = local_layer.gin_local_message_ell(meta, ops["ee_table"], h, ops["window"])
        acc = base.acc_dtype(prec)
        h = local_layer.gin_epilogue(m.to(acc), h.to(acc), ops["m_spill"],
                         *(ops[k] for k in ("w1", "b1", "w2", "b2", "eps1", "final_relu")),
                         prec.compute_dtype)
        inter.append(h)
    h_graph = base.mean_pool(h, batch, prec)
    out = base.linear(h_graph, params["pred_w"], params["pred_b"], prec)
    return out, {"layers": inter, "h_graph": h_graph}


def bucket_launches(name: str, batch: dict, kw: dict | None = None) -> dict:
    """The launches one bucket's forward (``kw``: its keyword arguments, as
    ``forward_kw`` gives them) must make, by kernel: the model's whole-model
    ELL or slot kernel once; for an ELL batch that kernel does not take (or a
    model without one), its per-layer ELL kernel once per layer, and with a
    spill tail the spill scatter too (GAT with ``fuse_layers``: row 23 for
    every layer but the last, row 17 for the last); for a slot batch with a
    spill tail, its per-layer slot kernel and the spill scatter once per
    layer; for one without a tail that the whole-model kernel does not take,
    its no-spill per-layer slot kernel once per layer (GIN and GCN: the plain
    loop); for an edge-block batch the windowed scatter once per layer (GIN
    with ``fused``: row 25 instead); for a legacy local batch GIN's and
    GIN-VN's row 10 once per layer, the other models nothing."""
    from flowgnn_tpu_torch.models import base

    kw = kw or {}
    inter = bool(kw.get("return_intermediates"))
    slot, ell, layer, layer0 = MODEL_KERNELS[name]
    L = num_layers(name)
    if "blk_vlocal" in batch:
        return {"gin_layer_fused" if kw.get("fused") and name == "gin" else SCATTER: L}
    if "loc_window" in batch:
        return {"gin_local_layer": L} if name in ("gin", "gin-vn") else {}
    if "loc_ell" in batch:
        if ell is not None and base.ell_megakernel(batch, inter):
            return {ell: 1}
        plain_k, spill_k = ELL_LAYER_KERNELS[name]
        tail = bool(base.ell_spill_lanes(batch))
        out = {spill_k if tail else plain_k: L}
        if kw.get("fuse_layers") and name == "gat":
            out = {"gat_local_layer_ell": L - 1, "gat_local_message_ell": 1}
        # A tail of pad lanes only has no blocked layout and no scatter.
        if tail and "spill_blk_vlocal" in batch:
            out[SCATTER] = L
        return out
    if not batch["slot_spill"].shape[-1]:
        if not inter and "pool_gl" in batch:
            return {slot: 1}
        return {layer0: L} if layer0 else {}
    return {layer: L, SCATTER: L}


def layer_operands(kname: str, name: str, params: dict, batch: dict, prec, kw: dict) -> dict:
    """Layer 0's keyword operands of the per-layer kernel ``kname`` on a
    path whose forward takes ``kw``: the model's ``layer_kernel_operands``
    with the path's ``fused`` / ``fuse_layers`` (the fused GAT path's last
    layer runs row 17, whose operands the unfused path gives); row 12's are
    row 13's with the bond embedding per lane and no table."""
    from flowgnn_tpu_torch.models import base, gin

    if kname in (ROW12, ROW31, PASS):
        h = base.atom_embed(params["node_embedding"], batch["node_feat"], prec)
        ops = gin.ell_layer_operands(params, batch, prec, 0, h, base.ell_meta(batch),
                                     base.ell_spill(batch), gin.eps1_all(params, prec),
                                     lane_ee=kname != ROW31)
        if kname == ROW31:
            return {k: ops[k] for k in ("ell_meta", "ee_table", "h", "window")}
        if kname == PASS:
            return {k: ops[k] for k in ("ee", "ell_meta", "h", "m_spill", "window")}
        return {k: v for k, v in ops.items() if k != "ee_table"}
    mod = model_module(name)
    op_kw = {k: v for k, v in kw.items() if k in ("fused", "fuse_layers")}
    ops = mod.layer_kernel_operands(params, batch, prec, **op_kw)
    return ops[kname] if kname in ops else mod.layer_kernel_operands(params, batch, prec)[kname]


def path_launches(key: tuple, batch: dict) -> dict:
    """``bucket_launches`` of one bucket on a path; ELL_EE's layer loop launches
    row 12 once per layer, ELL_MSG's row 31 once per layer (and the spill
    scatter, as row 13's path does)."""
    if key[2] == ELL_EE:
        return {ROW12: num_layers(key[0])}
    if key[2] == ELL_MSG:
        out = bucket_launches(key[0], batch, {"return_intermediates": True})
        return {ROW31 if k == "gin_local_layer_ell" else k: n for k, n in out.items()}
    return bucket_launches(key[0], batch, forward_kw(key))


def kernel_calls(kname: str, name: str, params: dict, batches: list, prec,
                 key: tuple | None = None) -> list:
    """The keyword operands of every launch of ``kname`` over a stream: a
    whole-model kernel's per bucket, a per-layer kernel's layer-0 operands
    per bucket, repeated as often as the path (``key``; None: the model's
    plain ``forward``) launches it on that bucket."""
    mod = model_module(name)
    if kname in PER_LAYER:
        key = key or (name, None, None)
        kw = forward_kw(key)
        return [o for b in batches
                for o in [layer_operands(kname, name, params, b, prec, kw)]
                for _ in range(path_launches(key, b)[kname])]
    return [(mod.ell_kernel_operands if "loc_ell" in b else mod.slot_kernel_operands)(
        params, b, prec) for b in batches]


def synthetic_params(name: str, seed: int) -> dict:
    from flowgnn_tpu_torch.params import loaders

    return {
        "gin": loaders.synthetic_gin_params, "gin-vn": loaders.synthetic_gin_params,
        "gcn": loaders.synthetic_gcn_params, "pna": loaders.synthetic_pna_params,
        "dgn": loaders.synthetic_dgn_params, "gat": loaders.synthetic_gat_params,
    }[name](seed)


_GRAPHS: dict = {}  # (model, profile, graphs) -> the transformed graphs
_PACKED: dict = {}  # (model, profile, graphs, packing window) -> (buckets, plain batches)


def make_stream(name: str, profile: str, num_graphs: int, layout, device,
                window: int | None = None):
    """The main path's host half for one model: (packed buckets, kernel
    batches in ``layout``, plain batches), the batches on ``device``. The
    window is ``choose_geometry``'s unless given; the ELL block is scaled
    to the window. The edge-block layout (``layout`` True) packs without
    window alignment, as the JAX bench's ``--layout blocked`` does. A
    packing two layouts share is made once."""
    from flowgnn_tpu_torch.core.graphs import auto_edge_capacity, pack_dataset
    from flowgnn_tpu_torch.core.synthetic import synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry

    spec = registry.get(name)
    gkey = (name, profile, num_graphs)
    if gkey not in _GRAPHS:
        _GRAPHS[gkey] = registry.apply_transforms(
            spec, synthetic_dataset(profile, seed=SEED, num_graphs=num_graphs))
    graphs = _GRAPHS[gkey]
    # A window given is paired with the block scaled to it, as the JAX bench
    # re-derives the block from --ell-window (bench.py:147-158).
    window, block = base.choose_geometry(name, window or max(g.num_nodes for g in graphs))
    align = None if layout is True else window
    if gkey + (align,) not in _PACKED:
        buckets = list(pack_dataset(
            graphs, node_capacity=NODE_CAP,
            edge_capacity=auto_edge_capacity(graphs, NODE_CAP),
            graph_capacity=GRAPH_CAP, with_eigen=spec.needs_eigen, align_window=align,
        ))
        _PACKED[gkey + (align,)] = (
            buckets, [base.to_device(base.as_batch(b), device) for b in buckets])
    buckets, plain = _PACKED[gkey + (align,)]
    batches = base.as_batches_uniform(buckets, blocked=layout, window=window, block=block)
    return buckets, [base.to_device(b, device) for b in batches], plain


def big_local_stream(name: str, device) -> tuple:
    """A one-bucket stream in the legacy local layout: 200 molhiv-shaped
    graphs and four of 300 nodes at W=128, whose crossing edges ride the
    layout's 8192-lane spill tail. (packed buckets, batches, plain batches)
    as ``make_stream`` gives them."""
    import numpy as np

    from flowgnn_tpu_torch.core.graphs import pack_graphs_aligned
    from flowgnn_tpu_torch.core.synthetic import random_molecule_graph, synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry

    rng = np.random.default_rng(SEED + 300)
    graphs = registry.apply_transforms(registry.get(name), (
        synthetic_dataset("molhiv", seed=SEED, num_graphs=200)
        + [random_molecule_graph(rng, num_nodes=300) for _ in range(4)]
    ))
    packed = pack_graphs_aligned(graphs, node_capacity=8191, edge_capacity=32768,
                                 graph_capacity=256, window=base.PALLAS_WINDOW)
    return ([packed], [base.to_device(base.as_batch(packed, blocked=LOCAL), device)],
            [base.to_device(base.as_batch(packed), device)])


def big_graph_stream(name: str, big: int, device, layout=ELL, window: int | None = None,
                     hub: int = 0) -> tuple:
    """A one-bucket stream of 200 molhiv-shaped graphs and four of ``big``
    nodes (with ``hub``, each large graph's first three nodes bonded to
    ``hub`` more nodes, so that their in-window in-degree passes the 8 slots
    and the extra edges ride the spill tail) in ``layout``, at ``window`` or
    the window ``choose_geometry`` gives them: (packed buckets, batches,
    plain batches) as ``make_stream`` gives them, on ``device``. A slot
    bucket spills exactly when ``hub`` is set."""
    import numpy as np

    from flowgnn_tpu_torch.core.graphs import pack_graphs_aligned
    from flowgnn_tpu_torch.core.synthetic import random_molecule_graph, synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry

    rng = np.random.default_rng(SEED + big + hub)
    bigs = [random_molecule_graph(rng, num_nodes=big) for _ in range(4)]
    if hub:
        bigs = [with_hubs(g, hub, rng) for g in bigs]
    spec = registry.get(name)
    graphs = registry.apply_transforms(
        spec, synthetic_dataset("molhiv", seed=SEED, num_graphs=200) + bigs)
    block = None  # the ELL block: choose_geometry's, scaled to its window
    if window is None:
        window, block = base.choose_geometry(name, max(g.num_nodes for g in graphs))
    packed = pack_graphs_aligned(graphs, node_capacity=max(8191, 16 * window - 1),
                                 edge_capacity=32768, graph_capacity=256, window=window,
                                 with_eigen=spec.needs_eigen)
    batch = base.as_batch(packed, blocked=layout, window=window, block=block)
    check(layout != SLOTS or ("slot_meta" in batch) != bool(hub),
          f"{name}: the W={window} slot bucket {'does not spill' if hub else 'spills'}")
    return ([packed], [base.to_device(batch, device)],
            [base.to_device(base.as_batch(packed), device)])


def big_graph_bucket(name: str, big: int, device, layout=ELL) -> dict:
    """``big_graph_stream``'s bucket at the window ``choose_geometry`` gives
    it."""
    return big_graph_stream(name, big, device, layout)[1][0]


def with_hubs(g, degree: int, rng):
    """``g`` with its first three nodes each bonded to ``degree`` more of its
    nodes (both directions, random bond attributes): an in-degree past the
    slot layout's 8 slots."""
    import numpy as np

    from flowgnn_tpu_torch.core.features import BOND_FEATURE_DIMS
    from flowgnn_tpu_torch.core.graphs import Graph

    have = set(map(tuple, g.edge_index.tolist()))
    new = []
    for hub in range(3):
        free = [v for v in range(3, g.num_nodes) if (hub, v) not in have]
        for v in rng.choice(free, degree, replace=False):
            new += [(hub, int(v)), (int(v), hub)]
    attr = np.stack([rng.integers(0, d, len(new) // 2) for d in BOND_FEATURE_DIMS], axis=1)
    return Graph(g.node_feat, np.concatenate([g.edge_index, np.asarray(new, np.int32)]),
                 np.concatenate([g.edge_attr, np.repeat(attr.astype(np.int32), 2, axis=0)]))


def gin_random_operands(batch: dict, vn: bool, dtype, device, seed: int, d: int = 100,
                        hid: int = 200) -> dict:
    """GIN kernel operands on a real bucket's slot or ELL layout, with
    seeded random h0 and weights, at full width or at width ``d`` and hidden
    width ``hid``."""
    import numpy as np
    import torch

    from flowgnn_tpu_torch.models import base

    L, D, H = 5, d, hid
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.05, s).astype(np.float32)).to(device, dtype)
    n = batch["node_feat"].shape[0]
    ops = dict(
        h0=t(n, D), pool_gl=batch["pool_gl"],
        ee_tables=t(L * 13, D), w1_all=t(L * H, D), b1_all=t(L, H),
        w2_all=t(L * D, H), b2_all=t(L, D),
        eps_all=(1 + t(L, 1)).float(), pred_w=t(D, 1), num_layers=L,
        gmax=base.POOL_GMAX, vn_col=batch["vn_mask"].to(dtype) if vn else None,
    )
    if "loc_ell" in batch:
        return dict(ops, ell_meta=base.ell_meta(batch), window=base.ell_geometry(batch)[0])
    slots = batch["slot_geom"].shape[-1]
    return dict(
        ops, slot_meta=batch["slot_meta"], window=batch["slot_geom"].shape[0], slots=slots,
        prefix_caps=base.slot_prefix_caps(batch, slots),
    )


def random_operands(name: str, batch: dict, prec, device, seed: int) -> dict:
    """Whole-model kernel operands at full width on a real bucket's slot or
    ELL layout: GIN's from seeded random tensors, the other models' from the
    model's own operand function over seeded synthetic weights (so the degree
    norms, scalers and eigenvector terms are the bucket's own)."""
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    if name in ("gin", "gin-vn"):
        return gin_random_operands(batch, name == "gin-vn", prec.compute_dtype, device, seed)
    params = params_from_numpy(synthetic_params(name, seed), prec, device)
    return kernel_calls(whole_kernel(name, batch), name, params, [batch], prec)[0]


def whole_kernel(name: str, batch: dict) -> str:
    slot, ell = MODEL_KERNELS[name][:2]
    return ell if "loc_ell" in batch else slot


def agree(got, want, tol: float) -> float:
    """Max abs error of ``got`` against ``want``; raises unless
    |got − want| ≤ tol·scale + tol·|want| elementwise, where scale is the
    largest |want| (at least 1). Rounding error grows with the magnitude
    of the summed terms, not of each result: a prediction near zero is a
    sum of terms as large as the largest prediction, and GIN-VN's
    synthetic-weight predictions reach thousands."""
    import torch

    got, want = got.float(), want.float()
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got / scale, want / scale, rtol=tol, atol=tol)
    return (got - want).abs().max().item()


def needed_tol(got, want) -> float:
    """The least tol at which ``agree(got, want, tol)`` passes."""
    got, want = got.float(), want.float()
    scale = max(1.0, want.abs().max().item())
    return ((got - want).abs() / (scale + want.abs())).max().item()


def compare(kname: str, ops: dict, what: str, tol: float) -> float:
    """One kernel launch against its plain version on ``ops``; prints and
    returns the max abs error."""
    import torch

    kernel = kernel_fn(kname)
    got = kernel(**ops)
    ring = getattr(kernel, "stages", 0)  # the bf16 GIN MLP's weight ring, 0 in f32
    want = kernel_fn(kname, plain=True)(**ops)
    torch.cuda.synchronize()
    err = agree(got, want, tol)
    ring = f", weight ring of {ring}" if ring else ""
    print(f"# kernel vs plain, {kname} {what}: max abs err {err:.3e} "
          f"(max |out| {want.float().abs().max().item():.3e}){ring}")
    return err


def check_kernel(name: str, batch: dict, device, what: str) -> float:
    """One model's whole-model kernel against its plain version on
    ``batch``'s layout, f32 and bf16; returns the f32 error."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32

    kname = whole_kernel(name, batch)
    errs = [compare(kname, random_operands(name, batch, prec, device, SEED + 1),
                    f"{name} {what} {prec.compute_dtype}", tol)
            for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2))]
    return errs[0]


def check_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3: each slot kernel against its plain version on random
    operands."""
    for name in MODELS:
        kname = MODEL_KERNELS[name][0]
        err = check_kernel(name, streams[name, "molhiv", SLOTS][1][0], device, "molhiv W=128")
        max_err[kname] = max(max_err[kname], err)


def largest_bucket(streams: dict, key: tuple) -> tuple:
    """(the bucket of a stream holding its largest graph, that graph's
    nodes, the bucket's index)."""
    buckets, batches, _ = streams[key]
    sizes = [int(b.n_node[: b.num_graphs].max()) for b in buckets]
    i = max(range(len(buckets)), key=sizes.__getitem__)
    return batches[i], sizes[i], i


def check_gin_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3, the tensor-core GIN kernels at each width of ``GIN_WIDTHS``,
    f32 (1e-4) and bf16 (5e-2), seeded random operands: row 1 at W=128
    (molhiv bucket 0), W=256 (a synthetic bucket with 250-node graphs) and
    W=512 (the hep10k slot bucket holding the largest graph), GIN and
    GIN-VN (the VN column); row 8 on the hep10k W=512 ELL bucket holding
    the largest graph; row 13 on layer 0 of the hep10k W=128 ELL bucket
    with the longest spill tail (seeded synthetic weights of the width)."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import gin
    from flowgnn_tpu_torch.params.loaders import params_from_numpy, synthetic_gin_params

    precs = ((FLOAT32, 1e-4), (BF16, 5e-2))
    for name in ("gin", "gin-vn"):
        vn = name == "gin-vn"
        hep, big, i = largest_bucket(streams, (name, "hep10k", HEP_SLOTS))
        ell, ell_big, j = largest_bucket(streams, (name, "hep10k", ELL))
        cases = [("gin_local_model_slots", streams[name, "molhiv", SLOTS][1][0],
                  "W=128 molhiv bucket 0"),
                 ("gin_local_model_slots", big_graph_bucket(name, 250, device, SLOTS),
                  "W=256 synthetic bucket, 250-node graphs"),
                 ("gin_local_model_slots", hep, f"W=512 hep10k bucket {i}, a {big}-node graph"),
                 ("gin_local_model", ell, f"W=512 hep10k ELL bucket {j}, a {ell_big}-node graph")]
        for (kname, batch, what), (d, hid) in (
                (c, w) for c in cases for w in GIN_WIDTHS):
            for prec, tol in precs:
                dt = prec.compute_dtype
                err = compare(kname, gin_random_operands(batch, vn, dt, device, SEED + 1, d, hid),
                              f"{name} {what} D={d} H={hid} {dt}", tol)
                if prec is FLOAT32:
                    max_err[kname] = max(max_err[kname], err)
        batch, what = longest_ell_spill(streams, name)
        for d, hid in GIN_WIDTHS:
            for prec, tol in precs:
                params = params_from_numpy(synthetic_gin_params(SEED + 1, dim=d, hidden=hid),
                                           prec, device)
                ops = gin.layer_kernel_operands(params, batch, prec)["gin_local_layer_ell"]
                err = compare("gin_local_layer_ell", ops, f"{name} {what} layer 0 D={d} H={hid} "
                              f"{prec.compute_dtype}", tol)
                if prec is FLOAT32:
                    max_err["gin_local_layer_ell"] = max(max_err["gin_local_layer_ell"], err)


def check_cluster_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3, rows 2, 3, 4 and 5 above W=128 (``check_kernels`` holds them
    at W=128): f32 (1e-4) and bf16 (5e-2) on W=256 (a synthetic bucket of
    250-node graphs) and W=512 (the hep10k slot bucket holding the largest
    graph), seeded synthetic weights, printing the bf16 launch's weight
    ring; then what the occupancy calculator says of rows 2, 4 and 5."""
    for name in CLUSTER_MODELS:
        kname = MODEL_KERNELS[name][0]
        hep, big, i = largest_bucket(streams, (name, "hep10k", HEP_SLOTS))
        for batch, what in ((big_graph_bucket(name, CLUSTER_BIG, device, SLOTS),
                             f"W=256 synthetic bucket, {CLUSTER_BIG}-node graphs"),
                            (hep, f"W=512 hep10k bucket {i}, a {big}-node graph")):
            max_err[kname] = max(max_err[kname], check_kernel(name, batch, device, what))
    print_occupancy(("gcn_local_model_slots", "dgn_local_model", "gat_local_model_slots"),
                    device)


def print_occupancy(knames, device) -> None:
    """Each kernel's two forms on the card at W=128 and W=512: the shared
    memory a block takes, the blocks an SM holds and the clusters in
    flight (``local_layer.occupancy``, at the models' widths, T = 1, or
    DGN's 50)."""
    import torch

    from flowgnn_tpu_torch.models import base
    from flowgnn_tpu_torch.ops.local_layer import occupancy

    for kname in knames:
        t_out = 50 if kname == "dgn_local_model" else 1
        for dt in (torch.bfloat16, torch.float32):
            for window in (128, 512):
                occ = occupancy(kname, dt, window, OCCUPANCY[kname], base.POOL_GMAX, t_out, device)
                print(f"# occupancy {kname} {dt} W={window}: {occ['smem']} B of shared memory "
                      f"a block (ring {occ['stages']}), {occ['blocks_per_sm']} blocks an SM, "
                      f"{occ['clusters']} clusters of {window // 128} at once")


def check_ell_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3b: each ELL kernel against its plain version at W=128, 256,
    384 and 512; the W=512 bucket holds the hep10k stream's largest graph.
    Then what the occupancy calculator says of row 9's two forms."""
    from flowgnn_tpu_torch.models import base

    for name in ELL_MODELS:
        kname = MODEL_KERNELS[name][1]
        batch, largest, i = largest_bucket(streams, (name, "hep10k", ELL))
        check(largest >= 385, f"{name}: the largest hep10k graph has {largest} nodes")
        cases = [
            (streams[name, "molhiv", ELL][1][0], "molhiv bucket"),
            (big_graph_bucket(name, 250, device), "synthetic bucket, 250-node graphs"),
            (big_graph_bucket(name, 380, device), "synthetic bucket, 380-node graphs"),
            (batch, f"hep10k bucket {i}, a {largest}-node graph"),
        ]
        for batch, what in cases:
            what = f"W={base.ell_geometry(batch)[0]} {what}"
            max_err[kname] = max(max_err[kname], check_kernel(name, batch, device, what))
    # Row 9's forms on the card: the blocks an SM holds and the clusters in flight.
    print_occupancy(("gcn_local_model",), device)


def check_layer_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3c: each per-layer slot kernel and the spill scatter against
    its plain version on layer 0's operands of the hep10k W=128 bucket with
    the longest spill tail, f32 (1e-4) and bf16 (5e-2), seeded synthetic
    weights."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    for name in SPILL_MODELS:
        _, batches, _ = streams[name, "hep10k", SLOTS]
        i = max(range(len(batches)), key=lambda j: int(batches[j]["slot_spill_mask"].sum()))
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            params = params_from_numpy(synthetic_params(name, SEED + 1), prec, device)
            kernels = model_module(name).layer_kernel_operands(params, batches[i], prec)
            for kname, ops in kernels.items():
                err = compare(kname, ops, f"{name} hep10k W=128 bucket {i} layer 0 "
                              f"{prec.compute_dtype}", tol)
                if prec is FLOAT32:
                    max_err[kname] = max(max_err[kname], err)


def real_spill_lanes(batch: dict) -> int:
    """The spill lanes of an ELL batch that carry an edge."""
    p, n = batch["loc_ulocal"].shape[0], batch["node_feat"].shape[0]
    return int((batch["receivers"][p:] < n - 1).sum())


def check_ell_layer_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3d: each per-layer ELL kernel and the spill scatter against its
    plain version on layer 0's operands of the hep10k W=128 ELL bucket with
    the longest spill tail (rows 13, 14 and 24) and of the first molhiv
    W=128 ELL bucket (rows 13 and 15), f32 (1e-4) and bf16 (5e-2), seeded
    synthetic weights."""
    cases = []
    for name in ELL_MODELS:
        cases += [(name, *longest_ell_spill(streams, name)),
                  (name, streams[name, "molhiv", ELL][1][0], "molhiv W=128 bucket 0")]
    check_layer_cases(cases, device, max_err)
    check_row14_windows(device, max_err)


def check_row14_windows(device, max_err: dict) -> None:
    """Phase 3d, row 14 (the messages-only form of row 9's cluster kernel)
    at every window its clusters take past W=128: layer 0's operands (seeded
    synthetic weights, the bucket's own degree norms) of the synthetic GCN
    ELL buckets of ``ELL_LAYER_WINDOWS`` (W = 256, 512 and 1024; k = 2 at
    W=1024), which have no spill tail, so the operands are row 15's messages
    part; f32 (1e-4) and bf16 (5e-2); then what the occupancy calculator says
    of its two forms."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import base
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    kname = "gcn_local_message_ell"
    for n, w in ELL_LAYER_WINDOWS:
        batch = big_graph_stream("gcn", n, device, ELL, window=w)[1][0]
        what = f"W={w} k={base.ell_geometry(batch)[1]} synthetic ELL bucket, {n}-node graphs"
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            params = params_from_numpy(synthetic_params("gcn", SEED + 1), prec, device)
            kernels = model_module("gcn").layer_kernel_operands(params, batch, prec)
            ops = kernels.get(kname) or {k: kernels["gcn_local_layer_ell"][k]
                                         for k in ("ell_meta", "h", "dis", "ee_table", "window")}
            err = compare(kname, ops, f"gcn {what} layer 0 {prec.compute_dtype}", tol)
            if prec is FLOAT32:
                max_err[kname] = max(max_err[kname], err)
    print_occupancy((kname,), device)


def longest_ell_spill(streams: dict, name: str) -> tuple:
    """(the hep10k W=128 ELL bucket with the longest spill tail, its name)."""
    _, hep, _ = streams[name, "hep10k", ELL_LAYER]
    i = max(range(len(hep)), key=lambda j: real_spill_lanes(hep[j]))
    return hep[i], f"hep10k W=128 bucket {i}"


def check_layer_cases(cases, device, max_err: dict) -> None:
    """Each per-layer kernel a (model, batch, name[, operand keywords]) case's
    layer 0 runs against its plain version, f32 (1e-4) and bf16 (5e-2),
    seeded synthetic weights. The keywords are ``layer_kernel_operands``'s
    (``fused``, ``fuse_layers``); ``row12`` takes row 12's operands."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    for name, batch, what, *rest in cases:
        kw = rest[0] if rest else {}
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            params = params_from_numpy(synthetic_params(name, SEED + 1), prec, device)
            if kw.get("row12"):
                kernels = {ROW12: layer_operands(ROW12, name, params, batch, prec, {})}
            else:
                kernels = model_module(name).layer_kernel_operands(params, batch, prec, **kw)
            for kname, ops in kernels.items():
                err = compare(kname, ops, f"{name} {what} layer 0 {prec.compute_dtype}", tol)
                if prec is FLOAT32:
                    max_err[kname] = max(max_err[kname], err)


def check_new_layer_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3e: row 20 on layer 0 of the first PNA molhiv slot bucket; row
    18 on the first DGN molhiv ELL bucket (W=128, block 512); rows 16 and 24
    on the DGN hep10k W=128 ELL bucket with the longest spill tail; row 17 on
    the first GAT molhiv ELL bucket and on the GAT hep10k W=128 ELL bucket
    with the longest tail (with row 24); f32 and bf16."""
    check_layer_cases([
        ("pna", streams["pna", "molhiv", SLOTS][1][0], "molhiv W=128 slot bucket 0"),
        ("dgn", streams["dgn", "molhiv", ELL][1][0], "molhiv W=128 ELL bucket 0"),
        ("dgn", *longest_ell_spill(streams, "dgn")),
        ("gat", streams["gat", "molhiv", ELL][1][0], "molhiv W=128 ELL bucket 0"),
        ("gat", *longest_ell_spill(streams, "gat")),
    ], device, max_err)


def check_layer_windows(streams: dict, device, max_err: dict) -> None:
    """Phase 3e, rows 20 and 22 (the one-layer forms of rows 3 and 4) at
    every window their clusters take: layer 0's operands (seeded synthetic
    weights, the bucket's own degree and eigenvector terms) at W=128 (molhiv
    bucket 0), W=256 and W=1024 (synthetic buckets, ``LAYER_WINDOWS``) and
    W=512 (the hep10k slot bucket holding the largest graph), f32 (1e-4) and
    bf16 (5e-2), row 22 also with a seeded ``m_spill``, row 19 (row 3's
    stats-only form) on row 20's ``STATS_KEYS``; then what the occupancy
    calculator says of the rows; then DGN's spilling W=256 bucket
    (``check_hub_spill``). Rows 18 and 15 (the one-layer forms of rows 4 and
    9 over the ELL layout; row 15 on a non-final layer and on the last) the
    same way on synthetic ELL buckets at W=256, 512 and 1024
    (``ELL_LAYER_WINDOWS``; two edge blocks a window at W=1024), row 16 (row
    4's channels-only form) on row 18's ``CHANNEL_KEYS``, and their
    occupancy. Row 21 on the GAT hep10k slot bucket at W=512 holding the
    largest graph (no spill tail), divided and as raw sums."""
    import numpy as np
    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import base
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    for name in HEP_INTER_MODELS:
        kname = MODEL_KERNELS[name][3]
        hep, big, i = largest_bucket(streams, (name, "hep10k", HEP_SLOTS))
        cases = [(streams[name, "molhiv", SLOTS][1][0], "W=128 molhiv bucket 0"),
                 (hep, f"W=512 hep10k bucket {i}, a {big}-node graph")]
        cases += [(big_graph_stream(name, n, device, SLOTS, window=w)[1][0],
                   f"W={w} synthetic bucket, {n}-node graphs") for n, w in LAYER_WINDOWS]
        for batch, what in cases:
            for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
                dt = prec.compute_dtype
                params = params_from_numpy(synthetic_params(name, SEED + 1), prec, device)
                ops = model_module(name).layer_kernel_operands(params, batch, prec)[kname]
                variants = [("", kname, ops)]
                if name == "dgn":
                    rng = np.random.default_rng(SEED + 2)
                    spill = rng.normal(0, 0.5, (ops["h"].shape[0], 2 * ops["h"].shape[1]))
                    variants.append((" with m_spill", kname, dict(
                        ops, m_spill=torch.from_numpy(spill.astype(np.float32)).to(device, dt))))
                else:  # row 19, the stats-only form, on row 20's operands
                    variants.append((" stats only", "pna_local_stats_ell",
                                     {k: ops[k] for k in STATS_KEYS}))
                for label, kn, v in variants:
                    err = compare(kn, v, f"{name} {what} layer 0{label} {dt}", tol)
                    if prec is FLOAT32:
                        max_err[kn] = max(max_err[kn], err)
    for name, kname in (("dgn", "dgn_local_layer_ell"), ("gcn", "gcn_local_layer_ell")):
        for n, w in ELL_LAYER_WINDOWS:
            batch = big_graph_stream(name, n, device, ELL, window=w)[1][0]
            what = f"W={w} k={base.ell_geometry(batch)[1]} synthetic ELL bucket, {n}-node graphs"
            for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
                params = params_from_numpy(synthetic_params(name, SEED + 1), prec, device)
                kernels = model_module(name).layer_kernel_operands(params, batch, prec)
                check(kname in kernels, f"{name} {what}: no {kname} launch ({sorted(kernels)})")
                ops = kernels[kname]
                variants = [("layer 0", kname, ops)]
                if name == "gcn":  # the last layer's form: no next conv
                    variants.append(("a last layer", kname, dict(ops, w_next=None, b_next=None,
                                                                 conv_tiles=None)))
                else:  # row 16, the channels-only form, on row 18's operands
                    variants.append(("channels only", "dgn_local_message_ell",
                                     {k: ops[k] for k in CHANNEL_KEYS}))
                for label, kn, v in variants:
                    err = compare(kn, v, f"{name} {what} {label} {prec.compute_dtype}", tol)
                    if prec is FLOAT32:
                        max_err[kn] = max(max_err[kn], err)
    kname = "gat_local_message_slots"
    hep, big, i = largest_bucket(streams, ("gat", "hep10k", HEP_SLOTS))
    for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
        params = params_from_numpy(synthetic_params("gat", SEED + 1), prec, device)
        ops = model_module("gat").layer_kernel_operands(params, hep, prec)[kname]
        for v in (ops, dict(ops, divide=not ops["divide"])):
            err = compare(kname, v, f"gat W=512 hep10k slot bucket {i}, a {big}-node graph, "
                          f"layer 0 {'divided' if v['divide'] else 'sums'} "
                          f"{prec.compute_dtype}", tol)
            if prec is FLOAT32:
                max_err[kname] = max(max_err[kname], err)
    print_occupancy(("pna_local_layer_slots", "dgn_local_layer_slots",
                     "dgn_local_layer_ell_model", "gcn_local_layer_ell", "pna_local_stats_slots",
                     "dgn_local_layer_ell"), device)
    check_hub_spill(device, max_err)


def check_hub_spill(device, max_err: dict) -> None:
    """Phase 3e: DGN over a W=256 bucket whose hub nodes have an in-window
    in-degree of ``HUB_DEGREE``, past the 8 slots, so that the bucket
    spills: rows 22 and 24 on its layer 0 against their plain versions, and
    ``dgn.forward`` over it (row 22 with the tail's channels and row 24 once
    a layer), counted and checked as in phase 4."""
    key = ("dgn", f"W=256 hubs of in-degree {HUB_DEGREE}", SLOTS)
    stream = big_graph_stream("dgn", 200, device, SLOTS, window=256, hub=HUB_DEGREE)
    batch = stream[1][0]
    real = int(batch["slot_spill_mask"].sum())
    check(real > 0, f"{key}: no spill tail")
    print(f"# spill {' '.join(key)}: W={batch['slot_geom'].shape[0]}, "
          f"S={batch['slot_geom'].shape[1]}, spill lanes {real} of {batch['senders'].shape[0]} "
          f"edges")
    check_layer_cases([("dgn", batch, " ".join(key[1:]))], device, max_err)
    run_main_path({key: stream}, device, [key])


def check_block_layer_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3f: rows 10, 12 and 25 on layer 0 of the first GIN molhiv bucket
    in the legacy local, ELL and edge-block layout; row 23 on the first GAT
    molhiv ELL bucket and on the GAT hep10k W=128 ELL bucket with the longest
    spill tail (with row 24); row 24 on the first edge-block bucket of GAT,
    GIN, PNA and DGN (widths 68, 100, 160, 200); f32 and bf16."""
    first = lambda name, layout: streams[name, "molhiv", layout][1][0]
    fuse = dict(fuse_layers=True)
    check_layer_cases([
        ("gin", first("gin", LOCAL), "molhiv legacy local bucket 0"),
        ("gin", first("gin", ELL), "molhiv W=128 ELL bucket 0, per-lane ee", dict(row12=True)),
        ("gin", first("gin", BLOCKED), "molhiv edge-block bucket 0, fused", dict(fused=True)),
        ("gat", first("gat", ELL), "molhiv W=128 ELL bucket 0, fused", fuse),
        ("gat", *longest_ell_spill(streams, "gat"), fuse),
        *((name, first(name, BLOCKED), "molhiv edge-block bucket 0")
          for name in ("gat", "gin", "pna", "dgn")),
    ], device, max_err)
    check_long_run(device, max_err)


def long_run_operands(window: int, chunk: int, seed: int) -> dict:
    """Row 24's seeded operands (numpy, D'=100) with one window whose run is
    longer than the kernel's list of ``chunk`` lanes: four windows of
    ``window`` rows in blocks of 128 lanes; window 0 two blocks; window 1 a
    hub row (v = 7), lanes on random rows and sentinel lanes in the numbers
    ``LONG_RUN`` gives, in random order; window 2 one block and blocks of
    sentinels parked on it; window 3 no block. Every lane carries a value."""
    import numpy as np

    rng = np.random.default_rng(seed)
    block = 128
    hub, rest, sentinels = (int(f * chunk) for f in LONG_RUN[0])
    v1 = rng.permutation(np.concatenate([np.full(hub, 7), rng.integers(0, window, rest),
                                         np.full(sentinels, window)]))
    v1 = np.concatenate([v1, np.full(-len(v1) % block, window)])
    v0 = rng.integers(0, window, 2 * block)
    v2 = np.concatenate([rng.integers(0, window, block), np.full(40 * block, window)])
    v = np.concatenate([v0, v1, v2]).astype(np.int32)
    bw = np.repeat(np.arange(3), [len(x) // block for x in (v0, v1, v2)]).astype(np.int32)
    return dict(values=rng.normal(0, 0.5, (len(v), 100)).astype(np.float32), v_local=v[:, None],
                block_window=bw, window=window, num_windows=4)


def check_long_run(device, max_err: dict) -> None:
    """Phase 3f, row 24 on ``long_run_operands`` at each window of
    ``LONG_RUN``: against its plain version, f32 (1e-4) and bf16 (5e-2); two
    launches equal bit for bit; the window with no block zero."""
    import torch

    from flowgnn_tpu_torch.ops import spmm

    chunk = spmm._library(SCATTER)["chunk"]()
    for window in LONG_RUN[1]:
        ops_np = long_run_operands(window, chunk, SEED + window)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            ops = {k: torch.from_numpy(v).to(device) if hasattr(v, "shape") else v
                   for k, v in ops_np.items()}
            ops["values"] = ops["values"].to(dtype)
            what = (f"W={window}, a run of {ops['v_local'].shape[0]} lanes past the {chunk}-lane "
                    f"list {dtype}")
            err = compare(SCATTER, ops, what, tol)
            again = spmm.windowed_segment_sum(**ops)
            first = spmm.windowed_segment_sum(**ops)
            torch.cuda.synchronize()
            check(torch.equal(first, again), f"{SCATTER} {what}: two launches differ")
            check(not first.reshape(4, -1)[3].any(), f"{SCATTER} {what}: window 3 not zero")
            if dtype == torch.float32:
                max_err[SCATTER] = max(max_err[SCATTER], err)


def block_operands(kname: str, batch: dict, d: int, hid: int, spill: bool, dtype, device,
                   seed: int) -> dict:
    """Seeded random operands of rows 10, 12 and 25 on an ELL bucket's lanes
    at width ``d`` and hidden width ``hid``: row 12 (``gin_local_layer_ell_
    lanes``) on the ELL grid as it is, rows 10 (``gin_local_layer``) and 25
    (``gin_layer_fused``) on the same lanes as one block a window named by
    ``block_window``, so their binary search over it runs; with ``spill`` a
    seeded ``m_spill`` (rows 10 and 12; row 25 has none)."""
    import numpy as np
    import torch

    from flowgnn_tpu_torch.models import base

    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.2, s).astype(np.float32)).to(device, dtype)
    meta, window = base.ell_meta(batch), base.ell_geometry(batch)[0]
    n, p = batch["node_feat"].shape[0], meta.shape[0]
    ops = dict(h=t(n, d), window=window, w1=t(hid, d), b1=t(hid), w2=t(d, hid), b2=t(d),
               eps1=(1 + t(1, 1)).float(), final_relu=True)
    m_spill = t(n, d) if spill else None
    if kname == ROW12:
        return dict(ops, ee=t(p, d), ell_meta=meta, m_spill=m_spill)
    ops.update(v_local=meta[:, 1].contiguous(),
               block_window=torch.arange(-(-n // window), dtype=torch.int32, device=device))
    if kname == "gin_local_layer":
        return dict(ops, ee=t(p, d), u_local=meta[:, 0].contiguous(), m_spill=m_spill)
    return dict(ops, vals=t(p, d).relu())


def gat_layer_operands(batch: dict, hd: int, heads: int, spill: bool, prec, device,
                       seed: int) -> dict:
    """Row 23's operands on a GAT ELL bucket at H·D = ``hd`` (``heads`` ×
    16): layer 0 of seeded synthetic weights of that width over the bucket's
    own features and scores, ``spill_both`` None, or with ``spill`` seeded
    sums [Σ score·h_u ‖ Σ score] (the score sums at least 0.5, as a tail's
    positive scores give: no row's denominator is near zero)."""
    import numpy as np
    import torch

    from flowgnn_tpu_torch.models import gat
    from flowgnn_tpu_torch.params import loaders

    params = loaders.params_from_numpy(
        loaders.synthetic_gat_params(seed, dim=hd // heads, heads=heads), prec, device)
    ops = gat.layer_kernel_operands(params, batch, prec, fuse_layers=True)["gat_local_layer_ell"]
    sums = None
    if spill:
        rng = np.random.default_rng(seed)
        x = rng.normal(0, 0.5, (ops["h"].shape[0], hd + heads)).astype(np.float32)
        x[:, hd:] = np.abs(x[:, hd:]) + 0.5
        sums = torch.from_numpy(x).to(device, prec.compute_dtype)
    return dict(ops, spill_both=sums)


def check_block_layer_widths(streams: dict, device, max_err: dict) -> None:
    """Phase 3f: rows 10, 12 and 25 at each (D, H) of ``GIN_WIDTHS`` and row
    23 at each (H·D, heads) of ``GAT_WIDTHS``, at W=128 (molhiv's first ELL
    bucket) and W=1024 (a synthetic ELL bucket of ``BLOCK_BIG``-node
    graphs), each with and without its spill operand (``m_spill``; row 23
    ``spill_both``; row 25 has none), f32 (1e-4) and bf16 (5e-2), seeded
    random operands, printing the bf16 launch's weight ring; then what the
    occupancy calculator says of rows 13, 10 / 12, 25 and 23."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32

    precs = ((FLOAT32, 1e-4), (BF16, 5e-2))
    for name, kernels in (("gin", ("gin_local_layer", ROW12, "gin_layer_fused")),
                          ("gat", ("gat_local_layer_ell",))):
        buckets = [(streams[name, "molhiv", ELL][1][0], "W=128 molhiv ELL bucket 0"),
                   (big_graph_stream(name, BLOCK_BIG, device, ELL, window=1024)[1][0],
                    f"W=1024 synthetic ELL bucket, {BLOCK_BIG}-node graphs")]
        for batch, what in buckets:
            for kname in kernels:
                spills = (False,) if kname == "gin_layer_fused" else (False, True)
                widths = GAT_WIDTHS if name == "gat" else GIN_WIDTHS
                for (a, b), spill, (prec, tol) in (
                        (w, sp, pt) for w in widths for sp in spills for pt in precs):
                    dt = prec.compute_dtype
                    if name == "gat":
                        ops = gat_layer_operands(batch, a, b, spill, prec, device, SEED + 3)
                        label = f"H·D={a} ({b} heads)"
                    else:
                        ops = block_operands(kname, batch, a, b, spill, dt, device, SEED + 3)
                        label = f"D={a} H={b}"
                    err = compare(kname, ops, f"{what} {label}{' with spill' if spill else ''} "
                                  f"{dt}", tol)
                    if prec is FLOAT32:
                        max_err[kname] = max(max_err[kname], err)
    print_layer_occupancy(device)


def print_layer_occupancy(device) -> None:
    """Each per-layer kernel of ``LAYER_OCCUPANCY`` in both forms on the
    card: the shared memory a block takes (with its bf16 weight ring) and
    the blocks an SM holds (``local_layer.layer_occupancy``)."""
    import torch

    from flowgnn_tpu_torch.ops.local_layer import layer_occupancy

    for kname, geometries in LAYER_OCCUPANCY.items():
        for geometry in geometries:
            for dt in (torch.bfloat16, torch.float32):
                occ = layer_occupancy(kname, dt, 128, geometry, device)
                print(f"# occupancy {kname} {dt} at {geometry}: {occ['smem']} B of shared memory "
                      f"a block (ring {occ['stages']}), {occ['blocks_per_sm']} blocks an SM")


def plain_rows(batch: dict, packed):
    """Each node row of a kernel batch's row in the plain batch of the same
    bucket: the slot layout sorts each window's rows by in-degree
    (``base._window_degree_perm``), the ELL layout keeps them."""
    import numpy as np
    import torch

    from flowgnn_tpu_torch.models import base

    n = packed.node_capacity + 1
    if "slot_src" not in batch:
        return torch.arange(n, device=batch["node_feat"].device)
    perm = base._window_degree_perm(np.asarray(packed.senders), np.asarray(packed.receivers), n,
                                    int(batch["slot_geom"].shape[0]))
    return torch.as_tensor(perm[:n], device=batch["node_feat"].device)


def check_outputs(key: tuple, i: int, packed, out, want, tol: float, plain=None, rows=None,
                  rounded=None):
    """One bucket's forward output against the reference's (``agree``); on
    an intermediates path every layer's rows of real nodes (``rows``: each
    kernel row's row in the reference, as ``plain_rows`` gives it) and the
    pooled h too. ``plain``, the bf16 plain path's output on the bucket,
    widens each comparison's tol to 1.5× the tol that path itself needs,
    where that is larger: bf16 GIN errs by up to ~5% of the largest
    prediction on either path (PERF.md §2). ``rounded``, the bf16 output of
    the path with its kernels replaced by their plain versions
    (``KERNEL_ROUNDING``), widens the predictions' tol the same way, and on
    an intermediates path every layer's and the pooled h's. Returns (the
    predictions' max abs error, their tol)."""
    k = packed.num_graphs
    wide = [None]
    if isinstance(out, tuple):
        import torch

        real = torch.as_tensor(packed.node_graph < k, device=out[0].device)[rows]
        ref_rows = rows[real]
        (out, inter), (want, want_inter) = out, want
        plain_inter = plain[1] if plain is not None else None
        check(len(inter["layers"]) == len(want_inter["layers"]), f"{key}: intermediates")
        pairs = [(out[:k], want[:k], None if plain is None else plain[0][:k])]
        for j, (a, b) in enumerate(zip(inter["layers"], want_inter["layers"])):
            pairs.append((a[real], b[ref_rows],
                          None if plain is None else plain_inter["layers"][j][ref_rows]))
        pairs.append((inter["h_graph"][:k], want_inter["h_graph"][:k],
                      None if plain is None else plain_inter["h_graph"][:k]))
        if rounded is not None:
            wide = ([rounded[0][:k]] + [x[real] for x in rounded[1]["layers"]]
                    + [rounded[1]["h_graph"][:k]])
    else:
        pairs = [(out[:k], want[:k], None if plain is None else plain[:k])]
        if rounded is not None:
            wide = [rounded[:k]]
    check(tuple(out.shape) == (packed.n_node.shape[0], 1), f"{key}: shape {tuple(out.shape)}")
    check(bool(out[:k].isfinite().all()), f"{key}: non-finite output")
    errs, tols = [], []
    for j, (got, ref, pl) in enumerate(pairs):
        t = tol if pl is None else max(tol, 1.5 * needed_tol(pl, ref))
        if j < len(wide) and wide[j] is not None:
            t = max(t, 1.5 * needed_tol(wide[j], ref))
        errs.append(agree(got, ref, t))
        tols.append(t)
    if len(pairs) > 1:
        print(f"# intermediates {' '.join(key)} bucket {i}: max abs err per layer "
              f"{', '.join(f'{e:.3e}' for e in errs[1:-1])}; pooled h {errs[-1]:.3e}; "
              f"tol {max(tols):.3e}")
    return errs[0], tols[0]


def check_sibling(key: tuple, packed, out, params: dict, batch: dict, prec, tol: float) -> str:
    """A path held to the kernel path it is a variant of, on the same bucket
    and dtype, at the path's own tol (``agree``): GAT's fused ELL path
    against its unfused one (predictions; the two round at different
    points), row 12's and row 31's layer loops against the row-13 path
    (predictions and every layer's h; row 12's bond embeddings arrive
    rounded to the compute dtype, row 31's messages rounded before the
    epilogue adds the spill tail's). Returns what to print, or nothing for a path with no sibling."""
    from flowgnn_tpu_torch.models import registry

    k = packed.num_graphs
    forward = registry.get(key[0]).forward
    if key[2] in (ELL_FUSED, ELL_LAYER_FUSED):
        err = agree(out[:k], forward(params, batch, prec)[:k], tol)
        return f", vs the unfused ELL path {err:.3e}"
    if key[2] not in (ELL_EE, ELL_MSG):
        return ""
    ref, ref_inter = forward(params, batch, prec, return_intermediates=True)
    errs = [agree(out[0][:k], ref[:k], tol)]
    errs += [agree(a, b, tol) for a, b in zip(out[1]["layers"], ref_inter["layers"])]
    return f", vs the row-13 path {errs[0]:.3e} (layers: {max(errs[1:]):.3e})"


def run_main_path(streams: dict, device, keys) -> dict:
    """Phases 4, 4b, 4c, 4d and 4e: each (model, profile, layout) of ``keys``
    over its whole stream in f32 and bf16; returns each kernel's launches
    counted in these runs.

    The reference is the port's plain edge-list path in f32 on the same
    device (``agree``). The f32 kernel path differs from it in summation
    order only: 1e-4. bf16 keeps about three significant digits, and a
    prediction is a mean of node outputs that partly cancel, so single
    graphs move by a few percent of the largest prediction: 5e-2. The bf16
    plain path's own error against the same reference is printed beside, and
    where that path needs more than 5e-2 itself (GIN), the gate is 1.5×
    what it needs (``check_outputs``). On the ``KERNEL_ROUNDING`` paths the
    gate also takes 1.5× what the path with its kernels' plain versions
    needs, printed beside, and the kernel path must match that path at
    5e-2. A path with a sibling kernel path (``check_sibling``) is held to
    it too."""
    import collections

    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    kernels = {k: kernel_fn(k) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    for key in keys:
        name, profile, layout = key
        buckets, batches, plain = streams[key]
        forward, plain_forward = path_forward(key), registry.get(name).forward
        params_np = synthetic_params(name, SEED)
        p32 = params_from_numpy(params_np, FLOAT32, device)
        kw = forward_kw(key)
        inter = bool(kw.get("return_intermediates"))
        plain_kw = dict(return_intermediates=True) if inter else {}
        want = [plain_forward(p32, pb, FLOAT32, **plain_kw) for pb in plain]
        expect = collections.Counter()
        for b in batches:
            expect.update(path_launches(key, b))
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            params = params_from_numpy(params_np, prec, device)
            for k in kernels.values():
                k.launches = 0
            outs = [forward(params, b, prec, **kw) for b in batches]
            torch.cuda.synchronize()
            counts = {k: f.launches for k, f in kernels.items()}
            check(counts == {k: expect.get(k, 0) for k in KERNELS},
                  f"{key}: launches {counts}, expected {dict(expect)}")
            for k, c in counts.items():
                launches[k] += c
            for i, (packed, out, pb, w) in enumerate(zip(buckets, outs, plain, want)):
                k = packed.num_graphs
                pl = plain_forward(params, pb, prec, **plain_kw) if prec is BF16 else None
                rows = plain_rows(batches[i], packed) if inter else None
                rounded = None
                if pl is not None and key in KERNEL_ROUNDING:
                    with plain_versions():
                        rounded = forward(params, batches[i], prec, **kw)
                    r_out = rounded[0] if inter else rounded
                    held = agree((out[0] if inter else out)[:k], r_out[:k], tol)
                err, t = check_outputs(key, i, packed, out, w, tol, pl, rows, rounded)
                sibling = check_sibling(key, packed, out, params, batches[i], prec, tol)
                w, pl = (w[0], pl[0] if pl is not None else None) if inter else (w, pl)
                line = (f"# main path {name} {profile} {layout} {prec.compute_dtype} bucket {i}: "
                        f"{k} graphs, launches {dict(path_launches(key, batches[i]))}, "
                        f"max abs err vs f32 plain path {err:.3e}{sibling}")
                if pl is not None:
                    plain_err = (pl[:k].float() - w[:k]).abs().max().item()
                    line += f" (bf16 plain path: {plain_err:.3e}"
                    if rounded is not None:
                        r_err = (r_out[:k].float() - w[:k]).abs().max().item()
                        line += (f"; bf16 plain versions' path: {r_err:.3e}, the kernel path "
                                 f"against it {held:.3e}")
                    line += f"; tol {t:.3e})"
                print(f"{line}; max |out| {w[:k].abs().max().item():.3e}")
    return launches


def describe_ell(streams: dict) -> None:
    """Phase 4b's geometry: W, k, spill lanes and the fullest window's lanes
    per ELL stream; k must be 1 and no lane may spill."""
    from flowgnn_tpu_torch.models import base

    for (name, profile, layout), (buckets, batches, _) in streams.items():
        if layout != ELL:
            continue
        for i, b in enumerate(batches):
            w, k = base.ell_geometry(b)
            lanes = b["loc_ulocal"].shape[0]
            spill = b["senders"].shape[0] - lanes
            nw = -(-b["node_feat"].shape[0] // w)
            fullest = int((b["loc_vlocal"].reshape(nw, -1) < w).sum(1).max())
            check(k == 1 and spill == 0, f"{name} {profile} bucket {i}: k={k}, {spill} spill lanes")
            print(f"# ELL {name} {profile} bucket {i}: {buckets[i].num_graphs} graphs, W={w}, "
                  f"k={k}, {lanes // nw} lanes per window, spill lanes {spill}, "
                  f"fullest window {fullest} lanes, largest graph "
                  f"{int(buckets[i].n_node[: buckets[i].num_graphs].max())} nodes")


def describe_hep_slots(streams: dict) -> None:
    """Phase 4b's slot geometry on hep10k: per bucket of every model of
    ``HEP_SLOT_MODELS`` at ``HEP_SLOT_WINDOW`` the windows, slots, prefix
    caps and lanes per window; no bucket may spill."""
    from flowgnn_tpu_torch.models import base

    for name in HEP_SLOT_MODELS:
        buckets, batches, _ = streams[name, "hep10k", HEP_SLOTS]
        for i, b in enumerate(batches):
            w, s = b["slot_geom"].shape
            nw = -(-b["node_feat"].shape[0] // w)
            check(w == HEP_SLOT_WINDOW and "slot_meta" in b and not bool(b["slot_spill_mask"].any()),
                  f"{name} hep10k slot bucket {i}: W={w}, spills")
            print(f"# slots {name} hep10k bucket {i}: {buckets[i].num_graphs} graphs, W={w}, "
                  f"{nw} windows, S={s}, prefix caps {base.slot_prefix_caps(b, s)}, "
                  f"{b['slot_meta'].shape[0] // nw} lanes per window, no spill, largest graph "
                  f"{int(buckets[i].n_node[: buckets[i].num_graphs].max())} nodes")


def describe_spill(streams: dict) -> None:
    """Phase 4c's geometry: per hep10k W=128 slot stream and bucket, the
    slots, the real spill lanes, the blocked lanes and the compact scatter
    windows T; every bucket must spill."""
    for name in SPILL_MODELS:
        buckets, batches, _ = streams[name, "hep10k", SLOTS]
        for i, b in enumerate(batches):
            real = int(b["slot_spill_mask"].sum())
            t = b["spill_blk_compact"].shape[0]
            check(real > 0, f"{name} hep10k bucket {i}: no spill tail")
            print(f"# spill {name} hep10k bucket {i}: {buckets[i].num_graphs} graphs, "
                  f"W={b['slot_geom'].shape[0]}, S={b['slot_geom'].shape[1]}, spill lanes "
                  f"{real} of {b['senders'].shape[0]} edges, {b['slot_spill'].shape[0]} blocked "
                  f"lanes in {b['spill_blk_window'].shape[0]} blocks, compact windows T={t} "
                  f"of {b['spill_blk_winmap'].shape[0]}")


def describe_blocks(streams: dict) -> None:
    """Phase 4f's geometry: per edge-block stream and bucket the blocks, the
    lanes that carry an edge and the all-sentinel blocks parked on the last
    window; per legacy local stream and bucket the blocked lanes and the
    crossing edges in the 8192-lane tail."""
    for (name, profile, layout), (buckets, batches, _) in streams.items():
        for i, b in enumerate(batches):
            n = b["node_feat"].shape[0]
            if layout == BLOCKED:
                real = b["blk_vlocal"].reshape(-1, 128) < 128
                used = int(real.any(1).sum())
                print(f"# edge blocks {name} {profile} bucket {i}: {buckets[i].num_graphs} "
                      f"graphs, {real.shape[0]} blocks over {-(-n // 128)} windows, "
                      f"{int(real.sum())} lanes carry an edge, {real.shape[0] - used} blocks "
                      f"hold none")
            elif layout == LOCAL:
                p = b["loc_ulocal"].shape[0]
                tail = b["receivers"][p:]
                print(f"# legacy local {name} {profile} bucket {i}: {buckets[i].num_graphs} "
                      f"graphs, {p} blocked lanes in {b['loc_window'].shape[0]} blocks, "
                      f"{int((b['loc_vlocal'] < 128).sum())} carry an edge, spill tail "
                      f"{int((tail < n - 1).sum())} of {tail.shape[0]} lanes")


def describe_ell_spill(streams: dict) -> None:
    """Phases 4d and 4e's geometry: per hep10k W=128 ELL stream and bucket,
    W, k, the ELL lanes, the spill tail's real and blocked lanes and the
    compact scatter windows T; every bucket must spill."""
    from flowgnn_tpu_torch.models import base

    for name in LAYER_MODELS:
        buckets, batches, _ = streams[name, "hep10k", ELL_LAYER]
        for i, b in enumerate(batches):
            w, k = base.ell_geometry(b)
            real = real_spill_lanes(b)
            check(real > 0 and "spill_blk_vlocal" in b, f"{name} hep10k W=128 bucket {i}: no spill")
            print(f"# ELL spill {name} hep10k bucket {i}: {buckets[i].num_graphs} graphs, W={w}, "
                  f"k={k}, {b['loc_ulocal'].shape[0]} ELL lanes, spill lanes {real} of "
                  f"{base.ell_spill_lanes(b)} blocked, compact windows "
                  f"T={b['spill_blk_compact'].shape[0]} of {b['spill_blk_winmap'].shape[0]}")


def check_ell_matches_slots(streams: dict, device) -> dict:
    """Phases 4b and 4e, molhiv at W=128: the ELL path's f32 predictions
    against the slot path's (both kernel paths; summation order only:
    1e-4), for GIN, GIN-VN and GCN (their whole-model ELL kernel) and DGN and
    GAT (rows 18 and 17, once per layer). Returns the ELL kernels' launches,
    counted as in ``run_main_path``."""
    import collections

    import torch

    from flowgnn_tpu_torch.core.numerics import FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    kernels = {k: kernel_fn(k) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    for name in LAYER_MODELS:
        forward = registry.get(name).forward
        params = params_from_numpy(synthetic_params(name, SEED), FLOAT32, device)
        buckets, ell, _ = streams[name, "molhiv", ELL]
        slot = streams[name, "molhiv", SLOTS][1]
        want = [forward(params, b, FLOAT32) for b in slot]
        expect = collections.Counter()
        for b in ell:
            expect.update(bucket_launches(name, b))
        for k in kernels.values():
            k.launches = 0
        outs = [forward(params, b, FLOAT32) for b in ell]
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in kernels.items()}
        check(counts == {k: expect.get(k, 0) for k in KERNELS},
              f"{name} molhiv ELL: launches {counts}, expected {dict(expect)}")
        for k, c in counts.items():
            launches[k] += c
        for i, (packed, out, w) in enumerate(zip(buckets, outs, want)):
            k = packed.num_graphs
            err = agree(out[:k], w[:k], 1e-4)
            print(f"# molhiv {name} f32 bucket {i}: ELL path (W=128) vs slot path, max abs err "
                  f"{err:.3e}; max |out| {w[:k].abs().max().item():.3e}")
    return launches


def check_hep_inter_matches_model(streams: dict, device) -> None:
    """Phase 4e, hep10k at W=512: PNA's and DGN's f32 predictions with
    ``return_intermediates`` (rows 20 and 22 once per layer) against the
    whole-model path's on the same batches (rows 3 and 4 once per bucket),
    graph by graph over the stream (summation order only: 1e-4)."""
    import torch

    from flowgnn_tpu_torch.core.numerics import FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    for name in HEP_INTER_MODELS:
        forward = registry.get(name).forward
        params = params_from_numpy(synthetic_params(name, SEED), FLOAT32, device)
        buckets, batches, _ = streams[name, "hep10k", HEP_SLOTS]
        cut = lambda outs: torch.cat([o[: p.num_graphs] for p, o in zip(buckets, outs)])
        whole = cut([forward(params, b, FLOAT32) for b in batches])
        layer = cut([forward(params, b, FLOAT32, return_intermediates=True)[0] for b in batches])
        err = agree(layer, whole, 1e-4)
        print(f"# hep10k {name} f32: per-layer slot path (W={HEP_SLOT_WINDOW}, "
              f"{MODEL_KERNELS[name][3]}) vs whole-model slot path ({MODEL_KERNELS[name][0]}), "
              f"{layer.shape[0]} graphs, max abs err {err:.3e}; max |out| "
              f"{whole.abs().max().item():.3e}")


def check_hep_slots_match_ell(streams: dict, device) -> dict:
    """Phase 4b, hep10k: the slot path's f32 predictions at W=512 against
    another kernel path's over the same graphs (summation order only:
    1e-4): GIN's, GIN-VN's and GCN's against the ELL W=512 path's on the
    same packing (rows 1 and 8, rows 2 and 9), PNA's, DGN's and GAT's
    against the W=128 spill path's (rows 3, 4 and 5 against rows 19, 22 and
    21 with row 24), graph by graph over the stream. Returns the slot
    kernels' launches, counted as in ``run_main_path``: one per bucket."""
    import torch

    from flowgnn_tpu_torch.core.numerics import FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    kernels = {k: kernel_fn(k) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    for name in HEP_SLOT_MODELS:
        forward = registry.get(name).forward
        params = params_from_numpy(synthetic_params(name, SEED), FLOAT32, device)
        buckets, slot, _ = streams[name, "hep10k", HEP_SLOTS]
        other, what = ((name, "hep10k", SLOTS), "W=128 spill path") if name in SPILL_MODELS else (
            (name, "hep10k", ELL), "ELL path (W=512)")
        other_buckets, other_batches, _ = streams[other]
        want = torch.cat([forward(params, b, FLOAT32)[: p.num_graphs]
                          for p, b in zip(other_buckets, other_batches)])
        for k in kernels.values():
            k.launches = 0
        outs = [forward(params, b, FLOAT32) for b in slot]
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in kernels.items()}
        kname = MODEL_KERNELS[name][0]
        expect = {k: len(slot) if k == kname else 0 for k in KERNELS}
        check(counts == expect, f"{name} hep10k slots: launches {counts}, expected {expect}")
        for k, c in counts.items():
            launches[k] += c
        got = torch.cat([out[: p.num_graphs] for p, out in zip(buckets, outs)])
        check(got.shape == want.shape, f"{name} hep10k: {got.shape} vs {want.shape} graphs")
        err = agree(got, want, 1e-4)
        print(f"# hep10k {name} f32: slot path (W={HEP_SLOT_WINDOW}) vs {what}, "
              f"{got.shape[0]} graphs, max abs err {err:.3e}; max |out| "
              f"{want.abs().max().item():.3e}")
    return launches


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def valid_lanes(ops: dict) -> int:
    """The lanes of a kernel's layout that carry an edge: the work its
    message loop does on this data."""
    w = ops["window"]
    if "slot_meta" in ops:
        src = ops["slot_meta"][:, 0] + (w // 2 if w <= 512 else 0)
        return int(((src >= 0) & (src < w)).sum())
    if "ell_meta" in ops:
        m = ops["ell_meta"]
        return int(((m[:, 0] >= 0) & (m[:, 0] < w) & (m[:, 1] >= 0) & (m[:, 1] < w)).sum())
    key = next(k for k in ("slot_pstack", "slot_src", "slot_stack", "v_local", "stack")
               if k in ops)
    return int((ops[key] < w).sum())


# Operands with one row per lane of a layout whose pad lanes close each
# window's run (the ELL and block layouts, the blocked spill tail): the
# kernels stop at a run's last lane with an edge, so this data's work is
# the rows of the lanes that carry one, not the padded tensor.
LANE_OPERANDS = ("ee", "vals", "values", "u_local", "v_local", "ell_meta")
PACKED_WEIGHTS = ("mlp_tiles", "conv_tiles", "tower_tiles", "posttrans_tiles", "glue_tiles",
                  "layer_tiles")


def work(kname: str, ops: dict, out) -> tuple[float, float]:
    """(operations, bytes) of one launch on ``ops``: each input read once
    and the output written once, a per-lane operand of a run layout
    (``LANE_OPERANDS``) counted over the lanes that carry an edge only;
    operations count a multiply-add as two, over the lanes that carry an
    edge (E) and the rows of h (n), for the dominant terms (PERF.md gives
    the formulas)."""
    import torch

    e = valid_lanes(ops)
    # The bf16 kernels' packed weight chunks copy weights counted once as those.
    byts = nbytes(out) + sum(
        e * nbytes(v[0]) if k in LANE_OPERANDS else nbytes(v)
        for k, v in ops.items() if torch.is_tensor(v) and k not in PACKED_WEIGHTS)
    L = ops.get("num_layers", 1)
    h = ops["h0"] if "h0" in ops else ops.get("h", ops.get("values"))
    n, d = h.shape
    if kname in ("gin_local_model_slots", "gin_local_model"):
        hid, t = ops["w1_all"].shape[0] // L, ops["pred_w"].shape[1]
        ops_ = L * (4 * e * d + 4 * n * d * hid) + 2 * n * d * t
    elif kname in ("gcn_local_model_slots", "gcn_local_model"):
        ops_ = L * 5 * e * d + (L - 1) * 2 * n * d * d + 2 * n * d * ops["pred_w"].shape[1]
    elif kname == "pna_local_model":
        ops_ = L * (5 * e * d + 24 * n * d * d) + 2 * n * d * ops["mlp1_w"].shape[1]
    elif kname == "dgn_local_model":
        ops_ = L * (3 * e * d + 4 * n * d * d) + 2 * n * d * ops["mlp1_w"].shape[1]
    elif kname in ("gat_local_model_slots", "gat_mega_ablate"):
        nh = ops["num_heads"]
        ops_ = (L * (4 * n * d * nh + e * (2 * d + 4 * nh)) + (L - 1) * 4 * n * d * d
                + 2 * n * d * ops["pred_hd"].shape[1])
    elif kname == "pna_local_stats_ell":
        ops_ = 5 * e * d
    elif kname == "dgn_local_layer_slots":
        ops_ = 3 * e * d + 4 * n * d * d
    elif kname == "gat_local_message_slots":
        ops_ = e * (2 * d + 4 * ops["num_heads"])
    elif kname == "gin_local_layer_ell":
        ops_ = 4 * e * d + 4 * n * d * ops["w1"].shape[0]
    elif kname == "gcn_local_message_ell":
        ops_ = 5 * e * d
    elif kname == "gcn_local_layer_ell":
        ops_ = 5 * e * d + (0 if ops["w_next"] is None else 2 * n * d * d)
    elif kname == "pna_local_layer":
        ops_ = 5 * e * d + 24 * n * d * d
    elif kname == "dgn_local_layer_ell":
        ops_ = 3 * e * d + 4 * n * d * d
    elif kname == "dgn_local_message_ell":
        ops_ = 3 * e * d
    elif kname == "gat_local_message_ell":
        ops_ = e * (2 * d + 4 * ops["num_heads"])
    elif kname in ("gin_local_layer", ROW12):
        ops_ = 2 * e * d + 4 * n * d * ops["w1"].shape[0]
    elif kname == ROW31:  # row 13's message term: the bond rows' sum, + h_u, the row sum
        ops_ = 4 * e * d
    elif kname == PASS:  # rows 10 / 12's: + h_u, the row sum
        ops_ = 2 * e * d
    elif kname == "gin_layer_fused":
        ops_ = e * d + 4 * n * d * ops["w1"].shape[0]
    elif kname == "gat_local_layer_ell":
        nh = ops["num_heads"]
        ops_ = e * (2 * d + 4 * nh) + 4 * n * d * d + 4 * n * d * nh
    else:  # the windowed scatter: one add per lane and column
        ops_ = e * d
    return float(ops_), float(byts)


def spill_receivers(batch: dict):
    """Each scattered lane's receiver: the spill lanes' of a slot or an ELL
    batch, every lane's of an edge-block batch."""
    from flowgnn_tpu_torch.models import base

    if "blk_vlocal" in batch:
        return batch["receivers"].long()
    if "loc_ell" in batch:
        return batch["receivers"][batch["loc_ulocal"].shape[0] :].long()
    return base.spill_lanes(batch)[1]


def time_paths(streams: dict, device, keys) -> dict:
    """Phases 5 to 5d: per (model, profile, layout) of ``keys`` and dtype,
    the end-to-end µs/graph of the kernel path and of the plain edge-list
    path, and per kernel of the path its ms per stream alone, its plain
    version's, its bound, and for the spill scatter PyTorch's
    ``index_add_`` into [n, D'] of the same values; the kernels of
    ``REPLAYED`` also by graph replay (``graph_ms``). Returns those per
    (kernel, key, dtype)."""
    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import base, registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    record = {}
    for key in keys:
        name, profile, layout = key
        buckets, batches, plain = streams[key]
        forward, plain_forward = path_forward(key), registry.get(name).forward
        graphs = sum(b.num_graphs for b in buckets)
        params_np = synthetic_params(name, SEED)
        kw = forward_kw(key)
        plain_kw = {k: v for k, v in kw.items() if k == "return_intermediates"}
        kernels = sorted(path_launches(key, batches[0]))
        for prec in (BF16, FLOAT32):
            dt = str(prec.compute_dtype).replace("torch.", "")
            params = params_from_numpy(params_np, prec, device)
            tag = f"{name} {profile} {layout} {dt}"
            e2e = cuda_ms(lambda: [forward(params, b, prec, **kw) for b in batches])
            e2e_plain = cuda_ms(lambda: [plain_forward(params, b, prec, **plain_kw) for b in plain])
            print(f"# time {tag}: kernel path {e2e * 1e3 / graphs:.4f} us/graph, "
                  f"plain edge-list path {e2e_plain * 1e3 / graphs:.4f} us/graph ({graphs} graphs)")
            for kname in kernels:
                calls = kernel_calls(kname, name, params, batches, prec, key)
                kernel, ref = kernel_fn(kname), kernel_fn(kname, plain=True)
                outs = [kernel(**o) for o in calls]
                flops, byts = map(sum, zip(*(work(kname, o, out) for o, out in zip(calls, outs))))
                t_ops, t_bytes = flops / PEAK_FLOPS[dt] * 1e3, byts / MEM_BYTES_PER_S * 1e3
                rec = dict(
                    ms=cuda_ms(lambda: [kernel(**o) for o in calls]),
                    plain_ms=cuda_ms(lambda: [ref(**o) for o in calls]),
                    bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops > t_bytes else "bytes", library_ms=None,
                )
                line = ""
                if kname in REPLAYED:
                    # The device time of the same launches, the wrappers' host work left out.
                    rec["graph_ms"] = graph_ms(lambda: [kernel(**o) for o in calls])
                    line = f", by graph replay {rec['graph_ms']:.4f} ms"
                if kname == SCATTER:
                    # The same sums as one PyTorch call: the lane values
                    # index-added at their receivers into [n, D'].
                    lib = [(b["node_feat"].shape[0], spill_receivers(b), o["values"])
                           for b, o in zip(batches, calls[:: num_layers(name)])]
                    lib = [x for x in lib for _ in range(num_layers(name))]
                    rec["library_ms"] = cuda_ms(lambda: [
                        torch.zeros(n, v.shape[1], dtype=v.dtype, device=device).index_add_(0, r, v)
                        for n, r, v in lib])
                    line += f", index_add_ {rec['library_ms']:.4f} ms"
                print(f"# time {tag}: {kname} alone {rec['ms']:.4f} ms/stream ({len(calls)} "
                      f"launches), its plain version {rec['plain_ms']:.4f} ms{line}; bound "
                      f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({flops:.4g} operations, "
                      f"{byts:.4g} bytes)")
                record[(kname, key, prec)] = rec
    return record


def time_turns(streams: dict, device) -> dict:
    """Phase 5f: each tensor-core kernel alone on each of its
    ``TURN_CELLS``, its bf16 form (wgmma) and its f32 form (FMA) on the same
    stream in turns, bf16, f32, f32, bf16 (``cuda_ms``
    each), with its launches per stream, its bound in each dtype and the
    share of the bound each form reaches. Returns per (kernel, cell) the two
    forms' mean ms per stream."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    record = {}
    for kname, cells in TURN_CELLS.items():
        kernel = kernel_fn(kname)
        for key in cells:
            name = key[0]
            batches = streams[key][1]
            params_np = synthetic_params(name, SEED)
            calls, bound = {}, {}
            for prec in (BF16, FLOAT32):
                dt = str(prec.compute_dtype).replace("torch.", "")
                calls[prec] = kernel_calls(kname, name, params_from_numpy(params_np, prec, device),
                                           batches, prec, key)
                outs = [kernel(**o) for o in calls[prec]]
                flops, byts = map(sum, zip(*(work(kname, o, out)
                                             for o, out in zip(calls[prec], outs))))
                bound[prec] = max(flops / PEAK_FLOPS[dt], byts / MEM_BYTES_PER_S) * 1e3
            times = {BF16: [], FLOAT32: []}
            for prec in (BF16, FLOAT32, FLOAT32, BF16):
                times[prec].append(cuda_ms(lambda: [kernel(**o) for o in calls[prec]]))
            mean = {p: sum(times[p]) / 2 for p in times}
            record[(kname, key)] = (mean[BF16], mean[FLOAT32])
            print(f"# time {kname} {' '.join(key)} in turns ({len(calls[BF16])} launches): bf16 "
                  f"(wgmma) {times[BF16][0]:.4f} / {times[BF16][1]:.4f} ms, f32 (FMA) "
                  f"{times[FLOAT32][0]:.4f} / {times[FLOAT32][1]:.4f} ms per stream; bound bf16 "
                  f"{bound[BF16]:.4f} ms ({bound[BF16] / mean[BF16]:.1%} of it reached), f32 "
                  f"{bound[FLOAT32]:.4f} ms ({bound[FLOAT32] / mean[FLOAT32]:.1%})")
    return record


def time_split(streams: dict, device) -> None:
    """Phase 5g: rows 9, 3, 4, 5, 20, 22, 23, 10, 12, 25, 18, 15, 17, 21, 14,
    16, 19 and 24 by stage on their ``SPLIT_CELLS``, bf16 and f32: the kernel
    alone over the stream whole, with its product knocked out (``knockout``
    bit 0: the next conv, the tower, the posttrans, the glue, row 23's two
    products or the GIN MLP; rows 17, 21, 14, 16, 19 and 24 have none), with
    its messages,
    stats, channels or sums knocked out (bit 1) and with both, each as
    the device time of the stream's launches replayed from a CUDA graph
    (``graph_ms``; beside it the whole as the Python loop's ``cuda_ms``,
    which a knocked-out launch brings down only to its wrapper's host
    work); the share of the whole each stage takes (whole − without it) and
    what is left with both out (set-up, barriers, epilogues, the pooled
    head). A kernel whose launches a graph does not capture is split by the
    loop's times, and says so."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    stage = {"gcn_local_model": "messages", "pna_local_model": "stats",
             "dgn_local_model": "channels", "gat_local_model_slots": "messages",
             "pna_local_layer": "stats", "dgn_local_layer_slots": "channels",
             "gat_local_layer_ell": "messages", "gin_local_layer": "messages", ROW12: "messages",
             "gin_layer_fused": "message sums", "dgn_local_layer_ell": "channels",
             "gcn_local_layer_ell": "messages", "gat_local_message_ell": "messages",
             "gat_local_message_slots": "messages", "gcn_local_message_ell": "messages",
             "dgn_local_message_ell": "channels", "pna_local_stats_ell": "stats",
             SCATTER: "sums"}
    for kname, cells in SPLIT_CELLS.items():
        kernel = kernel_fn(kname)
        for key in cells:
            name = key[0]
            for prec in (BF16, FLOAT32):
                calls = kernel_calls(kname, name, params_from_numpy(synthetic_params(name, SEED),
                                                                    prec, device),
                                     streams[key][1], prec, key)
                # Rows 17, 21, 14, 16, 19 and 24 have no product: bit 0 knocks
                # nothing out.
                bits = (0, 2) if kname in MESSAGES_ONLY else (0, 1, 2, 3)
                loop = {k: cuda_ms(lambda: [kernel(**o, knockout=k) for o in calls]) for k in bits}
                try:
                    ms = {k: graph_ms(lambda: [kernel(**o, knockout=k) for o in calls])
                          for k in bits}
                    how = (f"device, graph replay; the loop {loop[0]:.4f}, without "
                           f"{'both' if 3 in loop else 'them'} {loop[max(bits)]:.4f}")
                except RuntimeError as e:
                    ms, how = loop, f"the loop: a graph does not capture it ({str(e)[:80]})"
                whole = ms[0]
                if len(bits) == 2:
                    print(f"# split {kname} {' '.join(key)} {prec.compute_dtype} ({len(calls)} "
                          f"launches): whole {whole:.4f} ms ({how}); "
                          f"without the {stage[kname]} {ms[2]:.4f}; {stage[kname]} "
                          f"{(whole - ms[2]) / whole:.1%}, the rest {ms[2] / whole:.1%}")
                    continue
                print(f"# split {kname} {' '.join(key)} {prec.compute_dtype} ({len(calls)} "
                      f"launches): whole {whole:.4f} ms ({how}); without the product {ms[1]:.4f}, "
                      f"without the {stage[kname]} {ms[2]:.4f}, without both {ms[3]:.4f}; "
                      f"product {(whole - ms[1]) / whole:.1%}, {stage[kname]} "
                      f"{(whole - ms[2]) / whole:.1%}, the rest {ms[3] / whole:.1%}")


def profile_path(key: tuple, streams: dict, device) -> None:
    """``--profile``: ``torch.profiler`` over ``PROFILE_PASSES`` bf16 passes
    of one path's whole stream, after 3 warm-up passes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flowgnn_tpu_torch.core.numerics import BF16
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    name, passes = key[0], PROFILE_PASSES
    # PLAIN: the plain edge-list batches of the stream's packing.
    batches = streams[key][2 if key[2] == PLAIN else 1]
    forward, kw = registry.get(name).forward, forward_kw(key)
    params = params_from_numpy(synthetic_params(name, SEED), BF16, device)
    run = lambda: [forward(params, b, BF16, **kw) for b in batches]
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(passes):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / passes
    events = prof.key_averages()
    dev_time = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    # Device-side events only: an ATen operator also carries its kernels' time.
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA and dev_time(e) > 0),
                     key=dev_time, reverse=True)
    busy = sum(dev_time(e) for e in kernels) / 1e3 / passes
    launches = sum(e.count for e in kernels) / passes
    print(f"# profile {' '.join(key)} bf16: wall {wall:.3f} ms/pass, device busy {busy:.3f} "
          f"ms/pass, idle share {1 - busy / wall:.1%}, {launches:.0f} device kernels per pass")
    for e in kernels[:8]:
        ms = dev_time(e) / 1e3 / passes
        print(f"#   device {ms:8.3f} ms/pass {ms / busy:6.1%} of busy  {e.count // passes:5d}x  "
              f"{e.key[:90]}")
    host = sorted((e for e in events if e.key.startswith("aten::")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host[:8]:
        print(f"#   host   {e.self_cpu_time_total / 1e3 / passes:8.3f} ms/pass  "
              f"{e.count // passes:5d}x  {e.key}")


def check_chained_matmul(device, max_err: dict) -> None:
    """Phase 6a's checks: row 26 on every SHAPES row at full size, in the
    row's dtype, against the closed form layers·K on all-ones operands
    (exactly) and against its plain version on seeded operands: int8
    exactly (integer products, the f32 sums in layer order), bf16 at 1e-4
    (``agree``; the K-sum order of the tensor cores against cuBLAS's)."""
    import numpy as np
    import torch

    from flowgnn_tpu_torch.bench import matmul_shapes as ms

    for i, (label, m, k, n, layers, grid, dtype) in enumerate(ms.SHAPES):
        a, b = ms.operands(m, k, n, grid, dtype, device)
        ones = ms.chained_matmul(a, b, layers, grid)
        torch.cuda.synchronize()
        check(bool((ones == layers * k).all()), f"{label}: all-ones output is not {layers * k}")
        rng = np.random.default_rng(SEED + i)
        if dtype == "int8":
            draw = lambda *sh: torch.from_numpy(rng.integers(-127, 128, sh).astype(np.int8))
        else:
            draw = lambda *sh: torch.from_numpy(rng.normal(0, 1, sh).astype(np.float32)).to(
                torch.bfloat16)
        a, b = draw(grid * m, k).to(device), draw(k, n).to(device)
        got = ms.chained_matmul(a, b, layers, grid)
        want = ms.chained_matmul_ref(a, b, layers, grid)
        torch.cuda.synchronize()
        if dtype == "int8":
            check(torch.equal(got, want), f"{label}: int8 kernel differs from its plain version")
            err = 0.0
        else:
            err = agree(got, want, 1e-4)
        max_err["chained_matmul"] = max(max_err["chained_matmul"], err)
        print(f"# kernel vs plain, chained_matmul {label} ({dtype}): all-ones == {layers * k}; "
              f"seeded max abs err {err:.3e} (max |out| {want.abs().max().item():.3e})")


def check_ablation(device, max_err: dict):
    """Phase 6b's checks on the 1028-graph molhiv GAT bucket at full width
    (seeded synthetic weights): at W=128 every (form, variant) of rows 27-30
    against its plain version, f32 at 1e-4 and bf16 at 5e-2 (``agree``), or
    1.5× what the plain version itself needs against its f64 run where that
    is more (``noexp`` divides by sums of signed raw scores that can
    cancel); at W=512 (clusters of four) each form's full, nogather, noglue
    and nopool the same way; at both windows each form's ``full`` against
    row 5's kernel in f32 at 1e-4. Prints each form's occupancy. Returns the
    W=128 bucket."""
    import torch

    from flowgnn_tpu_torch.bench import ablate_gat_mega as abl
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import base, gat
    from flowgnn_tpu_torch.ops.local_layer import gat_local_model_slots
    from flowgnn_tpu_torch.params.loaders import params_from_numpy, synthetic_gat_params

    first = None
    for window in (None, ABLATION_WIDE):
        batch = abl.molhiv_bucket(ABLATION_GRAPHS, window, device)
        first = first or batch
        w, s = batch["slot_geom"].shape
        print(f"# ablation bucket: {ABLATION_GRAPHS} graphs, {batch['node_feat'].shape[0]} rows, "
              f"W={w}, S={s}, prefix caps {base.slot_prefix_caps(batch, s)}")
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            params = params_from_numpy(synthetic_gat_params(SEED), prec, device)
            c = abl.ablation_operands(params, batch, prec)
            for form, (names, _) in abl.FORMS.items():
                ops = abl.form_operands(form, c)
                occ = abl.occupancy(form, prec.compute_dtype, w, ops["h0"].shape[1],
                                    ops["num_heads"], ops["gmax"], ops["pred_hd"].shape[1],
                                    device)
                print(f"# gat_mega_ablate {form} {prec.compute_dtype} W={w}: {occ['smem']} B of "
                      f"shared memory, ring {occ['stages']}, {occ['blocks_per_sm']} blocks an "
                      f"SM, {occ['clusters']} clusters in flight")
                f64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
                       for k, v in ops.items()}
                for v in names if window is None else [
                        v for v in ABLATION_WIDE_VARIANTS if v in names]:
                    got = abl.gat_mega_ablate(form, v, **ops)
                    want = abl.gat_mega_ablate_ref(form, v, **ops)
                    exact = abl.gat_mega_ablate_ref(form, v, **f64)
                    torch.cuda.synchronize()
                    # A knockout can overflow (nodivide: the numerators grow
                    # layer by layer past exp's range), as on the TPU: the
                    # kernel must overflow where the plain version does, and
                    # agree elsewhere.
                    fin = want.isfinite()
                    kind = lambda x: x[~fin].nan_to_num(nan=0.0, posinf=1.0, neginf=-1.0)
                    check(torch.equal(got.isfinite(), fin) and torch.equal(kind(got), kind(want)),
                          f"{form} {v} W={w}: non-finite outputs differ from the plain version's")
                    both = fin & exact.isfinite()
                    t = max(tol, 1.5 * needed_tol(want[both], exact[both]))
                    err = agree(got[fin], want[fin], t)
                    if prec is FLOAT32:
                        max_err["gat_mega_ablate"] = max(max_err["gat_mega_ablate"], err)
                    print(f"# kernel vs plain, gat_mega_ablate {form} {v} W={w} "
                          f"{prec.compute_dtype}: max abs err {err:.3e}, tol {t:.1e} (the plain "
                          f"version vs its f64 run {needed_tol(want[both], exact[both]):.1e}), "
                          f"{int((~fin).sum())} of {fin.numel()} outputs not finite; max finite "
                          f"|out| {want[fin].abs().max().item():.3e}")
                if prec is FLOAT32:
                    row5 = gat_local_model_slots(**gat.slot_kernel_operands(params, batch, prec))
                    err = agree(abl.gat_mega_ablate(form, "full", **ops), row5, 1e-4)
                    print(f"# gat_mega_ablate {form} full vs row 5's kernel, float32, W={w}: max "
                          f"abs err {err:.3e}")
    return first


def run_bench_tools(device) -> dict:
    """Phase 6's main path: the two tools' ``main`` as a user runs them,
    ``matmul_shapes`` over every SHAPES row and ``ablate_gat_mega`` over
    noop, slots, dense and every (form, variant), bf16, at its default
    window and at ``ABLATION_WIDE``, with every launch count set to 0
    before and read after. Returns the counts."""
    import torch

    from flowgnn_tpu_torch.bench import ablate_gat_mega as abl
    from flowgnn_tpu_torch.bench import matmul_shapes as ms

    names = ["slots", "dense"] + [v if form == "v1" else (form if v == "full" else f"{form}:{v}")
                                  for form, (vs, _) in abl.FORMS.items() for v in vs]
    reps = ["--reps", str(TOOL_REPS), "--trials", str(TOOL_TRIALS)]
    kernels = {k: kernel_fn(k) for k in KERNELS}
    for f in kernels.values():
        f.launches = 0
    ms.main(reps)
    for window in ([], ["--ell-window", str(ABLATION_WIDE)]):
        abl.main(reps + ["--graphs", str(ABLATION_GRAPHS), "--variants", ",".join(names)]
                 + window)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in kernels.items()}
    expect = {"chained_matmul", "gat_mega_ablate", "gat_local_model_slots"}
    check(all(counts[k] > 0 for k in expect) and not any(
        c for k, c in counts.items() if k not in expect), f"phase 6 launches {counts}")
    print(f"# phase 6 launches: {dict((k, counts[k]) for k in sorted(expect))}")
    return counts


def time_bench_kernels(device, batch: dict) -> dict:
    """Phase 6's timings: per SHAPES row row 26, its plain version and
    cuBLAS (``layers`` products of the same operands: bf16 ``torch.matmul``,
    int8 ``torch._int_mm``; timed here, used nowhere in the port), TF/s and
    the share of the dtype's peak; the ablation's record (``ABLATION_RECORD``,
    bf16) alone, by the loop and by graph replay, and its plain version.
    Returns the two records."""
    import torch

    from flowgnn_tpu_torch.bench import ablate_gat_mega as abl
    from flowgnn_tpu_torch.bench import matmul_shapes as ms
    from flowgnn_tpu_torch.core.numerics import BF16
    from flowgnn_tpu_torch.params.loaders import params_from_numpy, synthetic_gat_params

    record = {}
    for i, (label, m, k, n, layers, grid, dtype) in enumerate(ms.SHAPES):
        a, b = ms.operands(m, k, n, grid, dtype, device)
        lib = torch._int_mm if dtype == "int8" else torch.matmul
        peak = PEAK_FLOPS["bfloat16"] * (2 if dtype == "int8" else 1)
        ops = 2.0 * m * k * n * layers * grid
        byts = float(nbytes(a) + nbytes(b) + grid * m * n * 4)
        rec = dict(ms=cuda_ms(lambda: ms.chained_matmul(a, b, layers, grid)),
                   plain_ms=cuda_ms(lambda: ms.chained_matmul_ref(a, b, layers, grid), reps=5),
                   library_ms=cuda_ms(lambda: [lib(a, b) for _ in range(layers)]))
        t_ops, t_bytes = ops / peak * 1e3, byts / MEM_BYTES_PER_S * 1e3
        rec.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes")
        tf = lambda ms_: ops / ms_ / 1e9
        print(f"# time chained_matmul {label} ({dtype}): kernel {rec['ms']:.4f} ms "
              f"{tf(rec['ms']):.1f} TF/s ({tf(rec['ms']) * 1e12 / peak:.1%} of {peak / 1e12:.0f}), "
              f"cuBLAS {rec['library_ms']:.4f} ms {tf(rec['library_ms']):.1f} TF/s "
              f"({tf(rec['library_ms']) * 1e12 / peak:.1%}), plain version {rec['plain_ms']:.4f} "
              f"ms; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}")
        if i == CHAIN_RECORD:
            record["chained_matmul"] = rec
    params = params_from_numpy(synthetic_gat_params(SEED), BF16, device)
    form, variant = ABLATION_RECORD
    ops = abl.form_operands(form, abl.ablation_operands(params, batch, BF16))
    out = abl.gat_mega_ablate(form, variant, **ops)
    flops, byts = work("gat_mega_ablate", ops, out)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"] * 1e3, byts / MEM_BYTES_PER_S * 1e3
    record["gat_mega_ablate"] = dict(
        ms=cuda_ms(lambda: abl.gat_mega_ablate(form, variant, **ops)),
        graph_ms=graph_ms(lambda: abl.gat_mega_ablate(form, variant, **ops)),
        plain_ms=cuda_ms(lambda: abl.gat_mega_ablate_ref(form, variant, **ops), reps=5),
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
        library_ms=None)
    r = record["gat_mega_ablate"]
    print(f"# time gat_mega_ablate {form} {variant} bfloat16: {r['ms']:.4f} ms, by graph replay "
          f"{r['graph_ms']:.4f} ms, its plain version {r['plain_ms']:.4f} ms; bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({flops:.4g} operations, {byts:.4g} bytes)")
    return record


def check_message_forms(streams: dict, device, max_err: dict) -> None:
    """Phase 7a: row 31 and row 12's pass-through (the messages-only forms
    of ``csrc/gin_layer.cuh``) against their plain versions on layer 0's
    operands of GIN's first molhiv ELL bucket and of its hep10k W=128 ELL
    bucket with the longest spill tail (row 31: the ELL lanes, h and the
    layer's table; the pass-through: each lane's bond embedding and the
    spill tail's messages as ``m_spill``), f32 (1e-4) and bf16 (5e-2),
    seeded synthetic weights; then what the occupancy calculator says of
    the two forms and of row 13 at W=128."""
    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.ops import local_layer
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    cases = [(streams["gin", "molhiv", ELL][1][0], "molhiv W=128 bucket 0"),
             longest_ell_spill(streams, "gin")]
    for batch, what in cases:
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            params = params_from_numpy(synthetic_params("gin", SEED + 1), prec, device)
            for kname in (ROW31, PASS):
                ops = layer_operands(kname, "gin", params, batch, prec, {})
                err = compare(kname, ops, f"gin {what} layer 0 {prec.compute_dtype}", tol)
                if prec is FLOAT32:
                    max_err[kname] = max(max_err[kname], err)
    for lib, geometry in MESSAGE_OCCUPANCY.items():
        for dt in (torch.bfloat16, torch.float32):
            occ = local_layer.layer_occupancy(lib, dt, 128, geometry, device)
            print(f"# occupancy {lib} {dt} W=128 {geometry}: {occ['smem']} B of shared memory a "
                  f"block, weight ring {occ['stages']}, {occ['blocks_per_sm']} blocks an SM")


def time_pass_through(streams: dict, device) -> dict:
    """Phase 7c: row 12's pass-through alone on GIN's hep10k W=128 ELL
    stream (the bench entry's ELL stage cell), each bucket's layer-0
    operands once per layer (row 13's cell), bf16 and f32: the loop of
    wrapper calls, its launches replayed from a CUDA graph, the plain
    version, the bound. Returns the bf16 record."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    batches = streams["gin", "hep10k", ELL_LAYER][1]
    kernel, ref = kernel_fn(PASS), kernel_fn(PASS, plain=True)
    record = None
    for prec in (BF16, FLOAT32):
        dt = str(prec.compute_dtype).replace("torch.", "")
        params = params_from_numpy(synthetic_params("gin", SEED), prec, device)
        calls = [o for b in batches for o in [layer_operands(PASS, "gin", params, b, prec, {})]
                 for _ in range(num_layers("gin"))]
        outs = [kernel(**o) for o in calls]
        flops, byts = map(sum, zip(*(work(PASS, o, out) for o, out in zip(calls, outs))))
        t_ops, t_bytes = flops / PEAK_FLOPS[dt] * 1e3, byts / MEM_BYTES_PER_S * 1e3
        rec = dict(ms=cuda_ms(lambda: [kernel(**o) for o in calls]),
                   graph_ms=graph_ms(lambda: [kernel(**o) for o in calls]),
                   plain_ms=cuda_ms(lambda: [ref(**o) for o in calls]),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops > t_bytes else "bytes", library_ms=None)
        print(f"# time gin hep10k {ELL_LAYER} {dt}: {PASS} alone {rec['ms']:.4f} ms/stream "
              f"({len(calls)} launches), by graph replay {rec['graph_ms']:.4f} ms, its plain "
              f"version {rec['plain_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms by "
              f"{rec['bound_by']} ({flops:.4g} operations, {byts:.4g} bytes)")
        record = record or rec
    return record


# The figures of an entry record's ``detail`` that must be finite and
# positive on the card.
ENTRY_FIGURES = ("us_per_graph_avg", "graphs_per_s", "edges_per_s", "buckets", "roofline_frac",
                 "achieved_tflops", "dispatch_floor_ms", "dispatch_share", "spmm_time_us",
                 "spmm_roofline_frac", "graph_us_per_graph", "device_share", "h2d_ms",
                 "sm_clock_mhz", "window")


def run_entry(device) -> dict:
    """Phase 7b: the bench entry's ``main`` (``flowgnn_tpu_torch.bench.
    bench``) in-process over ``ENTRY_RUNS``, each record parsed and its
    figures finite and positive, the last line of a run of all six models
    the geometric mean; every launch count set to 0 before and read after:
    the stage benches must have launched row 19 (the slot stage) and row
    12's pass-through (the ELL stage). Returns the counts."""
    import torch

    from flowgnn_tpu_torch.bench import bench

    kernels = {k: kernel_fn(k) for k in KERNELS}
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    for run in ENTRY_RUNS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench.main(run + ["--reps", str(ENTRY_REPS), "--trials", str(ENTRY_TRIALS)])
        recs = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]
        args = bench.parse_args(run)
        names = list(bench.BASELINES_US[args.dataset]) if args.model == "all" else [args.model]
        check(rc == 0 and len(recs) == len(names) + (len(names) > 1), f"entry {run}: {recs}")
        positive = lambda x: isinstance(x, (int, float)) and math.isfinite(x) and x > 0
        for name, rec in zip(names, recs):
            figures = [rec["value"], rec["vs_baseline"]] + [rec["detail"][k] for k in ENTRY_FIGURES]
            check(rec["metric"] == f"{name}_{args.dataset}_synth_us_per_graph"
                  and all(positive(x) for x in figures), f"entry {run}: {rec}")
        if len(names) > 1:
            check(recs[-1]["metric"] == f"all_{args.dataset}_synth_geomean_speedup"
                  and positive(recs[-1]["value"]), f"entry {run}: {recs[-1]}")
        for rec in recs:
            print("# entry " + json.dumps(rec))
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in kernels.items()}
    check(counts["pna_local_stats_ell"] > 0 and counts[PASS] > 0,
          f"phase 7b: the stage benches launched {counts}")
    print(f"# phase 7b: {len(ENTRY_RUNS)} entry runs in {time.perf_counter() - t0:.1f} s, "
          f"launches {dict((k, c) for k, c in counts.items() if c)}")
    return counts


def stream_checks(stream, buckets, preds, sets: list, prec, tol: float, device) -> tuple:
    """Each bucket's predictions from the stream's replays against the same
    bucket's eager forward (``agree`` at ``tol``) and against the plain
    edge-list path in f32 on the same packing (``tol``; in bf16 the gate
    widens to 1.5× what the bf16 plain path needs, as ``check_outputs``).
    Returns the largest errors against the two."""
    import torch

    from flowgnn_tpu_torch.core.graphs import pack_graphs_aligned
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import base
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    spec = stream.spec
    params = [params_from_numpy(p, prec, device) for p in sets]
    p32 = [params_from_numpy(p, FLOAT32, device) for p in sets]
    off, e_eager, e_plain = 0, 0.0, 0.0
    for bucket, sid in buckets:
        batch, n = stream._make_batch(bucket)
        got = torch.as_tensor(preds[off:off + n])
        off += n
        eager = spec.forward(params[sid], base.to_device(batch, device), prec)[:n, 0].float().cpu()
        window, _ = base.choose_geometry(spec.name, max(g.num_nodes for g in bucket))
        packed = pack_graphs_aligned(bucket, *stream.caps, window=window,
                                     with_eigen=spec.needs_eigen)
        plain_batch = base.to_device(base.as_batch(packed), device)
        plain = spec.forward(p32[sid], plain_batch, FLOAT32)[:n, 0].float().cpu()
        t = tol
        if prec is BF16:
            pl = spec.forward(params[sid], plain_batch, prec)[:n, 0].float().cpu()
            t = max(tol, 1.5 * needed_tol(pl, plain))
        e_eager = max(e_eager, agree(got, eager, tol))
        e_plain = max(e_plain, agree(got, plain, t))
    check(off == len(preds), f"{spec.name}: {len(preds)} predictions, {off} in the buckets")
    return e_eager, e_plain


def check_stream(device) -> dict:
    """Phase 8a: ``runtime.stream.InferenceStream`` for each model over the
    molhiv stream at full width, weight sets SEED and SEED + 1 flipped
    halfway, f32 (1e-4) and bf16 (5e-2): a pin pass over every bucket, then
    ``run`` and ``run_pipelined`` (depth 2, chain 4, three workers), which
    must agree (1e-5). Every launch count is set to 0 just before ``run``
    and read just after: the model's whole-model kernel (rows 1-5) must have
    launched twice per captured (signature, weight set), for its eager pass
    and its capture, and nothing else; ``run_pipelined`` must launch nothing
    (it only replays). Some signature and weight set must serve more than
    one bucket, so that a graph is replayed on content other than what it
    was captured from. Each bucket's replayed predictions are held to its
    eager forward and to the plain path (``stream_checks``), and bucket 0
    under the other weight set must differ. Then GIN's bf16 stream over
    MANY_SETS weight sets, one bucket each, run twice: the second run
    replays graphs whose weight chunks the cache has evicted, and must
    equal the first and each bucket's eager forward. Returns the launches
    of the ``run`` calls."""
    import collections

    import numpy as np

    from flowgnn_tpu_torch.bench.host_app import edge_capacity
    from flowgnn_tpu_torch.core.graphs import laplacian_eigenvectors
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.core.synthetic import synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry
    from flowgnn_tpu_torch.ops import local_layer
    from flowgnn_tpu_torch.params.loaders import params_from_numpy
    from flowgnn_tpu_torch.runtime.stream import InferenceStream

    kernels = {k: kernel_fn(k) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    raw = synthetic_dataset("molhiv", seed=SEED, num_graphs=STREAM_GRAPHS)
    edge_cap = edge_capacity(raw, NODE_CAP)
    for name in MODELS:
        spec = registry.get(name)
        graphs = [laplacian_eigenvectors(g) for g in raw] if spec.needs_eigen else raw
        sets = [synthetic_params(name, SEED), synthetic_params(name, SEED + 1)]
        items = [(g, int(i >= len(graphs) // 2)) for i, g in enumerate(graphs)]
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            t0 = time.perf_counter()
            stream = InferenceStream(name, sets, prec, NODE_CAP, edge_cap, GRAPH_CAP,
                                     device=device)
            buckets = list(stream._bucketize(items))
            for bucket, _ in buckets:
                stream._make_batch(bucket)
            for f in kernels.values():
                f.launches = 0
            seq = np.array(list(stream.run(items)))
            counts = {k: f.launches for k, f in kernels.items() if f.launches}
            captured = stream.captured()
            whole = MODEL_KERNELS[name][0]
            check(counts == {whole: 2 * len(captured)},
                  f"stream {name} {prec.compute_dtype}: launches {counts}, {len(captured)} "
                  f"graphs captured")
            for k, c in counts.items():
                launches[k] += c
            served = collections.Counter(stream.last_buckets)
            check(len(stream.last_buckets) == len(buckets) and max(served.values()) > 1,
                  f"stream {name}: no captured graph served two buckets ({dict(served)})")
            pipe = np.array(list(stream.run_pipelined(items, depth=2, chain=4, workers=3)))
            check({k: f.launches for k, f in kernels.items() if f.launches} == counts,
                  f"stream {name}: run_pipelined launched kernels")
            check(seq.shape == pipe.shape == (len(graphs),) and np.isfinite(seq).all(),
                  f"stream {name}: {seq.shape} / {pipe.shape} predictions")
            np.testing.assert_allclose(pipe, seq, rtol=1e-5, atol=1e-5)
            dispatches = stream.last_dispatches
            e_eager, e_plain = stream_checks(stream, buckets, seq, sets, prec, tol, device)
            batch, n = stream._make_batch(buckets[0][0])
            other = registry.get(name).forward(
                params_from_numpy(sets[1 - buckets[0][1]], prec, device),
                base.to_device(batch, device), prec)[:n, 0].float().cpu().numpy()
            flip = float(np.abs(other - seq[:n]).max())
            check(flip > 1e-3 * max(1.0, float(np.abs(seq[:n]).max())),
                  f"stream {name}: the two weight sets agree on bucket 0 ({flip:.3e})")
            print(f"# stream {name} {prec.compute_dtype}: {len(graphs)} graphs, {len(buckets)} "
                  f"buckets, {len(captured)} graphs captured (buckets served "
                  f"{sorted(served.values())}), launches {counts}, pipelined in {dispatches} "
                  f"dispatches; replay vs eager {e_eager:.3e}, vs f32 plain path {e_plain:.3e}; "
                  f"the other weight set moves bucket 0 by {flip:.3e}; "
                  f"{time.perf_counter() - t0:.1f} s")
    # More weight sets than the chunk cache keeps, one bucket each.
    sets = [synthetic_params("gin", SEED + k) for k in range(MANY_SETS)]
    items = [(g, i // MANY_GRAPHS) for i, g in enumerate(raw[:MANY_SETS * MANY_GRAPHS])]
    stream = InferenceStream("gin", sets, BF16, NODE_CAP, edge_cap, GRAPH_CAP, device=device)
    first = np.array(list(stream.run(items)))
    again = np.array(list(stream.run(items)))
    buckets = list(stream._bucketize(items))
    check(len(buckets) == MANY_SETS > local_layer.MLP_TILE_SETS
          and np.array_equal(first, again), "stream gin: many weight sets' second run differs")
    e_eager, _ = stream_checks(stream, buckets, again, sets, BF16, 5e-2, device)
    print(f"# stream gin bf16 over {MANY_SETS} weight sets (the chunk cache keeps "
          f"{local_layer.MLP_TILE_SETS}): {len(stream.captured())} graphs captured, the second "
          f"run equal to the first, replay vs eager {e_eager:.3e}")
    return launches


def run_host_app(device) -> dict:
    """Phase 8b: ``bench.host_app.main`` in-process for each model on
    HOST_APP_GRAPHS graphs (weight sets flipped halfway) at one trial, its
    record parsed and its figures finite and positive, every launch count
    set to 0 before and read after: the model's whole-model kernel must
    have launched (at its captures). Returns the counts."""
    from flowgnn_tpu_torch.bench import host_app

    kernels = {k: kernel_fn(k) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    positive = lambda x: isinstance(x, (int, float)) and math.isfinite(x) and x > 0
    for name in MODELS:
        for f in kernels.values():
            f.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = host_app.main(["--model", name, "--graphs", str(HOST_APP_GRAPHS), "--flip",
                                str(HOST_APP_GRAPHS // 2), "--trials", "1"])
        recs = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
        check(rc == 0 and len(recs) == 1, f"host_app {name}: {out.getvalue()}")
        rec = recs[0]
        check(rec["metric"] == f"{name}_host_app_sustained_us_per_graph"
              and all(positive(rec[k]) for k in HOST_APP_FIGURES), f"host_app {name}: {rec}")
        counts = {k: f.launches for k, f in kernels.items() if f.launches}
        check(counts.get(MODEL_KERNELS[name][0], 0) > 0, f"host_app {name}: launches {counts}")
        for k, c in counts.items():
            launches[k] += c
        print("# host_app " + json.dumps(rec))
    return launches


def cli_main(argv: list) -> str:
    """``flowgnn_tpu_torch.cli.main(argv)`` in-process; returns its stdout
    (its stderr goes through)."""
    from flowgnn_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def counted_pass(fn, kernels: dict) -> tuple:
    """``fn()`` with every launch count set to 0 just before and read just
    after: (its result, the counts)."""
    import torch

    for f in kernels.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in kernels.items()}


def cli_counted(argv: list, kernels: dict) -> tuple:
    """``cli_main`` counted (``counted_pass``): (stdout, the counts that
    moved)."""
    out, counts = counted_pass(lambda: cli_main(argv), kernels)
    return out, {k: c for k, c in counts.items() if c}


def plain_predictions(name: str, graphs, device) -> dict:
    """The plain edge-list path's per-graph predictions of ``graphs``
    (transformed) on the card, f32 and bf16, in order: {dtype: [graphs]}."""
    import torch

    from flowgnn_tpu_torch.core.graphs import auto_edge_capacity, pack_dataset
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import base, registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    spec = registry.get(name)
    buckets = list(pack_dataset(graphs, NODE_CAP, auto_edge_capacity(graphs, NODE_CAP),
                                GRAPH_CAP, with_eigen=spec.needs_eigen))
    batches = [base.to_device(base.as_batch(b), device) for b in buckets]
    out = {}
    for prec in (FLOAT32, BF16):
        params = params_from_numpy(synthetic_params(name, SEED), prec, device)
        out[prec.compute_dtype] = torch.cat([
            spec.forward(params, b, prec)[: p.num_graphs, 0].float()
            for p, b in zip(buckets, batches)])
    return out


def held_to_plain(what: str, got, plain: dict) -> str:
    """bf16 predictions against the f32 plain path as ``check_outputs`` holds
    them (5e-2, or 1.5× what the bf16 plain path needs where larger);
    returns what to print."""
    import torch

    want = plain[torch.float32]
    got = torch.as_tensor(got, dtype=torch.float32, device=want.device)
    check(got.shape == want.shape and bool(got.isfinite().all()),
          f"{what}: {tuple(got.shape)} predictions, {tuple(want.shape)} graphs")
    tol = max(5e-2, 1.5 * needed_tol(plain[torch.bfloat16], want))
    err = agree(got, want, tol)
    return f"max abs err vs f32 plain path {err:.3e} (tol {tol:.3e})"


def read_outputs(path, count: int) -> list:
    """A ``<model>_output.txt``: ``count`` lines ``g1..g<count>`` in order."""
    lines = open(path).read().splitlines()
    keys = [ln.split(": ")[0] for ln in lines]
    check(keys == [f"g{i}" for i in range(1, count + 1)], f"{path}: {len(lines)} lines")
    return [float(ln.split(": ")[1]) for ln in lines]


def check_run_files(out_dir, records: list, trials: int) -> None:
    """``results.json``'s records and each ``summary.<model>.csv`` parse,
    their figures finite and positive."""
    positive = lambda x: isinstance(x, (int, float)) and math.isfinite(x) and x > 0
    for rec in records:
        check(all(positive(rec[k]) for k in ("num_graphs", "avg_ms", "ms_per_graph",
                                              "graphs_per_s")), f"cli run: {rec}")
        lines = open(f"{out_dir}/summary.{rec['model']}.csv").read().splitlines()
        row = lines[2].split(",")
        check(lines[0] == "Kernel Execution" and row[0] == f"{rec['model']}_compute_graphs"
              and int(row[1]) == trials and all(positive(float(x)) for x in row[2:]),
              f"summary.{rec['model']}.csv: {lines}")


def run_cli(device) -> dict:
    """Phase 9: the experiment CLI (``python -m flowgnn_tpu_torch.cli``)
    in-process on the card. Every launch count is set to 0 just before each
    command and read just after. 9a: ``run --model all`` over the 4113-graph
    molhiv stream, bf16, CLI_TRIALS trials: each model's whole-model slot
    kernel (rows 1-5) launched once a bucket and pass (the warm pass and the
    trials) and nothing else, each ``<model>_output.txt`` 4113 lines in order
    and held to the f32 plain path (``held_to_plain``), results.json and
    each summary CSV parsed. 9b: GIN on the 2048-graph hep10k sample (slots
    at W=512: row 1 counted) and GCN on CLI_SMALL graphs in the edge-block
    layout (row 24 once a layer, bucket and pass). 9c: GIN with ``--trace``:
    the Chrome trace names row 1's kernel among its device events. 9d:
    ``tune`` for GIN (ELL) and GAT (slots), each record ranked, finite and
    positive. 9e: CLI_OGB_GRAPHS seeded molhiv graphs written as OGB raw
    CSVs (binary labels; two tasks with blanks), ``convert`` (and
    ``--eigen`` for DGN), read back equal, ``accuracy`` for GIN, DGN and
    GIN's AP on the two-task set: each metric finite, each model's scores
    held to the f32 plain path. Returns the launches."""
    import collections
    import os
    import tempfile

    import numpy as np

    from flowgnn_tpu_torch import cli
    from flowgnn_tpu_torch.core import io as gio
    from flowgnn_tpu_torch.core import ogb
    from flowgnn_tpu_torch.core.synthetic import synthetic_molhiv
    from flowgnn_tpu_torch.models import registry

    t0 = time.perf_counter()
    kernels = {k: kernel_fn(k) for k in KERNELS}
    launches = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        # 9a: all six models on the molhiv stream.
        t = time.perf_counter()
        _, counts = cli_counted(["run", "--model", "all", "--dataset", "synth", "--num-graphs",
                                 str(STREAM_GRAPHS), "--trials", str(CLI_TRIALS), "--out",
                                 f"{tmp}/all"], kernels)
        records = json.load(open(f"{tmp}/all/results.json"))
        check([r["model"] for r in records] == list(cli.MODELS), f"cli run: {records}")
        expect = collections.Counter()
        for r in records:
            check(r["layout"] == SLOTS and r["num_graphs"] == STREAM_GRAPHS, f"cli run: {r}")
            expect[MODEL_KERNELS[r["model"]][0]] += r["buckets"] * (1 + CLI_TRIALS)
        check(counts == dict(expect), f"cli run all: launches {counts}, expected {dict(expect)}")
        launches.update(counts)
        check_run_files(f"{tmp}/all", records, CLI_TRIALS)
        raw = synthetic_molhiv(STREAM_GRAPHS, seed=0)
        for r in records:
            name = r["model"]
            got = read_outputs(f"{tmp}/all/{name}_output.txt", STREAM_GRAPHS)
            graphs = registry.apply_transforms(registry.get(name), raw)
            held = held_to_plain(f"cli run {name}", got, plain_predictions(name, graphs, device))
            print(f"# cli run {name} molhiv: {r['ms_per_graph'] * 1e3:.3f} us/graph "
                  f"({r['graphs_per_s']:.0f} graphs/s, avg of {CLI_TRIALS} trials), "
                  f"{r['buckets']} buckets, W={r['window']}, {held}")
        print(f"# phase 9a: {time.perf_counter() - t:.1f} s, launches {counts}")

        # 9b: hep10k slots at W=512; GCN's edge-block layout.
        _, counts = cli_counted(["run", "--model", "gin", "--dataset", "hep10k", "--num-graphs",
                                 str(HEP_GRAPHS), "--trials", "2", "--out", f"{tmp}/hep"],
                                kernels)
        (r,) = json.load(open(f"{tmp}/hep/results.json"))
        got = read_outputs(f"{tmp}/hep/gin_output.txt", HEP_GRAPHS)
        check((r["layout"], r["window"]) == (SLOTS, HEP_SLOT_WINDOW) and np.isfinite(got).all()
              and counts == {"gin_local_model_slots": 3 * r["buckets"]},
              f"cli run gin hep10k: {r}, launches {counts}")
        launches.update(counts)
        print(f"# cli run gin hep10k: {r['ms_per_graph'] * 1e3:.3f} us/graph, {r['buckets']} "
              f"buckets, W={r['window']}, launches {counts}")
        _, counts = cli_counted(["run", "--model", "gcn", "--layout", "blocked", "--num-graphs",
                                 str(CLI_SMALL), "--trials", "1", "--out", f"{tmp}/blk"], kernels)
        (r,) = json.load(open(f"{tmp}/blk/results.json"))
        check(r["layout"] == BLOCKED
              and counts == {SCATTER: 2 * r["buckets"] * num_layers("gcn")},
              f"cli run gcn blocked: {r}, launches {counts}")
        launches.update(counts)
        print(f"# cli run gcn blocked: {r['ms_per_graph'] * 1e3:.3f} us/graph, launches {counts}")

        # 9c: a traced run.
        _, counts = cli_counted(["run", "--model", "gin", "--num-graphs", str(CLI_SMALL),
                                 "--trials", "1", "--trace", f"{tmp}/trace", "--out",
                                 f"{tmp}/traced"], kernels)
        (r,) = json.load(open(f"{tmp}/traced/results.json"))
        check(counts == {"gin_local_model_slots": 2 * r["buckets"]}, f"cli trace: {counts}")
        launches.update(counts)
        (trace,) = os.listdir(f"{tmp}/trace")
        events = json.load(open(f"{tmp}/trace/{trace}"))["traceEvents"]
        device_kernels = [e for e in events if e.get("cat") == "kernel"]
        row1 = [e for e in device_kernels if ROW1_SYMBOL in e.get("name", "")]
        check(len(row1) == r["buckets"], f"cli trace: {len(row1)} {ROW1_SYMBOL} events of "
              f"{len(device_kernels)} device kernels, {r['buckets']} buckets")
        print(f"# cli trace: {trace}, {len(events)} events, {len(device_kernels)} device kernels, "
              f"{len(row1)} of row 1 ({sum(e.get('dur', 0) for e in row1):.1f} us)")

        # 9d: tune.
        for name, windows in CLI_TUNES:
            out, counts = cli_counted(["tune", "--model", name, "--windows", windows,
                                       "--num-graphs", str(CLI_SMALL), "--reps", "5",
                                       "--trials", "1"], kernels)
            rec = json.loads(out.splitlines()[-1])
            us = [x["us_per_graph"] for x in rec["results"]]
            check(rec["model"] == name and us and us == sorted(us)
                  and all(math.isfinite(x) and x > 0 for x in us)
                  and {x["window"] for x in rec["results"]} == {int(w) for w in windows.split(",")},
                  f"cli tune {name}: {rec}")
            launches.update(counts)
            print(f"# cli tune {name}: " + json.dumps(rec))

        # 9e: OGB raw CSVs -> convert -> accuracy.
        rng = np.random.default_rng(SEED)
        graphs = synthetic_molhiv(CLI_OGB_GRAPHS, seed=SEED + 9)
        binary = rng.integers(0, 2, (CLI_OGB_GRAPHS, 1)).astype(np.float64)
        two = rng.integers(0, 2, (CLI_OGB_GRAPHS, 2)).astype(np.float64)
        two[rng.random(two.shape) < 0.2] = np.nan
        ogb.write_ogb_raw(f"{tmp}/raw", graphs, binary)
        ogb.write_ogb_raw(f"{tmp}/raw2", graphs, two, gz=True)
        for eigen in (False, True):
            ds = f"{tmp}/ds{'_eig' * eigen}"
            cli_main(["convert", "--raw", f"{tmp}/raw", "--out", ds] + ["--eigen"] * eigen)
            back = list(gio.read_dataset(ds, with_eigen=eigen))
            check(len(back) == CLI_OGB_GRAPHS and all(
                np.array_equal(a.node_feat, b.node_feat) and np.array_equal(a.edge_index,
                                                                            b.edge_index)
                and np.array_equal(a.edge_attr, b.edge_attr) for a, b in zip(back, graphs))
                and np.array_equal(ogb.load_labels(ds), binary), f"cli convert {ds}")
        scored = []
        original = cli.accuracy_scores
        cli.accuracy_scores = lambda *a, **k: scored.append(original(*a, **k)) or scored[-1]
        try:
            for name, ds, metric in (("gin", "ds", "auto"), ("dgn", "ds_eig", "auto"),
                                     ("gin", "raw2", "ap")):
                out, counts = cli_counted(["accuracy", "--model", name, "--dataset",
                                           f"{tmp}/{ds}", "--metric", metric], kernels)
                rec = json.loads(out.splitlines()[-1])
                check(rec["metric"] == ("ap" if ds == "raw2" else "rocauc")
                      and math.isfinite(rec["value"]) and rec["num_graphs"] == CLI_OGB_GRAPHS
                      and counts.get(MODEL_KERNELS[name][0], 0) > 0
                      and set(counts) == {MODEL_KERNELS[name][0]},
                      f"cli accuracy {name} {ds}: {rec}, launches {counts}")
                launches.update(counts)
                spec = registry.get(name)
                ref = (ogb.load_ogb_raw(f"{tmp}/{ds}")[0] if ds == "raw2" else
                       list(gio.read_dataset(f"{tmp}/{ds}", with_eigen=spec.needs_eigen)))
                held = held_to_plain(f"cli accuracy {name} {ds}", scored[-1][0],
                                     plain_predictions(name, registry.apply_transforms(spec, ref),
                                                       device))
                print(f"# cli accuracy {name} {ds}: {rec['metric']} {rec['value']:.6f}, "
                      f"launches {counts}, {held}")
        finally:
            cli.accuracy_scores = original
    print(f"# phase 9: {time.perf_counter() - t0:.1f} s")
    return dict(launches)


def grid_ulps(got, want, spec) -> float:
    """The largest |got − want| in ulps of the ap_fixed grid ``spec``."""
    import torch

    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return (got - want).abs().max().item() * spec.scale


def check_on_grid(what: str, x, spec) -> None:
    """``x`` finite, exactly on the grid of ``spec`` and within its range."""
    import torch

    x = torch.as_tensor(x).double()
    s = x * spec.scale
    check(bool(s.isfinite().all()) and torch.equal(s, s.round())
          and spec.min_val <= x.min().item() and x.max().item() <= spec.max_val,
          f"{what}: off the ap_fixed<{spec.width},{spec.int_bits}> grid or out of range")


def run_fixed(streams: dict, device, smi: str) -> dict:
    """Phases 10a and 10b: every model in the fixed mode (its registry grid,
    f32) over the 4113-graph molhiv stream. 10a, the edge-block layout: row
    24 launched once per layer and bucket and no other kernel; the
    predictions on the grid, in range, equal bits in a second pass, within
    FIXED_ULPS of the same pass with row 24's plain version
    (``plain_versions``), and their envelope against the f32 plain path on the
    same packing printed beside the JAX test's limit (gated on
    FIXED_ENVELOPE's models). 10b, the slot layout: no kernel launched (the
    plain loop), each graph's prediction within FIXED_ULPS of 10a's. Each
    pass timed (CUDA events, eager) beside the f32 float plain path and the
    f32 float kernel path of the edge-block layout. Returns row 24's
    launches of the 10a passes."""
    import torch

    from flowgnn_tpu_torch.core.numerics import FLOAT32, Precision
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    kernels = {k: kernel_fn(k) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    for name in MODELS:
        spec = registry.get(name)
        prec = Precision(fixed=spec.fixed_spec)
        fx = prec.fixed
        params_np = synthetic_params(name, SEED)
        pf = params_from_numpy(params_np, prec, device)
        p32 = params_from_numpy(params_np, FLOAT32, device)
        buckets, batches, plain = streams[name, "molhiv", BLOCKED]
        s_buckets, s_batches, _ = streams[name, "molhiv", SLOTS]

        def preds(params, bs, bks, p=prec):
            return torch.cat([spec.forward(params, b, p)[:k.num_graphs, 0]
                              for b, k in zip(bs, bks)])

        a, counts = counted_pass(lambda: preds(pf, batches, buckets), kernels)
        expect = {SCATTER: num_layers(name) * len(batches)}
        check(counts == {k: expect.get(k, 0) for k in KERNELS},
              f"phase 10a {name}: launches {dict((k, c) for k, c in counts.items() if c)}, "
              f"expected {expect}")
        launches[SCATTER] += counts[SCATTER]
        check(a.numel() == STREAM_GRAPHS and torch.equal(a, preds(pf, batches, buckets)),
              f"phase 10a {name}: two passes differ")
        check_on_grid(f"phase 10a {name}", a, fx)
        with plain_versions():
            ref, counts = counted_pass(lambda: preds(pf, batches, buckets), kernels)
        check(not any(counts.values()), f"phase 10a {name}: the plain version launched")
        e_plain = grid_ulps(a, ref, fx)
        f32 = preds(p32, plain, buckets, FLOAT32)
        env = ((a - f32).abs() / f32.abs().clamp_min(1)).max().item()
        b, counts = counted_pass(lambda: preds(pf, s_batches, s_buckets), kernels)
        check(not any(counts.values()),
              f"phase 10b {name}: launches {dict((k, c) for k, c in counts.items() if c)}")
        check_on_grid(f"phase 10b {name}", b, fx)
        e_slots = grid_ulps(b, a, fx)
        times = {
            "fixed edge-block": cuda_ms(lambda: preds(pf, batches, buckets), reps=3, warmup=1),
            "fixed slots": cuda_ms(lambda: preds(pf, s_batches, s_buckets), reps=3, warmup=1),
            "f32 plain": cuda_ms(lambda: preds(p32, plain, buckets, FLOAT32), reps=3, warmup=1),
            "f32 edge-block kernel path": cuda_ms(
                lambda: preds(p32, batches, buckets, FLOAT32), reps=3, warmup=1),
        }
        limit = FIXED_ENVELOPE.get(name)
        print(f"# phase 10 {name} ap_fixed<{fx.width},{fx.int_bits}> over {a.numel()} molhiv "
              f"graphs: 10a edge-block: row 24 x{expect[SCATTER]} ({len(batches)} buckets), on "
              f"the grid, two passes equal; vs row 24's plain version {e_plain:g} ulps (tol "
              f"{FIXED_ULPS[name]}); envelope vs f32 plain path {env:.4f} (JAX test limit "
              f"{0.6 if name == 'dgn' else 0.15}, {'gated' if limit else 'not gated'}); "
              f"10b slots: no launch, vs 10a {e_slots:g} ulps; us/graph: "
              + ", ".join(f"{k} {1e3 * t / a.numel():.4f}" for k, t in times.items())
              + f" ({smi})")
        check(e_plain <= FIXED_ULPS[name] and e_slots <= FIXED_ULPS[name],
              f"phase 10 {name}: {e_plain:g} / {e_slots:g} grid ulps past {FIXED_ULPS[name]}")
        check(limit is None or env < limit, f"phase 10a {name}: envelope {env:.4f} > {limit}")
    return launches


def check_fixed_stream(device) -> None:
    """Phase 10c: ``runtime.stream.InferenceStream`` in the fixed mode for
    FIXED_STREAM_MODELS (each at its grid) over FIXED_STREAM_GRAPHS molhiv
    graphs, weight sets SEED and SEED + 1 flipped halfway: after a pin pass,
    ``run`` with every launch count set to 0 just before and read just
    after launches no kernel (the plain loop) and captures one CUDA graph
    per (signature, weight set) of its buckets; ``run_pipelined`` captures
    none more; the two agree within FIXED_ULPS, lie on the grid, and each
    bucket's replayed predictions are within FIXED_ULPS of its eager fixed
    forward."""
    import numpy as np

    from flowgnn_tpu_torch.bench.host_app import edge_capacity
    from flowgnn_tpu_torch.core.graphs import laplacian_eigenvectors
    from flowgnn_tpu_torch.core.numerics import Precision
    from flowgnn_tpu_torch.core.synthetic import synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy
    from flowgnn_tpu_torch.runtime.stream import InferenceStream

    kernels = {k: kernel_fn(k) for k in KERNELS}
    raw = synthetic_dataset("molhiv", seed=SEED, num_graphs=FIXED_STREAM_GRAPHS)
    edge_cap = edge_capacity(raw, NODE_CAP)
    for name in FIXED_STREAM_MODELS:
        t0 = time.perf_counter()
        spec = registry.get(name)
        prec = Precision(fixed=spec.fixed_spec)
        graphs = [laplacian_eigenvectors(g) for g in raw] if spec.needs_eigen else raw
        sets = [synthetic_params(name, SEED), synthetic_params(name, SEED + 1)]
        items = [(g, int(i >= len(graphs) // 2)) for i, g in enumerate(graphs)]
        stream = InferenceStream(name, sets, prec, NODE_CAP, edge_cap, GRAPH_CAP, device=device)
        buckets = list(stream._bucketize(items))
        for bucket, _ in buckets:
            stream._make_batch(bucket)
        seq, counts = counted_pass(lambda: np.array(list(stream.run(items))), kernels)
        check(not any(counts.values()),
              f"phase 10c {name}: launches {dict((k, c) for k, c in counts.items() if c)}")
        captured = len(stream.captured())
        check(captured == len(set(stream.last_buckets)),
              f"phase 10c {name}: {captured} graphs captured for "
              f"{len(set(stream.last_buckets))} (signature, weight set) pairs")
        pipe = np.array(list(stream.run_pipelined(items, depth=2, chain=4, workers=3)))
        check(len(stream.captured()) == captured, f"phase 10c {name}: run_pipelined captured")
        check(seq.shape == pipe.shape == (len(graphs),), f"phase 10c {name}: {seq.shape}")
        check_on_grid(f"phase 10c {name}", seq, prec.fixed)
        e_pipe = grid_ulps(pipe, seq, prec.fixed)
        params = [params_from_numpy(p, prec, device) for p in sets]
        off, e_eager = 0, 0.0
        for bucket, sid in buckets:
            batch, n = stream._make_batch(bucket)
            eager = spec.forward(params[sid], base.to_device(batch, device), prec)[:n, 0].cpu()
            e_eager = max(e_eager, grid_ulps(seq[off:off + n], eager, prec.fixed))
            off += n
        print(f"# phase 10c stream {name} ap_fixed<{prec.fixed.width},{prec.fixed.int_bits}>: "
              f"{len(graphs)} graphs, {len(buckets)} buckets, {captured} graphs captured, no "
              f"launch; run_pipelined vs run {e_pipe:g} ulps, replay vs eager {e_eager:g} ulps "
              f"(tol {FIXED_ULPS[name]}); {time.perf_counter() - t0:.1f} s")
        check(off == len(graphs) and max(e_pipe, e_eager) <= FIXED_ULPS[name],
              f"phase 10c {name}: {e_pipe:g} / {e_eager:g} ulps past {FIXED_ULPS[name]}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the per-layer paths only")
    ap.add_argument("--paths", default="",
                    help="--profile: only the paths whose 'model profile layout' starts with one "
                         "of these comma-separated prefixes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flowgnn_tpu_torch.bench import ablate_gat_mega, matmul_shapes
    from flowgnn_tpu_torch.core.numerics import BF16
    from flowgnn_tpu_torch.ops import build, local_layer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if args.profile:
        print(smi)
        hep = lambda layout: ("hep10k", HEP_GRAPHS, layout, dev, SPILL_WINDOW)
        mol = lambda layout: ("molhiv", STREAM_GRAPHS, layout, dev)
        paths = [((name, "hep10k", SLOTS), hep(SLOTS)) for name in SPILL_MODELS]
        # PNA's, DGN's and GAT's hep10k slot paths at W=512 beside their spill
        # paths; GCN's hep10k ELL path at W=512 (row 9 once per bucket) beside
        # its W=128 one.
        paths += [((name, "hep10k", HEP_SLOTS), ("hep10k", HEP_GRAPHS, SLOTS, dev, HEP_SLOT_WINDOW))
                  for name in SPILL_MODELS]
        paths += [((name, "hep10k", HEP_SLOT_INTER), ("hep10k", HEP_GRAPHS, SLOTS, dev,
                                                      HEP_SLOT_WINDOW))
                  for name in HEP_INTER_MODELS]
        paths += [(("gcn", "hep10k", ELL), ("hep10k", HEP_GRAPHS, ELL, dev))]
        paths += [((name, "hep10k", ELL_LAYER), hep(ELL)) for name in LAYER_MODELS]
        paths += [(("gat", "hep10k", ELL_LAYER_FUSED), hep(ELL)),
                  (("gin", "molhiv", BLOCKED), mol(True)), (("gin", "molhiv", FUSED), mol(True)),
                  (("gin", "molhiv", LOCAL), mol(LOCAL)),
                  (("pna", "molhiv", BLOCKED), mol(True)), (("pna", "molhiv", PLAIN), mol(True))]
        prefixes = [p.strip() for p in args.paths.split(",") if p.strip()]
        for key, stream in paths:
            if not prefixes or any(" ".join(key).startswith(p) for p in prefixes):
                profile_path(key, {key: make_stream(key[0], *stream)}, dev)
        return 0
    kind = torch.cuda.get_device_name(0)
    print(f"# device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # 2. Build, all sources at once.
    t0 = time.perf_counter()
    libs = build.build_libraries(local_layer.LIBRARIES + matmul_shapes.LIBRARIES
                                 + ablate_gat_mega.LIBRARIES)
    for name in local_layer.LIBRARIES:
        local_layer._library(name)
    matmul_shapes._library()
    ablate_gat_mega._library()
    print(f"# build of {len(libs)} kernels: {time.perf_counter() - t0:.1f} s")
    for so in libs:
        print(f"# {so.name}:")
        for line in so.with_suffix(".log").read_text().splitlines():
            print(f"#   {line}")
    check_sass(libs)

    # The main paths' host half (phases 3, 3b and 3c run on real buckets' layouts).
    t0 = time.perf_counter()
    streams = {(name, "molhiv", SLOTS): make_stream(name, "molhiv", STREAM_GRAPHS, SLOTS, dev)
               for name in MODELS}
    for name in ELL_MODELS:
        streams[name, "hep10k", ELL] = make_stream(name, "hep10k", HEP_GRAPHS, ELL, dev)
    for name in LAYER_MODELS:
        streams[name, "molhiv", ELL] = make_stream(name, "molhiv", STREAM_GRAPHS, ELL, dev)
    for name in SPILL_MODELS:
        streams[name, "hep10k", SLOTS] = make_stream(name, "hep10k", HEP_GRAPHS, SLOTS, dev,
                                                     window=SPILL_WINDOW)
    for name in LAYER_MODELS:
        streams[name, "hep10k", ELL_LAYER] = make_stream(name, "hep10k", HEP_GRAPHS, ELL, dev,
                                                         window=SPILL_WINDOW)
    # The hep10k slot stream at W=512 (GIN's, GIN-VN's and GCN's the ELL W=512
    # stream's packing).
    for name in HEP_SLOT_MODELS:
        streams[name, "hep10k", HEP_SLOTS] = make_stream(name, "hep10k", HEP_GRAPHS, SLOTS, dev,
                                                         window=HEP_SLOT_WINDOW)
    for name in INTER_MODELS:  # the molhiv ELL stream, run with intermediates
        streams[name, "molhiv", ELL_INTER] = streams[name, "molhiv", ELL]
    # PNA's molhiv slot stream, run with intermediates (row 20); PNA's and
    # DGN's hep10k slot stream at W=512, run with intermediates (rows 20, 22).
    streams["pna", "molhiv", SLOT_INTER] = streams["pna", "molhiv", SLOTS]
    # GAT's molhiv slot stream, run with intermediates (row 21, divided).
    streams["gat", "molhiv", SLOT_INTER] = streams["gat", "molhiv", SLOTS]
    for name in HEP_INTER_MODELS:
        streams[name, "hep10k", HEP_SLOT_INTER] = streams[name, "hep10k", HEP_SLOTS]
    # The edge-block layout for every model, GIN's also with its fused layer.
    for name in MODELS:
        streams[name, "molhiv", BLOCKED] = make_stream(name, "molhiv", STREAM_GRAPHS, True, dev)
    streams["gin", "molhiv", FUSED] = streams["gin", "molhiv", BLOCKED]
    # The legacy local layout: the aligned molhiv stream, and one bucket whose
    # 300-node graphs cross windows.
    for name in ("gin", "gin-vn"):
        streams[name, "molhiv", LOCAL] = make_stream(name, "molhiv", STREAM_GRAPHS, LOCAL, dev)
        streams[name, BIG, LOCAL] = big_local_stream(name, dev)
    # Streams there already, driven through row 12 and through GAT's row 23.
    streams["gin", "molhiv", ELL_EE] = streams["gin", "molhiv", ELL]
    streams["gat", "molhiv", ELL_FUSED] = streams["gat", "molhiv", ELL]
    streams["gat", "hep10k", ELL_LAYER_FUSED] = streams["gat", "hep10k", ELL_LAYER]
    for (name, profile, layout), (buckets, batches, _) in streams.items():
        if layout == SLOTS and profile == "molhiv":
            w, s = batches[0]["slot_geom"].shape
            nw = -(-batches[0]["node_feat"].shape[0] // w)
            print(f"# {name}: {len(buckets)} buckets, {sum(b.num_graphs for b in buckets)} "
                  f"graphs, window {w}, slots {s}, prefix lanes per window "
                  f"{batches[0]['slot_meta'].shape[0] // nw}")
    describe_ell(streams)
    describe_hep_slots(streams)
    describe_spill(streams)
    describe_ell_spill(streams)
    describe_blocks(streams)
    print(f"# host pack of {len({id(v) for v in streams.values()})} streams: "
          f"{time.perf_counter() - t0:.1f} s")

    # 3. Kernels against their plain versions; 4. the main paths; 5. timings.
    slot_keys = [(name, "molhiv", SLOTS) for name in MODELS]
    hep_keys = [(name, "hep10k", ELL) for name in ELL_MODELS]
    hep_slot_keys = [(name, "hep10k", HEP_SLOTS) for name in HEP_SLOT_MODELS]
    spill_keys = [(name, "hep10k", SLOTS) for name in SPILL_MODELS]
    layer_keys = [(name, "hep10k", ELL_LAYER) for name in ELL_MODELS]
    layer_keys += [(name, "molhiv", ELL_INTER) for name in INTER_MODELS]
    # Phase 4e's paths: PNA's row 20, DGN's and GAT's ELL paths, PNA's row 20
    # and DGN's row 22 on hep10k at W=512, GAT's row 21 on molhiv slots.
    new_keys = [("pna", "molhiv", SLOT_INTER), ("dgn", "molhiv", ELL), ("gat", "molhiv", ELL),
                ("dgn", "hep10k", ELL_LAYER), ("gat", "hep10k", ELL_LAYER)]
    new_keys += [(name, "hep10k", HEP_SLOT_INTER) for name in HEP_INTER_MODELS]
    new_keys += [("gat", "molhiv", SLOT_INTER)]
    # Phase 4f's paths: the edge-block and legacy local layouts, row 12's
    # layer loop, GAT's fused layer. The one-bucket local streams are not timed.
    block_keys = [(name, "molhiv", BLOCKED) for name in MODELS] + [("gin", "molhiv", FUSED)]
    block_keys += [(name, "molhiv", LOCAL) for name in ("gin", "gin-vn")]
    block_keys += [("gin", "molhiv", ELL_EE), ("gat", "molhiv", ELL_FUSED),
                   ("gat", "hep10k", ELL_LAYER_FUSED)]
    big_keys = [(name, BIG, LOCAL) for name in ("gin", "gin-vn")]
    max_err = dict.fromkeys(KERNELS, 0.0)
    check_kernels(streams, dev, max_err)
    check_gin_kernels(streams, dev, max_err)
    check_cluster_kernels(streams, dev, max_err)
    check_ell_kernels(streams, dev, max_err)
    check_layer_kernels(streams, dev, max_err)
    check_ell_layer_kernels(streams, dev, max_err)
    check_new_layer_kernels(streams, dev, max_err)
    check_layer_windows(streams, dev, max_err)
    check_block_layer_kernels(streams, dev, max_err)
    check_block_layer_widths(streams, dev, max_err)
    launches = run_main_path(streams, dev, slot_keys + hep_keys + hep_slot_keys + spill_keys
                             + layer_keys + new_keys + block_keys + big_keys)
    for k, n in check_ell_matches_slots(streams, dev).items():
        launches[k] += n
    for k, n in check_hep_slots_match_ell(streams, dev).items():
        launches[k] += n
    check_hep_inter_matches_model(streams, dev)
    molhiv_ell_keys = [(name, "molhiv", ELL) for name in ELL_MODELS]
    record = time_paths(streams, dev, slot_keys + hep_keys + hep_slot_keys + molhiv_ell_keys
                        + spill_keys + layer_keys + new_keys + block_keys)
    time_turns(streams, dev)
    time_split(streams, dev)

    # 6. The bench tools: checks, their main runs (counted), timings.
    check_chained_matmul(dev, max_err)
    batch = check_ablation(dev, max_err)
    for k, n in run_bench_tools(dev).items():
        launches[k] += n
    for kname, rec in time_bench_kernels(dev, batch).items():
        record[(kname, None, BF16)] = rec

    # 7. The messages-only forms of rows 13 and 12; row 31's layer loop over
    # GIN's hep10k W=128 ELL stream (counted, checked, timed as in phases 4
    # and 5); the bench entry's runs (counted).
    t0 = time.perf_counter()
    msg_key = ("gin", "hep10k", ELL_MSG)
    streams[msg_key] = streams["gin", "hep10k", ELL_LAYER]
    check_message_forms(streams, dev, max_err)
    for k, n in run_main_path(streams, dev, [msg_key]).items():
        launches[k] += n
    record.update(time_paths(streams, dev, [msg_key]))
    record[(PASS, None, BF16)] = time_pass_through(streams, dev)
    for k, n in run_entry(dev).items():
        launches[k] += n
    print(f"# phase 7: {time.perf_counter() - t0:.1f} s")

    # 8. The streaming runtime (counted, checked) and the host application.
    t0 = time.perf_counter()
    for k, n in check_stream(dev).items():
        launches[k] += n
    for k, n in run_host_app(dev).items():
        launches[k] += n
    print(f"# phase 8: {time.perf_counter() - t0:.1f} s")

    # 9. The experiment CLI (counted, checked).
    for k, n in run_cli(dev).items():
        launches[k] += n

    # 10. The fixed mode: every model on the edge-block (counted: row 24) and
    # slot layouts, checked and timed; the stream's CUDA graphs of it.
    t0 = time.perf_counter()
    for k, n in run_fixed(streams, dev, smi).items():
        launches[k] += n
    check_fixed_stream(dev)
    print(f"# phase 10: {time.perf_counter() - t0:.1f} s")

    print(smi)
    kernels = []
    for kname, (_, source, replaces, key) in KERNELS.items():
        check(launches[kname] > 0, f"{kname}: no launch on the main paths")
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err[kname],
            **record[(kname, key, BF16)],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
