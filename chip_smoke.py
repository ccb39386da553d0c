#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py          # from the repository root, one CUDA GPU
    python3 chip_smoke.py --depth-cap 128   # an earlier build's kernels,
                                            # which refused deeper trees

Nineteen paths, each driven through the entry points a user calls, with every
kernel launch and plain-version call counted from zero just before it and
read just after (every kernel of the path must have launched, no plain
version may have run):

  main     the paper's query on the ``rpf`` backend at the paper's own
           MNIST-784 configuration (N = 60,000, d = 784, L = 80, C = 12,
           r = 0.3): ``build_index`` on ``cuda`` and ``Index.search`` for
           batches of 1, 7 and 1024 at k = 10 with 1 and 4 probes per tree
           (kernels A and B)
  int8     the same on ``rpf+int8`` with expand 4 (kernels A, C and B)
  brute    ``ops.topk`` l2 and dot on MNIST-784 (kernel D), the
           ``bruteforce`` backend on MNIST-784 (kernel B's query-tiled scan,
           ``fused_scan``), and ``ops.topk`` chi2 on ISS-595 at full size
           (kernel E); B = 1024
  iss595   ``build_index`` on ``iss_like`` at the paper's ISS-595
           configuration (N = 250,736, d = 595, L = 160, chi2) and 1024
           queries at 1 and 4 probes (kernels A and B at d = 595)
  deep     ``build_index`` on 6,000 MNIST-784 rows with 8 trees and
           ``max_depth = 160`` (past the 128 levels kernels A and F once
           refused; ``--depth-cap`` lowers it, and drops the deeper chains
           below) and ``Index.search`` of 64 queries at 1 and 4 probes
           (kernels A and B)
  tree     ``ops.traverse_tree(kernel="smem")`` on every tree of the
           MNIST-784 forest, sliced to its used nodes, for 1, 7 and 1024
           queries at 1 and 4 probes (kernel F); ``kernel="auto"`` on an
           unsliced MNIST tree and an ISS-595 tree, both over the card's
           shared-memory cap, must launch kernel A, and ``kernel="smem"``
           there must raise
  rerank   ``ops.rerank_candidates`` on the ``rpf`` path's own deduplicated
           candidates gathered as db[ids]: MNIST-784 at 1 and 4 probes (M =
           960 / 3840), ISS-595 chi2 at 1 probe (M = 1920), B = 1, 7, 1024
           (kernel G)
  bag      ``ops.embedding_bag`` on the MIND history bag: a 1,000,000 x 64
           f32 table, H = 50, B = 512 and 262,144 (kernel H, with its launch
           shape and an empty kernel of the same grid as its latency floor)
  lsh      ``build_index`` on ``lsh-cascade`` over MNIST-784 at the paper's
           radii and ``Index.search`` for 1, 7 and 1024 queries (the host
           buckets, then kernel B)
  mutate   the mutable index on MNIST-784 at ``rebuild_frac`` 0.1, on
           ``rpf``, ``rpf+int8`` (expand 4) and ``bruteforce``: 7,000
           ``add``s (the first 6,000 seal into segment 1, which builds its
           own 80-tree forest; 1,000 stay in the delta buffer), ``delete``
           of every 30th base id, every 12th id of segment 1 and every 2nd
           delta id, 300 ``upsert``s of live base ids; ``stats()`` must
           read 2 segments, 64,000 live, 3,300 tombstones, 800 in the
           delta, 3,000 deleted.  Then 1024 queries at k = 10 (``rpf`` at
           1 and 4 probes, ``rpf+int8`` at 4): kernels A, B and the scan,
           and C on ``rpf+int8`` (the scan alone on ``bruteforce``).  Its
           checks: ``bruteforce`` bitwise a fresh build over
           ``live_points()``; ``rpf`` and ``rpf+int8`` against the plain
           path by the compare rule, no deleted id, no id twice in a row,
           every id scoring its current row (an upserted id its new one);
           ``save`` then ``load_index`` of the ``rpf`` index answering bit
           for bit the same; a search while ``compact(block=False)``
           rebuilds answering as the old view, bit for bit; the compacted
           index bitwise a fresh ``build_index`` of its live rows with the
           same seed, and two such builds giving equal forests.  Every row
           carries metadata columns (``label``: its class; ``bucket``: id %
           100; ``ts``: an int64 timestamp near 1.7e18) through the adds
           and upserts: a filtered search in the brute regime
           (``Eq("bucket", 7)``) is bitwise a ``bruteforce`` build over the
           live matching rows on all three backends, and ``save`` /
           ``load_index`` keeps filtered answers bit for bit
  knobs    the MNIST-784 index on ``rpf`` and ``rpf+int8`` (expand 4) with
           the same columns, 1024 queries at k = 10: ``probe_schedule`` 4
           at tol 0 bitwise the fixed P = 4 search; a 100-query subset at P
           = 2 bitwise the same rows of the full batch; ``adaptive_wave``
           10 at tol 0 using all 80 trees and (``rpf``) equal to the fixed
           search by the compare rule; ``Eq("bucket", 7)`` (600 rows, the
           brute regime) bitwise a ``bruteforce`` build over its rows;
           ``Eq("label", 3)`` (~10%, widened to P = 4) returning only
           matching rows, none twice; ``expand=0`` bitwise ``expand=4`` on
           ``rpf`` and a ``ValueError`` on ``rpf+int8``; ``tune`` on 512
           queries choosing the same params twice (kernels A, B, the scan
           and C)
  serve    the MNIST-784 ``rpf`` index behind ``ServingRuntime(max_batch=64,
           slo_p99_ms=25)`` at ``SearchParams(k=10, n_probes=4)`` (its
           ladder: P = 4, 2, 1, then 40 and 20 trees), every search launched
           from a batcher's worker thread: the traffic model calibrated and
           a plan made at the rated QPS of batch 64; open-loop Poisson runs
           (``serve/loadgen.py``, the 1024 MNIST queries in turn) of 1,000
           requests at 0.5x the rated QPS with ``degrade=False``, 1,000 and
           5,000 at 2x with the ladder (the 5,000 must shed) and without;
           the plan saved into the manifest and a runtime loaded from it;
           8 queries added to the loaded index while it serves and one
           deleted; a fleet of 2 replicas (``build_fleet``) and its draining
           stop; ``repro_torch.launch.serve.main`` at its defaults, with
           ``--load`` and with ``--config``; ``rpf+int8`` (expand 4, P = 4)
           for 500 requests.  No request may be lost; every answer must be
           bit for bit its query's row of a direct ``Index.search`` of the
           1024 queries (under overload, at one of the ladder's rungs; on
           the mutated index, of its new view), an added query must come
           back first at distance 0 and a deleted id never (kernels A and
           B, the scan on the mutated index, C on ``rpf+int8``)
  sharded  ``ShardedIndex`` over the main path's index on ``Mesh((4, 2))``:
           4 DB shards of 15,000 rows, each shard's 80 trees split over 2
           tree shards, so 8 cells of 40 trees run in turn on the card;
           1024 queries at k = 10, P = 1 and 4, one A and one B a cell a
           search.  Checks: the answers against the same mesh in
           ``mode="ref"`` by the compare rule; each cell bitwise a second
           build; a (1, 1) mesh drawing as the index's own build (its one
           cell the index's forest) giving the local search's distances
           bit for bit, ids equal at every untied rank; a one-rank NCCL
           group bit for bit the group-less mesh; ``probe_schedule`` 4 at
           tol 0 bitwise P = 4; ``adaptive_wave`` refused (strict) and
           stripped and counted (not strict); on the ``knobs`` metadata
           index ``Eq("bucket", 7)`` bitwise the local filtered search and
           ``Eq("label", 3)`` (widened) only matching rows, none twice;
           after deleting every 30th id, none surfacing; ``tune_sharded``
           (512 queries, 2 shards, a (2, 1) mesh) choosing the same params
           twice; a mesh ``ServingRuntime(max_batch=64)`` at P = 4 serving
           1,000 open-loop requests at 0.5x its own rated QPS, and a fleet
           with a ``mesh:`` section 200, every answer bit for bit its
           query's row of a direct ``ShardedIndex.search`` (kernels A and
           B, and the scan in the brute regime)
  recsys   the recommenders through ``launch/steps.build_cell`` on the card.
           MIND at full width (a 1,000,192 x 64 catalog, hist 50, 4
           interests, 3 routing iterations): ``serve_p99`` (512 users) and
           ``serve_bulk`` (262,144) run ``mind_train_logits``;
           ``retrieval_cand`` brute-force (4 interests x the catalog, the max
           over interests, a top-100) and with ``variant="rpf=1"`` (the
           paper's index over the catalog on ``Mesh((1, 1))``: 80 trees, C =
           16, r = 0.3, l2, k = 100; its build timed; kernels A and B);
           ``recsys.embedding_bag`` on the MIND table at the history bag's
           two batch sizes, ids -1 and past the table included (kernel H).
           DLRM-MLPerf (every table capped at 4,000,000 rows: its 187.8M
           rows are 96 GB of f32), AutoInt and Wide&Deep: ``serve_p99``,
           ``serve_bulk`` and ``retrieval_cand`` at 131,072 candidates.
           Checks: every output against the same port function in float64
           on the CPU over a 64-user slab (the table rows it touches),
           rtol 1e-4 / atol 1e-5; the brute retrievals' ids against their
           float64 answers at every untied rank; ``rpf=1`` against the same
           program in ``kernel_mode="ref"`` by the compare rule over runs
           of equal ids; H by its rule; a second build's forest bit for
           bit; IEEE fp32 products (TF32 off, matmul precision "highest").
           Printed: ms and users / s a cell, the retrievals' ms, recall@100
           of ``rpf=1`` against the exact l2 answer of the same program
           (kernel D per interest, merged), its overlap with the brute
           max-dot answer, and the device's idle share (profiler) for
           ``serve_p99`` and both retrievals
  train    the recommenders' ``train_batch`` cells through
           ``build_cell``: one AdamW step a call (``train/``, plain PyTorch
           on the card, as the reference's is plain XLA), 20 steps each of
           MIND at full width (65,536 ``BehaviorStream`` users, the
           1,000,192 x 64 catalog), AutoInt and Wide&Deep at their full
           configurations and DLRM-MLPerf with every table capped at
           2,000,000 rows (at 4,000,000 the parameters, gradients, two
           moments and updates alone are 62 GB).  Checks: each model's
           gradient on a 512-example slab (ids -1, past the table and below
           minus its rows included) against the same port function in
           float64 on the CPU over the table rows it touches (rtol 1e-4,
           atol 1e-6 x the gradient's largest magnitude; every other row's
           gradient exactly 0), one AdamW update against float64, the loss
           finite and the mean of the last 5 of 20 steps below the first;
           on MIND a step-10 checkpoint (async save) restored into a fresh
           state taking step 11 to the same loss (rtol 1e-5),
           ``make_dp_train_step`` over a one-rank NCCL group equal to
           ``make_train_step`` (rtol 1e-6), the compressed step finite and
           descending, and kernel H's forward and the bag's plain backward
           on the MIND bag against float64; ``launch.train.main`` for MIND
           and DLRM-MLPerf at ``--preset smoke``.  Printed: ms a step and
           examples / s (median of 10 after 3), peak device memory, the
           forward / backward / optimizer device ms (profiler, 5 steps,
           synced at each phase's end), the idle share over 5 steps, and
           whether two runs of one step from one state are bit for bit
           equal (and if not, which leaves differ)
  lm       the dense language models through ``build_cell`` at full
           width, seeded weights and ``MarkovTokens`` (``models/
           transformer.py``, plain PyTorch on the card as the reference's
           is plain XLA): smollm-135m ``prefill_32k`` (``attn=blockwise``,
           batch 1 of 32), ``decode_32k`` (batch 64 of 128: a 48.3 GB bf16
           cache read whole each step) and ``train_4k`` (batch 8 of 256);
           gemma3-4b at ``nl=6`` (five 1024-token windows, then one global
           layer) ``prefill_32k`` (blockwise, batch 1), ``decode_32k``
           (batch 8), ``long_500k`` (batch 1) and ``train_4k`` (batch 2:
           the chunked CE over 262,144 logits, remat); stablelm-12b at
           ``nl=2`` ``decode_32k`` (batch 8).  Checks: prefill over a
           2,048-token prompt equal to ``forward``'s last position and one
           decode step to its next (smollm-135m and gemma3-4b ``nl=6`` in
           f32 compute, rtol / atol 2e-3); blockwise attention equal to
           dense (f32 atol 1e-5; bf16 within 4 bf16 units of the largest
           output); the gradients of a small f32 LM within rtol 1e-4 (atol
           1e-6 x the largest) of float64 on the CPU, dense and chunked
           CE; the train cells' losses descending on their one batch.
           Then the kNN-LM datastore (``examples/knn_lm_torch.py`` at full
           width): smollm-135m trained 300 steps at 16 x 64, the unit
           hidden states of 4,096 x 64 positions (262,144 x 576) on
           ``rpf`` (40 trees, C = 12), 1,024 held-out positions searched
           under cosine at k = 8, P = 1 and 4 (kernels A and B), against
           ``mode="ref"`` by the compare rule, recall(P = 4) >= recall(P =
           1).  Printed: ms (CUDA events, median), tokens / s, peak device
           memory, the device's idle share (profiler), ``model_flops`` as
           a share of the bf16 peak, decode's bytes bound (cache plus
           parameters in bf16 over the memory rate), whether two runs of
           one train step are bit for bit equal; the datastore's recall@8
           against exact cosine, next-token accuracy at lambda 0, 0.3 and
           0.6, search ms and build seconds; the two routes to f32 scores
           from bf16 operands (``bmm(out_dtype=f32)`` and an upcast)
  moe      the MoE language models through ``build_cell`` (``models/moe.py``
           and the transformer's ``moe`` / ``dense_moe`` structures, plain
           PyTorch on the card as the reference's router, dispatch and
           expert products are plain XLA): granite-moe-1b-a400m at full
           depth and width ``prefill_32k`` (blockwise, batch 1),
           ``decode_32k`` (batch 32: a 51.5 GB cache) and ``train_4k``
           (batch 4); llama4-maverick-400b-a17b at ``nl=2``, one [dense,
           MoE] group at full width (18.55B parameters, 37.1 GB bf16),
           ``prefill_32k`` (blockwise, batch 1) and ``decode_32k`` (batch
           64).  Checks: prefill over a 2,048-token prompt and one decode
           step against ``forward`` at a capacity that drops nothing
           (granite in f32 compute, rtol / atol 2e-3; llama4 in bf16, 2^-6
           of the largest logit); the gradients of two 2-layer f32 MoE LMs
           (top-2 ``moe``; top-1 ``dense_moe`` with a shared expert; tokens
           dropped) within rtol 1e-4 (atol 1e-6 x the largest) of float64
           on the CPU taking the card's routing; ``moe_fwd_sharded``
           (plain, fsdp, the int8 gather) and ``moe_fwd_a2a`` on a one-rank
           NCCL group bit for bit the group-less mesh, outputs and
           gradients, and ``moe_fwd_sharded`` at (1, 1) within 1e-6 of
           ``moe_fwd``; the train cell's losses descending.  Printed as the
           ``lm`` path prints its cells (the decodes' bytes bound counts
           every expert: the dispatch runs each on its cap + 1 slots)
  gnn      MACE through ``build_cell`` (``models/mace.py``, plain PyTorch on
           the card as the reference's geometry, tensor products, scatters
           and readout are plain XLA) at full width (d_hidden 128, l_max
           2, correlation order 3, 15 paths, n_rbf 8, 2 layers), f32 with
           TF32 off, on ``Mesh((1, 1))``: ``molecule`` (128 graphs, 3,840
           nodes / 8,192 edges), ``full_graph_sm`` (2,720 / 10,752, 1,433
           features, 7 classes), ``minibatch_lg`` at
           ``graph_edges=11461589`` (the host graph the sampler draws
           1,024 seeds at fanouts (15, 10) from, cut 10x; the sample padded
           to 169,984 / 168,960, 602 features, 41 classes), the same with
           ``ex=bf16``, and ``ogb_products`` at ``nodes=306128`` (1/8 of
           its nodes, its edges by the same ratio, 30 checkpointed
           chunks; the earlier paths' tensors wait on the host meanwhile,
           ``parked_on_host``).
           Checks: molecule's and full_graph_sm's outputs and gradients
           against float64 on the CPU (rtol 1e-4 / atol 1e-5; gradients
           atol 1e-6 x the largest); energies unchanged by a rotation and a
           translation (rtol 2e-4 / atol 2e-5); 4 edge chunks against 1
           (1e-5 of the largest); a group-less ``Mesh((4, 1))`` against the
           local path (rtol 2e-4 / atol 2e-5); a one-rank NCCL group bit
           for bit the group-less mesh under deterministic algorithms; the
           losses falling.  Printed: ms a step (median of 10 after 3;
           ``ogb_products`` 3 after 1), nodes / s and edges / s, peak
           device memory, the idle share and device events (profiler, 2
           steps) with the 8 aten ops that take the most device time,
           ``model_flops`` over the fp32 peak, whether two runs of a step
           are bit for bit equal (``index_add_``'s atomics)
  examples ``examples/quickstart_torch.py`` (``rpf`` at L = 5, 20, 80 over
           20,000 MNIST-like rows, ``tune`` on a held-out half,
           ``rpf+int8`` with and without waves, add / delete / upsert /
           compact, chi2: kernels A, B, C and B's scan),
           ``ann_serving_torch.py`` (``make_ann_server`` over 10,000 rows,
           128 concurrent clients, an add queryable at once, a delete and a
           background compaction while serving: A, B and the scan) and
           ``two_tower_retrieval_torch.py`` (2,000 users, 20,000 items, 200
           AdamW steps, ``rpf`` over the unit item tower, ``metric="ip"``
           at P = 8: A and B), each at its full size, called through its
           ``main``.  Checks: each example's own asserts (the mutation
           block's answers, the served add and delete, two-tower recall@20
           >= 0.8 against exact MIPS), recall non-decreasing in L, every
           client answered

Phases, each printing one JSON line:

  card     the card's name and power limit (``nvidia-smi``)
  build    nvcc builds every kernel from ``src/repro_torch/csrc``
  <path>   each path above and its launch counts
  compare  each path's searches against the plain path (``mode="ref"``, or
           the plain versions in 128-query slabs): distances within rtol
           1e-5 / atol 1e-6 (the kernels sum the d terms in another order
           and, for cosine, divide by the norms instead of normalizing
           first) -- for kernel D's l2 / dot within 1e-5 (|q|^2 + |c|^2) +
           1e-6, since the expansion cancels near 0 -- ids equal at every
           rank whose distance is separated from its neighbours by more
           than that, and every returned id scores its returned distance
  kernels  each kernel against its plain version at the paths' shapes and
           at edge shapes: the descents bitwise -- kernel A on MNIST-784 at
           1, 3, 4 and 8 probes, on ties (thresholds and queries on one
           grid), NaN and +-inf query elements at 1, 3, 4, 8 and 9 probes,
           more probes than levels, ISS-595 at 1 and 4 probes, and chains
           150 and 200 levels deep (``chain_forest``) at 1, 4 and 9 probes;
           kernel F on the chains and the edge queries, bitwise kernel A --
           B's small-M path (M <= 128) at d = 784 and 595 under l2, dot
           and cosine; the others by the rule above (kernel G also against
           kernel B on the same ids: distances bit for bit, ids equal at
           every untied rank; kernel H within 1e-5 sum_h |w row| + 1e-6 of
           its plain version, at every launch shape it takes; kernel E also
           bitwise, ids equal, against the d-ordered plain sum on sparse
           and dense slabs of ISS-595 with edge rows and an edge query, and
           kernels B and G under chi2 against their lane-order plain
           versions on the same slabs and on rows wider than a staged
           chunk, at k = 10 and 129); kernel D also at its tile edges (B =
           129, N = 127 and 129, d = 595 and 785, a db 4 bytes off 16)
  scan     kernel B's scan against kernel B's gather over ids = arange(N),
           bit for bit in scores and ids: all 1024 MNIST-784 queries (l2,
           every row live and every 7th row dead), 128-query slabs for dot,
           cosine (dead rows) and chi2 (ISS-595, live and dead rows, and its
           dense copy), and a 50-row db at k = 129 (+inf / -1 past N)
  anyk     k = 129 and 256 (past every kernel's list of 128, or 512 for
           kernel C): ``Index.search`` on ``rpf``, ``rpf+int8`` (expand 4 at
           4 probes: k' = 516 and 1024) and ``bruteforce``, ``ops.topk`` l2,
           dot and chi2 (an ISS-595 slab) and ``ops.rerank_candidates``, each
           against its plain version by the rule above; and kernels B, C, D,
           E, G and the scan at k = 129 and 256, whose first 10 columns must
           be their own k = 10 output bit for bit
  serve    one line per served run: offered and achieved QPS, p50 / p99
           / p999 / max ms (wall clock, from each request's scheduled
           arrival), shed fraction, final rung, recall@10 against exact
           k-NN, shed and recover steps, batches by rung, the launches of
           the run; and the traffic model, warm-up seconds by rung, shed
           depth, rated QPS and plan
  sharded  the sharded path's build, its checks, its served runs and plan
  recsys   one line per recommender cell (ms, users / s, peak device
           memory, error against float64, launches) and the MIND
           retrievals' line
  train    one line per train cell and one for the bag's backward and the
           launcher
  lm       the gates' line, one line per LM cell and the kNN-LM
           datastore's line
  gnn      the gates' line and one line per MACE cell
  examples one line per example: wall seconds, launches and what it
           printed; quickstart's recall at every L, the tuned operating
           point, the int8 recalls and trees used; the served batcher's
           stats; two-tower's first and last loss and recall@20
  roofline every model cell the recsys, train, lm, moe and gnn paths timed,
           at its cut, traced on the ``meta`` device by
           ``launch/dryrun.py`` and put through ``roofline.py`` (H100 SXM:
           989 TFLOP/s bf16, 67 fp32, 3.35 TB/s): compute, memory, ideal
           and bound ms, the dominant term, the measured ms and ideal /
           measured, which may not exceed 1.05; then the dry run's argument
           bytes of ``mace/molecule``, ``mind/serve_p99`` and
           ``smollm-135m/decode_32k`` at ``batch=8`` against the device
           memory ``make_args`` allocates on the card (within 1% + 1 MB)
  timing   ms per 1024-query batch (CUDA events, median after warm-up),
           QPS, recall@1 / @10 against exact k-NN (MNIST) or against kernel
           E's exact chi2 top-1 (ISS-595); recall with 4 probes must not
           fall below 1 probe (a superset of candidates, reranked exactly);
           ``lsh-cascade`` beside ``rpf`` at k = 10: ms per batch, recall,
           mean candidates, build seconds; the mutated and the compacted
           ``rpf`` index beside the pristine one at 1 and 4 probes (ms and
           recall against exact k-NN over the live points; the seal's and
           the compaction's seconds), the mutated ``rpf+int8`` and
           ``bruteforce`` beside theirs; the knobs cell: fixed P = 1, 2, 4,
           the schedule (cap 4, tol 0.01) with its mean probes, the waves
           (10 trees, tol 0.01) with the trees used, both filter regimes
           (recall against exact k-NN over the matching rows); the
           sharded search at P = 1 and 4 beside the local index (local,
           sharded, sharded, local), its schedule and its served run
  profile  device time per search by kernel and the device's idle share
           (``torch.profiler`` over 5 searches of 1024 queries), the
           mutated and compacted ``rpf`` index at 4 probes too, and the
           knobs cell's schedule, waves and filters; the serve path's
           batches of 64 at rung 0 (the worker's search alone, and 64
           requests served through the batcher, 20 times each); the
           sharded search at P = 1 and 4 and the mesh runtime's batch of 64
  digests  the sha256 (16 hex digits) of kernels A's, B's, C's and D's
           outputs on every case above, at the timed shapes (B's stage-2
           shortlists) and in the any-k rounds, to compare two builds' runs
           bit for bit; a second line for the sharded path's answers
  done     the script's wall time

then the kernels line (each kernel's launches, time, plain time and bound;
kernel A's on MNIST-784 and ISS-595 beside its two chain bounds, from the
latency of one dependent load that ``csrc/pointer_chase.cu`` measures)
and, last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the script exits non-zero without that line.
"""
import collections
import contextlib
import ctypes
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 10
EXPAND = 4
TS0 = 1_700_000_000_000_000_000     # the timestamp column's origin (ns)
BATCHES = (1, 7, 1024)
PROBES = (1, 4)
RTOL, ATOL = 1e-5, 1e-6
SLAB = 128                  # queries per slab of a plain version's run
FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
# the ogb_products cell's nodes on one card (nodes=N): 1/8 of its 2,449,029,
# the largest power-of-two share whose step stays under ~70 GB (68.1 GB on
# an H100 80GB HBM3 with nothing else held; the cell runs with the earlier
# paths' tensors parked on the host)
OGB_NODES = 306_128
# fp32 instruction issues per chi2 term whose row element is not 0: x - y,
# x + y, + eps, t * t, the IEEE division's fast path (reciprocal, check,
# five FMAs) and the accumulate, as kernel E's SASS shows
# (``sass_per_chi2_term``); a term whose row element is 0 costs kernel E one
# FADD.  An SM issues 128 fp32 lanes a cycle (FP32_FLOPS / 2)
CHI2_ISSUES = 12
# device memory rate by card (NVIDIA data sheets); SXM is the default
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def mem_rate(name):
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    return 3.35e12


def compare_topk(torch, got, want, k, tol=None):
    """Kernel (or kernel-path) top-k ``got`` against plain ``want``, where
    ``want`` holds k + 1 columns so the last rank's lower neighbour is
    known; ``tol`` (B, k + 1) defaults to rtol / atol of ``want``'s
    distances.  Returns the largest absolute distance error."""
    gd, gi = got
    wd_ext, wi_ext = want
    wd, wi = wd_ext[:, :k], wi_ext[:, :k]
    finite = torch.isfinite(wd)
    check(torch.equal(finite, torch.isfinite(gd)), "inf pattern differs")
    check(bool((gi[~finite] == -1).all()), "id of an inf slot is not -1")
    if tol is None:
        tol = RTOL * wd_ext.abs() + ATOL
    err = (gd - wd).abs()[finite]
    check(bool((err <= tol[:, :k][finite]).all()),
          f"distance error {float(err.max()) if err.numel() else 0.0}")
    gap = (wd_ext[:, 1:] - wd_ext[:, :-1]).nan_to_num(0.0)   # >= 0
    sep = finite.clone()
    sep[:, 1:] &= gap[:, :k - 1] > tol[:, 1:k]
    sep &= gap[:, :k] > tol[:, :k]
    check(torch.equal(gi[sep], wi[sep]), "ids differ at a separated rank")
    return float(err.max()) if err.numel() else 0.0


def digest(out):
    """The first 16 hex digits of the sha256 of a kernel's (dists, ids)
    output, bit for bit: runs of two builds compare by it."""
    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def check_scores(torch, metrics_fn, q, db, got):
    """Every returned id must score its returned distance."""
    gd, gi = got
    ok = gi >= 0
    cand = db[gi.clamp_min(0).long()]
    d = metrics_fn(q[:, None, :], cand)
    check(bool(((d - gd).abs()[ok] <= (RTOL * gd.abs() + ATOL)[ok]).all()),
          "a returned id does not score its returned distance")


def expansion_tol(torch, q, db, ids):
    """The l2 / dot expansion's tolerance at (B, k) result ids: 1e-5
    (|q|^2 + |c|^2) + 1e-6 (+inf where the id is -1)."""
    q_sq = torch.sum(q * q, dim=1)[:, None]
    c_sq = torch.sum(db * db, dim=1)[ids.clamp_min(0).long()]
    return torch.where(ids >= 0, 1e-5 * (q_sq + c_sq) + 1e-6, float("inf"))


def in_slabs(torch, fn, b, size=SLAB):
    """``fn(lo, hi)`` over query slabs, outputs concatenated: a plain
    version run slab by slab is the same function with its gathered block
    kept small."""
    parts = [fn(lo, min(b, lo + size)) for lo in range(0, b, size)]
    return tuple(torch.cat(p) for p in zip(*parts))


def counted(torch, counters, fn):
    """Run ``fn`` with every counter set to zero just before and read just
    after: (fn(), launches, plain-version calls)."""
    for c in counters:
        c.clear()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return (out,) + tuple(dict(c) for c in counters)


def require(launches, ref_calls, names, path):
    for name in names:
        check(launches.get(name, 0) > 0, f"{name} never launched on {path}")
    check(sum(ref_calls.values()) == 0,
          f"plain versions ran on {path}: {ref_calls}")


def sass_per_chi2_term(path):
    """Kernel E's fp32-pipe instructions (FADD, FMUL, FFMA, FCHK,
    MUFU.RCP) per chi2 term of its non-zero path as compiled: counted in
    the SASS of ``chi2_scan_kernel`` up to the IEEE division's slow-path
    subroutine, less the zero path's FADDs (the basic blocks that hold
    nothing but FADDs), per FCHK (one per non-zero term).  None where the
    toolkit has no ``cuobjdump``."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    body = sass.split("Function : _Z16chi2_scan_kernel")[1]
    body = body.split("Function :")[0]
    code = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9.]+)([^;]*);",
        body)]
    calls = [int(t, 16) for _, op, rest in code if op.startswith("CALL")
             for t in re.findall(r"0x([0-9a-f]+)", rest)]
    main = [(a, op, rest) for a, op, rest in code
            if not calls or a < min(calls)]
    targets = {int(t, 16) for _, op, rest in main if op.startswith("BRA")
               for t in re.findall(r"0x([0-9a-f]+)", rest)}
    blocks, block = [], []
    for a, op, _ in main:          # basic blocks: split at branch targets
        if a in targets and block:  # and after every branch
            blocks.append(block)
            block = []
        block.append(op.split(".")[0])
        if op.startswith(("BRA", "CALL", "EXIT", "RET")):
            blocks.append(block)
            block = []
    blocks.append(block)
    zero_fadds = sum(len(b) - (b[-1] == "BRA") for b in blocks
                     if b and set(b) <= {"FADD", "BRA"} and b[0] == "FADD")
    n = collections.Counter(op for b in blocks for op in b)
    fp32 = n["FADD"] + n["FMUL"] + n["FFMA"] + n["FCHK"] \
        + sum(op == "MUFU.RCP" for _, op, _ in main)
    return (fp32 - zero_fadds) / n["FCHK"]


def time_ms(torch, fn, reps, flush=None, warm=2):
    """Median device time of ``fn()`` over ``reps`` runs after ``warm``
    warm-up runs; ``flush()`` (outside the timed region) evicts the L2
    cache."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_storages(torch):
    """The storage of every CUDA tensor Python can reach, once each."""
    import gc
    gc.collect()
    found = {}
    for obj in gc.get_objects():
        try:
            if not (issubclass(type(obj), torch.Tensor) and obj.is_cuda):
                continue
            st = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):
            continue                # a tensor without storage (sparse)
        if st.nbytes() and st.resizable():
            found.setdefault(st.data_ptr(), st)
    return list(found.values())


@contextlib.contextmanager
def parked_on_host(torch, storages):
    """The bytes of ``storages`` wait on the host for the body and come
    back after it.  Each storage is freed and refilled in place
    (``resize_``), so every tensor and view of it sees its own bytes again;
    the body must not read them.  Yields the bytes parked."""
    torch.cuda.synchronize()
    host = [st.cpu() for st in storages]
    for st in storages:
        st.resize_(0)
    torch.cuda.empty_cache()
    try:
        yield sum(h.nbytes() for h in host)
    finally:
        for st, h in zip(storages, host):
            st.resize_(h.nbytes())
            st.copy_(h)
        torch.cuda.synchronize()


def node_depths(torch, child_base, max_depth):
    """(L, max_nodes) depth of every reachable node (-1 elsewhere)."""
    n_trees, m = child_base.shape
    depth = torch.full((n_trees, m), -1, dtype=torch.long,
                       device=child_base.device)
    depth[:, 0] = 0
    rows = torch.arange(n_trees, device=child_base.device)[:, None]
    cb = child_base.long()
    for t in range(max_depth):
        par = (depth == t) & (cb >= 0)
        if not bool(par.any()):
            break
        r = rows.expand_as(cb)[par]
        depth[r, cb[par]] = t + 1
        depth[r, cb[par] + 1] = t + 1
    return depth


def descent_edge_inputs(torch, feat, thresh, child, q):
    """Kernel A's edge inputs on a forest: its thresholds and 256 queries on
    one grid of 1/8 (ties of margins, and q[feat] == thresh), and 256
    queries with NaN, +inf and -inf elements."""
    qe = q[:256].clone()
    qe[0] = float("nan")
    qe[1, ::3] = float("inf")
    qe[2, 1::3] = float("-inf")
    qe[3, ::7] = float("nan")
    qe[4, ::2], qe[4, 1::2] = float("inf"), float("-inf")
    return {"grid": (feat, torch.round(thresh * 8) / 8, child,
                     torch.round(q[:256] * 8) / 8),
            "nan / inf": (feat, thresh, child, qe)}


def chain_forest(torch, depth, d, n_trees, n_queries, gen, dev):
    """A forest of chains ``depth`` levels deep, past the 128 levels the
    port's kernels A and F once capped.  The path node at depth t has
    children 2t + 1 and 2t + 2: one is a leaf, the other the next path
    node, and the test sends most queries to the latter (a threshold below
    or above the queries' [0, 1)); on about one level in 25 the threshold
    falls inside [0, 1), so queries leave the chain at every depth and
    their alternates flip near the root, deep and in between.  Returns
    feat, thresh, child_base (n_trees, 2 depth + 1) and queries (n_queries,
    d) in [0, 1), every 9th element NaN in query 1."""
    n = 2 * depth + 1
    t = torch.arange(depth, device=dev)
    right = torch.rand((n_trees, depth), generator=gen, device=dev) < 0.5
    inside = torch.rand((n_trees, depth), generator=gen, device=dev) < 0.04
    u = torch.rand((n_trees, depth), generator=gen, device=dev)
    path = torch.zeros((n_trees, depth), dtype=torch.long, device=dev)
    path[:, 1:] = 2 * t[1:] - 1 + right[:, :-1].long()
    rows = torch.arange(n_trees, device=dev)[:, None].expand_as(path)
    feat = torch.zeros((n_trees, n), dtype=torch.int32, device=dev)
    thresh = torch.zeros((n_trees, n), device=dev)
    child = torch.full((n_trees, n), -1, dtype=torch.int32, device=dev)
    feat[rows, path] = torch.randint(0, d, (n_trees, depth), generator=gen,
                                     device=dev, dtype=torch.int32)
    thresh[rows, path] = torch.where(inside, u, torch.where(right, -u, 1 + u))
    child[rows, path] = (2 * t + 1).int().expand_as(path)
    q = torch.rand((n_queries, d), generator=gen, device=dev)
    q[1, ::9] = float("nan")
    return feat, thresh, child, q


def least_chain_levels(torch, child_base, depth, leaves):
    """(L, B, P) leaf ids (-1 absent) -> (L, B) levels of kernel A's chain
    for each (tree, query): the primary's levels plus the deepest
    alternate's levels below its flip.  An alternate flips where its path
    leaves the primary's, at the lowest common ancestor of the two leaves,
    found by climbing both through the parent of every node."""
    n_trees, m = child_base.shape
    rows = torch.arange(n_trees, device=child_base.device)[:, None]
    cb = child_base.long()
    parent = torch.zeros((n_trees, m), dtype=torch.long,
                         device=child_base.device)
    r, n = torch.nonzero(cb >= 0, as_tuple=True)
    parent[r, cb[r, n]] = n
    parent[r, cb[r, n] + 1] = n
    l_idx = rows[:, :, None]
    prim = leaves[..., :1].long().expand_as(leaves[..., 1:])
    alt = leaves[..., 1:].long()
    ok = alt >= 0
    a, z = alt.clamp_min(0), prim
    da, dz = depth[l_idx, a], depth[l_idx, z]
    while True:                # the deeper of the two climbs first
        up_a, up_z = da > dz, dz > da
        if not bool(up_a.any() or up_z.any()):
            break
        a = torch.where(up_a, parent[l_idx, a], a)
        z = torch.where(up_z, parent[l_idx, z], z)
        da, dz = da - up_a.long(), dz - up_z.long()
    while True:                # then both, until they meet
        apart = a != z
        if not bool(apart.any()):
            break
        a = torch.where(apart, parent[l_idx, a], a)
        z = torch.where(apart, parent[l_idx, z], z)
        da = da - apart.long()
    below = torch.where(ok, depth[l_idx, alt.clamp_min(0)] - da - 1, 0)
    base = depth[rows, leaves[..., 0].long()]
    return base + (below.amax(-1) if below.shape[-1] else 0)


def main():
    wall0 = time.perf_counter()
    # the deepest max_depth the checks give the descents (all by default)
    deepest = (int(sys.argv[sys.argv.index("--depth-cap") + 1])
               if "--depth-cap" in sys.argv else None)
    import numpy as np
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA GPU; none is available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import mind_bag as bagcfg
    from repro_torch.configs import rpf_iss595 as isscfg
    from repro_torch.configs import rpf_mnist784 as cfgmod
    from repro_torch.core.distances import METRICS
    from repro_torch.core.forest import Forest, ForestConfig, generator_draws
    from repro_torch.core.knn import exact_knn
    from repro_torch.core.pipeline import candidates
    from repro_torch.core.quantized import quantize_db
    from repro_torch.core.search import (mask_duplicates, merge_topk_pairs,
                                         recall_at_k)
    from repro_torch.core.sharded_index import (CellDraws, Mesh, ShardedIndex,
                                                build_sharded_index)
    from repro_torch.data.synthetic import iss_like, mnist_like
    from repro_torch.filter import Eq
    from repro_torch.filter.predicate import use_brute_force, widen_params
    from repro_torch.index import (CapabilityError, IndexSpec, SearchParams,
                                   build_index, load_index, tune, tune_report,
                                   tune_sharded)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.chi2_topk import chi2_topk
    from repro_torch.kernels.common import LAUNCHES, REF_CALLS
    from repro_torch.kernels.distance_topk import distance_topk
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.forest_traverse import (forest_traverse,
                                                     smem_node_cap)
    from repro_torch.kernels.forest_traverse_hbm import forest_traverse_hbm
    from repro_torch.kernels.fused_query import fused_gather_topk, fused_scan
    from repro_torch.kernels.fused_query_int8 import fused_gather_topk_int8
    from repro_torch.kernels.matmul_topk import (MAX_SLICES, matmul_topk,
                                                 scan_outputs)
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import (ServingRuntime, build_fleet, build_ladder,
                                   loadgen, planner)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    counters = (LAUNCHES, REF_CALLS)
    launches_by_path = {}
    # sha256 of kernels A's, B's, C's and D's outputs by case (phase
    # ``digests``)
    digests = {"forest_traverse": {}, "fused_gather_topk": {},
               "matmul_topk": {}, "fused_gather_topk_int8": {}}

    # ---- card ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for n, log in logs.items()}
    emit({"phase": "build", "seconds": build_s, "built": sorted(logs),
          "ptxas": regs})

    # ---- main path: rpf ------------------------------------------------------
    db_np, db_labels, q_np, _ = mnist_like(cfgmod.N_DB,
                                           n_test=cfgmod.QUERY_BATCH,
                                   d=cfgmod.DIM, seed=0)
    spec = IndexSpec(backend="rpf", forest=cfgmod.CONFIG, seed=0)
    queries = torch.from_numpy(q_np).to(dev)

    def drive_rpf():
        t0 = time.perf_counter()
        index = build_index(db_np, spec, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        return index, build_s, {
            (p, b): index.search(queries[:b], SearchParams(k=K, n_probes=p))
            for p in PROBES for b in BATCHES}

    (index, index_build_s, results), launches, ref_calls = counted(
        torch, counters, drive_rpf)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk"),
            "rpf")
    launches_by_path["rpf"] = launches
    n_searches = len(results)
    db = index.engine.db
    forest = index.forest
    rc = spec.forest.resolved(db.shape[0])
    emit({"phase": "main", "rows": db.shape[0], "dim": db.shape[1],
          "trees": rc.n_trees, "max_depth": rc.max_depth,
          "max_nodes": rc.max_nodes, "nodes_used_max": int(forest.n_nodes.max()),
          "index_build_s": index_build_s, "searches": n_searches,
          "launches": launches, "ref_calls": ref_calls})

    worst = 0.0
    for (p, b), got in results.items():
        want = index.search(queries[:b], SearchParams(k=K + 1, n_probes=p,
                                                      mode="ref"))
        worst = max(worst, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["l2"], queries[:b], db, got)
    emit({"phase": "compare", "path": "rpf", "cases": len(results),
          "max_abs_err": worst})

    # ---- path: rpf+int8 --------------------------------------------------------
    spec8 = IndexSpec(backend="rpf+int8", forest=cfgmod.CONFIG, seed=0)

    def drive_int8():
        t0 = time.perf_counter()
        index8 = build_index(db_np, spec8, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        return index8, build_s, {
            (p, b): index8.search(queries[:b], SearchParams(
                k=K, n_probes=p, expand=EXPAND))
            for p in PROBES for b in BATCHES}

    (index8, int8_build_s, results8), launches, ref_calls = counted(
        torch, counters, drive_int8)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk_int8",
                                  "fused_gather_topk"), "rpf+int8")
    launches_by_path["rpf+int8"] = launches
    qdb = index8.qdb
    emit({"phase": "int8", "index_build_s": int8_build_s,
          "searches": len(results8), "expand": EXPAND,
          "launches": launches, "ref_calls": ref_calls})

    def int8_plain(q, p, k=K):
        """The plain path of ``rerank_fused_quantized``, stage by stage,
        with stage 2 widened to k + 1 so the last rank's lower neighbour
        is known."""
        ids, mask = candidates(index8.forest, q, rc.max_depth, rc.leaf_pad,
                               p, mode="ref")
        ids = torch.where(mask_duplicates(ids, mask), ids, -1).int()
        kp = min(EXPAND * k, ids.shape[1])
        _, short = ref.fused_gather_topk_int8_ref(q, ids, qdb.q, qdb.scale,
                                                  kp)
        return ref.fused_gather_topk_ref(q, short, qdb.fp, k + 1)

    worst8 = 0.0
    for (p, b), got in results8.items():
        digests["fused_gather_topk_int8"][f"rpf+int8 search P={p} B={b}"] = \
            digest(got)
        want = in_slabs(torch, lambda lo, hi: int8_plain(queries[lo:hi], p),
                        b)
        worst8 = max(worst8, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["l2"], queries[:b], db, got)
    emit({"phase": "compare", "path": "rpf+int8", "cases": len(results8),
          "max_abs_err": worst8})

    # ---- path: brute (kernel D, bruteforce backend, kernel E) --------------
    t0 = time.perf_counter()
    iss_np, _, iss_q_np, _ = iss_like(isscfg.N_DB, n_test=isscfg.QUERY_BATCH,
                                      d=isscfg.DIM, n_models=isscfg.N_MODELS,
                                      seed=1)
    iss_data_s = time.perf_counter() - t0
    iss_db = torch.from_numpy(iss_np).to(dev)
    iss_q = torch.from_numpy(iss_q_np).to(dev)
    # ISS-595 with no element 0 (the rows raised by 2e-3, as kernel E's
    # dense slab): what chi2's zero terms save, the dense rows cannot
    iss_dense = iss_db + 2e-3

    def drive_brute():
        out = {m: ops.topk(queries, db, K, m) for m in ("l2", "dot")}
        bidx = build_index(db_np, IndexSpec(backend="bruteforce"),
                           device=dev)
        out["bruteforce"] = bidx.search(queries, SearchParams(k=K))
        out["chi2"] = ops.topk(iss_q, iss_db, K, "chi2")
        return bidx, out

    (bidx, brute), launches, ref_calls = counted(torch, counters, drive_brute)
    require(launches, ref_calls, ("matmul_topk", "fused_scan", "chi2_topk"),
            "brute")
    launches_by_path["brute"] = launches
    emit({"phase": "brute", "mnist": list(db.shape),
          "iss595": list(iss_db.shape), "iss_data_s": iss_data_s,
          "launches": launches, "ref_calls": ref_calls})

    brute_err = {}
    for m in ("l2", "dot"):
        digests["matmul_topk"][f"ops.topk {m} 1024x60000x784 k={K}"] = \
            digest(brute[m])
        want = in_slabs(torch, lambda lo, hi: ref.matmul_topk_ref(
            queries[lo:hi], db, K + 1, m), queries.shape[0])
        brute_err[m] = compare_topk(
            torch, brute[m], want, K,
            tol=expansion_tol(torch, queries, db, want[1]))
    want = exact_knn(queries, db, K + 1)
    brute_err["l2_vs_exact_knn"] = compare_topk(
        torch, brute["l2"], want, K,
        tol=expansion_tol(torch, queries, db, want[1]))
    want = in_slabs(torch, lambda lo, hi: bidx.search(
        queries[lo:hi], SearchParams(k=K + 1, mode="ref")), queries.shape[0])
    brute_err["bruteforce"] = compare_topk(torch, brute["bruteforce"], want,
                                           K)
    check_scores(torch, METRICS["l2"], queries, db, brute["bruteforce"])
    want = in_slabs(torch, lambda lo, hi: ref.chi2_topk_ref(
        iss_q[lo:hi], iss_db, K + 1), iss_q.shape[0])
    brute_err["chi2"] = compare_topk(torch, brute["chi2"], want, K)
    check_scores(torch, METRICS["chi2"], iss_q, iss_db, brute["chi2"])
    emit({"phase": "compare", "path": "brute", "max_abs_err": brute_err,
          "tolerance": {"l2, dot": "1e-5 (|q|^2 + |c|^2) + 1e-6",
                        "bruteforce, chi2": f"rtol {RTOL}, atol {ATOL}"}})

    # ---- path: ISS-595 on rpf ----------------------------------------------
    spec_iss = IndexSpec(backend="rpf", forest=isscfg.CONFIG, seed=0)

    def drive_iss():
        t0 = time.perf_counter()
        idx = build_index(iss_np, spec_iss, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        return idx, build_s, {p: idx.search(iss_q, SearchParams(
            k=K, n_probes=p, metric="chi2")) for p in PROBES}

    (iss_index, iss_build_s, iss_res), launches, ref_calls = counted(
        torch, counters, drive_iss)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk"),
            "iss595")
    launches_by_path["iss595"] = launches
    iss_rc = spec_iss.forest.resolved(iss_db.shape[0])
    emit({"phase": "iss595", "rows": iss_db.shape[0], "dim": iss_db.shape[1],
          "trees": iss_rc.n_trees, "max_depth": iss_rc.max_depth,
          "leaf_pad": iss_rc.leaf_pad,
          "nodes_used_max": int(iss_index.forest.n_nodes.max()),
          "index_build_s": iss_build_s, "launches": launches,
          "ref_calls": ref_calls})
    worst_iss = 0.0
    for p, got in iss_res.items():
        want = in_slabs(torch, lambda lo, hi: iss_index.search(
            iss_q[lo:hi], SearchParams(k=K + 1, n_probes=p, metric="chi2",
                                       mode="ref")), iss_q.shape[0])
        worst_iss = max(worst_iss, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["chi2"], iss_q, iss_db, got)
    emit({"phase": "compare", "path": "iss595", "cases": len(iss_res),
          "max_abs_err": worst_iss})

    # ---- a forest built with max_depth = 160 (the kernels once refused
    # max_depth > 128): Index.search on the card against mode="ref" -------
    spec_deep = IndexSpec(backend="rpf", forest=ForestConfig(
        n_trees=8, capacity=12, split_ratio=0.3,
        max_depth=min(160, deepest or 160)), seed=0)

    def drive_deep():
        idx = build_index(db_np[:6000], spec_deep, device=dev)
        return idx, {p: idx.search(queries[:64], SearchParams(k=K,
                                                               n_probes=p))
                     for p in PROBES}

    (deep_index, deep_res), launches, ref_calls = counted(torch, counters,
                                                          drive_deep)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk"),
            "deep")
    worst_deep = 0.0
    for p, got in deep_res.items():
        want = deep_index.search(queries[:64], SearchParams(
            k=K + 1, n_probes=p, mode="ref"))
        worst_deep = max(worst_deep, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["l2"], queries[:64], db, got)
    emit({"phase": "compare", "path": "deep",
          "max_depth": spec_deep.forest.max_depth,
          "cases": len(deep_res), "max_abs_err": worst_deep,
          "launches": launches, "ref_calls": ref_calls})

    # ---- kernels against their plain versions ------------------------------
    def bitwise(got, want):
        return (torch.equal(got[0].view(torch.int32),
                            want[0].view(torch.int32))
                and torch.equal(got[1], want[1]))

    feat = forest.proj_idx[..., 0]
    thresh, child = forest.thresh, forest.child_base
    descent_cases = []

    def check_descent(tag, f, th, cb, q, depth_cap, p):
        """Kernel A bitwise its plain version; its leaves' digest kept."""
        got = forest_traverse_hbm(f, th, cb, q, depth_cap, p)
        want = ref.forest_traverse_ref(f, th, cb, q, depth_cap, p)
        check(torch.equal(got, want), f"kernel A differs from its plain "
              f"version: {tag}")
        digests["forest_traverse"][tag] = digest((got,))
        descent_cases.append(tag)
        return got

    for p in (1, 3, 4, 8):
        for b in BATCHES:
            check_descent(f"mnist784 P={p} B={b}", feat, thresh, child,
                          queries[:b], rc.max_depth, p)
    # more probes than levels: the tail slots must be -1 in both
    got = check_descent("mnist784 max_depth=3 P=6", feat, thresh, child,
                        queries[:7], 3, 6)
    check(bool((got[..., 4:] == -1).all()), "descent slots past "
          "max_depth + 1 are not -1")
    # ties (a grid of 1/8), NaN / +-inf query elements, P past one round
    # of alternates (8 and 9)
    for name, (f, th, cb, q) in descent_edge_inputs(torch, feat, thresh,
                                                    child, queries).items():
        for p in (1, 3, 4, 8, 9):
            check_descent(f"mnist784 {name} P={p}", f, th, cb, q,
                          rc.max_depth, p)
    iss_feat = iss_index.forest.proj_idx[..., 0]
    for p in PROBES:
        check_descent(f"iss595 P={p}", iss_feat, iss_index.forest.thresh,
                      iss_index.forest.child_base, iss_q, iss_rc.max_depth, p)
    # chains 150 and 200 levels deep (the kernels once refused max_depth >
    # 128), at their full depth and cut 7 levels short; kernel F on each
    # tree too, bitwise A
    deep_cases = []
    cgen = torch.Generator(device=dev).manual_seed(3)
    for depth_ in [d_ for d_ in (150, 200) if d_ <= (deepest or d_)]:
        cf, cth, ccb, cq = chain_forest(torch, depth_, 64, 8, 1024, cgen, dev)
        for depth_cap in (depth_, depth_ - 7):
            for p in (1, 4, 9):
                got = check_descent(f"chain {depth_} max_depth={depth_cap} "
                                    f"P={p}", cf, cth, ccb, cq, depth_cap, p)
                got = got.view(cf.shape[0], cq.shape[0], -1)
                for t in range(cf.shape[0]):
                    got_f = forest_traverse(cf[t], cth[t], ccb[t], cq,
                                            depth_cap, p)
                    check(torch.equal(got_f.view(cq.shape[0], -1), got[t]),
                          f"kernel F differs from A on chain {depth_} tree "
                          f"{t} P={p}")
                deep_cases.append([depth_, depth_cap, p])
    # kernel F on edge queries (NaN / +-inf, ties) on four MNIST trees
    used0 = forest.n_nodes.tolist()
    for name, (f, th, cb, q) in descent_edge_inputs(torch, feat, thresh,
                                                    child, queries).items():
        for p in (1, 4, 9):
            a_out = forest_traverse_hbm(f, th, cb, q, rc.max_depth, p)
            for t in range(4):
                tr = (f[t, :used0[t]], th[t, :used0[t]], cb[t, :used0[t]])
                got_f = forest_traverse(*tr, q, rc.max_depth, p)
                check(torch.equal(got_f, ref.forest_traverse_tree_ref(
                    *tr, q, rc.max_depth, p)), f"kernel F differs from its "
                    f"plain version: {name} tree {t} P={p}")
                check(torch.equal(got_f, a_out[t]), f"kernel F differs "
                      f"from A: {name} tree {t} P={p}")

    def dedup_cand(frst, q, cfg, p):
        ids, mask = candidates(frst, q, cfg.max_depth, cfg.leaf_pad, p)
        return torch.where(mask_duplicates(ids, mask), ids, -1).int()

    cand = {p: dedup_cand(forest, queries, rc, p) for p in PROBES}
    iss_cand = dedup_cand(iss_index.forest, iss_q, iss_rc, 1)
    gen = torch.Generator(device=dev).manual_seed(1)
    holes = cand[1].clone()
    holes[torch.rand(holes.shape, generator=gen, device=dev) < 0.3] = -1
    fused_cases, fused_err = 0, 0.0
    # (M <= 128 takes B's small-M path: the last four)
    shapes = [(cand[1], K), (cand[4], K), (cand[1][:1], 1), (cand[1][:7], K),
              (holes[:7], K), (holes, 1), (cand[4][:7, :40], 128),
              (holes[:, :40], K), (cand[1][:, :64], K), (cand[1][:, :128], K)]
    for metric in ("l2", "dot", "chi2", "cosine"):
        for ids, k in shapes:
            q = queries[:ids.shape[0]].contiguous()
            ids = ids.contiguous()
            got = fused_gather_topk(q, ids, db, k, metric)
            digests["fused_gather_topk"][
                f"{metric} {ids.shape[0]}x{ids.shape[1]} k={k} "
                f"case {fused_cases % len(shapes)}"] = digest(got)
            want = in_slabs(torch, lambda lo, hi: ref.fused_gather_topk_ref(
                q[lo:hi], ids[lo:hi], db, k + 1, metric), q.shape[0])
            fused_err = max(fused_err, compare_topk(torch, got, want, k))
            fused_cases += 1
    # the small-M path with one element a lane (d = 595: no float4 rows)
    for metric in ("l2", "dot", "cosine"):
        for ids, k in ((iss_cand[:7, :50], K), (iss_cand[:, :64], 128)):
            q = iss_q[:ids.shape[0]].contiguous()
            ids = ids.contiguous()
            got = fused_gather_topk(q, ids, iss_db, k, metric)
            digests["fused_gather_topk"][
                f"{metric} iss595 {ids.shape[0]}x{ids.shape[1]} k={k}"] = \
                digest(got)
            want = in_slabs(torch, lambda lo, hi: ref.fused_gather_topk_ref(
                q[lo:hi], ids[lo:hi], iss_db, k + 1, metric), q.shape[0])
            fused_err = max(fused_err, compare_topk(torch, got, want, k))
            fused_cases += 1

    # kernel C: the int8 path's shapes (k' = 40 over M = 960 / 3840), one
    # and seven queries, 30% holes, k' = 512, d = 784 and 595, four metrics
    iss_qdb = quantize_db(iss_db)
    kp = EXPAND * K
    c_shapes = [(queries, qdb, cand[1], kp), (queries, qdb, cand[4], kp),
                (queries, qdb, cand[1][:1], kp), (queries, qdb, cand[1][:7], kp),
                (queries, qdb, holes[:7], kp), (queries, qdb, cand[4][:7], 512),
                (iss_q, iss_qdb, iss_cand[:7], kp),
                (iss_q, iss_qdb, iss_cand[:7], 512)]
    int8_cases, int8_err = 0, 0.0
    for metric in ("l2", "dot", "chi2", "cosine"):
        for i, (qq, qd, ids, k) in enumerate(c_shapes):
            q = qq[:ids.shape[0]].contiguous()
            ids = ids.contiguous()
            got = fused_gather_topk_int8(q, ids, qd.q, qd.scale, k, metric)
            digests["fused_gather_topk_int8"][
                f"{metric} case {i}: {ids.shape[0]}x{ids.shape[1]} "
                f"d={q.shape[1]} k={k}"] = digest(got)
            want = in_slabs(torch, lambda lo, hi: ref.fused_gather_topk_int8_ref(
                q[lo:hi], ids[lo:hi], qd.q, qd.scale, k + 1, metric),
                q.shape[0])
            int8_err = max(int8_err, compare_topk(torch, got, want, k))
            int8_cases += 1

    # kernels D and E: one and seven queries, k = 128, k > N (every slot
    # past N is +inf / -1), d = 784 and 595
    scan_cases, d_err, e_err = 0, 0.0, 0.0
    mnist_small, iss_small = db[:5].contiguous(), iss_db[:5].contiguous()
    for b, rows_l2, rows_chi2, k in [
            (1, db, iss_db, K), (7, db, iss_db, K), (7, db, iss_db, 128),
            (7, iss_db, db, K), (7, mnist_small, iss_small, K)]:
        for m in ("l2", "dot"):
            q = (queries if rows_l2.shape[1] == queries.shape[1]
                 else iss_q)[:b].contiguous()
            got = matmul_topk(q, rows_l2, k, m)
            digests["matmul_topk"][f"{m} {b}x{rows_l2.shape[0]}x"
                                   f"{rows_l2.shape[1]} k={k}"] = digest(got)
            want = ref.matmul_topk_ref(q, rows_l2, k + 1, m)
            d_err = max(d_err, compare_topk(
                torch, got, want, k,
                tol=expansion_tol(torch, q, rows_l2, want[1])))
            scan_cases += 1
        q = (iss_q if rows_chi2.shape[1] == iss_q.shape[1]
             else queries)[:b].contiguous()
        got = chi2_topk(q, rows_chi2, k)
        want = ref.chi2_topk_ref(q, rows_chi2, k + 1)
        e_err = max(e_err, compare_topk(torch, got, want, k))
        if rows_chi2.shape[0] < k:
            check(bool((got[1][:, rows_chi2.shape[0]:] == -1).all()),
                  "slots past N are not -1")
        scan_cases += 1
    # kernel D at its tile edges (128 queries, 128 rows, 32 columns a step,
    # each passed by one): B = 129, N = 127 and 129 (k = 128 past N: the
    # slots past N +inf / -1), d = 595 and 785 (4-byte copies, and a tail
    # of 19 and 17 columns), and a db that starts 4 bytes past a 16-byte
    # boundary
    q785 = torch.cat([queries[:129], queries[:129, :1]], 1)
    db785 = torch.cat([db[:4099], db[:4099, :1]], 1)
    n_off = min(4099, db.shape[0] - 1)
    db_off = db.view(-1)[1:1 + n_off * db.shape[1]].view(n_off, -1)
    for q, rows, k in [
            (queries[:129], db, K), (queries[:129], db[:127], K),
            (queries[:129], db[:129], 128), (queries[:7], db[:127], 128),
            (iss_q[:129], iss_db[:4099], K), (iss_q[:7], iss_db[:129], 128),
            (q785, db785, K), (q785[:7], db785[:129], 128),
            (queries[:7], db_off, K)]:
        q = q.contiguous()
        for m in ("l2", "dot"):
            got = matmul_topk(q, rows, k, m)
            tag = (f"edge {m} {q.shape[0]}x{rows.shape[0]}x{rows.shape[1]} "
                   f"k={k}{' offset' if rows.storage_offset() else ''}")
            digests["matmul_topk"][tag] = digest(got)
            want = ref.matmul_topk_ref(q, rows, k + 1, m)
            d_err = max(d_err, compare_topk(
                torch, got, want, k,
                tol=expansion_tol(torch, q, rows, want[1])))
            n = rows.shape[0]
            check(n > k or (bool((got[1][:, n:] == -1).all())
                            and bool(torch.isinf(got[0][:, n:]).all())),
                  f"kernel D's slots past N = {n} are not +inf / -1")
            scan_cases += 1
    del q785, db785, db_off
    # kernel E bitwise against the d-ordered plain sum: 64 queries x 4096
    # rows of ISS-595 at k = 10 and 128, x 4096 dense rows (raised by 2e-3,
    # every 7th element of every other row negated: no element is 0, so
    # the warps take E's copy of the loop for chunks with no zero) at k =
    # 10, and x 128 rows at k = 128 (every score returned).  Every row set
    # ends in three edge rows (every 0 a -0.0; negative elements; -1e-12
    # where query 0 is 0, so that term's denominator is 0 and query 0
    # scores the row +inf), and query 63 is an edge query (-0.0 and
    # negative elements)
    slab_q = iss_q[:64].clone()
    edge = iss_db[:3].clone()
    edge[0][edge[0] == 0] = -0.0
    edge[1, ::7] = -edge[1, ::7]
    edge[2, int(torch.nonzero(slab_q[0] == 0)[0])] = -1e-12
    slab_q[63, ::5] = -0.0
    slab_q[63, 1::11] = -slab_q[63, 1::11]
    dense_rows = iss_db[:4096] + 2e-3
    dense_rows[1::2, ::7] = -dense_rows[1::2, ::7]
    slabs = [(torch.cat([rows, edge]).contiguous(), k)
             for rows, k in ((iss_db[:4096], K), (iss_db[:4096], 128),
                             (dense_rows, K), (iss_db[:125], 128))]
    del dense_rows
    for slab_db, k in slabs:
        got = chi2_topk(slab_q, slab_db, k)
        want = ref.chi2_topk_dordered(slab_q, slab_db, k)
        check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
              f"kernel E is not bitwise the d-ordered sum ({slab_db.shape[0]} "
              f"rows, k = {k})")
        check(torch.equal(got[1], want[1]), "kernel E's ids differ from the "
              f"d-ordered sum's ({slab_db.shape[0]} rows, k = {k})")
        scan_cases += 1
    check(bool(torch.isinf(got[0][0]).any()), "the edge row's +inf is lost")
    # kernels B and G bitwise against their chi2 order of sums
    # (ref.*_lane_order) on E's sparse and dense ISS-595 row sets: the 64
    # slab queries x 1920 slots of ids into the set (10% of them -1, the
    # first three the edge rows), k = 10 and 129 (two rounds)
    lane_cases = []
    for tag, slab_db in (("sparse", slabs[0][0]), ("dense", slabs[2][0])):
        r = slab_db.shape[0]
        lids = torch.randint(0, r, (64, 1920), generator=gen, device=dev,
                             dtype=torch.int32)
        lids[torch.rand(lids.shape, generator=gen, device=dev) < 0.1] = -1
        lids[:, :3] = torch.arange(r - 3, r, dtype=torch.int32, device=dev)
        lmask = lids >= 0
        lc = slab_db[lids.clamp_min(0).long()]
        for k in (K, 129):
            check(bitwise(fused_gather_topk(slab_q, lids, slab_db, k, "chi2"),
                          ref.fused_gather_topk_lane_order(slab_q, lids,
                                                           slab_db, k)),
                  f"kernel B is not bitwise its chi2 lane order ({tag}, "
                  f"k = {k})")
            check(bitwise(distance_topk(slab_q, lc, lids, lmask, k, "chi2"),
                          ref.distance_topk_lane_order(slab_q, lc, lids,
                                                       lmask, k)),
                  f"kernel G is not bitwise its chi2 lane order ({tag}, "
                  f"k = {k})")
            lane_cases.append([tag, 64, 1920, k])
        del lc
    # rows past one staged chunk (pair_score.cuh CHUNK, 1024 elements): d =
    # 2048 (float4 groups) and 2101 (one element a lane, rows off 16
    # bytes); 80% zeros, 16 queries x 200 slots of 300 rows; G's l2 too
    for dd in (2048, 2101):
        wide = torch.rand((316, dd), generator=gen, device=dev)
        wide[wide < 0.8] = 0.0
        wq, wide = wide[300:].contiguous(), wide[:300].contiguous()
        wids = torch.randint(0, 300, (16, 200), generator=gen, device=dev,
                             dtype=torch.int32)
        wids[:, ::9] = -1
        wmask = wids >= 0
        wc = wide[wids.clamp_min(0).long()]
        for k in (K, 129):
            check(bitwise(fused_gather_topk(wq, wids, wide, k, "chi2"),
                          ref.fused_gather_topk_lane_order(wq, wids, wide,
                                                           k)),
                  f"kernel B is not bitwise its chi2 lane order (d = {dd}, "
                  f"k = {k})")
            check(bitwise(distance_topk(wq, wc, wids, wmask, k, "chi2"),
                          ref.distance_topk_lane_order(wq, wc, wids, wmask,
                                                       k)),
                  f"kernel G is not bitwise its chi2 lane order (d = {dd}, "
                  f"k = {k})")
            lane_cases.append([f"d = {dd}", 16, 200, k])
        g_wide = compare_topk(torch, distance_topk(wq, wc, wids, wmask, K),
                              ref.distance_topk_ref(wq, wc, wids, wmask,
                                                    K + 1), K)
        fused_err = max(fused_err, g_wide)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "descent_cases": len(descent_cases),
          "descent_bitwise": True, "deep_chains_a_and_f": deep_cases,
          "fused_cases": fused_cases,
          "fused_max_abs_err": fused_err, "int8_cases": int8_cases,
          "int8_max_abs_err": int8_err, "scan_cases": scan_cases,
          "matmul_max_abs_err": d_err, "chi2_max_abs_err": e_err,
          "chi2_dordered_slabs": [[64, r.shape[0], k] for r, k in slabs],
          "chi2_dordered_bitwise": True, "chi2_lane_order_bitwise_b_g":
          lane_cases})

    # ---- kernel B's scan against its gather, bit for bit --------------------
    def gather_all(q, rows, k, metric, valid=None):
        """Kernel B's gather over ids = arange(N), -1 where ``valid`` is
        False, for every query: the scan's function as the gather computes
        it."""
        ids = torch.arange(rows.shape[0], dtype=torch.int32, device=dev)
        if valid is not None:
            ids = torch.where(valid, ids, -1)
        return fused_gather_topk(q, ids.expand(q.shape[0], -1).contiguous(),
                                 rows, k, metric)

    def every_7th_dead(rows):
        return torch.arange(rows.shape[0], device=dev) % 7 != 0

    iss_slab = iss_q[:SLAB].contiguous()
    db50 = db[:50].contiguous()
    bitwise_cases = []
    for metric, q, rows, valid, k in (
            ("l2", queries, db, None, K),
            ("l2", queries, db, every_7th_dead(db), K),
            ("dot", queries[:SLAB], db, None, K),
            ("cosine", queries[:SLAB], db, every_7th_dead(db), K),
            ("chi2", iss_slab, iss_db, None, K),
            ("chi2", iss_slab, iss_db, every_7th_dead(iss_db), K),
            ("chi2", iss_slab, iss_dense, None, K),
            ("l2", queries[:7], db50, None, 129),
            ("dot", queries[:7], db50, every_7th_dead(db50), 129)):
        q = q.contiguous()
        got = fused_scan(q, rows, k, metric, valid)
        want = gather_all(q, rows, k, metric, valid)
        tag = (f"{metric}, {q.shape[0]} x {rows.shape[0]}, k = {k}, "
               f"{'every 7th row dead' if valid is not None else 'all live'}"
               f"{', dense' if rows is iss_dense else ''}")
        check(bitwise(got, want), f"the scan differs from B's gather: {tag}")
        live = rows.shape[0] if valid is None else int(valid.sum())
        check(bool((got[1][:, live:] == -1).all())
              and bool(torch.isinf(got[0][:, live:]).all()),
              f"the scan's slots past the live rows are not +inf / -1: {tag}")
        bitwise_cases.append(tag)
    emit({"phase": "scan", "bitwise_vs_gather": True,
          "cases": bitwise_cases})

    # ---- any k: k = 129 and 256 -------------------------------------------
    any_k, any_err = (129, 256), {}
    sq = queries[:SLAB].contiguous()
    iss_rows = iss_db[:32768].contiguous()
    iss_sq = iss_q[:64].contiguous()
    ids1 = cand[1][:SLAB].contiguous()
    ids4 = cand[4][:SLAB].contiguous()
    c64, ids64 = db[cand[1][:64].clamp_min(0).long()], cand[1][:64].contiguous()
    mask64 = ids64 >= 0
    for k in any_k:
        err = {}
        got = index.search(sq, SearchParams(k=k))
        err["rpf"] = compare_topk(torch, got, index.search(
            sq, SearchParams(k=k + 1, mode="ref")), k)
        check_scores(torch, METRICS["l2"], sq, db, got)
        got = index8.search(sq, SearchParams(k=k, n_probes=4, expand=EXPAND))
        err["rpf+int8"] = compare_topk(torch, got, int8_plain(sq, 4, k), k)
        check_scores(torch, METRICS["l2"], sq, db, got)
        got = bidx.search(sq, SearchParams(k=k))
        err["bruteforce"] = compare_topk(torch, got, bidx.search(
            sq, SearchParams(k=k + 1, mode="ref")), k)
        for m in ("l2", "dot"):
            want = ref.matmul_topk_ref(sq, db, k + 1, m)
            err[f"topk_{m}"] = compare_topk(
                torch, ops.topk(sq, db, k, m), want, k,
                tol=expansion_tol(torch, sq, db, want[1]))
        err["topk_chi2"] = compare_topk(
            torch, ops.topk(iss_sq, iss_rows, k, "chi2"),
            ref.chi2_topk_ref(iss_sq, iss_rows, k + 1), k)
        err["rerank_candidates"] = compare_topk(
            torch, ops.rerank_candidates(queries[:64], c64, ids64, mask64, k),
            ref.distance_topk_ref(queries[:64], c64, ids64, mask64, k + 1), k)
        any_err[k] = err
        # each kernel's k = 10 output is its k's first 10 columns, bitwise
        for name, fn in (
                ("fused_gather_topk", lambda kk: fused_gather_topk(
                    sq, ids1, db, kk)),
                ("fused_gather_topk M=64", lambda kk: fused_gather_topk(
                    sq, ids1[:, :64].contiguous(), db, kk)),
                ("fused_gather_topk_int8", lambda kk: fused_gather_topk_int8(
                    sq, ids4, qdb.q, qdb.scale, 4 * kk)),
                ("matmul_topk", lambda kk: matmul_topk(sq, db, kk)),
                ("chi2_topk", lambda kk: chi2_topk(iss_sq, iss_rows, kk)),
                ("distance_topk", lambda kk: distance_topk(
                    queries[:64], c64, ids64, mask64, kk)),
                ("fused_scan", lambda kk: fused_scan(sq, db, kk))):
            big, small = fn(k), fn(K)
            kernel, _, tag = name.partition(" ")
            if kernel in digests:
                tag = f" {tag}" if tag else ""
                digests[kernel][f"anyk {k}{tag}"] = digest(big)
                digests[kernel][f"anyk {K} beside {k}{tag}"] = digest(small)
            w = small[0].shape[1]
            check(bitwise((big[0][:, :w].contiguous(),
                           big[1][:, :w].contiguous()), small),
                  f"{name}'s k = {K} output is not the prefix of its k = {k}")
    del c64
    emit({"phase": "anyk", "k": list(any_k), "max_abs_err": any_err,
          "prefix_bitwise": ["fused_gather_topk", "fused_gather_topk_int8",
                             "matmul_topk", "chi2_topk", "distance_topk",
                             "fused_scan"]})

    # ---- shared by the timings below ----------------------------------------
    rate = mem_rate(card)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def bound(nbytes, ops, op_rate=FP32_FLOPS):
        by_bytes, by_ops = nbytes / rate, ops / op_rate
        return {"bound_ms": max(by_bytes, by_ops) * 1e3, "bytes": nbytes,
                "operations": ops,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations"}

    depth = node_depths(torch, child, rc.max_depth)

    # ---- path: tree (kernel F through ops.traverse_tree) ---------------------
    # every tree of the MNIST-784 forest, sliced to its used nodes (nodes are
    # allocated as a prefix, so the slice is the same tree)
    used = forest.n_nodes.tolist()
    trees = [(feat[t, :n], thresh[t, :n], child[t, :n])
             for t, n in enumerate(used)]
    cap = smem_node_cap(dev)
    check(max(used) <= cap, f"a used tree of {max(used)} nodes exceeds the "
          f"shared-memory cap of {cap}")

    def drive_tree():
        return {(t, p, b): ops.traverse_tree(*trees[t], queries[:b],
                                             rc.max_depth, n_probes=p,
                                             kernel="smem")
                for t in range(rc.n_trees) for p in PROBES for b in BATCHES}

    tree_res, launches, ref_calls = counted(torch, counters, drive_tree)
    require(launches, ref_calls, ("forest_traverse_smem",), "tree")
    check(set(launches) == {"forest_traverse_smem"},
          f"ops.traverse_tree(kernel='smem') launched {launches}")
    launches_by_path["tree"] = launches
    emit({"phase": "tree", "trees": rc.n_trees, "nodes_used_max": max(used),
          "smem_node_cap": cap, "calls": len(tree_res), "launches": launches,
          "ref_calls": ref_calls})
    a_leaves = {p: forest_traverse_hbm(feat, thresh, child, queries,
                                       rc.max_depth, p) for p in PROBES}
    tree_plain = {(t, p): ref.forest_traverse_tree_ref(
        *trees[t], queries, rc.max_depth, p)
        for t in range(rc.n_trees) for p in PROBES}
    for (t, p, b), got in tree_res.items():
        check(torch.equal(got, tree_plain[t, p][:b]),
              f"kernel F differs from its plain version: tree {t} P={p} B={b}")
        check(torch.equal(got, a_leaves[p][t, :b]),
              f"kernel F differs from kernel A: tree {t} P={p} B={b}")
    # above the cap "auto" must take kernel A and "smem" must raise
    iss_forest = iss_index.forest
    big = {"mnist784_unsliced": (feat[0], thresh[0], child[0], queries,
                                 rc.max_depth, a_leaves[4][0]),
           "iss595": (iss_forest.proj_idx[0, :, 0].contiguous(),
                      iss_forest.thresh[0], iss_forest.child_base[0], iss_q,
                      iss_rc.max_depth, None)}
    auto_launches = collections.Counter()
    for name, (f, th, cb, q, depth_cap, want) in big.items():
        check(f.shape[0] > cap, f"the {name} tree fits the cap")
        got, launches, ref_calls = counted(torch, counters, lambda: (
            ops.traverse_tree(f, th, cb, q, depth_cap, n_probes=4,
                              kernel="auto")))
        check(launches == {"forest_traverse": 1} and not ref_calls,
              f"kernel='auto' on {name} launched {launches}, plain "
              f"{ref_calls}")
        auto_launches.update(launches)
        if want is not None:
            check(torch.equal(got, want), "kernel='auto' differs from A")
        try:
            ops.traverse_tree(f, th, cb, q, depth_cap, kernel="smem")
        except ValueError:
            pass
        else:
            raise RuntimeError(f"check failed: kernel='smem' on {name} "
                               f"({f.shape[0]} nodes) did not raise")
    launches_by_path["tree_auto"] = dict(auto_launches)
    emit({"phase": "compare", "path": "tree", "cases": len(tree_res),
          "bitwise_vs_plain": True, "bitwise_vs_kernel_a": True,
          "auto_above_cap": dict(auto_launches), "smem_above_cap": "raised",
          "allocated_nodes": {n: int(v[0].shape[0]) for n, v in big.items()}})

    # F's time on the largest tree at B = 1024, beside kernel A on the same
    # tree: bytes are the tree once (12 B a node), one q coordinate per
    # (query, level reached) and the output
    t_big = max(range(rc.n_trees), key=lambda t: used[t])
    tf = trees[t_big]
    tf2 = tuple(a[None] for a in tf)
    tree_rows = []
    for p in PROBES:
        leaves = tree_plain[t_big, p].view(queries.shape[0], -1)
        ok = leaves >= 0
        levels = torch.where(ok, depth[t_big, leaves.clamp_min(0).long()], 0)
        nbytes = 12 * used[t_big] + 4 * int(levels.sum()) + 4 * leaves.numel()
        tree_rows.append({
            "n_probes": p, "tree": t_big, "nodes": used[t_big],
            "smem_bytes": 12 * used[t_big],
            "blocks": -(-queries.shape[0] // 128),
            "ms": time_ms(torch, lambda: forest_traverse(
                *tf, queries, rc.max_depth, p), 25, flush),
            "kernel_a_same_tree_ms": time_ms(torch, lambda: forest_traverse_hbm(
                *tf2, queries, rc.max_depth, p), 25, flush),
            "plain_ms": time_ms(torch, lambda: ref.forest_traverse_tree_ref(
                *tf, queries, rc.max_depth, p), 5, flush),
            **bound(nbytes, 0), "max_levels": int(levels.max())})
    del tree_res, tree_plain

    # ---- path: rerank (kernel G through ops.rerank_candidates) --------------
    def rerank_path():
        """The rpf path's own deduplicated candidates, gathered as db[ids]
        (25 GB in all with the dense ISS-595 copy, freed on return): drive,
        compare, time."""
        gathered = []
        for cell, metric, q, rows, ids in (
                ("rpf_mnist784 P=1", "l2", queries, db, cand[1]),
                ("rpf_mnist784 P=4", "l2", queries, db, cand[4]),
                ("rpf_iss595 P=1", "chi2", iss_q, iss_db, iss_cand)):
            ids = ids.contiguous()
            gathered.append((cell, metric, q, rows, ids, ids >= 0,
                             rows[ids.clamp_min(0).long()]))

        def drive():
            return [{b: ops.rerank_candidates(q[:b], c[:b], ids[:b],
                                              mask[:b], K, metric)
                     for b in BATCHES}
                    for _, metric, q, _, ids, mask, c in gathered]

        res, launches, ref_calls = counted(torch, counters, drive)
        require(launches, ref_calls, ("distance_topk",), "rerank")
        launches_by_path["rerank"] = launches
        emit({"phase": "rerank",
              "shapes": {g[0]: list(g[6].shape) for g in gathered},
              "gathered_gb": sum(g[6].numel() * 4 for g in gathered) / 1e9,
              "launches": launches, "ref_calls": ref_calls})
        err, cases = 0.0, 0
        for (cell, metric, q, rows, ids, mask, c), per_b in zip(gathered,
                                                                res):
            for b, got in per_b.items():
                want = in_slabs(torch, lambda lo, hi: ref.distance_topk_ref(
                    q[lo:hi], c[lo:hi], ids[lo:hi], mask[lo:hi], K + 1,
                    metric), b)
                err = max(err, compare_topk(torch, got, want, K))
                # G scores each pair in B's order of sums: its distances are
                # B's bit for bit, and its ids B's at every rank whose
                # distance ties neither neighbour (B breaks ties by slot,
                # G by id); B's k + 1 columns give the last rank's neighbour
                bd, bi = fused_gather_topk(q[:b].contiguous(), ids[:b], rows,
                                           K + 1, metric)
                gd, gi = got
                untied = torch.ones_like(gi, dtype=torch.bool)
                untied[:, 1:] &= bd[:, 1:K] != bd[:, :K - 1]
                untied &= bd[:, :K] != bd[:, 1:]
                check(torch.equal(gd.view(torch.int32),
                                  bd[:, :K].contiguous().view(torch.int32))
                      and torch.equal(gi[untied], bi[:, :K][untied]),
                      f"kernel G differs from kernel B: {cell}, B = {b}")
                check_scores(torch, METRICS[metric], q[:b], rows, got)
                cases += 1
        # edges: an all-masked row with k > M, k = 128, and ties, whose ids
        # must come out smallest first
        _, _, _, _, ids1, mask1, c1 = gathered[0]
        mask7 = mask1[:7, :40].clone()
        mask7[3] = False
        for q, c, ids, mask, k in (
                (queries[:7], c1[:7, :40].contiguous(),
                 ids1[:7, :40].contiguous(), mask7, 64),
                (queries[:7], c1[:7], ids1[:7], mask1[:7], 128)):
            got = distance_topk(q, c, ids, mask, k, "l2")
            want = ref.distance_topk_ref(q, c, ids, mask, k + 1, "l2")
            err = max(err, compare_topk(torch, got, want, k))
            cases += 1
            if k == 64:
                check(bool(got[1][3].eq(-1).all())
                      and bool(got[0][3].isinf().all()),
                      "an all-masked row is not +inf / -1")
        tie_ids = torch.stack([torch.randperm(1000, generator=gen,
                                              device=dev)[:300]
                               for _ in range(2)]).int()
        tie = (torch.zeros((2, 784), device=dev),
               torch.ones((2, 300, 784), device=dev), tie_ids,
               torch.ones((2, 300), dtype=torch.bool, device=dev))
        got = distance_topk(*tie, K, "l2")
        want = ref.distance_topk_ref(*tie, K, "l2")
        check(torch.equal(got[1], want[1]) and torch.equal(
            got[1], torch.sort(tie_ids, dim=1).values[:, :K]),
            "tied slots do not come out smallest id first")
        cases += 1
        emit({"phase": "compare", "path": "rerank", "cases": cases,
              "max_abs_err": err, "vs_kernel_b": "distances bitwise, ids "
              "equal where untied",
              "ties": "smallest id first"})

        # G reads each valid slot's row once (a masked slot loads nothing),
        # the ids and the mask once: l2 3 operations per element, chi2
        # CHI2_ISSUES issues per term.  Besides the path's cells: ISS-595
        # under l2 and MNIST-784 under chi2 (which of d and the division
        # costs the time), and ISS-595 under chi2 on the dense rows
        mnist1, _, iss1 = gathered
        gathered += [
            (iss1[0], "l2") + iss1[2:],
            (mnist1[0], "chi2") + mnist1[2:],
            ("rpf_iss595 P=1 dense", "chi2", iss_q, iss_dense, iss1[4],
             iss1[5], iss_dense[iss1[4].clamp_min(0).long()])]
        rows_out = []
        for cell, metric, q, rows, ids, mask, c in gathered:
            valid = int(mask.sum())
            b, m, d = c.shape
            nbytes = valid * d * 4 + b * m * 5 + q.numel() * 4 + b * K * 8
            ops_ = ((3 * valid * d, FP32_FLOPS) if metric == "l2" else
                    (CHI2_ISSUES * valid * d, FP32_FLOPS / 2))
            rows_out.append({
                "cell": cell, "metric": metric, "m": m, "valid_slots": valid,
                "ms": time_ms(torch, lambda: distance_topk(
                    q, c, ids, mask, K, metric), 25, flush),
                "kernel_b_same_ids_ms": time_ms(
                    torch, lambda: fused_gather_topk(q, ids, rows, K, metric),
                    25, flush),
                "plain_ms": time_ms(torch, lambda: in_slabs(
                    torch, lambda lo, hi: ref.distance_topk_ref(
                        q[lo:hi], c[lo:hi], ids[lo:hi], mask[lo:hi], K,
                        metric), b), 3, flush),
                **bound(nbytes, *ops_)})
        return err, rows_out

    g_err, rerank_rows = rerank_path()
    torch.cuda.empty_cache()

    # ---- path: bag (kernel H through ops.embedding_bag) ----------------------
    # the MIND history bag: 1M x 64 f32 table, H = 50, ragged histories of 1
    # to 50 items (the tail id 0, weight 0), B = 512 and 262,144
    bgen = torch.Generator(device=dev).manual_seed(2)
    hist = bagcfg.HIST_LEN
    table = torch.randn((bagcfg.ITEM_VOCAB, bagcfg.EMBED_DIM), generator=bgen,
                        device=dev)

    def bag_inputs(b, v=bagcfg.ITEM_VOCAB, h=hist):
        ids = torch.randint(0, v, (b, h), generator=bgen, device=dev,
                            dtype=torch.int32)
        w = torch.rand((b, h), generator=bgen, device=dev)
        tail = torch.arange(h, device=dev)[None, :] >= torch.randint(
            1, h + 1, (b, 1), generator=bgen, device=dev)
        return ids.masked_fill(tail, 0), w.masked_fill(tail, 0.0)

    bags = {name: bag_inputs(b) for name, b in bagcfg.BATCHES.items()}

    def drive_bag():
        return {name: ops.embedding_bag(ids, w, table)
                for name, (ids, w) in bags.items()}

    bag_res, launches, ref_calls = counted(torch, counters, drive_bag)
    require(launches, ref_calls, ("embedding_bag",), "bag")
    launches_by_path["bag"] = launches
    emit({"phase": "bag", "table": list(table.shape), "hist_len": hist,
          "batches": dict(bagcfg.BATCHES), "launches": launches,
          "ref_calls": ref_calls})

    def bag_err(got, ids, w, tab):
        """Largest |kernel - plain| with its tolerance 1e-5 sum |w row| +
        1e-6, in slabs; the NaN and inf pattern must agree."""
        worst = 0.0
        for lo in range(0, ids.shape[0], 32768):
            hi = lo + 32768
            want = ref.embedding_bag_ref(ids[lo:hi], w[lo:hi], tab)
            scale = ref.embedding_bag_ref(ids[lo:hi], w[lo:hi].abs(),
                                          tab.abs())
            g = got[lo:hi]
            check(torch.equal(g.isnan(), want.isnan())
                  and torch.equal(g.isinf(), want.isinf()),
                  "bag NaN / inf pattern differs")
            fin = want.isfinite()
            err = (g - want).abs()[fin]
            check(bool((err <= (RTOL * scale + ATOL)[fin]).all()),
                  f"bag error {float(err.max())}")
            worst = max(worst, float(err.max()) if err.numel() else 0.0)
        return worst

    # the launch shape (warps a bag, blocks) H's C entry takes for (B, H,
    # D), and an empty kernel on the same blocks: H's latency floor
    hlib = build.library("embedding_bag")
    hlib.embedding_bag_shape.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    hlib.embedding_bag_empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def bag_shape(b, h, d):
        shape = (ctypes.c_int * 2)()
        build.check_launch(hlib.embedding_bag_shape(b, h, d, shape),
                           "embedding_bag_shape")
        return shape[0], shape[1]

    import torch.nn.functional as F
    h_err = max(bag_err(bag_res[n], *bags[n], table) for n in bags)
    lib_err = max(bag_err(F.embedding_bag(ids, table, per_sample_weights=w,
                                          mode="sum"), ids, w, table)
                  for ids, w in bags.values())
    # edges: one bag, seven bags, H = 1, 600 bags (2 warps a bag), D = 6
    # (the scalar branch) with a NaN in row 0 (every padded slot's 0 * NaN)
    # and an inf in row 5, and the same on a copy of the MIND table (16-byte
    # chunks, a bag split over warps that meet in shared memory)
    small = torch.randn((100, 6), generator=bgen, device=dev)
    small[0, 1], small[5, 2] = float("nan"), float("inf")
    special = table.clone()
    special[0, 1], special[5, 2] = float("nan"), float("inf")
    h_cases = {n: bag_shape(ids.shape[0], hist, table.shape[1])
               for n, (ids, _) in bags.items()}
    for tag, tab, b, h in (("1", table, 1, hist), ("7", table, 7, hist),
                           ("7_h1", table, 7, 1), ("600", table, 600, hist),
                           ("7_d6_nan", small, 7, 9),
                           ("300_d6_nan", small, 300, 50),
                           ("7_nan", special, 7, hist),
                           ("600_nan", special, 600, hist)):
        ids, w = bag_inputs(b, tab.shape[0], h)
        h_err = max(h_err, bag_err(embedding_bag(ids, w, tab), ids, w, tab))
        h_cases[tag] = bag_shape(b, h, tab.shape[1])
    del special
    check(any(wpb == 2 for wpb, _ in h_cases.values())
          and h_cases["7_nan"][0] > 1,
          f"bag cases miss a split launch shape: {h_cases}")
    emit({"phase": "compare", "path": "bag",
          "cases_warps_per_bag_blocks": h_cases,
          "max_abs_err": h_err, "library_max_abs_err": lib_err,
          "tolerance": f"{RTOL} sum_h |w row| + {ATOL}"})

    # H's bytes: each distinct row the bags touch once, ids and weights once,
    # the output once; 2 operations per element
    bag_rows = []
    for name, (ids, w) in bags.items():
        b = ids.shape[0]
        d = table.shape[1]
        distinct = int(torch.unique(ids).numel())
        wpb, blocks = h_cases[name]
        stream = torch.cuda.current_stream(dev).cuda_stream

        def empty():
            build.check_launch(hlib.embedding_bag_empty(b, hist, d, stream),
                               "embedding_bag_empty")

        empty()
        bag_rows.append({
            "cell": name, "batch": b, "distinct_rows": distinct,
            "gathered_bytes": b * hist * d * 4,
            "warps_per_bag": wpb, "blocks": blocks,
            "ms": time_ms(torch, lambda: embedding_bag(ids, w, table), 25,
                          flush),
            "latency_floor_ms": time_ms(torch, empty, 25, flush),
            "plain_ms": time_ms(torch, lambda: torch.cat([
                ref.embedding_bag_ref(ids[lo:lo + 32768], w[lo:lo + 32768],
                                      table)
                for lo in range(0, b, 32768)]), 3, flush),
            "library_ms": time_ms(torch, lambda: F.embedding_bag(
                ids, table, per_sample_weights=w, mode="sum"), 25, flush),
            **bound(distinct * d * 4 + b * hist * 8 + b * d * 4,
                    2 * b * hist * d)})
    del bag_res

    # ---- path: lsh (the lsh-cascade backend, kernel B) -----------------------
    lsh_spec = IndexSpec(backend="lsh-cascade", seed=0)

    def drive_lsh():
        t0 = time.perf_counter()
        idx = build_index(db_np, lsh_spec, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        return idx, build_s, {b: idx.search(queries[:b], SearchParams(k=K))
                              for b in BATCHES}

    (lsh_index, lsh_build_s, lsh_res), launches, ref_calls = counted(
        torch, counters, drive_lsh)
    require(launches, ref_calls, ("fused_gather_topk",), "lsh")
    launches_by_path["lsh"] = launches
    emit({"phase": "lsh", "radii": list(lsh_spec.lsh_radii),
          "tables": lsh_spec.lsh_tables, "bits": lsh_spec.lsh_bits,
          "index_build_s": lsh_build_s,
          "mean_candidates": lsh_index.last_mean_candidates,
          "launches": launches, "ref_calls": ref_calls})
    worst_lsh = 0.0
    for b, got in lsh_res.items():
        want = in_slabs(torch, lambda lo, hi: lsh_index.search(
            queries[lo:hi], SearchParams(k=K + 1, mode="ref")), b)
        worst_lsh = max(worst_lsh, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["l2"], queries[:b], db, got)
    emit({"phase": "compare", "path": "lsh", "cases": len(lsh_res),
          "max_abs_err": worst_lsh})

    # ---- path: mutate (segments, delta buffer, tombstones) -----------------
    # the paper's MNIST-784 index at rebuild_frac 0.1 on rpf, rpf+int8 and
    # bruteforce, each through the same churn: 7,000 adds of
    # mnist_like(seed=1) rows (the first 6,000 seal into segment 1, which
    # builds its own forest; 1,000 stay in the delta), deletes of every
    # 30th base id, every 12th id of segment 1 and every 2nd delta id, and
    # 300 upserts of live base ids
    # (at N = 60,000: 6,000 sealed, 1,000 in the delta, 2,000 + 500 + 500
    # deleted, 300 upserted; stats n_segments 2, n_live 64,000,
    # n_tombstones 3,300, n_delta 800, n_deleted_total 3,000)
    n_base = cfgmod.N_DB
    n_seal = n_base // 10               # the seal threshold at 0.1
    n_added = n_seal + n_seal // 6
    churn_np, churn_labels = mnist_like(n_added + n_base // 200, n_test=1,
                                        d=cfgmod.DIM, seed=1)[:2]

    def row_meta(gid, label):
        """A row's metadata: its class, id % 100 and a timestamp."""
        return {"label": int(label), "bucket": gid % 100, "ts": TS0 + gid}

    # the base rows' columns (the knobs path's too): Eq("bucket", 7) keeps
    # 1% of the rows (the brute regime), Eq("label", 3) about 10% (widened)
    base_meta = {"label": db_labels.astype(np.int64),
                 "bucket": np.arange(n_base, dtype=np.int64) % 100,
                 "ts": TS0 + np.arange(n_base, dtype=np.int64)}
    p_brute, p_wide = Eq("bucket", 7), Eq("label", 3)
    dead_base = list(range(0, n_base, 30))
    dead_seg1 = list(range(n_base, n_base + n_seal, 12))
    dead_delta = list(range(n_base + n_seal, n_base + n_added, 2))
    dead_ids = dead_base + dead_seg1 + dead_delta
    upserted = list(range(15, n_base, 200))        # never a multiple of 30
    want_stats = {
        "n_segments": 2, "n_live": n_base + n_added - len(dead_ids),
        "n_tombstones": len(dead_ids) + len(upserted),
        "n_delta": n_added - n_seal - len(dead_delta) + len(upserted),
        "n_deleted_total": len(dead_ids)}
    mut_specs = {name: IndexSpec(backend=name, forest=cfgmod.CONFIG, seed=0,
                                 rebuild_frac=0.1)
                 for name in ("rpf", "rpf+int8", "bruteforce")}
    mut_params = {"rpf": [SearchParams(k=K, n_probes=p) for p in PROBES],
                  "rpf+int8": [SearchParams(k=K, n_probes=4,
                                            expand=EXPAND)],
                  "bruteforce": [SearchParams(k=K)]}
    mut_kernels = {"rpf": ("forest_traverse", "fused_gather_topk",
                           "fused_scan"),
                   "rpf+int8": ("forest_traverse", "fused_gather_topk_int8",
                                "fused_gather_topk", "fused_scan"),
                   "bruteforce": ("fused_scan",)}

    def drive_mutate(name):
        t0 = time.perf_counter()
        idx = build_index(db_np, mut_specs[name], device=dev,
                          metadata=base_meta)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        for j in range(n_added):
            if j == n_seal - 1:    # this add seals the delta into segment 1
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            idx.add(churn_np[j], metadata=row_meta(n_base + j,
                                                   churn_labels[j]))
            if j == n_seal - 1:
                torch.cuda.synchronize()
                seal_s = time.perf_counter() - t0
        idx.delete(dead_ids)
        for j, gid in enumerate(upserted):
            idx.upsert(gid, churn_np[n_added + j], metadata=row_meta(
                gid, churn_labels[n_added + j]))
        return idx, build_s, seal_s, [idx.search(queries, p)
                                      for p in mut_params[name]]

    mut, seal_s_by = {}, {}
    for name in mut_specs:
        (idx, build_s, seal_s, res), launches, ref_calls = counted(
            torch, counters, lambda name=name: drive_mutate(name))
        require(launches, ref_calls, mut_kernels[name], f"mutate {name}")
        launches_by_path[f"mutate {name}"] = launches
        st = idx.stats()
        check(all(st[key] == v for key, v in want_stats.items()),
              f"mutate {name}: stats {st}, want {want_stats}")
        mut[name] = (idx, res, idx.snapshot())
        seal_s_by[name] = seal_s
        emit({"phase": "mutate", "backend": name, "stats": st,
              "index_build_s": build_s, "seal_build_s": seal_s,
              "searches": len(res), "launches": launches,
              "ref_calls": ref_calls})

    # every returned id is live, once a row, and scores its current row
    gids_live, rows_live = mut["rpf"][0].live_points()
    for name in ("rpf+int8", "bruteforce"):
        g, r = mut[name][0].live_points()
        check(np.array_equal(g, gids_live) and np.array_equal(r, rows_live),
              f"mutate {name}: live points differ from rpf's")
    gl = torch.from_numpy(gids_live).to(dev)
    rows_live_dev = torch.from_numpy(rows_live).to(dev)
    by_gid = torch.zeros((n_base + n_added, db.shape[1]), device=dev)
    by_gid[gl.long()] = rows_live_dev
    dead = torch.zeros(n_base + n_added, dtype=torch.bool, device=dev)
    dead[dead_ids] = True

    def integrity(got, name):
        gi = got[1]
        ok = gi >= 0
        check(not bool(dead[gi.clamp_min(0).long()][ok].any()),
              f"a deleted id surfaced on mutate {name}")
        s = gi.sort(dim=1)[0]
        check(not bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any()),
              f"an id appears twice in a row on mutate {name}")
        check_scores(torch, METRICS["l2"], queries, by_gid, got)

    def as_gids(out):
        d, i = out
        return d, torch.where(i >= 0, gl[i.clamp_min(0).long()], -1)

    def int8_plain_mut(view, q, p, k=K):
        """``int8_plain`` over each sealed segment (its tombstones masked
        before dedup), the delta's plain scan, merged to k + 1."""
        parts = []
        for seg in view.segments:
            eng = seg.engine
            rcs = eng.spec.forest.resolved(eng.db.shape[0])
            ids, mask = candidates(eng.forest, q, rcs.max_depth,
                                   rcs.leaf_pad, p, mode="ref")
            if seg.n_dead:
                mask = mask & seg.live_dev[ids.long()]
            ids = torch.where(mask_duplicates(ids, mask), ids, -1).int()
            kp = min(EXPAND * k, ids.shape[1])
            _, short = ref.fused_gather_topk_int8_ref(q, ids, eng.qdb.q,
                                                      eng.qdb.scale, kp)
            d, i = ref.fused_gather_topk_ref(q, short, eng.qdb.fp, k + 1)
            parts.append((d, torch.where(
                i >= 0, seg.gids_dev[i.clamp_min(0).long()], -1)))
        parts.append(view.delta.search(q, SearchParams(k=k + 1, mode="ref")))
        return merge_topk_pairs(torch.cat([d for d, _ in parts], dim=1),
                                torch.cat([i for _, i in parts], dim=1),
                                k + 1)

    # 1. bruteforce: bitwise a fresh build over the live points
    fresh_b = build_index(rows_live, IndexSpec(backend="bruteforce"),
                          device=dev)
    mb_res = mut["bruteforce"][1][0]
    check(bitwise(mb_res, as_gids(fresh_b.search(queries,
                                                 SearchParams(k=K)))),
          "mutated bruteforce differs from a fresh build of its live rows")
    integrity(mb_res, "bruteforce")
    del fresh_b
    # 2. rpf at P = 1 and 4, rpf+int8 at P = 4: against the plain path
    m_rpf, rpf_res, rpf_view = mut["rpf"]
    mut_err, from_part = {}, {}
    for p, got in zip(PROBES, rpf_res):
        want = rpf_view.search(queries, SearchParams(k=K + 1, n_probes=p,
                                                     mode="ref"))
        mut_err[f"rpf P={p}"] = compare_topk(torch, got, want, K)
        integrity(got, "rpf")
        gi = got[1][got[1] >= 0]
        from_part[f"rpf P={p}"] = {
            "base": int((gi < n_base).sum()),
            "segment 1": int(((gi >= n_base) & (gi < n_base + n_seal)).sum()),
            "delta": int((gi >= n_base + n_seal).sum()),
            "upserted": int(torch.isin(gi, torch.tensor(
                upserted, device=dev)).sum())}
    m_int8, (int8_got,), int8_view = mut["rpf+int8"]
    want = in_slabs(torch, lambda lo, hi: int8_plain_mut(
        int8_view, queries[lo:hi], 4), queries.shape[0])
    mut_err["rpf+int8 P=4"] = compare_topk(torch, int8_got, want, K)
    integrity(int8_got, "rpf+int8")
    # 6. a filtered search in the brute regime (Eq("bucket", 7): the live
    # rows with id % 100 == 7) is bitwise a bruteforce build over the live
    # matching rows, on every backend
    match = gids_live % 100 == 7
    n_match = int(match.sum())
    check(use_brute_force(n_match / gids_live.shape[0], n_match),
          f"mutate: {n_match} matches are not the brute regime")
    fresh_f = build_index(rows_live[match], IndexSpec(backend="bruteforce"),
                          device=dev)
    gm = torch.from_numpy(gids_live[match]).to(dev)
    fd, fi = fresh_f.search(queries, SearchParams(k=K))
    want_f = (fd, torch.where(fi >= 0, gm[fi.clamp_min(0).long()], -1))
    for name in mut:
        got = mut[name][0].search(queries, SearchParams(k=K,
                                                        filter=p_brute))
        check(bitwise(got, want_f), f"mutate {name}: the filtered brute "
              f"regime differs from a bruteforce build over the live "
              f"matching rows")
    del fresh_f
    emit({"phase": "compare", "path": "mutate", "max_abs_err": mut_err,
          "bruteforce_bitwise_fresh": True, "result_ids_from": from_part,
          "filtered_brute_regime_bitwise_fresh": {"matches": n_match,
                                                  "backends": sorted(mut)}})

    # 5. save -> load_index on the card: the same answers bit for bit (the
    # save seals the delta into segment 2 first)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_rpf.save(tmp)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_index(tmp, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    for p in PROBES:
        params = SearchParams(k=K, n_probes=p)
        check(bitwise(loaded.search(queries, params),
                      m_rpf.search(queries, params)),
              f"save / load_index changed the answers at P = {p}")
    for pred in (p_brute, p_wide):
        params = SearchParams(k=K, filter=pred)
        check(bitwise(loaded.search(queries, params),
                      m_rpf.search(queries, params)),
              f"save / load_index changed the filtered answers ({pred})")
    check(loaded.stats()["metadata_columns"] == ["bucket", "label", "ts"],
          f"loaded metadata columns {loaded.stats()['metadata_columns']}")
    saved_st = m_rpf.stats()
    check(all(loaded.stats()[key] == saved_st[key] for key in (
        "n_segments", "n_live", "n_tombstones", "n_delta")),
        f"loaded stats {loaded.stats()} differ from {saved_st}")
    del loaded
    # 4. a search while compact(block=False) rebuilds answers from the old
    # view, bit for bit; then the thread publishes the new view
    params4 = SearchParams(k=K, n_probes=4)
    old = m_rpf.search(queries, params4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compaction = m_rpf.compact(block=False)
    during = m_rpf.search(queries, params4)
    torch.cuda.synchronize()
    in_progress = m_rpf.stats()["compaction_in_progress"]
    compaction.join()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    check(in_progress, "the compaction ended before the search issued "
          "during it returned")
    check(bitwise(during, old), "a search during compaction differs from "
          "the old view's answer")
    st = m_rpf.stats()
    check(st["n_segments"] == 1 and st["n_tombstones"] == 0
          and st["n_live"] == want_stats["n_live"]
          and st["n_compactions"] == 1,
          f"compacted stats {st}")
    # 3. the compacted rpf index is bitwise a fresh build of its live rows
    # with the original seed, and two such builds give equal forests
    gids_c, rows_c = m_rpf.live_points()
    check(np.array_equal(gids_c, gids_live)
          and np.array_equal(rows_c, rows_live),
          "compaction changed the live points or their order")
    fresh = [build_index(rows_live, mut_specs["rpf"], device=dev)
             for _ in range(2)]
    for name, a, b, c in zip(Forest._fields, m_rpf.forest, fresh[0].forest,
                             fresh[1].forest):
        check(torch.equal(b, c), f"two builds over the same rows differ in "
              f"forest.{name}")
        check(torch.equal(a, b), f"the compacted forest differs from a "
              f"fresh build in forest.{name}")
    compact_res = {}
    for p in PROBES:
        params = SearchParams(k=K, n_probes=p)
        compact_res[p] = m_rpf.search(queries, params)
        check(bitwise(compact_res[p], as_gids(fresh[0].search(queries,
                                                                params))),
              f"the compacted index differs from a fresh build at P = {p}")
        integrity(compact_res[p], "rpf compacted")
    del fresh
    emit({"phase": "mutate", "backend": "rpf", "stats_compacted": st,
          "save_s": save_s, "load_s": load_s, "compact_s": compact_s,
          "compact_note": "compact(block=False) to join, one search "
                          "during it", "checks": [
              "bruteforce bitwise fresh", "rpf / rpf+int8 vs plain",
              "filtered brute regime bitwise fresh (3 backends)",
              "save-load bitwise (filtered too)",
              "search during compaction bitwise old",
              "compacted bitwise fresh", "two builds equal"]})

    # ---- path: knobs (probe schedules, tree waves, filters, tune) ---------
    # the MNIST-784 index on rpf and rpf+int8 (expand 4) with the base
    # rows' metadata columns: fixed searches at P = 1, 2 and 4, a 100-query
    # subset at P = 2, schedules (cap 4) and waves (10 trees) at tol 0 and
    # 0.01, both filter regimes, expand 0, and tune() on 512 queries
    sub = torch.from_numpy(np.random.default_rng(5).permutation(
        cfgmod.QUERY_BATCH)[:100]).to(dev)
    tune_q = queries[:512]

    def drive_knobs():
        out = {}
        for name, sp in (("rpf", spec), ("rpf+int8", spec8)):
            idx = build_index(db_np, sp, device=dev, metadata=base_meta)
            e = {"expand": EXPAND} if name == "rpf+int8" else {}
            r = {f"P={p}": idx.search(queries, SearchParams(k=K, n_probes=p,
                                                            **e))
                 for p in (1, 2, 4)}
            r["P=1 k+1"] = idx.search(queries, SearchParams(k=K + 1, **e))
            r["P=2 subset"] = idx.search(queries[sub], SearchParams(
                k=K, n_probes=2, **e))
            for tol in (0.0, 0.01):
                r[f"schedule tol={tol}"] = idx.search(queries, SearchParams(
                    k=K, probe_schedule=4, tol=tol, **e))
                r[f"schedule tol={tol} probes"] = idx.last_mean_probes
                r[f"waves tol={tol}"] = idx.search(queries, SearchParams(
                    k=K, adaptive_wave=10, tol=tol, **e))
                r[f"waves tol={tol} trees"] = idx.last_trees_used
            for tag, pred in (("brute", p_brute), ("widened", p_wide)):
                r[tag] = idx.search(queries, SearchParams(k=K, filter=pred,
                                                          **e))
            if name == "rpf":
                r["expand=0"] = idx.search(queries, SearchParams(k=K,
                                                                 expand=0))
                t0 = time.perf_counter()
                r["tune"] = tune_report(idx, tune_q, target_recall=0.95)
                torch.cuda.synchronize()
                r["tune_s"] = time.perf_counter() - t0
                r["tune again"] = tune(idx, tune_q, target_recall=0.95)
            out[name] = (idx, r)
        return out

    knobs, launches, ref_calls = counted(torch, counters, drive_knobs)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk",
                                  "fused_gather_topk_int8", "fused_scan"),
            "knobs")
    launches_by_path["knobs"] = launches
    n_label = int((db_labels == 3).sum())
    sel_wide = n_label / n_base
    check(use_brute_force(0.01, 600) and not use_brute_force(sel_wide,
                                                              n_label),
          f"the knobs path's filters are not one of each regime: "
          f"{n_label} rows of label 3")
    wide_probes = widen_params(SearchParams(k=K), sel_wide).n_probes
    knob_checks = {}
    for name, (idx, r) in knobs.items():
        c = {}
        # 1. a schedule at tol 0 is bitwise the fixed search at its cap
        check(bitwise(r["schedule tol=0.0"], r["P=4"]),
              f"knobs {name}: the schedule at tol 0 differs from P = 4")
        check(r["schedule tol=0.0 probes"] == 1 + 2 + 4,
              f"knobs {name}: {r['schedule tol=0.0 probes']} probes at "
              f"tol 0")
        # 2. a query's answer does not depend on the rest of its batch
        check(bitwise(r["P=2 subset"], tuple(t[sub] for t in r["P=2"])),
              f"knobs {name}: a 100-query subset answers differently")
        # 3. waves at tol 0 use the whole forest and equal the fixed search
        # (rpf: each pair scores the same bits in either; rpf+int8 takes a
        # shortlist a wave, so its answer is printed, not held)
        check(r["waves tol=0.0 trees"] == cfgmod.CONFIG.n_trees,
              f"knobs {name}: waves at tol 0 used "
              f"{r['waves tol=0.0 trees']} trees")
        c["waves_tol0_bitwise_fixed"] = bitwise(r["waves tol=0.0"],
                                                r["P=1"])
        c["waves_tol0_ids_equal_rows"] = int(
            (r["waves tol=0.0"][1] == r["P=1"][1]).all(1).sum())
        if name == "rpf":
            c["waves_tol0_max_abs_err"] = compare_topk(
                torch, r["waves tol=0.0"], r["P=1 k+1"], K)
        # 4. the brute regime: bitwise a bruteforce build over its rows
        rows_b = np.flatnonzero(base_meta["bucket"] == 7)
        fresh_k = build_index(db_np[rows_b], IndexSpec(backend="bruteforce"),
                              device=dev)
        gb = torch.from_numpy(rows_b.astype(np.int32)).to(dev)
        fd, fi = fresh_k.search(queries, SearchParams(k=K))
        check(bitwise(r["brute"], (fd, torch.where(
            fi >= 0, gb[fi.clamp_min(0).long()], -1))),
            f"knobs {name}: the brute regime differs from a bruteforce "
            f"build over the 600 matching rows")
        del fresh_k
        # 5. the widened regime: matching rows only, no id twice a row
        wi = r["widened"][1]
        ok = wi >= 0
        lab = torch.from_numpy(db_labels).to(dev)
        check(bool((lab[wi.clamp_min(0).long()][ok] == 3).all()),
              f"knobs {name}: the widened regime returned a row of another "
              f"label")
        srt = wi.sort(dim=1)[0]
        check(not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
                        ).any()), f"knobs {name}: an id twice in a row")
        knob_checks[name] = c
    # 6. expand 0: rpf serves it bitwise as expand 4; rpf+int8 refuses
    check(bitwise(knobs["rpf"][1]["expand=0"], knobs["rpf"][1]["P=1"]),
          "expand=0 changed the rpf answer")
    try:
        knobs["rpf+int8"][0].search(queries, SearchParams(k=K, expand=0))
        raise RuntimeError("check failed: rpf+int8 served expand=0")
    except ValueError as err:
        expand0_error = str(err)
    # 7. tune picks the same params twice
    chosen, report = knobs["rpf"][1]["tune"]
    check(knobs["rpf"][1]["tune again"] == chosen,
          "tune chose other params on the same index and queries")
    emit({"phase": "knobs", "launches": launches, "ref_calls": ref_calls,
          "checks": knob_checks, "brute_rows": 600,
          "widened_rows": n_label, "widened_selectivity": sel_wide,
          "widened_n_probes": wide_probes,
          "schedule_tol0_bitwise_fixed_cap": True,
          "subset_rows_bitwise": True, "expand0_rpf_bitwise_expand4": True,
          "expand0_rpf_int8_error": expand0_error,
          "tune": {"params": chosen.to_dict(), "seconds":
                   knobs["rpf"][1]["tune_s"], "queries": tune_q.shape[0],
                   "same_twice": True, "report": [
                       {"n_trees": row["params"].n_trees,
                        "n_probes": row["params"].n_probes,
                        "recall": row["recall"], "cost": row["cost"]}
                       for row in report]}})

    # ---- timing, recall ----------------------------------------------------
    _, true_i = exact_knn(queries, db, K)
    cells = {}
    for name, idx, res in (("rpf", index, results),
                           ("rpf+int8", index8, results8)):
        cell = {}
        for p in PROBES:
            params = SearchParams(k=K, n_probes=p, expand=EXPAND)
            ms = time_ms(torch, lambda: idx.search(queries, params), 25)
            _, ids = res[p, cfgmod.QUERY_BATCH]
            cell[p] = {"ms_per_batch": ms,
                       "qps": cfgmod.QUERY_BATCH / ms * 1e3,
                       "recall_at_1": recall_at_k(ids[:, :1], true_i[:, :1]),
                       "recall_at_10": recall_at_k(ids, true_i)}
        check(cell[4]["recall_at_1"] >= cell[1]["recall_at_1"]
              and cell[4]["recall_at_10"] >= cell[1]["recall_at_10"],
              f"recall fell with more probes on {name}: {cell}")
        cells[name] = cell
    emit({"phase": "timing", "cell": "rpf_mnist784", "batch":
          cfgmod.QUERY_BATCH, "k": K, "card": smi, "n_probes": cells["rpf"]})
    emit({"phase": "timing", "cell": "rpf_mnist784 / rpf+int8",
          "batch": cfgmod.QUERY_BATCH, "k": K, "expand": EXPAND, "card": smi,
          "n_probes": cells["rpf+int8"]})

    e_ms = time_ms(torch, lambda: chi2_topk(iss_q, iss_db, K), 3, warm=1)
    _, exact_iss = brute["chi2"]
    iss_cell = {}
    for p in PROBES:
        params = SearchParams(k=K, n_probes=p, metric="chi2")
        ms = time_ms(torch, lambda: iss_index.search(iss_q, params), 10)
        iss_cell[p] = {"ms_per_batch": ms,
                       "qps": isscfg.QUERY_BATCH / ms * 1e3,
                       "recall_at_1": recall_at_k(iss_res[p][1][:, :1],
                                                  exact_iss[:, :1]),
                       "exact_scan_over_search": e_ms / ms}
    check(iss_cell[4]["recall_at_1"] >= iss_cell[1]["recall_at_1"],
          f"recall fell with more probes on iss595: {iss_cell}")
    emit({"phase": "timing", "cell": "rpf_iss595", "batch":
          isscfg.QUERY_BATCH, "k": K, "card": smi, "exact_scan_ms": e_ms,
          "n_probes": iss_cell})

    # the paper's comparison: lsh-cascade beside rpf at equal k, same run;
    # min_candidates 1 is the paper's cascade (stop at the first radius
    # with a match), 10 k a deeper probe of the same tables
    lsh_cell = {}
    for mc in (1, 10 * K):
        params = SearchParams(k=K, min_candidates=mc)
        ms = time_ms(torch, lambda: lsh_index.search(queries, params), 5,
                     warm=1)
        _, lsh_ids = lsh_index.search(queries, params)
        lsh_cell[mc] = {"ms_per_batch": ms,
                        "qps": cfgmod.QUERY_BATCH / ms * 1e3,
                        "recall_at_1": recall_at_k(lsh_ids[:, :1],
                                                   true_i[:, :1]),
                        "recall_at_10": recall_at_k(lsh_ids, true_i),
                        "mean_candidates": lsh_index.last_mean_candidates}
    emit({"phase": "timing", "cell": "rpf_mnist784 / lsh-cascade",
          "batch": cfgmod.QUERY_BATCH, "k": K, "card": smi,
          "index_build_s": lsh_build_s, "min_candidates": lsh_cell, "rpf": {
              p: dict(cells["rpf"][p], index_build_s=index_build_s)
              for p in PROBES}})

    # the mutate cell: the mutated rpf index (its view before the save
    # sealed the delta) and the compacted one between two timings of the
    # pristine index; recall against exact k-NN over the live points
    _, true_live = exact_knn(queries, rows_live_dev, K)
    true_live = gl[true_live.long()]
    mut_cell = {}
    for p in PROBES:
        params = SearchParams(k=K, n_probes=p)
        row = {}
        for tag, idx in (("pristine", index), ("mutated", rpf_view),
                         ("compacted", m_rpf), ("pristine_again", index)):
            row[f"{tag}_ms"] = time_ms(torch, lambda: idx.search(queries,
                                                                 params), 25)
        for tag, ids in (("mutated", rpf_res[PROBES.index(p)][1]),
                         ("compacted", compact_res[p][1])):
            row[f"{tag}_recall_at_1"] = recall_at_k(ids[:, :1],
                                                    true_live[:, :1])
            row[f"{tag}_recall_at_10"] = recall_at_k(ids, true_live)
        mut_cell[p] = row
    p8, pb = SearchParams(k=K, n_probes=4, expand=EXPAND), SearchParams(k=K)
    emit({"phase": "timing", "cell": "rpf_mnist784 / mutate",
          "batch": cfgmod.QUERY_BATCH, "k": K, "card": smi,
          "stats": want_stats, "index_build_s_pristine": index_build_s,
          "seal_build_s": seal_s_by, "compact_s": compact_s,
          "n_probes": mut_cell, "others": {
              "rpf+int8 P=4": {
                  "pristine_ms": time_ms(torch, lambda: index8.search(
                      queries, p8), 25),
                  "mutated_ms": time_ms(torch, lambda: int8_view.search(
                      queries, p8), 25)},
              "bruteforce": {
                  "pristine_ms": time_ms(torch, lambda: bidx.search(
                      queries, pb), 10, warm=1),
                  "mutated_ms": time_ms(torch, lambda: mut["bruteforce"][
                      2].search(queries, pb), 10, warm=1)}}})

    # the knobs cell: the metadata index's fixed, scheduled, wave and
    # filtered searches; recall against exact k-NN (the filtered searches
    # against exact k-NN over their matching rows)
    def true_over(rows):
        rows_t = torch.from_numpy(rows).to(dev)
        _, pos = exact_knn(queries, db[rows_t], K)
        return rows_t[pos.long()].int()

    true_f = {"brute": true_over(np.flatnonzero(base_meta["bucket"] == 7)),
              "widened": true_over(np.flatnonzero(db_labels == 3))}
    knob_cells = {}
    for name, (idx, _) in knobs.items():
        e = {"expand": EXPAND} if name == "rpf+int8" else {}
        cases = {f"fixed P={p}": (SearchParams(k=K, n_probes=p, **e),
                                  true_i) for p in (1, 2, 4)}
        cases["schedule cap 4 tol 0.01"] = (SearchParams(
            k=K, probe_schedule=4, tol=0.01, **e), true_i)
        cases["waves 10 tol 0.01"] = (SearchParams(
            k=K, adaptive_wave=10, tol=0.01, **e), true_i)
        cases["filter brute (bucket 7)"] = (SearchParams(
            k=K, filter=p_brute, **e), true_f["brute"])
        cases["filter widened (label 3)"] = (SearchParams(
            k=K, filter=p_wide, **e), true_f["widened"])
        cell = {}
        for tag, (params, truth) in cases.items():
            ms = time_ms(torch, lambda: idx.search(queries, params), 25)
            _, ids = idx.search(queries, params)
            cell[tag] = {"ms_per_batch": ms,
                         "qps": cfgmod.QUERY_BATCH / ms * 1e3,
                         "recall_at_1": recall_at_k(ids[:, :1], truth[:, :1]),
                         "recall_at_10": recall_at_k(ids, truth)}
            # the engine's counters (the brute regime runs no engine)
            if params.probe_schedule or params.filter is p_wide:
                cell[tag]["mean_probes"] = idx.last_mean_probes
            if params.adaptive_wave:
                cell[tag]["trees_used"] = idx.last_trees_used
        knob_cells[name] = cell
    # what the brute regime would cost as a masked scan of the whole
    # segment (kernel B's scan loads no dead row but still scores it)
    kidx = knobs["rpf"][0]
    seg0 = kidx.snapshot().segments[0]
    mask_b = seg0.filter_valid(p_brute, kidx.meta_store)[1]
    masked_ms = time_ms(torch, lambda: fused_scan(queries, seg0.rows, K,
                                                  "l2", mask_b), 25)
    emit({"phase": "timing", "cell": "rpf_mnist784 / knobs",
          "batch": cfgmod.QUERY_BATCH, "k": K, "card": smi,
          "widened_n_probes": wide_probes, "backends": knob_cells,
          "brute_regime_as_masked_60000_row_scan_ms": masked_ms})

    # ---- where the time goes: device time by kernel over 5 searches -------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def breakdown(idx, q, params):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                idx.search(q, params)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, n_events = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n_events += 1
                name = e.name.split("(")[0].split("<")[0][:60]
                by_name[name] = by_name.get(name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        return {"wall_ms_per_search": wall_ms / 5,
                "device_ms_per_search": busy / 5,
                "device_idle_share": 1 - busy / wall_ms,
                "device_events": n_events,
                "kernels_ms_per_search": {n: t / 5 for n, t in top}}

    for cell, idx, q, kw in (
            ("rpf_mnist784", index, queries, {}),
            ("rpf_mnist784 / rpf+int8", index8, queries, {"expand": EXPAND}),
            ("rpf_iss595", iss_index, iss_q, {"metric": "chi2"})):
        emit({"phase": "profile", "cell": cell, "batch": q.shape[0],
              "card": smi, "n_probes": {p: breakdown(
                  idx, q, SearchParams(k=K, n_probes=p, **kw))
                  for p in PROBES}})
    emit({"phase": "profile", "cell": "rpf_mnist784 / lsh-cascade",
          "batch": queries.shape[0], "card": smi,
          "search": breakdown(lsh_index, queries, SearchParams(k=K))})
    for cell, idx in (("rpf_mnist784 / mutate, mutated", rpf_view),
                      ("rpf_mnist784 / mutate, compacted", m_rpf)):
        emit({"phase": "profile", "cell": cell, "batch": queries.shape[0],
              "card": smi, "n_probes": {4: breakdown(
                  idx, queries, SearchParams(k=K, n_probes=4))}})
    emit({"phase": "profile", "cell": "rpf_mnist784 / knobs",
          "batch": queries.shape[0], "card": smi, "searches": {
              tag: breakdown(knobs["rpf"][0], queries, params)
              for tag, params in (
                  ("schedule cap 4 tol 0.01", SearchParams(
                      k=K, probe_schedule=4, tol=0.01)),
                  ("waves 10 tol 0.01", SearchParams(
                      k=K, adaptive_wave=10, tol=0.01)),
                  ("filter brute", SearchParams(k=K, filter=p_brute)),
                  ("filter widened", SearchParams(k=K, filter=p_wide)))}})

    # ---- path: serve (the batcher, the ladder, the planner, the fleet) -----
    # The main path's MNIST-784 rpf index behind ServingRuntime(max_batch=64,
    # slo_p99_ms=25) at the operating point SearchParams(k=10, n_probes=4).
    # Each served run counts from zero just before it and reads just after:
    # what launches then launches from a batcher's worker thread (or two,
    # the fleet's).  Every answer is checked bit for bit against its row of
    # a direct Index.search of the 1024 queries.
    serve_p = SearchParams(k=K, n_probes=4)
    slo_ms, serve_batch = 25.0, 64
    true_host = true_i.cpu().numpy()
    served_launches = collections.Counter()
    serve_runs = {}

    class Recorder:
        """A runtime or fleet whose submitted requests are kept, in order,
        so that each answer can be checked against its query's row."""

        def __init__(self, target):
            self.target, self.reqs = target, []

        def submit(self, q):
            req = self.target.submit(q)
            self.reqs.append(req)
            return req

        def stats(self):
            return self.target.stats()

    def host(out):
        return tuple(t.cpu().numpy() for t in out)

    def bit_rows(results, want, rows):
        """(n,) whether each answer equals ``want``'s row bit for bit."""
        d = np.stack([r[0] for r in results]).view(np.int32)
        i = np.stack([r[1] for r in results])
        return ((i == want[1][rows]).all(1)
                & (d == want[0][rows].view(np.int32)).all(1))

    def served(fn, names=("forest_traverse", "fused_gather_topk")):
        out, launches, ref_calls = counted(torch, counters, fn)
        require(launches, ref_calls, names, "serve")
        served_launches.update(launches)
        return out, launches

    def open_loop(name, target, qps, n, want, names=("forest_traverse",
                                                      "fused_gather_topk"),
                  seed=1, phase="serve"):
        """``n`` open-loop requests at ``qps`` (query j % 1024), none lost;
        returns the report, the answers and the rows each answer equals
        bit for bit in ``want`` (a list of direct searches); its line goes
        under ``phase``."""
        rec = Recorder(target)
        rep, launches = served(lambda: loadgen.run_open_loop(
            rec, q_np, qps, n_requests=n, seed=seed, true_ids=true_host),
            names)
        check(rep["n_ok"] == n and rep["n_failed"] == 0
              and rep["n_timeout"] == 0, f"serve {name}: requests lost {rep}")
        results = [r.result for r in rec.reqs]
        rows = np.arange(n) % cfgmod.QUERY_BATCH
        match = np.stack([bit_rows(results, w, rows) for w in want])
        st = target.stats()
        serve_runs[name] = {
            "offered_qps": rep["offered_qps"],
            "achieved_qps": rep["achieved_qps"], "requests": n,
            **{key: rep[key] for key in ("p50_ms", "p99_ms", "p999_ms",
                                         "max_ms", "dispatch_lag_ms")},
            "shed_fraction": rep.get("shed_fraction"),
            "rung_final": rep.get("rung_final"),
            "recall_at_10": rep["recall_vs_oracle"],
            "shed_steps": st.get("shed_steps"),
            "recover_steps": st.get("recover_steps"),
            "batches_by_rung": st.get("batches_by_rung"),
            "depth_peak": st.get("batcher", {}).get("depth_peak"),
            "bitwise_rows_by_rung": match.sum(1).tolist(),
            "launches": launches}
        emit({"phase": phase, "run": name, "card": smi,
              **serve_runs[name]})
        return rep, results, match, st

    # 1. the operating point, its ladder, the traffic model and the plan
    index.tuned_params = serve_p
    def stand_up():
        t0 = time.perf_counter()
        runtime = ServingRuntime(index, max_batch=serve_batch,
                                 slo_p99_ms=slo_ms)
        return runtime, time.perf_counter() - t0

    (rt, standup_s), standup_launches, ref_calls = counted(
        torch, counters, stand_up)
    require(standup_launches, ref_calls, ("forest_traverse",
                                          "fused_gather_topk"),
            "serve stand-up")
    check(rt.params == serve_p and rt.ladder == build_ladder(
        serve_p, cfgmod.CONFIG.n_trees), f"serve: ladder {rt.ladder}")
    model = rt.calibrate(q_np[:32])
    rated = planner.rated_qps(model, slo_ms, serve_batch)
    check(rated > 0, f"serve: no in-SLO rate at batch 64: {model}")
    plan = planner.plan(model, qps=rated, slo_p99_ms=slo_ms,
                        recall_target=cells["rpf"][4]["recall_at_10"])
    direct = [host(index.search(queries, p)) for p in rt.ladder]
    emit({"phase": "serve", "run": "plan", "card": smi,
          "ladder": [{"n_probes": p.n_probes, "n_trees": p.n_trees}
                     for p in rt.ladder],
          "standup_s": standup_s, "standup_launches": standup_launches,
          "warmup_s_by_rung": rt.stats()["service_s_by_rung"],
          "shed_depth": rt.shed_depth, "traffic_model": model.to_dict(),
          "rated_qps_at_batch_64": rated, "plan": plan.to_dict()})

    # 2. degrade=False at 0.5x the rated QPS: the direct search, bit for bit
    rt0 = ServingRuntime(index, max_batch=serve_batch, slo_p99_ms=slo_ms,
                         degrade=False)
    _, _, match, _ = open_loop("rung 0, 0.5x rated", rt0, 0.5 * rated, 1000,
                               direct[:1])
    check(bool(match[0].all()), f"serve: {int((~match[0]).sum())} of 1000 "
          f"answers differ from the direct search")

    # 3. degrade=True at 2x the rated QPS: nothing lost, every answer one
    # rung's bit for bit; 1,000 requests (~30 ms of arrivals) end before the
    # queue reaches the shed depth, so the shed gate runs 5,000 (and a
    # degrade=False control at the same rate beside each)
    for n in (1000, 5000):
        rt_d = rt if n == 1000 else ServingRuntime(
            index, max_batch=serve_batch, slo_p99_ms=slo_ms)
        _, _, match, st = open_loop(f"ladder, 2x rated, {n}", rt_d,
                                    2 * rated, n, direct)
        check(bool(match.any(0).all()), f"serve: an overload answer is no "
              f"rung's ({n} requests)")
        check(sum(st["batches_by_rung"]) == st["batcher"]["batches"]
              and st["requests_total"] == n, f"serve: counters {st}")
        if n == 5000:
            check(st["shed_steps"] > 0, f"serve: 2x rated never shed: {st}")
        rt_d.stop()
        rt_c = ServingRuntime(index, max_batch=serve_batch,
                              slo_p99_ms=slo_ms, degrade=False)
        open_loop(f"rung 0 control, 2x rated, {n}", rt_c, 2 * rated, n,
                  direct[:1])
        rt_c.stop()

    # the device's idle share while serving batches of 64 at rung 0: the
    # worker's search alone, and closed loops of 64 requests served;
    # ``top_ops`` adds the device ms a call of the aten ops that take most
    def idle_share(fn, n=20, top_ops=0):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                if e.device_type == DeviceType.CUDA]
        out = {"wall_ms_per_batch": wall_ms / n,
               "device_ms_per_batch": sum(busy) / n,
               "device_idle_share": 1 - sum(busy) / wall_ms,
               "device_events_per_batch": len(busy) / n}
        if top_ops:
            ops = sorted(((a.key, a.self_device_time_total / 1e3 / n)
                          for a in prof.key_averages()
                          if a.key.startswith("aten::")),
                         key=lambda kv: -kv[1])[:top_ops]
            out["top_aten_ops_device_ms_per_batch"] = dict(ops)
        return out

    def serve_64():
        reqs = [rt0.submit(q) for q in q_np[:serve_batch]]
        check(all(r.event.wait(60) and r.error is None for r in reqs),
              "serve: a closed-loop request failed")

    q64 = q_np[:serve_batch]
    emit({"phase": "profile", "cell": "rpf_mnist784 / serve", "batch":
          serve_batch, "card": smi, "rung": 0,
          "search_alone": idle_share(lambda: rt0._search(q64, 0)),
          "served": idle_share(serve_64)})
    rt0.stop()

    with tempfile.TemporaryDirectory() as serve_tmp:
        # 5. the manifest: plan and traffic model saved, a runtime loaded
        # from it (the shed depth set past any queue, so that every answer
        # is rung 0's)
        index.serving_plan = {"plan": plan.to_dict(),
                              "traffic_model": model.to_dict()}
        man = os.path.join(serve_tmp, "idx")
        index.save(man)
        rt5 = ServingRuntime.load(man, shed_depth=1 << 30)
        check(rt5.max_batch == plan.batch and rt5.slo_p99_ms == slo_ms
              and rt5.ladder == rt.ladder and rt5.params == serve_p,
              f"serve: the loaded runtime is not the plan's: batch "
              f"{rt5.max_batch}, slo {rt5.slo_p99_ms}")
        _, _, match, _ = open_loop("loaded manifest, 0.5x rated", rt5,
                                   0.5 * rated, 1000, direct[:1])
        check(bool(match[0].all()), "serve: the loaded runtime answers "
              "otherwise")

        # 4. serving while mutating the loaded index: 8 queries added (their
        # ids come first, at distance 0), the first deleted (never served
        # again), then 1,000 requests bitwise a direct search of the view
        live = rt5.index
        n_base = live.n_rows
        new_ids = [live.add(x) for x in q_np[:8]]
        check(new_ids == list(range(n_base, n_base + 8)), f"ids {new_ids}")

        def first_answers():
            return [rt5(x, timeout=60.0) for x in q_np[:8]]

        after_add, _ = served(first_answers, ("forest_traverse",
                                              "fused_gather_topk",
                                              "fused_scan"))
        for gid, (d, i) in zip(new_ids, after_add):
            check(int(i[0]) == gid and float(d[0]) == 0.0,
                  f"serve: an added query came back as {i[:2]}, {d[:2]}")
        live.delete(new_ids[0])
        after_del, _ = served(first_answers, ("forest_traverse",
                                              "fused_gather_topk",
                                              "fused_scan"))
        view = host(live.search(queries, serve_p))
        _, results, match, _ = open_loop(
            "mutated, 0.5x rated", rt5, 0.5 * rated, 1000, [view],
            ("forest_traverse", "fused_gather_topk", "fused_scan"))
        check(bool(match[0].all()), "serve: answers on the mutated index "
              "differ from a direct search of its view")
        check(all(new_ids[0] not in i for _, i in after_del + results),
              "serve: a deleted id was served")
        check(all(int(i[0]) == g for g, (_, i) in zip(new_ids[1:],
                                                       after_del[1:])),
              "serve: an added id lost its place after the delete")
        rt5.stop()
        mutate_stats = live.stats()
        emit({"phase": "serve", "run": "mutate", "card": smi, "added": 8,
              "deleted": 1, "n_delta": mutate_stats["n_delta"],
              "n_tombstones": mutate_stats["n_tombstones"],
              "added_first_at_distance_0": True, "deleted_never_served":
              True, "bitwise_view": True})
        del live, rt5

        # 6. a fleet of 2 replicas (their stop drains), then the launcher
        fleet_cfg = {"serving": {"slo_p99_ms": slo_ms, "max_batch":
                                 serve_batch, "degrade": False},
                     "autoscale": {"enabled": True, "qps": rated,
                                   "min_replicas": 2, "max_replicas": 2}}
        handle = build_fleet(fleet_cfg, index=index, model=model)
        check(handle.fleet.n_replicas == 2, "serve: the fleet is not 2")
        _, _, match, _ = open_loop("fleet of 2, 1x rated", handle.fleet,
                                   rated, 1000, direct[:1])
        check(bool(match[0].all()), "serve: the fleet answers otherwise")
        burst = Recorder(handle.fleet)
        replicas = handle.fleet.replicas
        for x in q_np[:512]:
            burst.submit(x)
        handle.stop()                 # drains every queued request
        check(all(r.event.is_set() and r.error is None for r in burst.reqs),
              "serve: the fleet's stop dropped a request")
        check(bool(bit_rows([r.result for r in burst.reqs], direct[0],
                            np.arange(len(burst.reqs))).all()),
              "serve: a drained answer differs")
        emit({"phase": "serve", "run": "fleet stop", "card": smi,
              "drained": 512, "requests_by_replica": [
                  r.stats()["requests_total"] for r in replicas],
              "autoscaler": handle.autoscaler.stats()})

        fleet_yml = os.path.join(serve_tmp, "fleet.yml")
        with open(fleet_yml, "w") as f:
            f.write(f"index: {man}\nserving:\n  slo_p99_ms: {slo_ms}\n"
                    f"  max_batch: {serve_batch}\nautoscale:\n"
                    f"  enabled: true\n  qps: {rated}\n  max_replicas: 2\n")
        launched = {}
        for tag, argv in (("defaults", []), ("load", ["--load", man]),
                          ("config", ["--config", fleet_yml])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                (rep, launches) = served(lambda: launcher.main(argv))
            check(rep["n_ok"] == rep["n_requests"] == 1000
                  and 0.0 < rep["recall_vs_oracle"] <= 1.0,
                  f"serve: the launcher's {tag} run: {rep}")
            launched[tag] = {"report": rep, "launches": launches,
                             "printed": out.getvalue().splitlines()[-4:]}
        emit({"phase": "serve", "run": "launcher", "card": smi, **launched})

    # 7. rpf+int8 at expand 4, P = 4: kernels A, C and B from the worker
    p8_serve = SearchParams(k=K, n_probes=4, expand=EXPAND)
    rt7 = ServingRuntime(index8, params=p8_serve, max_batch=serve_batch,
                         slo_p99_ms=slo_ms, degrade=False)
    _, _, match, _ = open_loop(
        "rpf+int8, 0.5x rated", rt7, 0.5 * rated, 500,
        [host(index8.search(queries, p8_serve))],
        ("forest_traverse", "fused_gather_topk_int8", "fused_gather_topk"))
    check(bool(match[0].all()), "serve: rpf+int8 answers otherwise")
    rt7.stop()
    index.tuned_params = None
    index.serving_plan = None
    launches_by_path["serve"] = dict(served_launches)
    emit({"phase": "serve", "run": "launches", "card": smi,
          "launches": dict(served_launches), "ref_calls": 0})

    # ---- path: sharded (the index over a mesh of cells on one card) --------
    # ShardedIndex over the main path's MNIST-784 index on a (4, 2) mesh: 4
    # DB shards of 15,000 rows, each with its 80 trees split over 2 tree
    # shards, so 8 cells of 40 trees, run one after another on this card;
    # every search launches one A and one B a cell, then merges the cells'
    # (B, k) lists.  Its gates: the compare rule against the same mesh in
    # mode="ref"; each cell bitwise a second build; a (1, 1) mesh drawing
    # as the index's own build bitwise the local search; a one-rank NCCL
    # group bitwise the group-less mesh; deletes, filters, schedules,
    # admission, tune_sharded, a mesh ServingRuntime and a mesh fleet
    sh_mesh = Mesh((4, 2), device=dev)
    sh_cells = 8

    def drive_sharded():
        t0 = time.perf_counter()
        sx = ShardedIndex(index, sh_mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        return sx, build_s, {p: sx.search(queries, SearchParams(
            k=K, n_probes=p)) for p in PROBES}

    (sx, sx_build_s, sx_res), launches, ref_calls = counted(
        torch, counters, drive_sharded)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk"),
            "sharded")
    check(launches.get("forest_traverse") == launches.get("fused_gather_topk")
          == sh_cells * len(PROBES),
          f"sharded: not one A and one B a cell a search: {launches}")
    sh_launches = collections.Counter(launches)
    local_res = {p: index.search(queries, SearchParams(k=K, n_probes=p))
                 for p in PROBES}
    emit({"phase": "sharded", "mesh": sh_mesh.shape, "cells": sh_cells,
          "rows_per_shard": sx._forest.n_local,
          "trees_per_cell": sx._forest.trees_per_cell,
          "mesh_build_s": sx_build_s, "searches": len(sx_res),
          "launches": launches, "ref_calls": ref_calls})
    sh_err = 0.0
    for p, got in sx_res.items():
        want = sx.search(queries, SearchParams(k=K + 1, n_probes=p,
                                               mode="ref"))
        sh_err = max(sh_err, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["l2"], queries, db, got)
    emit({"phase": "compare", "path": "sharded", "cases": len(sx_res),
          "max_abs_err": sh_err})

    # 1. each cell bitwise a second build under the same seed
    again = build_sharded_index(index.seed, sx._db, index.spec.forest,
                                sh_mesh)
    check(all(c1 == c2 and all(torch.equal(a, b) for a, b in zip(f1, f2))
              for (c1, f1), (c2, f2) in zip(sx._forest.cells, again.cells)),
          "sharded: a second build under the same seed differs")
    del again
    # 2. a (1, 1) mesh drawing as the index's own build: its one cell is the
    # index's forest and its distances the local search's, bit for bit
    own = CellDraws(lambda di, ti, n: generator_draws(
        torch.Generator(device=dev).manual_seed(index.seed),
        spec.forest.resolved(n), db.shape[1], dev))
    sx1 = ShardedIndex(index, Mesh((1, 1), device=dev), draws=own)
    check(all(torch.equal(a, b) for a, b in zip(sx1._forest.cells[0][1],
                                                forest)),
          "sharded (1, 1): its cell is not the index's forest")
    one_cell = {}
    for p in PROBES:
        (sd, si) = sx1.search(queries, SearchParams(k=K, n_probes=p))
        ld, li = local_res[p]
        check(torch.equal(sd.view(torch.int32), ld.view(torch.int32)),
              f"sharded (1, 1): distances differ from the local search, "
              f"P = {p}")
        untied = torch.ones_like(sd, dtype=torch.bool)
        untied[:, 1:] &= sd[:, 1:] != sd[:, :-1]
        untied[:, :-1] &= sd[:, :-1] != sd[:, 1:]
        check(torch.equal(si[untied], li[untied]),
              f"sharded (1, 1): ids differ at an untied rank, P = {p}")
        one_cell[p] = {"rows_ids_equal": int((si == li).all(1).sum())}
    del sx1
    # 3. a one-rank NCCL group: the merge's all-gather through NCCL, bit for
    # bit the group-less mesh (a failed init fails the run)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        nccl_mesh = Mesh((4, 2), device=dev, group=dist.group.WORLD)
        sxn = ShardedIndex(index, nccl_mesh)
        nccl_res, launches, ref_calls = counted(torch, counters, lambda: {
            p: sxn.search(queries, SearchParams(k=K, n_probes=p))
            for p in PROBES})
        require(launches, ref_calls, ("forest_traverse",
                                      "fused_gather_topk"), "sharded")
        sh_launches.update(launches)
        for p in PROBES:
            check(bitwise(nccl_res[p], sx_res[p]),
                  f"sharded: the NCCL group answers otherwise, P = {p}")
        nccl_backend = dist.get_backend(dist.group.WORLD)
        del sxn
    finally:
        dist.destroy_process_group()
    # 4. schedule at tol 0 bitwise the fixed cap; 5. admission
    sched, launches, ref_calls = counted(torch, counters, lambda: sx.search(
        queries, SearchParams(k=K, probe_schedule=4, tol=0.0)))
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk"),
            "sharded")
    sh_launches.update(launches)
    check(bitwise(sched, sx_res[4]),
          "sharded: the schedule at tol 0 differs from P = 4")
    wavy = SearchParams(k=K, adaptive_wave=10)
    try:
        sx.search(queries, wavy)
        raise RuntimeError("check failed: strict ShardedIndex served "
                           "adaptive_wave")
    except CapabilityError as err:
        check([v.knob for v in err.violations] == ["adaptive_wave"],
              f"sharded: refused {err}")
    sx.strict = False
    stripped = sx.search(queries, wavy)
    sx.strict = True
    check(bitwise(stripped, sx_res[1]) and
          sx.stats()["counters"]["stripped_knobs"] == 1,
          "sharded: the stripped search is not the P = 1 search")
    # 6. filters on the knobs path's metadata index, then deletes
    kidx = knobs["rpf"][0]

    def drive_filtered():
        sxk = ShardedIndex(kidx, sh_mesh)
        return sxk, {tag: sxk.search(queries, SearchParams(k=K, filter=pred))
                     for tag, pred in (("brute", p_brute),
                                       ("widened", p_wide))}

    (sxk, fres), launches, ref_calls = counted(torch, counters,
                                               drive_filtered)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk",
                                  "fused_scan"), "sharded")
    sh_launches.update(launches)
    check(bitwise(fres["brute"], kidx.search(queries, SearchParams(
        k=K, filter=p_brute))), "sharded: the brute regime differs from the "
        "local filtered search")
    wi = fres["widened"][1]
    lab = torch.from_numpy(db_labels).to(dev)
    check(bool((lab[wi.clamp_min(0).long()][wi >= 0] == 3).all()),
          "sharded: the widened regime returned a row of another label")
    srt = wi.sort(dim=1)[0]
    check(not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()),
          "sharded: an id twice in a row")
    filter_counters = sxk.stats()["counters"]
    del sxk
    dead = torch.arange(0, cfgmod.N_DB, 30, device=dev)
    kidx.delete(dead.tolist())

    def drive_deleted():
        sxd = ShardedIndex(kidx, sh_mesh)
        return sxd, {p: sxd.search(queries, SearchParams(k=K, n_probes=p))
                     for p in PROBES}

    (sxd, del_res), launches, ref_calls = counted(torch, counters,
                                                  drive_deleted)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk"),
            "sharded")
    sh_launches.update(launches)
    for p, (_, ids) in del_res.items():
        check(not bool(torch.isin(ids, dead.int()).any()),
              f"sharded: a deleted id surfaced, P = {p}")
    deleted_stats = sxd.stats()
    del sxd
    # 7. tune_sharded twice on 512 queries, 2 shards, checked on a (2, 1)
    # mesh
    t0 = time.perf_counter()
    (tuned, launches, ref_calls) = counted(torch, counters, lambda: [
        tune_sharded(index, tune_q, n_shards=2, mesh=Mesh((2, 1), device=dev),
                     persist=False) for _ in range(2)])
    tune_sharded_s = (time.perf_counter() - t0) / 2
    check(sum(ref_calls.values()) == 0, f"plain versions ran in "
          f"tune_sharded: {ref_calls}")
    sh_launches.update(launches)
    (t_params, t_report), (t_params2, _) = tuned
    check(t_params == t_params2, "tune_sharded chose other params on the "
          "same index and queries")
    check("mesh_recall" in t_report[-1], f"tune_sharded: {t_report[-1]}")
    emit({"phase": "sharded", "checks": {
        "cells_bitwise_second_build": True, "one_cell_mesh_bitwise_local":
        one_cell, "nccl_backend": nccl_backend, "nccl_bitwise": True,
        "schedule_tol0_bitwise_fixed_cap": True,
        "adaptive_wave_strict_refused": True, "stripped": True,
        "brute_bitwise_local": True, "filter_counters": filter_counters,
        "deleted": len(dead), "deleted_never_surfaced": True,
        "deleted_stats": deleted_stats},
        "tune_sharded": {"params": [p.to_dict() for p in t_params],
                         "seconds": tune_sharded_s, "rows": [
                             {k_: (v.to_dict() if isinstance(
                                 v, SearchParams) else v)
                              for k_, v in row.items()}
                             for row in t_report]}})

    # 8. a mesh ServingRuntime at P = 4 at 0.5x its own rated QPS, and a
    # fleet with a mesh section: every answer its query's row of a direct
    # ShardedIndex.search, bit for bit
    sh_serve_p = SearchParams(k=K, n_probes=4)
    rt_s = ServingRuntime(index, params=sh_serve_p, mesh=sh_mesh,
                          max_batch=serve_batch, slo_p99_ms=slo_ms,
                          degrade=False)
    model_s = rt_s.calibrate(q_np[:32])
    rated_s = planner.rated_qps(model_s, slo_ms, serve_batch)
    check(rated_s > 0, f"sharded serve: no in-SLO rate: {model_s}")
    want_s = host(rt_s._sharded.search(queries, sh_serve_p))
    rep_s, _, match, _ = open_loop("sharded, 0.5x rated", rt_s,
                                   0.5 * rated_s, 1000, [want_s],
                                   phase="sharded")
    check(bool(match[0].all()), f"sharded serve: {int((~match[0]).sum())} "
          f"of 1000 answers differ from the direct search")
    sh_launches.update(serve_runs["sharded, 0.5x rated"]["launches"])
    sh_serve_idle = idle_share(lambda: rt_s._search(q64, 0))
    rt_s.stop()
    handle = build_fleet({"serving": {"slo_p99_ms": slo_ms,
                                      "max_batch": serve_batch,
                                      "degrade": False},
                          "mesh": {"shape": [4, 2],
                                   "axes": ["data", "model"]}},
                         index=index, model=model_s)
    replica = handle.fleet.replicas[0]
    check(replica.stats()["sharded"], "sharded fleet: a local replica")
    want_f = host(replica._sharded.search(queries, replica.ladder[0]))
    _, _, match, _ = open_loop("sharded fleet, 0.5x rated", handle.fleet,
                               0.5 * rated_s, 200, [want_f], phase="sharded")
    check(bool(match[0].all()), "sharded fleet: answers differ")
    sh_launches.update(serve_runs["sharded fleet, 0.5x rated"]["launches"])
    handle.stop()
    del handle, replica
    emit({"phase": "sharded", "run": "plan", "card": smi,
          "traffic_model": model_s.to_dict(),
          "rated_qps_at_batch_64": rated_s,
          "warmup_s_by_rung": rt_s.stats()["service_s_by_rung"]})

    # timing: the sharded search beside the local index in one call (local,
    # sharded, sharded, local), recall against exact k-NN
    sh_cell = {}
    for p in PROBES:
        params = SearchParams(k=K, n_probes=p)
        t_local, t_mesh = [], []
        for times, idx in ((t_local, index), (t_mesh, sx), (t_mesh, sx),
                           (t_local, index)):
            times.append(time_ms(torch, lambda: idx.search(queries, params),
                                 25))
        _, ids = sx_res[p]
        sh_cell[p] = {"ms_per_batch": t_mesh, "local_ms_per_batch": t_local,
                      "qps": cfgmod.QUERY_BATCH / min(t_mesh) * 1e3,
                      "recall_at_1": recall_at_k(ids[:, :1], true_i[:, :1]),
                      "recall_at_10": recall_at_k(ids, true_i),
                      "local_recall_at_1": cells["rpf"][p]["recall_at_1"],
                      "local_recall_at_10": cells["rpf"][p]["recall_at_10"],
                      "launches_per_search": {"forest_traverse": sh_cells,
                                              "fused_gather_topk": sh_cells},
                      "candidate_slots": sh_cells * sx._forest.trees_per_cell
                      * p * sx._forest.cfg.leaf_pad}
    sched_p = SearchParams(k=K, probe_schedule=4, tol=0.01)
    before = dict(sx.stats()["counters"])
    _, sched_ids = sx.search(queries, sched_p)
    after = sx.stats()["counters"]
    emit({"phase": "timing", "cell": "rpf_mnist784 / sharded",
          "batch": cfgmod.QUERY_BATCH, "k": K, "card": smi,
          "mesh": sh_mesh.shape, "mesh_build_s": sx_build_s,
          "index_build_s": index_build_s, "n_probes": sh_cell,
          "schedule cap 4 tol 0.01": {
              "ms_per_batch": time_ms(torch, lambda: sx.search(
                  queries, sched_p), 10),
              "mean_probes": (after["probes_processed"]
                              - before["probes_processed"])
              / cfgmod.QUERY_BATCH,
              "recall_at_10": recall_at_k(sched_ids, true_i)},
          "served": {key: rep_s[key] for key in (
              "offered_qps", "achieved_qps", "p50_ms", "p99_ms",
              "p999_ms")}})
    emit({"phase": "profile", "cell": "rpf_mnist784 / sharded",
          "batch": cfgmod.QUERY_BATCH, "card": smi, "n_probes": {
              p: breakdown(sx, queries, SearchParams(k=K, n_probes=p))
              for p in PROBES},
          "served_batch_64_search_alone": sh_serve_idle})
    emit({"phase": "digests", "path": "sharded", "sha256_16": {
        **{f"sharded P={p} 1024": digest(sx_res[p]) for p in PROBES},
        **{f"local P={p} 1024": digest(local_res[p]) for p in PROBES},
        **{f"deleted P={p} 1024": digest(del_res[p]) for p in PROBES}}})
    launches_by_path["sharded"] = dict(sh_launches)
    del sx

    # ---- path: recsys (the recommenders through launch/steps.build_cell) ---
    # MIND at full width (1,000,192 x 64 catalog, hist 50, 4 interests, 3
    # routing iterations): serve_p99 / serve_bulk (mind_train_logits),
    # retrieval_cand brute-force (4 interests x the catalog, max, top-100)
    # and through the paper's index (rpf=1: kernels A and B on Mesh((1,
    # 1))), recsys.embedding_bag on its table (kernel H); DLRM-MLPerf
    # (tables capped at 4,000,000 rows), AutoInt and Wide&Deep: serve_p99,
    # serve_bulk and retrieval_cand at 131,072 candidates.  Gates: every
    # output against the same port function in float64 on the CPU (the
    # table rows a 64-user slab touches), the brute retrievals' ids at
    # every untied rank, rpf=1 against kernel_mode="ref" by the compare
    # rule, H by its rule, a second build's forest bit for bit
    # every model cell the recsys, train, lm, moe and gnn paths time:
    # (arch, cell, variant, ms), for phase ``roofline``
    timed = []

    def recsys_path():
        from repro_torch.configs import get_arch
        from repro_torch.kernels.common import topk_smallest
        from repro_torch.launch import steps
        from repro_torch.models import recsys as rs
        from repro_torch.tree import tree_map
        check(not torch.backends.cuda.matmul.allow_tf32
              and torch.get_float32_matmul_precision() == "highest",
              "recsys: fp32 products are not IEEE fp32")
        tol64 = (1e-4, 1e-5)            # rtol, atol against float64
        rec_launches = collections.Counter()
        errs = {}

        def drive(fn, names, tag):
            out, launches, ref_calls = counted(torch, counters, fn)
            require(launches, ref_calls, names, f"recsys {tag}")
            rec_launches.update(launches)
            return out, launches

        def close64(got, want, tag):
            """float32 ``got`` against float64 ``want``, elementwise."""
            got = got.detach().double().cpu()
            err = (got - want).abs()
            check(bool((err <= tol64[0] * want.abs() + tol64[1]).all()),
                  f"recsys {tag}: {float(err.max())} from float64")
            return float(err.max())

        def model64(cfg, model, batch, n):
            """The model in float64 on the CPU with only the table rows the
            first ``n`` users of ``batch`` touch, and that slab re-indexed."""
            tree = rs.param_tree(model)
            b = {k: v[:n] for k, v in batch.items()}
            out = {}

            def sub(table, cols):
                idx = [rs.gather_index(c, table.shape[0]) for c in cols]
                uniq = torch.unique(torch.cat([i.flatten() for i in idx]))
                return (table.detach()[uniq].double().cpu(),
                        [torch.searchsorted(uniq, i).cpu() for i in idx])

            for name, value in tree.items():
                if name in ("tables", "wide_tables"):
                    out[name], cols = [], []
                    for i, t in enumerate(value):
                        t64, (c,) = sub(t, [b["sparse"][:, i]])
                        out[name].append(t64)
                        cols.append(c)
                    sparse = torch.stack(cols, dim=1)
                elif name == "item_embed":
                    out[name], (hist, tgt) = sub(value, [b["hist"],
                                                         b["target"]])
                else:
                    out[name] = tree_map(
                        lambda t: t.detach().double().cpu(), value)
            b64 = ({"hist": hist, "target": tgt} if cfg.model == "mind"
                   else {"sparse": sparse})
            if "dense" in b:
                b64["dense"] = b["dense"].double().cpu()
            return rs.MODELS[cfg.model](cfg, out), b64

        def serve_cell(arch, cell, variant, seed):
            prog = steps.build_cell(arch, cell, variant=variant, device=dev)
            cfg = steps._recsys_variant(get_arch(arch).config, variant)[0]
            t0 = time.perf_counter()
            params, batch = prog.make_args(
                torch.Generator(device=dev).manual_seed(seed))
            torch.cuda.synchronize()
            args_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()   # the script's tensors too
            out, launches = drive(lambda: prog.fn(params, batch), (),
                                  f"{arch} {cell}")
            peak = torch.cuda.max_memory_allocated()
            b = batch[next(iter(batch))].shape[0]
            check(out.shape == (b,) and bool(out.isfinite().all()),
                  f"recsys {arch} {cell}: output {tuple(out.shape)}")
            m64, b64 = model64(cfg, params, batch, 64)
            with torch.no_grad():
                want = steps._recsys_fwd(cfg)(m64, b64)
            errs[f"{arch} {cell}"] = close64(out[:64], want,
                                             f"{arch} {cell}")
            ms = time_ms(torch, lambda: prog.fn(params, batch),
                         25 if b <= 512 else 5)
            timed.append((arch, cell, variant, ms))
            row = {"arch": arch, "cell": cell, "variant": variant,
                   "batch": b, "ms": ms, "users_per_s": b / ms * 1e3,
                   "peak_device_gb": peak / 1e9, "args_s": args_s,
                   "max_abs_err_vs_f64": errs[f"{arch} {cell}"],
                   "launches": launches, "meta": prog.meta}
            if arch == "mind" and cell == "serve_p99":
                row["profile"] = idle_share(lambda: prog.fn(params, batch))
            emit({"phase": "recsys", "card": smi, **row})

        def ctr_retrieval(arch, variant, seed):
            prog = steps.build_cell(arch, "retrieval_cand", variant=variant,
                                    device=dev)
            cfg = steps._recsys_variant(get_arch(arch).config, variant)[0]
            params, user, cand = prog.make_args(
                torch.Generator(device=dev).manual_seed(seed))
            (top, ids), launches = drive(lambda: prog.fn(params, user, cand),
                                         (), f"{arch} retrieval")
            # float64 over the distinct rows the candidates read
            last = cfg.n_sparse - 1
            col = rs.gather_index(cand, params.tables[last].shape[0])
            uniq, inv = torch.unique(col, return_inverse=True)
            ub = {"sparse": user["sparse"].expand(len(uniq), -1).clone()}
            ub["sparse"][:, last] = uniq.int()
            if "dense" in user:
                ub["dense"] = user["dense"].expand(len(uniq), -1)
            m64, b64 = model64(cfg, params, ub, len(uniq))
            with torch.no_grad():
                s64 = steps._recsys_fwd(cfg)(m64, b64)[inv.cpu()]
            wd, wi = topk_smallest(-s64[None], steps.K_RETRIEVE + 1)
            got = (-top[None].double().cpu(), ids[None].cpu())
            errs[f"{arch} retrieval"] = compare_topk(
                torch, got, (wd, cand.cpu()[wi]), steps.K_RETRIEVE,
                tol=tol64[0] * wd.abs() + tol64[1])
            ms = time_ms(torch, lambda: prog.fn(params, user, cand), 10)
            timed.append((arch, "retrieval_cand", variant, ms))
            emit({"phase": "recsys", "card": smi,
                "arch": arch, "cell": "retrieval_cand", "variant": variant,
                "candidates": cand.shape[0], "distinct_rows": len(uniq),
                "ms": ms,
                "max_abs_err_vs_f64": errs[f"{arch} retrieval"],
                "untied_ranks": untied(wd[0, :steps.K_RETRIEVE + 1]),
                "launches": launches, "meta": prog.meta})

        def untied(d):
            """Ranks of ``d`` (k + 1 ascending) apart from both neighbours
            by more than the float64 tolerance."""
            tol = tol64[0] * d.abs() + tol64[1]
            gap = d[1:] - d[:-1]
            sep = torch.ones(d.shape[0] - 1, dtype=torch.bool)
            sep[1:] &= gap[:-1] > tol[1:-1]
            sep &= gap > tol[:-1]
            return int(sep.sum())

        # MIND: serve cells, then the two retrievals of one user
        for cell in ("serve_p99", "serve_bulk"):
            serve_cell("mind", cell, "base", 31)
        cfg = get_arch("mind").config
        brute_cell = {c.name: c for c in get_arch("mind").cells}[
            "retrieval_cand"]
        brute = steps.build_cell("mind", "retrieval_cand", device=dev)
        params, hist = brute.make_args(
            torch.Generator(device=dev).manual_seed(31))
        check(params.item_embed.shape == (1_000_192, 64),
              f"recsys: the MIND catalog is {tuple(params.item_embed.shape)}")
        (b_top, b_ids), launches = drive(lambda: brute.fn(params, hist), (),
                                         "mind retrieval")
        m64, h64 = model64(cfg, params, {"hist": hist, "target": hist[:, 0]},
                           1)
        with torch.no_grad():
            interests = rs.mind_user_fwd(m64, cfg, h64["hist"])
            s64 = torch.einsum("bkd,nd->bkn", interests,
                               params.item_embed.detach().double().cpu()
                               ).amax(dim=1)
        wd, wi = topk_smallest(-s64, steps.K_RETRIEVE + 1)
        errs["mind retrieval"] = compare_topk(
            torch, (-b_top.double().cpu(), b_ids.cpu()), (wd, wi.int()),
            steps.K_RETRIEVE, tol=tol64[0] * wd.abs() + tol64[1])
        brute_ms = time_ms(torch, lambda: brute.fn(params, hist), 25)
        del s64

        # rpf=1: the forest over the catalog (kernel A descends, kernel B
        # reranks), its build timed, a second build bit for bit
        rpf = steps.build_cell("mind", "retrieval_cand", variant="rpf=1",
                               device=dev)
        mesh11 = Mesh((1, 1), device=dev)

        def build_and_search():
            t0 = time.perf_counter()
            forest = steps.build_catalog_index(params, mesh11)
            torch.cuda.synchronize()
            return forest, time.perf_counter() - t0, rpf.fn(params, hist,
                                                            forest)

        (forest, build_s, (r_d, r_ids)), launches = drive(
            build_and_search, ("forest_traverse", "fused_gather_topk"),
            "mind rpf=1")
        rpf_launches = launches
        t0 = time.perf_counter()
        again = steps.build_catalog_index(params, mesh11)
        torch.cuda.synchronize()
        build2_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for (_, fa), (_, fb) in zip(
            forest.cells, again.cells) for a, b in zip(fa, fb)),
              "recsys rpf=1: a second build under the same seed differs")
        del again
        plain = steps._mind_rpf_retrieval_program(
            get_arch("mind"), brute_cell, mesh11, False,
            kernel_mode="ref")
        p_d, p_ids = plain.fn(params, hist, forest)

        def runs(d, i):
            first = torch.ones_like(i, dtype=torch.bool)
            first[:, 1:] = i[:, 1:] != i[:, :-1]
            return d[first][None], i[first][None]

        (gd, gi), (pd_, pi) = runs(r_d, r_ids), runs(p_d, p_ids)
        check(gi.shape == pi.shape, f"recsys rpf=1: {gi.shape[1]} runs of "
              f"ids against the plain path's {pi.shape[1]}")
        errs["mind rpf=1"] = compare_topk(torch, (gd[:, :-1], gi[:, :-1]),
                                          (pd_, pi), gi.shape[1] - 1)
        # the exact l2 answer of the same program: kernel D per interest,
        # merged as the program merges the forest's lists
        with torch.no_grad():
            flat = rs.mind_user_fwd(params, cfg, hist).reshape(
                cfg.n_interests, cfg.embed_dim)
            e_d, e_i = ops.topk(flat, params.item_embed.detach(),
                                steps.K_RETRIEVE, "l2")
            x_d, x_i = merge_topk_pairs(e_d.reshape(1, -1),
                                        e_i.reshape(1, -1), steps.K_RETRIEVE)
        rpf_set, exact_set = set(r_ids[0].tolist()), set(x_i[0].tolist())
        brute_set = set(b_ids[0].tolist())
        rpf_ms = time_ms(torch, lambda: rpf.fn(params, hist, forest), 25)
        timed.extend([("mind", "retrieval_cand", "base", brute_ms),
                      ("mind", "retrieval_cand", "rpf=1", rpf_ms)])
        emit({"phase": "recsys", "card": smi, "arch": "mind", "cell": "retrieval_cand", "catalog": list(
                params.item_embed.shape), "interests": cfg.n_interests,
            "brute_ms": brute_ms, "rpf_ms": rpf_ms,
            "rpf_build_s": build_s, "rpf_build2_s": build2_s,
            "rpf_trees": forest.cfg.n_trees,
            "rpf_max_depth": forest.cfg.max_depth,
            "rpf_launches": rpf_launches,
            "recall_at_100_vs_exact_l2": recall_at_k(r_ids, x_i),
            "distinct_recall_vs_exact_l2": len(rpf_set & exact_set)
            / len(exact_set),
            "rpf_distinct_items": len(rpf_set),
            "exact_l2_distinct_items": len(exact_set),
            "rpf_l2_first_last": [float(r_d[0, 0]), float(r_d[0, -1])],
            "exact_l2_first_last": [float(x_d[0, 0]), float(x_d[0, -1])],
            "overlap_with_brute_max_dot": len(rpf_set & brute_set),
            "brute_padded_rows_returned": int(
                (b_ids >= cfg.item_vocab).sum()),
            "brute_max_abs_err_vs_f64": errs["mind retrieval"],
            "brute_untied_ranks": untied(wd[0]),
            "rpf_max_abs_err_vs_plain": errs["mind rpf=1"],
            "profile": {"brute": idle_share(lambda: brute.fn(params, hist)),
                        "rpf=1": idle_share(lambda: rpf.fn(params, hist,
                                                           forest))}})
        del forest

        # kernel H through recsys.embedding_bag on the MIND catalog, at the
        # history bag's two batch sizes; ids past the table and -1 on the
        # first (the reference's gather rule maps them into it)
        rgen = torch.Generator(device=dev).manual_seed(32)
        tab = params.item_embed
        n_rows = tab.shape[0]

        def bag_batch(b, edge):
            ids = torch.randint(0, bagcfg.ITEM_VOCAB, (b, bagcfg.HIST_LEN),
                                generator=rgen, device=dev, dtype=torch.int32)
            w = torch.rand((b, bagcfg.HIST_LEN), generator=rgen, device=dev)
            if edge:
                ids[:, 0], ids[:, 1] = -1, n_rows + 7
                ids[:, 2] = -n_rows - 3
            return ids, w

        bags = {name: bag_batch(b, name == "serve_p99")
                for name, b in bagcfg.BATCHES.items()}
        bag_out, launches = drive(lambda: {
            **{name: rs.embedding_bag(tab, ids, w)
               for name, (ids, w) in bags.items()},
            "unweighted": rs.embedding_bag(tab, bags["serve_p99"][0])},
            ("embedding_bag",), "bag")
        h_errs = {}
        for name, (ids, w) in bags.items():
            h_errs[name] = bag_err(bag_out[name],
                                   rs.gather_index(ids, n_rows).int(), w,
                                   tab.detach())
        ids = bags["serve_p99"][0]
        h_errs["unweighted"] = bag_err(
            bag_out["unweighted"], rs.gather_index(ids, n_rows).int(),
            torch.ones(ids.shape, device=dev), tab.detach())
        emit({"phase": "recsys", "cell": "mind bag", "card": smi,
              "batches": dict(bagcfg.BATCHES), "launches": launches,
              "max_abs_err": h_errs})
        del params, bag_out, bags
        torch.cuda.empty_cache()

        # the CTR models
        for seed, (arch, variant) in enumerate((
                ("dlrm-mlperf", "rows=4000000,cand=131072"),
                ("autoint", "cand=131072"), ("wide-deep", "cand=131072"))):
            for cell in ("serve_p99", "serve_bulk"):
                serve_cell(arch, cell, variant, 40 + seed)
            ctr_retrieval(arch, variant, 40 + seed)
            torch.cuda.empty_cache()
        emit({"phase": "compare", "path": "recsys",
              "max_abs_err_vs_f64": errs,
              "tolerance_vs_f64": f"{tol64[0]} |x| + {tol64[1]}",
              "rpf_vs_plain": "compare rule over runs of equal ids"})
        return dict(rec_launches)

    launches_by_path["recsys"] = recsys_path()

    # ---- path: train (the recommenders' train cells through build_cell) --
    # one AdamW step a call of CellProgram.fn (train/train_state.py,
    # optimizer.py), plain PyTorch on the card as the reference's is plain
    # XLA: MIND at full width (65,536 BehaviorStream users, the 1,000,192 x
    # 64 catalog), AutoInt and Wide&Deep at their full configurations,
    # DLRM-MLPerf with every table capped at 2,000,000 rows.  Gates: each
    # model's gradient on a 512-example slab (ids -1, past the table and
    # below minus its rows included) against the same port function in
    # float64 on the CPU over the rows the slab touches (every other row's
    # gradient exactly 0), float64 taking the card's branch at every ReLU
    # whose input the two put on either side of 0 (each ReLU's input within
    # 1e-4 of its largest), one optimizer update against float64, losses
    # finite and descending over 20 steps; on MIND a checkpoint at step 10
    # restored into a fresh state taking step 11 to the same loss, a
    # one-rank NCCL make_dp_train_step equal to make_train_step, the
    # compressed step descending, kernel H's forward and the bag's backward
    # against float64; and the train launcher on the card
    def train_path():
        import copy
        import torch.distributed as dist
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.configs import get_arch
        from repro_torch.launch import steps
        from repro_torch.launch import train as train_launcher
        from repro_torch.models import recsys as rs
        from repro_torch.train import optimizer as topt
        from repro_torch.train.train_state import (
            TrainState, init_train_state, make_dp_train_step,
            make_train_step, value_and_grad)
        from repro_torch.tree import (flatten_with_names, leaves, tree_map,
                                      unflatten)
        check(not torch.backends.cuda.matmul.allow_tf32
              and torch.get_float32_matmul_precision() == "highest",
              "train: fp32 products are not IEEE fp32")
        rtol64, n_slab, n_steps = 1e-4, 512, 20
        lr, b1, b2, eps, wd = 1e-3, 0.9, 0.95, 1e-8, 0.1   # the program's
        tr_launches = collections.Counter()
        rows = []

        def drive(fn, names, tag):
            out, launches, ref_calls = counted(torch, counters, fn)
            require(launches, ref_calls, names, f"train {tag}")
            tr_launches.update(launches)
            return out

        def clone(state):
            return TrainState(state.step.clone(), copy.deepcopy(state.params),
                              tree_map(torch.clone, state.opt_state),
                              tree_map(torch.clone, state.residuals))

        def sub_rows(table, cols):
            """(the rows of ``table`` that the id tensors ``cols`` read, in
            float64 on the CPU; their indices; ``cols`` re-indexed into that
            copy so that the gather rule reads the same rows and drops the
            same ids: past the table becomes past the copy, below minus its
            rows below minus the copy's)."""
            n = table.shape[0]
            idx = [rs.gather_index(c, n) for c in cols]
            uniq = torch.unique(torch.cat([i.flatten() for i in idx]))
            m = uniq.numel()
            out = [torch.where(c >= n, m, torch.where(
                c < -n, -m - 1, torch.searchsorted(uniq, i))).cpu()
                for c, i in zip(cols, idx)]
            return table.detach()[uniq].double().cpu(), uniq, out

        def model64(cfg, model, b):
            """(the model in float64 on the CPU over the table rows batch
            ``b`` reads, the batch re-indexed, {table leaf: its rows})."""
            tree, sel, out = rs.param_tree(model), {}, {}
            for name, value in tree.items():
                if name in ("tables", "wide_tables"):
                    out[name], cols = [], []
                    for i, t in enumerate(value):
                        t64, sel[f"{name}/{i}"], (c,) = sub_rows(
                            t, [b["sparse"][:, i]])
                        out[name].append(t64)
                        cols.append(c)
                    sparse = torch.stack(cols, dim=1)
                elif name == "item_embed":
                    out[name], sel[name], (hist, tgt) = sub_rows(
                        value, [b["hist"], b["target"]])
                else:
                    out[name] = tree_map(lambda t: t.detach().double().cpu(),
                                         value)
            b64 = ({"hist": hist, "target": tgt} if cfg.model == "mind"
                   else {"sparse": sparse})
            if "dense" in b:
                b64["dense"] = b["dense"].double().cpu()
            b64["labels"] = b["labels"].double().cpu()
            m64 = rs.MODELS[cfg.model](cfg, tree_map(
                lambda t: t.requires_grad_(), out))
            return m64, b64, sel

        def slab_of(cfg, batch):
            """The first 512 examples, with edge ids: -1, past the table and
            below minus its rows."""
            s = {k: v[:n_slab].clone() for k, v in batch.items()}
            big = 1 << 30
            if cfg.model == "mind":
                s["hist"][0, :3] = torch.tensor([-1, big, -big])
                s["target"][1], s["target"][2] = big, -big
            else:
                s["sparse"][0], s["sparse"][1] = -1, big
                s["sparse"][2] = -big
            return s

        class ReluBranches(torch.overrides.TorchFunctionMode):
            """Each ``torch.relu``'s input, in call order.  Given ``card``
            (the record of the card's run), ``relu(x)`` is ``x`` times the
            card's mask ``x > 0``, so that float64 differentiates the branch
            the card took: ReLU's derivative jumps at 0, and an input within
            rounding of 0 may fall on either side in f32 and float64."""

            def __init__(self, card=None):
                super().__init__()
                self.card, self.inputs = card, []

            def __torch_function__(self, func, types, args=(), kwargs=None):
                if func is not torch.relu:
                    return func(*args, **(kwargs or {}))
                x = args[0]
                self.inputs.append(x.detach())
                if self.card is None:
                    return func(x)
                mask = self.card.inputs[len(self.inputs) - 1] > 0
                return x * mask.to(x.device, x.dtype)

        def grad_gate(cfg, state, batch, tag):
            """The card's gradient of the slab's loss against float64 on
            the card's ReLU branches; (gradient, table rows, largest error
            over the largest gradient, ReLU inputs on either side of 0)."""
            slab = slab_of(cfg, batch)
            loss_fn = steps.recsys_loss(cfg)
            card = ReluBranches()
            with card:
                loss, _, grads = value_and_grad(loss_fn, state.params, slab)
            m64, b64, sel = model64(cfg, state.params, slab)
            host = ReluBranches(card)
            with host:
                loss64, _, g64 = value_and_grad(loss_fn, m64, b64)
            check(len(host.inputs) == len(card.inputs),
                  f"train {tag}: {len(card.inputs)} ReLUs on the card, "
                  f"{len(host.inputs)} in float64")
            flips = 0
            for i, (x, x64) in enumerate(zip(card.inputs, host.inputs)):
                x = x.double().cpu()
                err = float((x - x64).abs().max())
                check(err <= rtol64 * float(x64.abs().max()),
                      f"train {tag}: ReLU {i}'s input differs by {err}")
                flips += int(torch.count_nonzero((x > 0) != (x64 > 0)))
            del card, host
            check(abs(float(loss) - float(loss64))
                  <= rtol64 * abs(float(loss64)), f"train {tag}: loss")
            # atol 1e-6 x the largest magnitude of the whole gradient
            top = max(float(w.abs().max()) for w in leaves(g64))
            worst = 0.0
            for (name, g), w in zip(flatten_with_names(grads), leaves(g64)):
                if name in sel:
                    check(int(torch.count_nonzero(
                        g.index_fill(0, sel[name], 0))) == 0,
                        f"train {tag}: {name} has a gradient off its rows")
                    g = g[sel[name]]
                g = g.double().cpu()
                err = (g - w).abs()
                tol = rtol64 * w.abs() + 1e-6 * top
                k = int((err - tol).argmax())
                check(bool((err <= tol).all()),
                      f"train {tag}: {name} gradient {float(g.flatten()[k])}"
                      f" against {float(w.flatten()[k])} (largest {top})")
                worst = max(worst, float(err.max()) / top)
            return grads, sel, worst, flips

        def update_gate(state, grads, sel, tag):
            """One AdamW update on the card (the state moves) against
            float64 on the CPU from the same gradient and state, over the
            slab's rows and 256 others of each table, and every dense
            leaf."""
            pick = {}
            for name, idx in sel.items():
                n = dict(flatten_with_names(state.params))[name].shape[0]
                extra = torch.randint(0, n, (256,), device=dev)
                pick[name] = torch.unique(torch.cat([idx, extra]))
            gn = torch.sqrt(sum(torch.sum(g.double() ** 2)
                                for g in leaves(grads)))
            scale = min(1.0, 1.0 / (float(gn) + 1e-9))
            t = int(state.opt_state.step) + 1
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t

            def host(tree):
                return {n: (x[pick[n]] if n in pick else x).detach()
                        .double().cpu() for n, x in flatten_with_names(tree)}

            p0, g0 = host(state.params), host(grads)
            m0, v0 = host(state.opt_state.m), host(state.opt_state.v)
            opt = topt.adamw(topt.constant_schedule(lr))
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            topt.apply_updates(state.params, updates)
            state = TrainState(state.step + 1, state.params, opt_state, None)
            p1, m1, v1 = (host(x) for x in (state.params, opt_state.m,
                                             opt_state.v))
            worst = 0.0
            for n in p0:
                g = g0[n] * scale
                m_terms = (b1 * m0[n]).abs() + ((1 - b1) * g).abs()
                m = b1 * m0[n] + (1 - b1) * g
                v = b2 * v0[n] + (1 - b2) * g * g
                root = torch.sqrt(v / bc2) + eps
                upd = -lr * ((m / bc1) / root + wd * p0[n])
                # each within 1e-5 of the sum of its terms' magnitudes (f32
                # sums may cancel, m's most), carried through the update;
                # the parameter through p1 - p0, within p1's rounding to f32
                for got, want, terms in (
                        (m1[n], m, m_terms), (v1[n], v, v),
                        (p1[n] - p0[n], upd,
                         lr * (m_terms / bc1 / root + wd * p0[n].abs())
                         + 1.2e-2 * p0[n].abs())):
                    err = (got - want).abs()
                    check(bool((err <= 1e-5 * terms + 1e-15).all()),
                          f"train {tag}: update of {n}: {float(err.max())}")
                    worst = max(worst, float(err.max()))
            return state, worst

        def phases(cfg, state, batch, n=5):
            """Device ms of the forward, the backward and the optimizer a
            step (the profiler's kernels between syncs at phase ends)."""
            loss_fn = steps.recsys_loss(cfg)
            opt = topt.adamw(topt.constant_schedule(lr))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    with record_function("phase:forward"):
                        loss, _ = loss_fn(state.params, batch)
                        torch.cuda.synchronize()
                    with record_function("phase:backward"):
                        grads = unflatten(state.params, torch.autograd.grad(
                            loss, leaves(state.params),
                            materialize_grads=True))
                        torch.cuda.synchronize()
                    with record_function("phase:optimizer"):
                        updates, st = opt.update(
                            grads, state.opt_state, state.params)
                        topt.apply_updates(state.params, updates)
                        state = TrainState(state.step + 1, state.params, st,
                                           None)
                        del grads, updates
                        torch.cuda.synchronize()
            ranges = [(e.name.split(":")[1], e.time_range.start,
                       e.time_range.end) for e in prof.events()
                      if e.name.startswith("phase:")
                      and e.device_type == DeviceType.CPU]
            busy = collections.Counter()
            by_kernel = collections.defaultdict(collections.Counter)
            for e in prof.events():
                if e.device_type == DeviceType.CUDA \
                        and not e.name.startswith("phase:"):
                    s = e.time_range.start
                    for name, lo, hi in ranges:
                        if lo <= s <= hi:
                            ms = e.time_range.elapsed_us() / 1e3 / n
                            busy[name] += ms
                            by_kernel[name][e.name[:60]] += ms
                            break
            return state, dict(busy), {
                name: dict(c.most_common(4)) for name, c in by_kernel.items()}

        def train_cell(arch, variant, seed, extra):
            wall0 = time.perf_counter()
            held = torch.cuda.memory_allocated()    # the script's, before
            prog = steps.build_cell(arch, "train_batch", variant=variant,
                                    device=dev)
            cfg = steps._recsys_variant(get_arch(arch).config, variant)[0]
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(seed)
            state, batch = prog.make_args(gen)
            torch.cuda.synchronize()
            args_s = time.perf_counter() - t0
            b = batch["labels"].shape[0]
            n_params = sum(p.numel() for p in leaves(state.params))
            grads, sel, g_err, flips = grad_gate(cfg, state, batch, arch)
            del grads
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ckpt_dir = tempfile.mkdtemp() if extra else None
            ckpt = Checkpointer(ckpt_dir) if extra else None

            def run(n):
                nonlocal state
                out = []
                for i in range(n):
                    if ckpt is not None and int(state.step) == 10:
                        ckpt.save(10, state, block=False)
                    state, m = prog.fn(state, batch)
                    out.append(float(m["loss"]))
                return out

            t0 = time.perf_counter()
            losses = drive(lambda: run(n_steps), (), f"{arch} steps")
            steps_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            check(all(math.isfinite(x) for x in losses)
                  and statistics.mean(losses[-5:]) < losses[0],
                  f"train {arch}: losses {losses}")
            row = {"arch": arch, "cell": "train_batch", "variant": variant,
                   "batch": b, "params": n_params, "args_s": args_s,
                   "losses": losses, "wall_s_20_steps": steps_s,
                   "peak_device_gb": peak / 1e9,
                   "cell_peak_gb": (peak - held) / 1e9,
                   "grad_err_over_largest_vs_f64": g_err,
                   "relu_inputs_across_0": [flips], "meta": prog.meta}
            if extra:      # step 11 from the step-10 checkpoint
                ckpt.wait()
                fresh = init_train_state(
                    rs.INITS[cfg.model](gen, cfg, dev),
                    topt.adamw(topt.constant_schedule(lr)))
                check(ckpt.restore_into(fresh) == 10,
                      "train: the checkpoint is not step 10")
                _, m = prog.fn(fresh, batch)
                check(abs(float(m["loss"]) - losses[10])
                      <= 1e-5 * abs(losses[10]),
                      f"train: step 11 from the checkpoint: "
                      f"{float(m['loss'])} against {losses[10]}")
                row["step11_from_checkpoint"] = [float(m["loss"]),
                                                 losses[10]]
                del fresh
                shutil.rmtree(ckpt_dir, ignore_errors=True)

            def one():
                nonlocal state
                state, _ = prog.fn(state, batch)

            ms = time_ms(torch, one, 10, warm=3)
            timed.append((arch, "train_batch", variant, ms))
            row.update({"ms_per_step": ms, "examples_per_s": b / ms * 1e3})
            state, row["device_ms"], row["top_kernels_ms"] = phases(
                cfg, state, batch)
            row["profile"] = idle_share(one, n=5)
            # two runs of one step from one state
            twin = clone(state)
            state, m1 = prog.fn(state, batch)
            twin, m2 = prog.fn(twin, batch)
            same = {n: torch.equal(x, y) for (n, x), (_, y) in zip(
                flatten_with_names(state), flatten_with_names(twin))}
            row["bitwise_repeat"] = (all(same.values())
                                     and float(m1["loss"]) == float(
                                         m2["loss"]))
            if not row["bitwise_repeat"]:
                loss_fn = steps.recsys_loss(cfg)
                (l1, _, g1), (l2, _, g2) = (value_and_grad(
                    loss_fn, twin.params, batch) for _ in range(2))
                row["repeat_differs"] = {
                    "loss": bool(l1 != l2),
                    "grad_leaves": [n for (n, x), (_, y) in zip(
                        flatten_with_names(g1), flatten_with_names(g2))
                        if not torch.equal(x, y)],
                    "state_leaves": [n for n, v in same.items() if not v]}
                del g1, g2
            del twin
            torch.cuda.empty_cache()
            # one optimizer update against float64, from the gradient of
            # the next 512 examples
            grads, sel, _, flips = grad_gate(
                cfg, state, {k: v[n_slab:] for k, v in batch.items()}, arch)
            row["relu_inputs_across_0"].append(flips)
            state, row["update_max_abs_err_vs_f64"] = update_gate(
                state, grads, sel, arch)
            del grads
            if extra:
                row.update(dp_gates(cfg, state, batch))
            row["cell_wall_s"] = time.perf_counter() - wall0
            emit({"phase": "train", "card": smi, **row})
            rows.append(row)
            return state

        def dp_gates(cfg, state, batch):
            """make_dp_train_step over a one-rank NCCL group against
            make_train_step; the compressed step descending."""
            opt = topt.adamw(topt.constant_schedule(lr))
            loss_fn = steps.recsys_loss(cfg)
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                    world_size=1)
            try:
                s1, s2 = clone(state), clone(state)
                s1, m1 = make_train_step(loss_fn, opt)(s1, batch)
                s2, m2 = make_dp_train_step(loss_fn, opt)(s2, batch)
                pairs = list(zip(leaves(s2.params), leaves(s1.params)))
                err = max(float((x - y).abs().max()) for x, y in pairs)
                check(abs(float(m2["loss"]) - float(m1["loss"]))
                      <= 1e-6 * abs(float(m1["loss"]))
                      and all(torch.allclose(x, y, rtol=1e-6, atol=1e-9)
                              for x, y in pairs),
                      f"train: the NCCL dp step differs ({err})")
                del s1, s2
                s3 = clone(state)
                s3 = TrainState(s3.step, s3.params, s3.opt_state,
                                init_train_state(s3.params, opt,
                                                 compress=True).residuals)
                step = make_dp_train_step(loss_fn, opt, compress=True)
                comp = []
                for _ in range(6):
                    s3, m = step(s3, batch)
                    comp.append(float(m["loss"]))
                check(all(math.isfinite(x) for x in comp)
                      and comp[-1] < comp[0],
                      f"train: compressed losses {comp}")
                del s3
                return {"nccl_dp_max_rel_err": err,
                        "compressed_losses": comp,
                        "backend": dist.get_backend()}
            finally:
                dist.destroy_process_group()

        for seed, (arch, variant, extra) in enumerate((
                ("mind", "base", True), ("autoint", "base", False),
                ("wide-deep", "base", False),
                ("dlrm-mlperf", "rows=2000000", False))):
            state = train_cell(arch, variant, 50 + seed, extra)
            if arch == "mind":
                mind_table = state.params.item_embed
            del state
            torch.cuda.empty_cache()

        # kernel H's forward and the bag's backward on the MIND bag (B =
        # 512, ids -1, past the table and below minus its rows), against
        # float64 on the CPU; the backward timed at both bag batches
        rgen = torch.Generator(device=dev).manual_seed(60)
        n_rows = mind_table.shape[0]
        tab = mind_table.detach().clone().requires_grad_()
        del mind_table

        def bag_batch(b, edge):
            ids = torch.randint(0, bagcfg.ITEM_VOCAB, (b, bagcfg.HIST_LEN),
                                generator=rgen, device=dev, dtype=torch.int32)
            w = torch.rand((b, bagcfg.HIST_LEN), generator=rgen, device=dev)
            if edge:
                ids[:, 0], ids[:, 1], ids[:, 2] = -1, n_rows + 7, -n_rows - 3
            return ids, w.requires_grad_()

        bags_t = {name: bag_batch(b, name == "serve_p99")
                  for name, b in bagcfg.BATCHES.items()}
        ids, w = bags_t["serve_p99"]
        g_out = torch.randn((ids.shape[0], tab.shape[1]), generator=rgen,
                            device=dev)
        out = drive(lambda: rs.embedding_bag(tab, ids, w), ("embedding_bag",),
                    "bag")
        out.backward(g_out)
        # the reference's bag, take + weighted sum, in float64
        t64, _, (i64,) = sub_rows(tab, [ids])
        t64.requires_grad_()
        w64 = w.detach().double().cpu().requires_grad_()
        out64 = torch.sum(rs.take_rows(t64, i64) * w64[..., None], dim=1)
        out64.backward(g_out.double().cpu())
        sel = torch.unique(rs.gather_index(ids, n_rows))
        check(int(torch.count_nonzero(tab.grad.index_fill(0, sel, 0))) == 0,
              "train bag: a table gradient off the bag's rows")
        bag_errs = {}
        for tag, got, want in (("forward", out, out64.detach()),
                               ("table_grad", tab.grad[sel], t64.grad),
                               ("weight_grad", w.grad, w64.grad)):
            err = (got.detach().double().cpu() - want).abs()
            check(bool((err <= rtol64 * want.abs() + 1e-6 * float(
                want.abs().max())).all()),
                f"train bag {tag}: {float(err.max())}")
            bag_errs[tag] = float(err.max())
        bag_bwd = {}
        for name, (ids, w) in bags_t.items():
            out = rs.embedding_bag(tab, ids, w)
            g = torch.randn_like(out)

            def backward():
                tab.grad = w.grad = None
                torch.autograd.backward(out, g, retain_graph=True)

            bag_bwd[name] = time_ms(torch, backward, 10, flush)
        del tab, bags_t
        torch.cuda.empty_cache()

        # the train launcher on the card
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            hists = {a: train_launcher.main(
                ["--arch", a, "--preset", "smoke"] + s)
                for a, s in (("mind", ["--steps", "20"]),
                             ("dlrm-mlperf", []))}
        launcher_s = time.perf_counter() - t0
        for a, h in hists.items():
            check(len(h["loss"]) > 0 and all(math.isfinite(x)
                                              for x in h["loss"]),
                  f"train launcher {a}: losses {h['loss']}")
        emit({"phase": "train", "card": smi, "cell": "mind bag",
              "max_abs_err_vs_f64": bag_errs,
              "backward_ms": bag_bwd, "batches": dict(bagcfg.BATCHES),
              "launcher": {a: {"steps": len(h["loss"]),
                               "first_last_loss": [h["loss"][0],
                                                   h["loss"][-1]]}
                           for a, h in hists.items()},
              "launcher_s": launcher_s})
        return dict(tr_launches)

    launches_by_path["train"] = train_path()

    def lm_cell_rows(path, cells, gen, path_launches):
        """Each LM cell ``(arch, cell, variant, timed runs, warm-up runs)``
        through ``build_cell`` with seeded weights: ms (CUDA events), tokens
        / s, the FLOPs share of the bf16 peak, peak memory, the idle share
        and device events (profiler), a decode's share of its bytes bound
        (cache and bf16 parameters), a train cell's losses on its one batch
        (they must fall) and whether two runs of a step are equal bit for
        bit.  No kernel launches and no plain version runs."""
        import copy
        from repro_torch.configs import get_arch
        from repro_torch.launch import steps
        from repro_torch.train.train_state import TrainState
        from repro_torch.tree import flatten_with_names, leaves, tree_map
        bf16_peak, hbm = 989e12, mem_rate(card)

        def lm_cfg(arch, variant):
            rest, _ = steps._lm_batch_variant(variant)
            return steps._apply_lm_variant(get_arch(arch).config, rest)

        for arch, cell, variant, reps, warm in cells:
            cfg = lm_cfg(arch, variant)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            prog = steps.build_cell(arch, cell, variant=variant, device=dev)
            t0 = time.perf_counter()
            args = prog.make_args(gen.manual_seed(0))
            torch.cuda.synchronize()
            args_s = time.perf_counter() - t0
            losses = []

            def call():
                out = prog.fn(*args)
                if prog.meta["kind"] == "train":
                    losses.append(out[1]["loss"])

            def drive():
                # the profiled calls warm up the timed ones
                idle_ = idle_share(call, 1 if "prefill" in cell else 2)
                return time_ms(torch, call, reps, warm=warm), idle_

            (ms, idle), launches, ref_calls = counted(torch, counters, drive)
            require(launches, ref_calls, (), f"{path} {arch} {cell}")
            timed.append((arch, cell, variant, ms))
            path_launches.update(launches)
            peak = torch.cuda.max_memory_allocated()
            meta = prog.meta
            row = {"phase": path, "card": smi, "arch": arch, "cell": cell,
                   "variant": variant, "kind": meta["kind"],
                   "n_layers": cfg.n_layers, "params": meta["params_total"],
                   "ms": ms, "tokens_per_s": meta["n_tokens"] / ms * 1e3,
                   "model_flops": meta["model_flops"],
                   "flops_share_of_bf16_peak":
                       meta["model_flops"] / (ms / 1e3) / bf16_peak,
                   "peak_gb": peak / 1e9, "held_before_gb": held / 1e9,
                   "make_args_s": args_s, **idle}
            if meta["kind"] == "decode":
                cache_bytes = sum(t.nbytes for t in args[1])
                param_bytes = meta["params_total"] * 2    # bf16 compute
                row.update(cache_gb=cache_bytes / 1e9,
                           bytes_bound_ms=(cache_bytes + param_bytes)
                           / hbm * 1e3)
                row["bound_share"] = row["bytes_bound_ms"] / ms
            if meta["kind"] == "train":
                ls = [float(x) for x in losses]
                check(all(math.isfinite(x) for x in ls) and ls[-1] < ls[0],
                      f"{path} {arch} train: losses {ls}")
                state = args[0]

                def one_step(st):
                    st = TrainState(st.step.clone(), copy.deepcopy(st.params),
                                    tree_map(torch.clone, st.opt_state),
                                    None)
                    prog.fn(st, args[1])
                    return st
                # the first run's state waits on the host (an f32 model's
                # parameters and moments are 16 GB at granite's 1.3B)
                a_ = tree_map(lambda t: t.cpu(), one_step(state))
                b_ = one_step(state)
                differ = [n for (n, x), y in zip(flatten_with_names(a_),
                                                 leaves(b_))
                          if not torch.equal(x, y.cpu())]
                row.update(losses=ls, two_runs_bit_for_bit=not differ,
                           leaves_that_differ=differ)
                del a_, b_, state
            emit(row)
            del prog, args
        torch.cuda.empty_cache()

    # ---- path: lm (the dense language models through build_cell) ---------
    # smollm-135m (prefill_32k blockwise at batch 1, decode_32k at 64,
    # train_4k at 8), gemma3-4b at nl=6 (prefill_32k blockwise at 1,
    # decode_32k at 8, long_500k at 1, train_4k at 2) and stablelm-12b at
    # nl=2 (decode_32k at 8), full width, seeded weights and MarkovTokens;
    # plain PyTorch on the card, as the reference's are plain XLA.  Gates:
    # prefill (last_only) over a 2,048-token prompt equal to forward's last
    # position and one decode step to forward's next, in f32 compute (the
    # reference's rtol / atol 2e-3); blockwise attention equal to dense
    # (f32: atol 1e-5; bf16: 4 bf16 units of the largest output); the
    # gradients of a small f32 LM within rtol 1e-4 of float64; the train
    # cells' losses descending on their one batch.  Then the kNN-LM
    # datastore: smollm-135m trained as examples/knn_lm_torch.py trains
    # (300 steps of MarkovTokens(49152, branch=8) at 16 x 64), the hidden
    # states of 4,096 x 64 positions (unit rows) indexed on rpf (40 trees,
    # C = 12) and 1,024 held-out positions searched under cosine at P = 1
    # and 4 (kernels A and B), against mode="ref" by the compare rule, with
    # recall(P = 4) >= recall(P = 1)
    def lm_path():
        import copy
        import dataclasses
        from repro_torch.configs import get_arch
        from repro_torch.configs.base import LMConfig
        from repro_torch.data.lm_data import MarkovTokens
        from repro_torch.launch import steps
        from repro_torch.models import attention as attn_mod
        from repro_torch.models import transformer as tr
        from repro_torch.train.optimizer import adamw, cosine_schedule
        from repro_torch.train.train_loop import LoopConfig, train
        from repro_torch.train.train_state import (
            TrainState, init_train_state, make_train_step, value_and_grad)
        from repro_torch.tree import (flatten_with_names, leaves,
                                      module_tree, tree_map)
        check(not torch.backends.cuda.matmul.allow_tf32,
              "lm: fp32 products are not IEEE fp32")
        bf16_peak, hbm = 989e12, mem_rate(card)
        knn_steps, knn_seqs, knn_batch = 300, 4096, 512
        cells = (  # arch, cell, variant, timed runs, warm-up runs
            ("smollm-135m", "prefill_32k", "attn=blockwise,batch=1", 2, 0),
            ("smollm-135m", "decode_32k", "batch=64", 10, 2),
            ("smollm-135m", "train_4k", "batch=8", 3, 0),
            ("gemma3-4b", "prefill_32k", "nl=6,attn=blockwise,batch=1", 3, 0),
            ("gemma3-4b", "decode_32k", "nl=6,batch=8", 10, 2),
            ("gemma3-4b", "long_500k", "nl=6,batch=1", 10, 2),
            ("gemma3-4b", "train_4k", "nl=6,batch=2", 3, 0),
            ("stablelm-12b", "decode_32k", "nl=2,batch=8", 10, 2))
        lm_launches = collections.Counter()
        gen = torch.Generator(device=dev)

        def lm_cfg(arch, variant):
            rest, _ = steps._lm_batch_variant(variant)
            return steps._apply_lm_variant(get_arch(arch).config, rest)

        def max_err(got, want):
            return float((got.double() - want.double()).abs().max())

        # 1. prefill and decode against forward, f32 compute
        gate_errs = {}
        for arch, variant, b in (("smollm-135m", "base", 2),
                                 ("gemma3-4b", "nl=6", 1)):
            cfg = dataclasses.replace(lm_cfg(arch, variant),
                                      compute_dtype="float32")
            model = tr.init_lm(gen.manual_seed(3), cfg, dev)
            tok = torch.from_numpy(MarkovTokens(cfg.vocab_size, seed=3)
                                   .sample(b, 2048)).to(dev)
            with torch.no_grad():
                full = tr.forward(model, tok, cfg)[0]
                cache = tr.init_cache(cfg, b, 2049, torch.float32, dev)
                pre, cache = tr.decode_step(model, cache, tok[:, :2048], 0,
                                            cfg, last_only=True)
                nxt, _ = tr.decode_step(model, cache, tok[:, 2048:], 2048,
                                        cfg)
            for tag, got, want in (("prefill", pre[:, 0], full[:, 2047]),
                                   ("decode", nxt[:, 0], full[:, 2048])):
                check(bool(torch.allclose(got, want, rtol=2e-3, atol=2e-3)),
                      f"lm {arch} {tag} against forward: "
                      f"{max_err(got, want)}")
                gate_errs[f"{arch} {tag}"] = max_err(got, want)
            del model, full, cache
            torch.cuda.empty_cache()

        # 2. blockwise attention against dense on the same inputs, and the
        # two routes of f32 scores from bf16 operands
        blk_errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(1, 4096, 9, 64, generator=gen.manual_seed(4),
                            device=dev).to(dtype)
            k, v = (torch.randn(1, 4096, 3, 64, generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            pos = torch.arange(4096, dtype=torch.int32, device=dev)
            for window, softcap in ((0, 0.0), (1024, 50.0)):
                dense = attn_mod._sdpa(q, k, v,
                                       attn_mod._mask(pos, pos, window),
                                       softcap).float()
                blk = attn_mod._sdpa_blockwise(q, k, v, pos, pos, window,
                                               softcap, 1024).float()
                tol = 1e-5 if dtype == torch.float32 \
                    else 2.0 ** -6 * float(dense.abs().max())
                err = max_err(blk, dense)
                check(err <= tol, f"lm blockwise against dense "
                                  f"({dtype}, window {window}): {err}")
                blk_errs[f"{str(dtype)[6:]} window {window}"] = err
        qs = torch.randn(64 * 3, 3, 64, generator=gen, device=dev).to(
            torch.bfloat16)
        ks = torch.randn(64 * 3, 64, 32768, generator=gen, device=dev).to(
            torch.bfloat16)
        with torch.no_grad():
            out_dtype = torch.bmm(qs, ks, out_dtype=torch.float32)
        upcast = torch.bmm(qs.float(), ks.float())
        scores_route = {
            "max_abs_err_out_dtype_vs_upcast": max_err(out_dtype, upcast),
            "out_dtype_ms": time_ms(torch, lambda: torch.bmm(
                qs, ks, out_dtype=torch.float32), 10),
            "upcast_ms": time_ms(torch, lambda: torch.bmm(
                qs.float(), ks.float()), 10),
            "shape": "decode_32k smollm, one layer: (192, 3, 64) x "
                     "(192, 64, 32768) bf16"}
        check(scores_route["max_abs_err_out_dtype_vs_upcast"] <= 1e-4,
              f"lm f32 scores: {scores_route}")
        del qs, ks, out_dtype, upcast, q, k, v, dense, blk
        torch.cuda.empty_cache()

        # 3. the gradients of a small f32 LM against float64 on the CPU
        gcfg = LMConfig(name="grad", n_layers=4, d_model=128, n_heads=4,
                        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=1000,
                        sliding_window=8, global_every=2, logit_softcap=30.0,
                        param_dtype="float32", compute_dtype="float32")
        g64cfg = dataclasses.replace(gcfg, param_dtype="float64",
                                     compute_dtype="float64")
        model = tr.init_lm(gen.manual_seed(5), gcfg, dev)
        m64 = tr.LM(g64cfg, tree_map(
            lambda t: t.detach().double().cpu().requires_grad_(),
            module_tree(model)))
        batch = steps.lm_tokens(gcfg, 4, 64, 5, dev)
        b64 = {k_: v_.cpu() for k_, v_ in batch.items()}
        grad_errs = {}
        for chunk in (0, 16):
            loss, _, g = value_and_grad(lambda p, b_: tr.loss_fn(
                p, b_, gcfg, logit_chunk=chunk), model, batch)
            loss64, _, g64 = value_and_grad(lambda p, b_: tr.loss_fn(
                p, b_, g64cfg, logit_chunk=chunk), m64, b64)
            check(abs(float(loss) - float(loss64)) <= 1e-4 * abs(
                float(loss64)), f"lm grad gate loss {float(loss)} "
                                f"{float(loss64)}")
            top = max(float(w.abs().max()) for w in leaves(g64))
            worst = 0.0
            for (name, x), w in zip(flatten_with_names(g), leaves(g64)):
                x = x.double().cpu()
                check(bool(torch.allclose(x, w, rtol=1e-4, atol=1e-6 * top)),
                      f"lm gradient {name} (chunk {chunk}): "
                      f"{max_err(x, w)}")
                worst = max(worst, max_err(x, w) / top)
            grad_errs[f"chunk {chunk}"] = worst
        del model, m64
        emit({"phase": "lm", "card": smi, "gates": {
            "prefill_decode_vs_forward_max_abs_err": gate_errs,
            "blockwise_vs_dense_max_abs_err": blk_errs,
            "f32_scores": scores_route,
            "grad_vs_f64_max_abs_err_over_top": grad_errs}})

        # 4. the cells
        lm_cell_rows("lm", cells, gen, lm_launches)
        # 5. the kNN-LM datastore on the paper's index; remat off, as the
        # example's config sets it (16 x 64 tokens need no recompute)
        cfg = dataclasses.replace(get_arch("smollm-135m").config,
                                  remat=False)
        data = MarkovTokens(cfg.vocab_size, branch=8, seed=0)
        model = tr.init_lm(gen.manual_seed(0), cfg, dev)
        opt = adamw(cosine_schedule(3e-3, 20, 400))
        step = make_train_step(lambda p, b_: tr.loss_fn(p, b_, cfg), opt)

        def token_batches():
            for b_ in data.batches(16, 64):
                yield {k_: torch.from_numpy(v_).to(dev)
                       for k_, v_ in b_.items()}

        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            state, hist = train(init_train_state(model, opt), step,
                                token_batches(),
                                LoopConfig(total_steps=knn_steps,
                                           log_every=100))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0

        def unit_rows(tokens):
            with torch.no_grad():
                h = tr.forward_hidden(state.params, tokens, cfg)[0]
            rows_ = h.float().reshape(-1, cfg.d_model)
            return rows_ / (torch.linalg.norm(rows_, dim=1, keepdim=True)
                            + 1e-9)

        mem = torch.from_numpy(data.sample(knn_seqs, 64)).to(dev)
        keys = torch.cat([unit_rows(mem[lo:lo + knn_batch, :-1])
                          for lo in range(0, knn_seqs, knn_batch)])
        vals = mem[:, 1:].reshape(-1)
        t0 = time.perf_counter()
        kindex = build_index(keys, IndexSpec(
            backend="rpf", forest=ForestConfig(n_trees=40, capacity=12),
            seed=2), device=dev)
        torch.cuda.synchronize()
        kbuild_s = time.perf_counter() - t0
        test = torch.from_numpy(data.sample(16, 64)).to(dev)
        q = unit_rows(test[:, :-1])

        def drive_knn():
            return {p: kindex.search(q, SearchParams(
                k=8, n_probes=p, metric="cosine")) for p in PROBES}

        res, launches, ref_calls = counted(torch, counters, drive_knn)
        require(launches, ref_calls, ("forest_traverse", "fused_gather_topk"),
                "lm knn")
        lm_launches.update(launches)
        _, exact_ids = exact_knn(q, keys, 8, metric="cosine")
        recall, knn_err = {}, 0.0
        for p, got in res.items():
            want = kindex.search(q, SearchParams(k=9, n_probes=p,
                                                 metric="cosine", mode="ref"))
            knn_err = max(knn_err, compare_topk(torch, got, want, 8))
            check_scores(torch, METRICS["cosine"], q, keys, got)
            recall[p] = recall_at_k(got[1], exact_ids)
        check(recall[4] >= recall[1], f"lm knn recall {recall}")
        search_ms = {p: time_ms(torch, lambda p=p: kindex.search(
            q, SearchParams(k=8, n_probes=p, metric="cosine")), 10)
            for p in PROBES}
        # the example's interpolation, at P = 1 as the example searches
        d, ids = res[1]
        with torch.no_grad():
            lm_probs = torch.softmax(tr.forward(state.params, test[:, :-1],
                                                cfg)[0], dim=-1)
        lm_probs = lm_probs.reshape(-1, cfg.padded_vocab)
        w = torch.exp(-d * 10.0) * (ids >= 0)
        knn_probs = torch.zeros_like(lm_probs).scatter_add_(
            1, vals[ids.clamp_min(0).long()].long(), w)
        knn_probs /= knn_probs.sum(1, keepdim=True) + 1e-9
        truth = test[:, 1:].reshape(-1)
        acc = {lam: float(((1 - lam) * lm_probs + lam * knn_probs)
                          .argmax(1).eq(truth).float().mean())
               for lam in (0.0, 0.3, 0.6)}
        emit({"phase": "lm", "card": smi, "cell": "knn-lm datastore",
              "keys": list(keys.shape), "queries": q.shape[0], "k": 8,
              "train_steps": knn_steps, "train_s": train_s,
              "loss_first_last": [hist["loss"][0], hist["loss"][-1]],
              "index_build_s": kbuild_s, "recall_at_8": recall,
              "search_ms": search_ms, "next_token_acc": acc,
              "max_abs_err": knn_err, "launches": launches,
              "ref_calls": ref_calls})
        del state, keys, kindex, lm_probs, knn_probs
        torch.cuda.empty_cache()
        return dict(lm_launches)

    launches_by_path["lm"] = lm_path()

    # ---- path: moe (the MoE language models through build_cell) --------
    # granite-moe-1b-a400m at full depth and width (prefill_32k blockwise
    # at batch 1, decode_32k at 32, train_4k at 4) and
    # llama4-maverick-400b-a17b at nl=2, one [dense, MoE] group at full
    # width (prefill_32k blockwise at 1, decode_32k at 64); seeded weights,
    # MarkovTokens; plain PyTorch on the card, as the reference's router,
    # dispatch and expert products are plain XLA with no Pallas kernel.
    # Gates: prefill (last_only) over a 2,048-token prompt equal to
    # forward's last position and one decode step to forward's next, at a
    # capacity that drops no token (cap = E / top_k): granite in f32
    # compute (rtol / atol 2e-3), llama4 in its bf16 (2^-6 of the largest
    # logit); the gradients of two small f32 MoE LMs (2 layers: top-2
    # "moe", and one [dense, MoE] group of top-1 "dense_moe" with a shared
    # expert; capacity 1.25 so that tokens drop) within rtol 1e-4 (atol
    # 1e-6 x the largest) of float64 on the CPU, the float64 run taking the
    # card's routing (each layer's selected experts, and so its keep
    # masks) as given; on a one-rank NCCL group, moe_fwd_sharded (plain,
    # fsdp, fsdp with the int8 gather) and moe_fwd_a2a bit for bit the
    # group-less mesh, outputs and gradients, and at (1, 1) moe_fwd_sharded
    # within 1e-6 of moe_fwd (of each tensor's largest magnitude)
    def moe_path():
        import dataclasses
        import torch.distributed as dist
        from repro_torch.configs import get_arch
        from repro_torch.configs.base import LMConfig
        from repro_torch.core.sharded_index import Mesh
        from repro_torch.data.lm_data import MarkovTokens
        from repro_torch.launch import steps
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import transformer as tr
        from repro_torch.models.layers import Axes
        from repro_torch.train.train_state import value_and_grad
        from repro_torch.tree import (flatten_with_names, leaves,
                                      module_tree, tree_map)
        check(not torch.backends.cuda.matmul.allow_tf32,
              "moe: fp32 products are not IEEE fp32")
        cells = (  # arch, cell, variant, timed runs, warm-up runs
            ("granite-moe-1b-a400m", "prefill_32k", "attn=blockwise,batch=1",
             2, 0),
            ("granite-moe-1b-a400m", "decode_32k", "batch=32", 10, 2),
            ("granite-moe-1b-a400m", "train_4k", "batch=4", 3, 0),
            ("llama4-maverick-400b-a17b", "prefill_32k",
             "nl=2,attn=blockwise,batch=1", 2, 0),
            ("llama4-maverick-400b-a17b", "decode_32k", "nl=2,batch=64", 10,
             2))
        moe_launches = collections.Counter()
        gen = torch.Generator(device=dev)

        def lm_cfg(arch, variant):
            return steps._apply_lm_variant(get_arch(arch).config, variant)

        def max_err(got, want):
            return float((got.double() - want.double()).abs().max())

        # 1. prefill and decode against forward at a capacity that drops
        # nothing (a call's capacity follows its token count)
        gate_errs, gate_s = {}, {}
        t0 = time.perf_counter()
        for arch, variant, f32 in (("granite-moe-1b-a400m", "cap=4", True),
                                   ("llama4-maverick-400b-a17b",
                                    "nl=2,cap=128", False)):
            cfg = lm_cfg(arch, variant)
            if f32:
                cfg = dataclasses.replace(cfg, compute_dtype="float32")
            model = tr.init_lm(gen.manual_seed(3), cfg, dev)
            tok = torch.from_numpy(MarkovTokens(cfg.vocab_size, seed=3)
                                   .sample(1, 2048)).to(dev)
            with torch.no_grad():
                full = tr.forward(model, tok, cfg)[0]
                cache = tr.init_cache(cfg, 1, 2049, torch.float32 if f32
                                      else torch.bfloat16, dev)
                pre, cache = tr.decode_step(model, cache, tok[:, :2048], 0,
                                            cfg, last_only=True)
                nxt, _ = tr.decode_step(model, cache, tok[:, 2048:], 2048,
                                        cfg)
            for tag, got, want in (("prefill", pre[:, 0], full[:, 2047]),
                                   ("decode", nxt[:, 0], full[:, 2048])):
                err = max_err(got, want)
                ok = bool(torch.allclose(got, want, rtol=2e-3, atol=2e-3)) \
                    if f32 else err <= 2.0 ** -6 * float(want.abs().max())
                check(ok, f"moe {arch} {tag} against forward: {err}")
                gate_errs[f"{arch} {tag}"] = err
            del model, full, cache, pre, nxt
            torch.cuda.empty_cache()

        gate_s["prefill_decode"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # 2. gradients of small f32 MoE LMs against float64 on the CPU, the
        # float64 run on the card's routing
        orig_top_k = moe_mod._top_k

        class Routes:
            """``moe._top_k`` on the card (``card`` None: each layer's
            experts recorded), or replaying the card's record: the
            probabilities at the card's experts, so that float64 routes as
            the card did (a probability within rounding of another's may
            rank otherwise in float64); ``flips`` counts the tokens whose
            own float64 choice differs."""

            def __init__(self, card=None):
                self.card, self.sel, self.flips = card, [], 0

            def __call__(self, probs, k):
                vals, ids = orig_top_k(probs, k)
                if self.card is None:
                    self.sel.append(ids)
                    return vals, ids
                ids_c = self.card.sel[len(self.sel)].to(probs.device)
                self.sel.append(ids_c)
                self.flips += int((ids != ids_c).any(-1).sum())
                return torch.gather(probs, -1, ids_c), ids_c

        grad_cfgs = {
            "moe top-2": LMConfig(
                name="grad-moe", n_layers=2, d_model=128, n_heads=4,
                n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=1000,
                moe=True, n_experts=8, top_k=2, capacity_factor=1.25,
                param_dtype="float32", compute_dtype="float32"),
            "dense_moe top-1 shared": LMConfig(
                name="grad-dense-moe", n_layers=2, d_model=128, n_heads=4,
                n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=1000,
                moe=True, moe_every=2, n_experts=8, top_k=1,
                shared_expert=True, capacity_factor=1.25,
                sliding_window=8, global_every=2,
                param_dtype="float32", compute_dtype="float32")}
        grad_rows = {}
        for tag, gcfg in grad_cfgs.items():
            g64cfg = dataclasses.replace(gcfg, param_dtype="float64",
                                         compute_dtype="float64")
            model = tr.init_lm(gen.manual_seed(5), gcfg, dev)
            m64 = tr.LM(g64cfg, tree_map(
                lambda t: t.detach().double().cpu().requires_grad_(),
                module_tree(model)))
            batch = steps.lm_tokens(gcfg, 4, 64, 5, dev)
            b64 = {k_: v_.cpu() for k_, v_ in batch.items()}
            card_routes, host_routes = Routes(), None
            try:
                moe_mod._top_k = card_routes
                loss, _, g = value_and_grad(lambda p, b_: tr.loss_fn(
                    p, b_, gcfg), model, batch)
                host_routes = moe_mod._top_k = Routes(card_routes)
                loss64, _, g64 = value_and_grad(lambda p, b_: tr.loss_fn(
                    p, b_, g64cfg), m64, b64)
            finally:
                moe_mod._top_k = orig_top_k
            check(len(host_routes.sel) == len(card_routes.sel),
                  f"moe grad gate {tag}: {len(card_routes.sel)} routings on "
                  f"the card, {len(host_routes.sel)} in float64")
            t_tok = 4 * 64
            cap = int(max(gcfg.top_k * gcfg.capacity_factor * t_tok
                          / gcfg.n_experts, 4))
            dropped = sum(int((moe_mod._position_in_expert(
                s_.reshape(-1), gcfg.n_experts) >= cap).sum())
                for s_ in card_routes.sel)
            check(dropped > 0, f"moe grad gate {tag}: no token dropped")
            check(abs(float(loss) - float(loss64)) <= 1e-4 * abs(
                float(loss64)), f"moe grad gate {tag}: loss {float(loss)} "
                                f"{float(loss64)}")
            top = max(float(w.abs().max()) for w in leaves(g64))
            worst = headroom = 0.0
            for (name, x), w in zip(flatten_with_names(g), leaves(g64)):
                x = x.double().cpu()
                check(bool(torch.allclose(x, w, rtol=1e-4, atol=1e-6 * top)),
                      f"moe gradient {tag} {name}: {max_err(x, w)}")
                worst = max(worst, max_err(x, w) / top)
                headroom = max(headroom, float(((x - w).abs() / (
                    1e-4 * w.abs() + 1e-6 * top)).max()))
            grad_rows[tag] = {"max_abs_err_over_top": worst,
                              "max_err_over_tolerance": headroom,
                              "slots_dropped": dropped,
                              "routings": len(card_routes.sel),
                              "float64_own_choice_differs":
                                  host_routes.flips}
            del model, m64

        gate_s["grad"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # 3. the expert-parallel paths on a one-rank NCCL group, bit for bit
        # the group-less mesh; at (1, 1) moe_fwd_sharded against moe_fwd
        t_l, d_l, f_l, e_l = 2048, 256, 512, 8
        lg = torch.Generator(device=dev).manual_seed(6)
        layer = moe_mod.init_moe(lg, d_l, f_l, e_l, torch.float32, True, dev)
        x_l = torch.randn(t_l, d_l, generator=lg, device=dev)
        ct_l = torch.randn(t_l, d_l, generator=lg, device=dev)

        def layer_run(path, kw, mesh):
            p_ = tree_map(lambda t: t.detach().clone().requires_grad_(),
                          layer)
            xx = x_l.clone().requires_grad_()
            if path == "local":
                out, aux = moe_mod.moe_fwd(p_, xx, n_experts=e_l, top_k=2,
                                           capacity_factor=1.25)
            elif path == "sharded":
                out, aux = moe_mod.moe_fwd_sharded(
                    p_, xx, n_experts=e_l, top_k=2, capacity_factor=1.25,
                    axes=Axes(("data",), "model", mesh), **kw)
            else:
                out, aux = moe_mod.moe_fwd_a2a(
                    p_, xx, n_experts=e_l, capacity_factor=1.25,
                    axes=Axes(("data",), "model", mesh), **kw)
            gs = torch.autograd.grad(torch.sum(out * ct_l) + 0.1 * aux,
                                     leaves(p_) + [xx])
            return [out.detach(), aux.detach()] + list(gs)

        ep_cases = (("sharded", {}), ("sharded", {"fsdp": True}),
                    ("sharded", {"fsdp": True, "gather_quant": True}),
                    ("a2a", {}))
        plain_mesh = Mesh((1, 1), device=dev)
        ep_rows = {}
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            nccl_mesh = Mesh((1, 1), device=dev, group=dist.group.WORLD)
            for path_, kw in ep_cases:
                name = path_ + "".join(f" {k_}" for k_ in kw)
                want = layer_run(path_, kw, plain_mesh)
                (got,), launches, ref_calls = counted(
                    torch, counters, lambda: (layer_run(path_, kw,
                                                        nccl_mesh),))
                require(launches, ref_calls, (), f"moe nccl {name}")
                check(all(torch.equal(a_, b_) for a_, b_ in zip(got, want)),
                      f"moe: the NCCL group computes otherwise ({name})")
                ep_rows[name] = "bit for bit"
            nccl_backend = dist.get_backend(dist.group.WORLD)
        finally:
            dist.destroy_process_group()
        local = layer_run("local", {}, None)
        sharded = layer_run("sharded", {}, plain_mesh)
        # each tensor (output, aux, gradients) within 1e-6 of its largest
        # magnitude: the two run their products on cap and cap + 1 slots
        one_cell_err = max(max_err(a_, b_) / float(b_.abs().max())
                           for a_, b_ in zip(sharded, local))
        check(one_cell_err <= 1e-6,
              f"moe: moe_fwd_sharded at (1, 1) against moe_fwd "
              f"{one_cell_err}")
        del layer, x_l, ct_l, local, sharded
        gate_s["expert_parallel"] = time.perf_counter() - t0
        emit({"phase": "moe", "card": smi, "gate_seconds": gate_s, "gates": {
            "prefill_decode_vs_forward_max_abs_err": gate_errs,
            "grad_vs_f64_on_card_routing": grad_rows,
            "nccl_one_rank_vs_groupless": ep_rows,
            "nccl_backend": nccl_backend,
            "sharded_1x1_vs_local_max_err_over_largest": one_cell_err}})
        torch.cuda.empty_cache()

        # 4. the cells
        lm_cell_rows("moe", cells, gen, moe_launches)
        return dict(moe_launches)

    launches_by_path["moe"] = moe_path()

    # ---- path: gnn (MACE through build_cell) -------------------------------
    # models/mace.py at the reference's full width (d_hidden 128, l_max 2,
    # correlation order 3, 15 paths, n_rbf 8, 2 layers), f32 with TF32 off,
    # on the default Mesh((1, 1)); plain PyTorch on the card, as the
    # reference's geometry, tensor products, scatters and readout are plain
    # XLA with no Pallas kernel.  Gates: the forward outputs and the
    # gradients of one step of molecule and full_graph_sm against the same
    # port function in float64 on the CPU (outputs rtol 1e-4 / atol 1e-5,
    # gradients rtol 1e-4 / atol 1e-6 x the largest); molecule's per-graph
    # energies unchanged by a seeded rotation and a translation of the
    # positions (rtol 2e-4 / atol 2e-5, tests/test_property.py's);
    # full_graph_sm at n_edge_chunks 4 equal to 1 within 1e-5 of each
    # tensor's largest magnitude, outputs and gradients; mace_fwd on
    # full_graph_sm's graph sorted for 4 shards on a group-less Mesh((4, 1))
    # equal to the local path (rtol 2e-4 / atol 2e-5,
    # tests/test_multidevice.py's); a one-rank NCCL group bit for bit the
    # group-less mesh under deterministic algorithms, outputs and
    # gradients; each cell's loss finite and falling on its one batch
    def gnn_path():
        import copy
        import torch.distributed as dist
        from repro_torch.configs import get_arch
        from repro_torch.core.sharded_index import Mesh
        from repro_torch.data.graph_data import sort_edges_for_mesh
        from repro_torch.launch import steps
        from repro_torch.models import mace as mace_mod
        from repro_torch.models.layers import Axes
        from repro_torch.train.train_state import TrainState, value_and_grad
        from repro_torch.tree import flatten_with_names, leaves, tree_map
        earlier = cuda_storages(torch)   # the earlier paths' tensors
        check(not torch.backends.cuda.matmul.allow_tf32,
              "gnn: fp32 products are not IEEE fp32")
        arch = get_arch("mace")
        by_name = {c.name: c for c in arch.cells}
        gnn_launches = collections.Counter()
        gen = torch.Generator(device=dev)
        plain = Mesh((1, 1), device=dev)
        axes = Axes(("data",), "model", plain)
        cpu_axes = Axes(("data",), "model", Mesh((1, 1), device="cpu"))

        def setup(cell):
            cfg, sizes, n_cls, _ = steps.gnn_cell_config(
                arch.config, by_name[cell], "base", 1)
            state, batch = steps.build_cell("mace", cell, device=dev
                                            ).make_args(gen.manual_seed(7))
            return cfg, sizes, n_cls, state.params, batch

        def fresh(params, dtype=None, device=None):
            return tree_map(lambda t: t.detach().to(
                device=device or t.device, dtype=dtype or t.dtype).clone()
                .requires_grad_(), params)

        def run(params, batch, cfg, sizes, n_cls, ax):
            """[loss, outputs..., gradients...] of the cell's loss and
            their names; ``run.n_out`` counts the loss and outputs."""
            loss, outs, g = value_and_grad(steps.gnn_loss(
                cfg, sizes, n_cls, ax, outputs=True), fresh(params), batch)
            named = ([("loss", loss)] + sorted(outs.items())
                     + flatten_with_names(g))
            run.n_out = 1 + len(outs)
            return [t for _, t in named], [n for n, _ in named]

        def err_over_largest(got, want):
            w = want.double().cpu()
            return float((got.double().cpu() - w).abs().max()
                         / w.abs().max().clamp_min(1e-30))

        gate_s, gates = {}, {}
        # 1. float64 on the CPU
        t0 = time.perf_counter()
        for cell in ("molecule", "full_graph_sm"):
            cfg, sizes, n_cls, params, batch = setup(cell)
            got, names = run(params, batch, cfg, sizes, n_cls, axes)
            b64 = {k: (v.double() if v.is_floating_point() else v).cpu()
                   for k, v in batch.items()}
            want, _ = run(fresh(params, torch.float64, "cpu"), b64, cfg,
                          sizes, n_cls, cpu_axes)
            n_out = run.n_out
            top = max(float(w.abs().max()) for w in want[n_out:])
            row = {}
            for i, (n, x, w) in enumerate(zip(names, got, want)):
                x = x.double().cpu()
                ok = (torch.allclose(x, w, rtol=1e-4, atol=1e-5) if i < n_out
                      else torch.allclose(x, w, rtol=1e-4, atol=1e-6 * top))
                check(bool(ok), f"gnn {cell} {n} against float64: "
                                f"{float((x - w).abs().max())}")
                row[n] = err_over_largest(x, w)
            gates[f"{cell} vs float64 (max err over largest)"] = {
                "outputs": {n: row[n] for n in names[:n_out]},
                "worst_gradient": max(row[n] for n in names[n_out:])}
        gate_s["float64"] = time.perf_counter() - t0

        # 2. rotation and translation (molecule)
        t0 = time.perf_counter()
        cfg, sizes, _, params, batch = setup("molecule")
        q, r_ = torch.linalg.qr(torch.randn(
            3, 3, dtype=torch.float64,
            generator=torch.Generator().manual_seed(11)))
        rot = q * torch.sign(torch.diagonal(r_))
        if torch.linalg.det(rot) < 0:
            rot[:, 0] = -rot[:, 0]

        def energies(pos):
            with torch.no_grad():
                return mace_mod.mace_fwd(
                    params, cfg, batch["species"], pos, batch["senders"],
                    batch["receivers"], edge_mask=batch["edge_mask"],
                    graph_ids=batch["graph_ids"], n_graphs=sizes.n_graphs,
                    axes=axes)["energy"]

        pos = batch["positions"]
        e0 = energies(pos)
        moved = {"rotated": (pos.double() @ rot.T.to(dev)).float(),
                 "translated": pos + torch.tensor([0.7, -1.3, 2.1],
                                                  device=dev)}
        for tag, p_ in moved.items():
            e1 = energies(p_)
            check(bool(torch.allclose(e1, e0, rtol=2e-4, atol=2e-5)),
                  f"gnn: energies {tag}: {float((e1 - e0).abs().max())}")
            gates[f"energy {tag} (max abs err)"] = float(
                (e1 - e0).abs().max())
        gates["largest |energy|"] = float(e0.abs().max())
        gate_s["invariance"] = time.perf_counter() - t0

        # 3. edge chunks (full_graph_sm): 4 against 1
        t0 = time.perf_counter()
        cfg, sizes, n_cls, params, batch = setup("full_graph_sm")
        one, names = run(params, batch, cfg, sizes, n_cls, axes)
        four, _ = run(params, batch, cfg, sizes._replace(n_edge_chunks=4),
                      n_cls, axes)
        errs = [err_over_largest(x, w) for x, w in zip(four, one)]
        check(max(errs) <= 1e-5, f"gnn: 4 edge chunks against 1: "
                                 f"{max(zip(errs, names))}")
        gates["chunks 4 vs 1 (max err over largest)"] = max(errs)
        gate_s["chunks"] = time.perf_counter() - t0

        # 4. the mesh path on full_graph_sm's graph sorted for 4 shards
        t0 = time.perf_counter()
        real = batch["edge_mask"] > 0
        s4, r4, m4 = (torch.from_numpy(a).to(dev) for a in sort_edges_for_mesh(
            batch["senders"][real].cpu().numpy(),
            batch["receivers"][real].cpu().numpy(), sizes.n_nodes, 4))
        graph = dict(species=batch["species"], positions=batch["positions"],
                     senders=s4, receivers=r4, edge_mask=m4,
                     node_feat=batch["node_feat"])
        with torch.no_grad():
            local = mace_mod.mace_fwd(params, cfg, **graph)
            mesh4 = mace_mod.mace_fwd(params, cfg, **graph, axes=Axes(
                ("data",), "model", Mesh((4, 1), device=dev)))
        for k in local:
            check(bool(torch.allclose(mesh4[k], local[k], rtol=2e-4,
                                      atol=2e-5)),
                  f"gnn: Mesh((4, 1)) {k} against the local path: "
                  f"{float((mesh4[k] - local[k]).abs().max())}")
        gates["mesh (4, 1) vs local (max err over largest)"] = {
            k: err_over_largest(mesh4[k], local[k]) for k in local}
        gates["mesh (4, 1) edges"] = int(s4.shape[0])

        # a one-rank NCCL group bit for bit the group-less mesh
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            want, _ = run(params, batch, cfg, sizes, n_cls, axes)
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                    world_size=1)
            try:
                group = Axes(("data",), "model", Mesh(
                    (1, 1), device=dev, group=dist.group.WORLD))
                (got, _), launches, ref_calls = counted(
                    torch, counters, lambda: run(params, batch, cfg, sizes,
                                                 n_cls, group))
                require(launches, ref_calls, (), "gnn nccl")
                nccl_backend = dist.get_backend(dist.group.WORLD)
            finally:
                dist.destroy_process_group()
            again, _ = run(params, batch, cfg, sizes, n_cls, axes)
        finally:
            torch.use_deterministic_algorithms(False)
        differ = [n for n, x, y in zip(names, got, want)
                  if not torch.equal(x, y)]
        check(not differ, f"gnn: the NCCL group computes otherwise: {differ}")
        gates["nccl one rank vs group-less"] = "bit for bit"
        gates["nccl_backend"] = nccl_backend
        gates["deterministic runs bit for bit"] = all(
            torch.equal(x, y) for x, y in zip(again, want))
        gate_s["mesh"] = time.perf_counter() - t0
        emit({"phase": "gnn", "card": smi, "gate_seconds": gate_s,
              "gates": gates})
        del params, batch, local, mesh4, graph, one, four, got, want, again
        torch.cuda.empty_cache()

        # 5. the cells: (cell, variant, timed runs, warm-up runs)
        cells = (("molecule", "base", 10, 3),
                 ("full_graph_sm", "base", 10, 3),
                 ("minibatch_lg", "graph_edges=11461589", 10, 3),
                 ("minibatch_lg", "graph_edges=11461589,ex=bf16", 10, 3),
                 ("ogb_products", f"nodes={OGB_NODES}", 3, 1))

        def gnn_cell(cell, variant, reps, warm, parked):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            prog = steps.build_cell("mace", cell, variant=variant, device=dev)
            t0 = time.perf_counter()
            state, batch = prog.make_args(gen.manual_seed(0))
            torch.cuda.synchronize()
            args_s = time.perf_counter() - t0
            start = TrainState(state.step.clone(), copy.deepcopy(
                state.params), tree_map(torch.clone, state.opt_state), None)
            cur, losses = [state], []

            def call():
                cur[0], m = prog.fn(cur[0], batch)
                losses.append(m["loss"])

            def drive():
                ms_ = time_ms(torch, call, reps, warm=warm)
                return ms_, idle_share(call, 2, top_ops=8)

            (ms, idle), launches, ref_calls = counted(torch, counters, drive)
            require(launches, ref_calls, (), f"gnn {cell} {variant}")
            timed.append(("mace", cell, variant, ms))
            gnn_launches.update(launches)
            peak = torch.cuda.max_memory_allocated()
            ls = [float(x) for x in losses]
            check(all(math.isfinite(x) for x in ls)
                  and statistics.mean(ls[-3:]) < ls[0],
                  f"gnn {cell} {variant}: losses {ls}")
            del cur[0], state

            def one_step(st):
                st = TrainState(st.step.clone(), copy.deepcopy(st.params),
                                tree_map(torch.clone, st.opt_state), None)
                prog.fn(st, batch)
                return st

            a_, b_ = one_step(start), one_step(start)
            differ = [n for (n, x), y in zip(flatten_with_names(a_),
                                             leaves(b_))
                      if not torch.equal(x, y)]
            meta = prog.meta
            emit({"phase": "gnn", "card": smi, "arch": "mace", "cell": cell,
                  "variant": variant, "n_layers": arch.config.n_layers,
                  "nodes": meta["n_nodes"], "edges": meta["n_edges"],
                  "params": meta["params_total"], "ms": ms,
                  "nodes_per_s": meta["n_nodes"] / ms * 1e3,
                  "edges_per_s": meta["n_edges"] / ms * 1e3,
                  "model_flops": meta["model_flops"],
                  "flops_share_of_fp32_peak":
                      meta["model_flops"] / (ms / 1e3) / FP32_FLOPS,
                  "peak_gb": peak / 1e9, "held_before_gb": held / 1e9,
                  "parked_on_host_gb": parked / 1e9,
                  "make_args_s": args_s, **idle, "losses": ls,
                  "two_runs_bit_for_bit": not differ,
                  "leaves_that_differ": differ})
            del prog, batch, start, a_, b_

        for cell, variant, reps, warm in cells:
            # ogb_products at 1/8 peaks near 68 GB: the ~8 GB the earlier
            # paths hold wait on the host meanwhile
            with parked_on_host(torch, earlier if cell == "ogb_products"
                                else []) as parked:
                gnn_cell(cell, variant, reps, warm, parked)
        torch.cuda.empty_cache()
        return dict(gnn_launches)

    launches_by_path["gnn"] = gnn_path()

    # ---- path: examples (the public surface end to end) ------------------
    # examples/quickstart_torch.py (rpf at L = 5, 20, 80 over 20,000
    # MNIST-like rows, tune on a held-out half, rpf+int8 with and without
    # waves, add / delete / upsert / compact, chi2), ann_serving_torch.py
    # (make_ann_server over 10,000 rows, 128 concurrent clients, an add
    # queryable at once, a delete and a background compaction while
    # serving) and two_tower_retrieval_torch.py (2,000 users, 20,000 items,
    # 200 AdamW steps, rpf over the unit item tower, ip at P = 8), each at
    # its full size on the card with the launches counted from zero around
    # it.  Gates: each example's own asserts (two-tower recall@20 >= 0.8
    # against exact MIPS); the kernels below must launch and no plain
    # version may run
    def examples_path():
        sys.path.insert(0, os.path.join(ROOT, "examples"))
        try:
            import ann_serving_torch
            import quickstart_torch
            import two_tower_retrieval_torch
        finally:
            sys.path.pop(0)
        ex_launches = collections.Counter()
        dev_args = ["--device", "cuda"]
        for name, mod, names in (
                ("quickstart", quickstart_torch,
                 ("forest_traverse", "fused_gather_topk",
                  "fused_gather_topk_int8", "fused_scan")),
                ("ann_serving", ann_serving_torch,
                 ("forest_traverse", "fused_gather_topk", "fused_scan")),
                ("two_tower_retrieval", two_tower_retrieval_torch,
                 ("forest_traverse", "fused_gather_topk"))):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                out, launches, ref_calls = counted(
                    torch, counters, lambda: mod.main(dev_args))
            wall = time.perf_counter() - t0
            require(launches, ref_calls, names, f"examples {name}")
            ex_launches.update(launches)
            row = {"phase": "examples", "card": smi, "example": name,
                   "wall_s": wall, "launches": launches,
                   "printed": said.getvalue().splitlines()}
            if name == "quickstart":
                rec = out["recall_by_trees"]
                check(rec[5] <= rec[20] <= rec[80] and rec[5] < rec[80],
                      f"examples quickstart: recall by L {rec}")
                row.update({k: out[k] for k in (
                    "recall_by_trees", "tuned", "int8_recall",
                    "int8_waves_recall", "int8_waves_trees_used",
                    "mutated", "compacted")})
            elif name == "ann_serving":
                check(out["batcher"]["requests"] == out["clients"],
                      f"examples ann_serving: {out['batcher']}")
                row.update(batcher=out["batcher"],
                           concurrent_ms=out["wall_ms"],
                           stats={k: out["stats"][k] for k in (
                               "n_live", "n_segments", "n_compactions")})
            else:
                row.update(losses_first_last=[out["loss"][0],
                                              out["loss"][-1]],
                           recall_at_20=out["recall"],
                           taste_hit=out["taste_hit"])
            emit(row)
        for name in ("forest_traverse", "fused_gather_topk",
                     "fused_gather_topk_int8", "fused_scan"):
            check(ex_launches[name] > 0, f"{name} never launched on examples")
        return dict(ex_launches)

    launches_by_path["examples"] = examples_path()

    # ---- phase: roofline (the dry run on meta beside the card's times) ---
    # every model cell timed above, at its cut, traced on the meta device
    # by launch/dryrun.py and put through roofline.py's H100 constants.
    # Gates: no cell's ideal time above 1.05 x its measured ms (no card
    # beats its roofline: a larger ideal means a wrong count or constant),
    # and for three cheap cells the dry run's argument bytes within 1% + 1
    # MB of the device memory make_args allocates on the card
    def roofline_phase():
        from repro_torch import roofline
        from repro_torch.launch import dryrun, steps
        t0 = time.perf_counter()
        rows = []
        for arch, cell, variant, ms in timed:
            rec = dryrun.run_cell(arch, cell, variant, save=False)
            t = roofline.roofline_terms(rec)
            row = {"phase": "roofline", "card": smi, "arch": arch,
                   "cell": cell, "variant": variant,
                   "compute_ms": t["compute_s"] * 1e3,
                   "memory_ms": t["memory_s"] * 1e3,
                   "ideal_ms": t["ideal_s"] * 1e3,
                   "bound_ms": t["bound_s"] * 1e3, "dominant": t["dominant"],
                   "measured_ms": ms, "ideal_over_measured":
                       t["ideal_s"] * 1e3 / ms,
                   "model_flops": t["model_flops"],
                   "counted_flops": t["counted_flops"],
                   "model_bytes": t["model_bytes"],
                   "trace_s": rec["trace_s"]}
            emit(row)
            rows.append(row)
            check(row["ideal_over_measured"] <= 1.05,
                  f"roofline {arch} {cell} {variant}: ideal "
                  f"{row['ideal_ms']} ms over measured {ms} ms")
        gen = torch.Generator(device=dev)
        byte_rows = []
        for arch, cell, variant in (("mace", "molecule", "base"),
                                    ("mind", "serve_p99", "base"),
                                    ("smollm-135m", "decode_32k", "batch=8")):
            want = dryrun.run_cell(arch, cell, variant, save=False)[
                "memory"]["argument_bytes"]
            prog = steps.build_cell(arch, cell, variant=variant, device=dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            args = prog.make_args(gen.manual_seed(0))
            torch.cuda.synchronize()
            grew = torch.cuda.memory_allocated() - before
            del args, prog
            torch.cuda.empty_cache()
            byte_rows.append({"arch": arch, "cell": cell,
                              "variant": variant, "dry_run_bytes": want,
                              "card_bytes": grew})
            check(abs(grew - want) <= 0.01 * want + 1e6,
                  f"roofline {arch} {cell}: the dry run's {want} argument "
                  f"bytes against {grew} allocated on the card")
        emit({"phase": "roofline", "card": smi, "cells": len(rows),
              "argument_bytes": byte_rows,
              "worst_ideal_over_measured": max(
                  r["ideal_over_measured"] for r in rows),
              "seconds": time.perf_counter() - t0})

    roofline_phase()

    # descent: bytes are 16 B per (tree, query, level reached) -- child_base,
    # feat, thresh, q[b, feat] -- plus the leaf's child_base and the output.
    # Its chains: one thread's P descents from the root (chain_levels_max,
    # how the kernel before this design walked them), and the least chain
    # these inputs need (least_chain_levels_max: the primary's levels plus
    # the deepest alternate's below its flip)
    trav_rows = []
    for cell, (f, th, cb, q, depth_cap) in (
            ("rpf_mnist784", (feat, thresh, child, queries, rc.max_depth)),
            ("rpf_iss595", (iss_feat, iss_index.forest.thresh,
                            iss_index.forest.child_base, iss_q,
                            iss_rc.max_depth))):
        dep = depth if cell == "rpf_mnist784" else node_depths(
            torch, cb, depth_cap)
        l_idx = torch.arange(f.shape[0], device=dev)[:, None, None]
        for p in PROBES:
            leaves = forest_traverse_hbm(f, th, cb, q, depth_cap, p).view(
                f.shape[0], -1, p)
            ok = leaves >= 0
            levels = torch.where(ok, dep[l_idx, leaves.clamp_min(0).long()],
                                 0)
            n_desc = int(ok.sum())
            nbytes = 16 * int(levels.sum()) + 4 * n_desc + 4 * leaves.numel()
            trav_rows.append({
                "cell": cell, "n_probes": p, "trees": f.shape[0],
                "queries": q.shape[0],
                "ms": time_ms(torch, lambda: forest_traverse_hbm(
                    f, th, cb, q, depth_cap, p), 25, flush),
                "plain_ms": time_ms(torch, lambda: ref.forest_traverse_ref(
                    f, th, cb, q, depth_cap, p), 5, flush),
                "bound_ms": nbytes / rate * 1e3, "bytes": nbytes,
                "mean_levels": float(levels[ok].float().mean()),
                "max_levels": int(levels.max()),
                "chain_levels_max": int(levels.sum(-1).max()),
                "least_chain_levels_max": int(least_chain_levels(
                    torch, cb, dep, leaves).max())})
    # the latency of one dependent load, the yardstick of the chain bounds:
    # one thread chases 4,096 hops scattered through a 64 MB array
    # (csrc/pointer_chase.cu, a kernel apart from A, so that the yardstick
    # does not move with A); the time over a 1-hop chase, per extra hop.
    # Flushed: from device memory; warm: from L2, what a level's node
    # record costs at best once the forest is cached.  A level of A needs
    # at least one such load, so its chain bounds are levels x the warm
    # latency.  The chase is long (~1 ms) because without a flush the start
    # event fires before the kernel is enqueued: the host's launch gap,
    # tens of microseconds that vary, must not weigh on the difference
    n_chain, hops = 1 << 24, 4096
    path = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      1 + torch.randperm(n_chain - 1, generator=gen,
                                         device=dev)[:hops]])
    chase_next = torch.zeros(n_chain, dtype=torch.int32, device=dev)
    chase_next[path[:-1]] = path[1:].int()
    chase_out = torch.empty(1, dtype=torch.int32, device=dev)
    chase = build.library("pointer_chase").pointer_chase

    def run_chase(n):
        build.check_launch(chase(chase_next.data_ptr(), n,
                                 chase_out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream),
                           "pointer_chase")

    t_long, t_short = (time_ms(torch, lambda n=n: run_chase(n), 25, flush)
                       for n in (hops, 1))
    per_level_us = (t_long - t_short) * 1e3 / (hops - 1)
    t_long, t_short = (time_ms(torch, lambda n=n: run_chase(n), 25)
                       for n in (hops, 1))
    per_level_l2_us = (t_long - t_short) * 1e3 / (hops - 1)
    for row in trav_rows:
        row["chain_bound_ms"] = row["chain_levels_max"] * per_level_l2_us / 1e3
        row["least_chain_bound_ms"] = (row["least_chain_levels_max"]
                                       * per_level_l2_us / 1e3)
    del chase_next

    # fused rerank: each valid slot reads its row once; ids, q, output once
    # (l2: 3 operations per element; chi2: CHI2_ISSUES issues per term)
    fused_rows = []
    iss_cand4 = dedup_cand(iss_index.forest, iss_q, iss_rc, 4)
    # stage 2 of rpf+int8: B over kernel C's shortlist of k' = 40 ids
    short = {p: fused_gather_topk_int8(queries, cand[p], qdb.q, qdb.scale, kp,
                                       "l2") for p in PROBES}
    for p in PROBES:
        digests["fused_gather_topk_int8"][
            f"timed l2 1024x{cand[p].shape[1]} k={kp}"] = digest(short[p])
    short = {p: short[p][1] for p in PROBES}
    # (the path's cells, then ISS-595 under l2 and MNIST-784 under chi2:
    # which of d = 595's scalar path and chi2's division costs the time;
    # and ISS-595 under chi2 on the dense rows)
    for cell, metric, q, rows, ids in (
            ("rpf_mnist784", "l2", queries, db, cand[1]),
            ("rpf_mnist784", "l2", queries, db, cand[4]),
            ("rpf_iss595", "chi2", iss_q, iss_db, iss_cand),
            ("rpf_iss595", "chi2", iss_q, iss_db, iss_cand4),
            ("rpf_iss595", "l2", iss_q, iss_db, iss_cand),
            ("rpf_iss595", "l2", iss_q, iss_db, iss_cand4),
            ("rpf_mnist784", "chi2", queries, db, cand[1]),
            ("rpf_iss595 dense", "chi2", iss_q, iss_dense, iss_cand),
            ("rpf_mnist784 / rpf+int8 stage 2 P=1", "l2", queries, qdb.fp,
             short[1]),
            ("rpf_mnist784 / rpf+int8 stage 2 P=4", "l2", queries, qdb.fp,
             short[4])):
        ids = ids.contiguous()
        valid = int((ids >= 0).sum())
        b, m = ids.shape
        d = rows.shape[1]
        nbytes = valid * d * 4 + b * m * 4 + q.numel() * 4 + b * K * 8
        ops_ = ((3 * valid * d, FP32_FLOPS) if metric == "l2" else
                (CHI2_ISSUES * valid * d, FP32_FLOPS / 2))
        if "stage 2" in cell:
            digests["fused_gather_topk"][f"timed {cell} {b}x{m} k={K}"] = \
                digest(fused_gather_topk(q, ids, rows, K, metric))
        fused_rows.append({
            "cell": cell, "metric": metric, "m": m, "valid_slots": valid,
            "ms": time_ms(torch, lambda: fused_gather_topk(
                q, ids, rows, K, metric), 25, flush),
            "plain_ms": time_ms(torch, lambda: in_slabs(
                torch, lambda lo, hi: ref.fused_gather_topk_ref(
                    q[lo:hi], ids[lo:hi], rows, K, metric), b, 256),
                5, flush),
            **bound(nbytes, *ops_)})
    # int8 rerank: each valid slot reads d + 4 bytes; dequantize, subtract,
    # multiply-add: 4 operations per element
    int8_rows = []
    for p in PROBES:
        ids = cand[p].contiguous()
        valid = int((ids >= 0).sum())
        b, m = ids.shape
        nbytes = valid * (db.shape[1] + 4) + b * m * 4 + queries.numel() * 4 \
            + b * kp * 8
        int8_rows.append({
            "m": m, "k_prime": kp, "valid_slots": valid,
            "ms": time_ms(torch, lambda: fused_gather_topk_int8(
                queries, ids, qdb.q, qdb.scale, kp, "l2"), 25, flush),
            "plain_ms": time_ms(torch, lambda: in_slabs(
                torch, lambda lo, hi: ref.fused_gather_topk_int8_ref(
                    queries[lo:hi], ids[lo:hi], qdb.q, qdb.scale, kp, "l2"),
                b, 256), 3, flush),
            **bound(nbytes, 4 * valid * db.shape[1])})

    # exact scans: each input read once; D does 2 B N d flops
    bq_, bn_, bd_ = queries.shape[0], db.shape[0], db.shape[1]
    for m in ("l2", "dot"):
        digests["matmul_topk"][f"timed {m} {bq_}x{bn_}x{bd_} k={K}"] = digest(
            matmul_topk(queries, db, K, m))
    # kernel D alone under l2: its C entry with |q|^2 and |c|^2 computed
    # outside the timed region (the wrapper's two torch.sum calls are the
    # rest of "ms")
    d_lib = build.library("scan_topk").scan_topk
    d_sq = (torch.sum(queries * queries, dim=1), torch.sum(db * db, dim=1))
    d_out = scan_outputs(queries, K)

    def d_kernel():
        build.check_launch(d_lib(
            queries.data_ptr(), db.data_ptr(), d_sq[0].data_ptr(),
            d_sq[1].data_ptr(), None, None, *(t.data_ptr() for t in d_out),
            bq_, bn_, bd_, K, MAX_SLICES, 0,
            torch.cuda.current_stream(dev).cuda_stream), "scan_topk")

    d_row = {
        "ms": time_ms(torch, lambda: matmul_topk(queries, db, K, "l2"), 10,
                      flush),
        "kernel_only_ms": time_ms(torch, d_kernel, 10, flush),
        "dot_ms": time_ms(torch, lambda: matmul_topk(queries, db, K, "dot"),
                          10, flush),
        "plain_ms": time_ms(torch, lambda: ref.matmul_topk_ref(
            queries, db, K, "l2"), 3, flush),
        "cublas_fp32_product_ms": time_ms(torch, lambda: queries @ db.T, 10,
                                          flush),
        **bound((bq_ + bn_) * (bd_ + 1) * 4 + bq_ * K * 8,
                2 * bq_ * bn_ * bd_)}
    # the bruteforce backend: kernel B's scan at M = N.  Its bound reads
    # each input once; each pair-element costs l2 an FADD and an FFMA: 3
    # flops over the fp32 peak, or 2 fp32 issues over the issue rate (half
    # the peak), the larger.  The gather at M = N (the earlier path, and
    # what the scan must equal) re-reads the rows for every query: were no
    # row reused, every pair would read its row from memory
    all_ids = torch.arange(bn_, dtype=torch.int32, device=dev).expand(
        bq_, -1).contiguous()
    brute_row = {
        "search_ms": time_ms(torch, lambda: bidx.search(
            queries, SearchParams(k=K)), 10, flush, warm=1),
        "scan_ms": time_ms(torch, lambda: fused_scan(queries, db, K), 10,
                           flush, warm=1),
        "gather_ms": time_ms(torch, lambda: fused_gather_topk(
            queries, all_ids, db, K), 3, flush, warm=1),
        "kernel_d_ms": d_row["ms"],
        "plain_ms": time_ms(torch, lambda: bidx.search(
            queries, SearchParams(k=K, mode="ref")), 1, flush, warm=1),
        **bound(bn_ * bd_ * 4 + bq_ * bd_ * 4 + bq_ * K * 8,
                3 * bq_ * bn_ * bd_),
        "issue_bound_ms": 2 * bq_ * bn_ * bd_ / (FP32_FLOPS / 2) * 1e3,
        "no_reuse_ms": bq_ * bn_ * bd_ * 4 / rate * 1e3}
    del all_ids

    ib, in_, id_ = iss_q.shape[0], iss_db.shape[0], iss_db.shape[1]
    # the share of terms whose q and c are both 0 (0 / 1e-12: the IEEE
    # division's slow path)
    # and of db elements that are 0 (kernel E's one-FADD case), and E's time
    # on the same shapes with the queries raised by 1e-3 and the rows by
    # 2e-3, so that no element is 0 (dense data).  E's bound (also
    # ``work_bound_ms``) counts the work this data needs (1 issue a term
    # whose row element is 0, CHI2_ISSUES for the others); the dense one
    # (CHI2_ISSUES every term, the bound of E's earlier row-lane layout)
    # stands beside it
    zero_terms = float(((iss_q == 0).sum(0).double()
                        * (iss_db == 0).sum(0).double()).sum())
    db_zeros = int((iss_db == 0).sum())
    iss_q_d, iss_db_d = iss_q + 1e-3, iss_db + 2e-3
    dense_ms = time_ms(torch, lambda: chi2_topk(iss_q_d, iss_db_d, K), 3,
                       warm=1)
    del iss_q_d, iss_db_d
    e_bytes = (ib + in_) * id_ * 4 + ib * K * 8
    e_work = bound(e_bytes,
                   ib * (db_zeros + CHI2_ISSUES * (in_ * id_ - db_zeros)),
                   FP32_FLOPS / 2)
    e_row = {
        "ms": e_ms,
        "zero_term_share": zero_terms / (ib * in_ * id_),
        "db_zero_share": db_zeros / (in_ * id_),
        "work_bound_ms": e_work["bound_ms"],
        "dense_bound_ms": bound(e_bytes, CHI2_ISSUES * ib * in_ * id_,
                                FP32_FLOPS / 2)["bound_ms"],
        "ms_no_zero_numerator": dense_ms,
        "sass_fp32_issues_per_nonzero_term": sass_per_chi2_term(
            build.library_path("chi2_topk")),
        "plain_ms": time_ms(torch, lambda: ref.chi2_topk_ref(
            iss_q, iss_db, K), 1, warm=0),
        "terms": ib * in_ * id_, "issues_per_nonzero_term": CHI2_ISSUES,
        **e_work}
    torch.cuda.synchronize()
    emit({"phase": "digests", "sha256_16": digests, "all": {
        name: hashlib.sha256(json.dumps(d, sort_keys=True).encode()
                             ).hexdigest()[:16] for name, d in digests.items()}})
    emit({"phase": "done", "wall_s": time.perf_counter() - wall0})

    def total(name):
        return sum(v.get(name, 0) for v in launches_by_path.values())

    def by_path(name):
        return {k: v[name] for k, v in launches_by_path.items() if name in v}

    t1, f1, c1 = trav_rows[0], fused_rows[0], int8_rows[0]
    tf1, g1, h1 = tree_rows[0], rerank_rows[0], bag_rows[-1]
    per_search = {n: launches_by_path["rpf"][n] / n_searches
                  for n in launches_by_path["rpf"]}
    emit({"kernels": [
        {"name": "forest_traverse", "route": "cuda",
         "source": "src/repro_torch/csrc/forest_traverse.cu",
         "replaces": "src/repro/kernels/forest_traverse_hbm.py:158",
         "launches": total("forest_traverse"),
         "launches_by_path": by_path("forest_traverse"),
         "launches_per_search": per_search["forest_traverse"],
         "max_abs_err": 0.0, "ms": t1["ms"], "plain_ms": t1["plain_ms"],
         "bound_ms": t1["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "latency_per_level_us": per_level_us,
         "latency_floor_ms": per_level_us * t1["max_levels"] / 1e3,
         "latency_per_level_l2_us": per_level_l2_us,
         "least_chain_levels_max": t1["least_chain_levels_max"],
         "least_chain_bound_ms": t1["least_chain_bound_ms"],
         "chain_bound_ms": t1["chain_bound_ms"],
         "shapes": trav_rows},
        {"name": "fused_gather_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_query.cu",
         "replaces": "src/repro/kernels/fused_query.py:146",
         "launches": total("fused_gather_topk"),
         "launches_by_path": by_path("fused_gather_topk"),
         "launches_per_search": per_search["fused_gather_topk"],
         "max_abs_err": fused_err, "ms": f1["ms"], "plain_ms": f1["plain_ms"],
         "bound_ms": f1["bound_ms"], "bound_by": f1["bound_by"],
         "library_ms": None, "shapes": fused_rows,
         "bruteforce": brute_row},
        {"name": "fused_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_scan.cu",
         "replaces": "src/repro/kernels/fused_query.py:146",
         "launches": total("fused_scan"),
         "launches_by_path": by_path("fused_scan"),
         "max_abs_err": max([brute_err["bruteforce"]]
                            + [e["bruteforce"] for e in any_err.values()]),
         "bitwise_vs_gather": True, "ms": brute_row["scan_ms"],
         "plain_ms": brute_row["plain_ms"],
         "bound_ms": max(brute_row["bound_ms"], brute_row["issue_bound_ms"]),
         "bound_by": "operations", "flop_bound_ms": brute_row["bound_ms"],
         "issue_bound_ms": brute_row["issue_bound_ms"],
         "gather_same_function_ms": brute_row["gather_ms"],
         "library_ms": None},
        {"name": "fused_gather_topk_int8", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_query_int8.cu",
         "replaces": "src/repro/kernels/fused_query_int8.py:152",
         "launches": total("fused_gather_topk_int8"),
         "launches_by_path": by_path("fused_gather_topk_int8"),
         "max_abs_err": int8_err, "ms": c1["ms"], "plain_ms": c1["plain_ms"],
         "bound_ms": c1["bound_ms"], "bound_by": c1["bound_by"],
         "library_ms": None, "shapes": int8_rows},
        {"name": "matmul_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/scan_topk.cu",
         "replaces": "src/repro/kernels/matmul_topk.py:79",
         "launches": total("matmul_topk"),
         "launches_by_path": by_path("matmul_topk"),
         "max_abs_err": max(d_err, brute_err["l2"], brute_err["dot"]),
         **d_row, "library_ms": None},
        {"name": "chi2_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/chi2_topk.cu",
         "replaces": "src/repro/kernels/chi2_topk.py:69",
         "launches": total("chi2_topk"),
         "launches_by_path": by_path("chi2_topk"),
         "max_abs_err": max(e_err, brute_err["chi2"]), **e_row,
         "library_ms": None},
        {"name": "forest_traverse_smem", "route": "cuda",
         "source": "src/repro_torch/csrc/forest_traverse_smem.cu",
         "replaces": "src/repro/kernels/forest_traverse.py:118",
         "launches": total("forest_traverse_smem"),
         "launches_by_path": by_path("forest_traverse_smem"),
         "max_abs_err": 0.0, "ms": tf1["ms"], "plain_ms": tf1["plain_ms"],
         "bound_ms": tf1["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "latency_floor_ms": per_level_us * tf1["max_levels"] / 1e3,
         "shapes": tree_rows},
        {"name": "distance_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/distance_topk.cu",
         "replaces": "src/repro/kernels/distance_topk.py:73",
         "launches": total("distance_topk"),
         "launches_by_path": by_path("distance_topk"),
         "max_abs_err": g_err, "ms": g1["ms"], "plain_ms": g1["plain_ms"],
         "bound_ms": g1["bound_ms"], "bound_by": g1["bound_by"],
         "library_ms": None, "shapes": rerank_rows},
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/csrc/embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag.py:54",
         "launches": total("embedding_bag"),
         "launches_by_path": by_path("embedding_bag"),
         "max_abs_err": h_err, "ms": h1["ms"], "plain_ms": h1["plain_ms"],
         "bound_ms": h1["bound_ms"], "bound_by": h1["bound_by"],
         "library_ms": h1["library_ms"],
         "latency_floor_ms": h1["latency_floor_ms"],
         "library": "torch.nn.functional.embedding_bag(mode='sum', "
                    "per_sample_weights=w)", "shapes": bag_rows},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
