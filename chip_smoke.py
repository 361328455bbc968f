#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``flechasdb_tpu_torch``) once on one
NVIDIA GPU and checks what comes out.

    python3 chip_smoke.py [--seed N]

Set-up: refuses to run without CUDA; prints the card's name and power
limit, the torch, CUDA and nvcc versions and both TF32 flags (set on,
as many applications set them: the port's cuBLAS ranking products must
still run in full f32, and K-B's 3xTF32 product does not read the flags;
every comparison below shows whether they hold); builds the kernels from
``flechasdb_tpu_torch/csrc`` and times the build; loads the host IO
runtime of the stored tier (``native/fastio.cc``, built with g++) and
prints which route runs: native, or Python's zlib, hashlib and numpy.

1. Kernel parity. Each hand-written kernel runs against its plain
   PyTorch version on the card at the main paths' shapes: K-A (ADC bucket
   scan) packed D=12, packed D=8 and unpacked C=200, and two tables of
   256 KB a cell, over a block's shared memory (D=256, C=256 packed and
   D=64, C=1024 unpacked) and GIST's packed D=60 (15 words a slot);
   ``adc_lookup`` (K-A over pre-gathered codes)
   at G=640, D=8, C=256, L=1280 unpacked; K-B
   (fused Lloyd round) at the coarse fit (B=1, N=100k, K=100, M=1536), the
   PQ fit (B=12, N=100k, K=256, m=128), K=1024, the SIFT coarse fit (B=1,
   N=1M, K=1024, M=128), the CLI's ``generate`` fits (coarse B=1, N=5000,
   K=10, M=1024; PQ B=8, N=5000, K=25, m=128) and duplicated centroids
   for the tie order; K-C
   (grouped Lloyd round) at the SIFT PQ shape (B=8, N=1M, K=256, m=16),
   GIST's division count with pad slots (B=60, N=100k, m=16), m=8, m=32
   and duplicated centroids, each also held to K-B's assignment on the
   ungrouped data (both rank with the same 3xTF32 tensor-core product in
   the same order, so the rows that differ are expected to be 0; the
   check allows near-ties). The fast_math variants of K-B and K-C (one
   bf16 tensor-core pass) against their plain fast versions: K-B fast
   (``csrc/lloyd_round_fast.cu``, ``wgmma`` fed by the TMA) at K-B's
   first four shapes, with duplicated centroids (copies of centroid 3 at
   7, 200 and K-1, other tiles) at the PQ shape and at K=1024, and at
   its edges: M=256 and M=264 (chunked, as every band over 128 columns;
   M=264 with K=257, past a tile pair), K=257 at M=128, and one row
   (N=1); its
   tiling (``ops.lloyd.fast_tiling``) is printed at each shape. K-C fast
   (``csrc/lloyd_grouped_fast.cu``: each grouped row read once by the
   TMA, a warp's own bf16 ``mma.sync`` on register fragments, the centroid
   fragments by ``ldmatrix``) at the SIFT PQ shape, m=8, m=32, m=64
   (K=300) and duplicated
   centroids, at K=256 and across tiles at K=1024 (copies of centroid 3 at
   7, 200 and 1023); its staging on the card bit-equal to
   ``stage_grouped_centroids``, its tiling (``ops.lloyd.
   grouped_fast_tiling``) printed, and at m >= 16 its picks equal to K-B
   fast's on the ungrouped data (0 rows may differ); ties measured on the
   bf16-rounded operands, sums against
   sums of the bf16-rounded x, which the sums of the f32 x must miss
   (where there are 1000 rows or more). Each Lloyd
   round is K-B's or K-C's assignment followed by the cluster-sum pass
   (``csrc/cluster_sums.cu``), which adds every sum in an order fixed by
   the assignment: each kernel is called twice on the same inputs and
   must return the same indices, sums and counts bit for bit; the counts
   must equal ``bincount``'s, and the sums must lie within SUM_RTOL /
   SUM_ATOL of the f64 sums and of the plain f32 ``index_add_``, except in
   one skewed K-B case at the SIFT coarse shape (over half the rows next
   to one centroid), whose serial f32 ``index_add_`` drifts past the
   tolerance by itself (both errors are printed). The kernels'
   ``ptxas`` registers and spills are printed for each K-C, K-B fast and
   K-C fast instance (the fast ones must not spill), with ptxas's
   performance warnings about the fast ones.
   K-B, K-C and plain times are CUDA-event means over back-to-back warm
   calls (median of five); at the SIFT PQ shape K-B is timed on the
   ungrouped data beside K-C; at each timed shape the cluster-sum pass
   is also timed alone as the rounds launch it (``_launch_sums``: no
   host sync in the timed call; CUDA events here, its device time in
   phase 10), with its plain version and ``index_add_``, and the route
   and tiling it took (``ops.lloyd.sum_tiling``) are printed. At K-B's
   PQ shape and K-C's SIFT PQ shape, full and fast, the dense route's
   sums and counts must equal ``cluster_sums_ordered``'s (its order in
   plain PyTorch) bit for bit. The pass's sort route, which takes the
   shapes above the dense route's K limit, is held at K=8192, N=50k,
   M=8, full and fast: two calls bit-equal, counts ``bincount``'s, sums
   within the tolerance of the f64 sums. The Deep10M path's shapes
   (phase 9), whose tilings (``sum_tiling``, ``fast_tiling``) are printed:
   K-B and K-B fast at the capped coarse fit (B=1, N=2,097,152, K=4096,
   M=96; the pass's dense route at S=8), at the PQ fit (B=8, N=1,048,576,
   K=256, m=12: 12 does not divide 128, so K-B and not K-C) and at
   K=4096 with copies of centroid 3 at 7, 200 and 4095 (N=65,536), two
   calls bit-equal, and at the first two the dense route's sums and
   counts equal to ``cluster_sums_ordered``'s. The GIST path's shapes
   (phase 13), full and fast, timed, the pass's sums and counts equal to
   ``cluster_sums_ordered``'s: K-B at the coarse fit (B=1, N=1M, K=1024,
   M=960; K-B fast's chunked bands) and K-C at the PQ fit (B=60, N=1M,
   K=256, m=16: the last of 8 groups holds 4 pad divisions), each K-C
   also held to K-B's picks on the ungrouped data. The probed
   partitions' L2 tables (``csrc/probed_tables.cu``, through
   ``ops.bucketed.probed_tables``) against the plain formula
   (``l2_tables_plain``) at both serving cells' shapes, GIST1M's (B=1000,
   nprobe=10, D=60, C=256, 16 dimensions a division, P=1024) and
   Deep10M's (B=200, nprobe=32, D=8, 12 a division, P=4096), the probes
   the first nprobe of a stable sort of random scores: within rel 1e-4
   and an abs 1e-4 of the largest entry. K-A and the tables are only
   checked here and timed in phase 10.
2. The headline slice. ``DatabaseBuilder(x, device="cuda")`` over
   bench.py's data (100,000 x 1536 unit rows; P=100, D=12, C=256), then
   ``query_batch`` over 64 queries and ``query`` over 8, k=10, nprobe=5.
   The results must agree with the same database queried on the CPU,
   where the plain versions run (rows up to distance ties, distances
   within rel 1e-4, abs 1e-5), and the build must have quantized well.
3. The SIFT1M-shaped path. 1,000,000 x 128 GMM rows and 1,000 queries
   (256 components, intrinsic 12; numpy, from the seed), built with P=1024,
   D=8 (m=16, so the PQ fit takes K-C) and C=256; all 1,000 queries at
   k=10, nprobe=10, without and with exact rerank of the top 100, through
   ``DeviceIndex(layout="bucketed")``'s ``query`` and ``query_rerank``,
   as the JAX package's sweep serves this configuration. Quality against
   exact ground truth on the card: recall@10, coarse@10 (the share of true
   neighbours whose partition was probed) and recall@10 after rerank.
   Then ``Database.query_batch``, which serves from the layout the
   card's policy picks for this skewed corpus (bucketed), is timed with
   and without rerank. 64 of the queries, from the bucketed index and
   from ``query_batch``, must agree with the CPU plain path (the policy's
   layout), with and without rerank, and a masked ``DeviceIndex`` with
   the bucketed one; the masked layout's time for all 1,000 queries and
   its peak device memory, which must stay within its budget, are
   printed.
4. Filters, range search and updates, on phase 2's database and phase
   3's bucketed SIFT index. Filters: ``tenant`` (row % 10, uint64) and
   ``lang`` (one of four strings, from the seed) set on every row through
   ``set_attribute_at``; four filters (10%, about 2.5%, an ``In | Range``
   and one that matches nothing) through ``query_batch(where=)`` with and
   without rerank and ``query(where=)``, each result checked against the
   filter's mask computed apart in numpy, against the CPU plain path, and
   the masked layout against the bucketed one under the same ``row_mask``;
   each filter's warm times and its column cache's first-use cost.
   Range: ``DeviceIndex.query_range`` of the 64 queries (radius the median
   midpoint of the 10th and 11th distances) against the CPU path and the
   masked layout, each query's ``query_range(limit=10)`` against its own
   top-10 under the radius, a filtered ``Database.query_range``, and 1000
   SIFT queries on buckets at nprobe=10 (64 against the CPU path). A
   row may fall on the other side of the radius, or of a full limit, only
   within the tolerance of it. Updates: ``add_vectors`` of 10,000 unit
   rows; each of 64 finds itself in its top 10, results equal to the CPU
   path after the add; ``encode`` of 10,000 built rows (the rows that
   differ from the build's assignment are printed); ``remove_vectors`` of
   the 10,000 gives back the build's host arrays and phase 2's results.
5. The stored tier, on phase 2's database (its arrays the build's again,
   with phase 4's ``tenant`` and ``lang`` on every row) and phase 3's.
   Headline: ``save_database`` into a temporary ``LocalFileSystem``, then
   ``load_database`` -> ``to_database()`` saved again into another
   directory: the same root and every file byte-equal. ``load_database(
   device="cuda")``; the 8 single queries cold (the host scan), each equal
   to phase 2's ``Database.query`` (rows up to ties, distances within the
   tolerance), never more partitions loaded than the queries probed, and
   each result's ``tenant`` and ``lang`` read back. ``preload()`` (a
   bucketed index on the card), then ``query_batch`` of the 64: every row
   and distance bit-equal to phase 2's; a filtered ``query_batch`` against
   numpy's mask and the in-memory database; ``query_range`` of the 64
   against ``DeviceIndex.query_range`` on the in-memory database. A copy
   of the tree with one byte of a partition file changed (its zlib
   header's level hint, so the stream still inflates) raises
   ``VerificationFailure`` when that partition loads. SIFT: save, load, 8
   cold queries at nprobe=10 (at most 10 partitions loaded a query),
   ``preload()`` (the card's policy: buckets, K-A) and the 1,000
   queries against phase 3's ``Database.query_batch``. Golden:
   ``tests/fixtures/goldendb`` (read-only) on the card, cold and after
   ``preload``, against its recorded results. The times printed: save,
   tree bytes, root load, cold queries, ``preload``, warm ``query_batch``
   and ``query``, and the SIFT save and ``preload``.
6. Fast-math training and OPQ, at full width. First one Lloyd round
   from phase 2's centroids, fast against full: the share of equal picks
   at the coarse fit (at least 0.95) and at the PQ fit. Then, with the
   launch counts zeroed: ``with_fast_math()`` at the headline shape
   (phase 2's seed; K-B fast at B=1, K=100, M=1536 and at B=12, K=256,
   m=128), whose recall@10 over 1,000 headline queries (k=10, nprobe=5)
   must come within 0.02 of phase 2's build and its PQ inertia within 5%;
   ``with_fast_math()`` at the SIFT shape (K-B fast at K=1024, K-C fast at
   m=16): recall@10 at nprobe=10 within 0.02 of phase 3's, coarse@10 at
   least 0.95; and the JAX package's ``sift-opq`` configuration
   (``benchmarks/sweep.py:79-130``): phase 3's data, ``with_opq(6)``, full
   precision (K-B coarse, K-C in every inner PQ fit), whose coarse fit
   (partition centroids and indices) and vector ids must equal phase 3's
   bit for bit (the same data and seed), whose rotation must
   be orthogonal within 1e-4, whose quantization error must not exceed
   that of phase 3's PQ configuration fitted on the same residuals (after
   the phase's launch counts are read), and whose 1,000 queries through
   ``DeviceIndex(layout="bucketed", rotation=R)`` (K-A on rotated tables)
   must reach phase 3's recall less 0.02 and agree with the CPU path (64)
   and the masked layout (1,000). Its tree (with ``rotations/``) is saved
   and loaded: 8 cold queries equal to the in-memory ones, then
   ``preload`` and ``query_batch(1000)`` bit-equal to the in-memory
   database's; ``add_vectors`` of 10,000 rows and a query after it (16
   against the CPU path). Each build's time and its fits' (the device
   synchronized at the events), the OPQ fit's parts (PQ fits, rotations,
   reconstructions, Gram, host SVD) and the phase's launches are printed;
   each fast kernel, K-B, K-C and K-A must have launched.
7. The async tier, the flat tier and the CLI, on the trees that phases 5
   and 6 saved. Async: 8 cold queries at nprobe=10 on the SIFT tree
   through ``asyncdb.AsyncLocalFileSystem``, then again warm, every row
   and distance bit-equal to the sync tier's cold queries on the same tree
   and equal to phase 3's bucketed K-A results up to ties (the partition
   files open at once are counted); 8 cold ``query(where=)`` on the
   headline tree with phase 4's attributes, bit-equal to the sync tier's,
   with ``tenant`` and ``lang`` read back through ``get_attribute``;
   ``asyncdb.save_database`` of phase 2's database: the sync save's root
   and every file byte-equal; 8 cold queries on the SIFT-OPQ tree (the
   rotation read), bit-equal to the sync tier's. Flat:
   ``FlatDatabase(x, device="cuda")`` over the SIFT corpus (1M x 128, 512
   MB) and the headline corpus (100,000 x 1536, 614 MB), each with 1,000
   queries at k=10 (phase 3's; the headline's those of phase 6), equal to
   the exact ground truth up to ties and, for 64 queries, to the CPU plain
   path; ``exact_topk``'s device time (CUDA events) beside its bound (the
   corpus read once, 2·B·N·M fp32 operations); a filtered batch and 8
   ``query_range`` calls at the headline against the CPU path; the SIFT
   corpus saved (``save_flat_database``), loaded onto the card, preloaded
   and queried, bit-equal to the in-memory batch, and through
   ``load_flat_database_async``. The async and flat parts must launch no
   kernel (the async tier scans on the host, the flat tier ranks on
   cuBLAS). CLI: ``main(["generate", db], device="cuda")`` in this
   process, its launch counts zeroed just before it and read just after
   (K-B must have built and K-A queried); K-A then held against its plain
   version at the saved tree's buckets (preloaded) and one query's
   tables; ``verify`` and ``gc --dry-run`` through ``main`` too, and
   ``python -m flechasdb_tpu_torch load`` in a subprocess (the module
   entry), each exiting 0 with its expected lines.
8. The f64 build: ``DatabaseBuilder(x, np.float64, device="cuda")`` over
   the first F64_N rows of phase 3's data cast to f64 (P=100, D=8,
   C=256; cut from 100,000 rows so that the host oracle keeps the phase
   within a minute), trained on the host by the numpy oracle (no
   kernel), then phase 3's 1,000 queries at k=10, nprobe=10 through
   ``Database.query_batch`` on the card (the card's policy's layout) and
   through ``DeviceIndex(layout="bucketed")``
   (K-A, which must launch), both equal to the same database served on
   the CPU up to ties; 64 corpus rows must find themselves first
   (``rerank=100``); the build time and recall@10 against exact ground
   truth are printed.
9. The Deep10M shape: the JAX package's scale-up
   (``benchmarks/deep10m.py:31-165``), nothing cut. 10,000,000 x 96 f32
   rows and 200 queries drawn on the card by ``synth.gmm_pair_device``
   (1024 components, intrinsic 12), the earlier phases' device tensors
   freed first; the exact top 10 of each query on the card
   (``ops.exact.exact_topk``). ``parallel.build.build_staged(x, 4096, 8,
   256, seed)`` twice, with the launch counts zeroed before: the arrays
   bit-equal, K-B launched with one cluster-sum pass a round (the coarse
   fit on the 2,097,152-row cap, one final K-B round over all rows, the
   PQ fit on 1,048,576 residuals at m=12), the second call's parts timed
   at its events (the card synchronized there): coarse seeding, coarse
   rounds, the final assignment, sample residuals, the PQ fit,
   ``_encode_chunked``; the final assignment's round then timed alone;
   10,000 rows' partitions and codes equal to ``ops.encode.encode``'s up
   to near-ties. Serving: ``ops.bucketed.bucketize`` (packed), then
   ``query_bucketed`` at nprobe 8, 32 and 128 in query chunks sized as
   the JAX script sizes them (K-A), recall@10 not falling as nprobe
   grows, the bucket stats and the batch times; 64 queries at nprobe=32
   equal to the CPU plain path on the same buckets. The rerank row
   (``benchmarks/deep10m.py:167-214``): ``DeviceIndex.query_rerank`` of
   the 200 queries at nprobe=32 with the top 100 re-scored against the
   corpus on the card, recall@10 at least 0.95 and at least the ADC
   recall, printed beside the JAX record (0.990), 64 equal to the CPU
   plain path on the same buckets and the host copy of the corpus. The
   bucketed top-k (``csrc/bucketed_topk.cu``), which every bucketed
   query above ran (its launches counted with the path's): on the K-A
   keys of the 200 queries at nprobe=32 (``ops.bucketed._probe_scan`` on
   the same buckets: ``vdist [6400, 12,288]``, the cells' lengths and
   buckets), ``ops.topk.bucketed_topk`` must equal
   ``bucketed_topk_plain`` (the stable sort and its index arithmetic)
   bit for bit in values, flat indices and rows, at kk=10 and kk=100. The
   streamed build: that host copy behind a read counter,
   ``StreamingDatabaseBuilder(src, device="cuda")`` with the same P, D,
   C and seed: one gather of at most 2,097,152 sorted unique rows, then
   the encode chunks of at most ``CHUNK_BYTES // (4·96)`` rows in order;
   its parts timed (``_make_uuids``, the gather, both fits, the encode
   stream); ``Database.query_batch`` of the 200 queries at nprobe=32 on
   the policy's layout, recall@10 within 0.03 of the staged build's, 64
   equal to the CPU path; ``rerank=`` and ``reconstruct`` raising
   ``InvalidArgs``. The data's, the builds' and the streamed leg's peak
   device memory is printed.
10. K-A's times and the cluster-sum pass's, after the paths, so that
   ``torch.profiler`` has not run in the process while they were timed.
   The pass: its device time a call at each of phase 1's timed shapes
   (``torch.profiler``'s CUDA activity for its kernels over back-to-back
   calls), split over its kernels. The assignment kernels alone: K-B
   fast's at its four timed shapes, K-C's and K-C fast's at the SIFT PQ
   shape: the device time of one ``assign_fast_kernel``,
   ``grouped_round_kernel`` or ``grouped_fast_assign`` launch
   (``torch.profiler`` over back-to-back calls of ``ops.lloyd.
   _assign_fast``, ``_assign_grouped`` or ``_assign_grouped_fast``; the
   fast ones stage the centroids and launch it), against its bound (x and
   the centroids read once, idx written, 2·B·N·K·M operations at the TF32
   or bf16 rate). K-A: at phase 1's six shapes and at
   each path's own buckets and query tables (checked against the plain
   version at the end of each path; phase 4's are the buckets after the
   add, phase 5's those of the preloaded stored database, phase 6's the
   SIFT-OPQ buckets with their rotated tables, phase 7's the CLI's,
   phase 8's the f64 build's, phase 9's the Deep10M staged build's,
   phase 12's the MIPS buckets with their dot tables, phase 13's the
   GIST buckets). The bucketed top-k on phase 9's keys at kk=100: the
   device time of a call (both kernels, ``topk_cells_kernel`` and
   ``topk_merge_kernel``) as K-A's, cold and warm; the stable sort's and
   one ``torch.topk`` call's CUDA-event times beside it. The tables
   kernel at phase 1's two shapes: the device time of a
   ``probed_tables_kernel`` launch as K-A's, cold and warm, beside the
   plain formula's CUDA-event time.
   K-A's calls
   last microseconds, less than the host's time to issue one, so its time
   is the device's: the profiler's CUDA activity for the kernel, a
   launch, each call after a read of 256 MiB that evicts its inputs from
   the 50 MB L2 (``ms``), and over back-to-back calls whose inputs the
   call before left in L2 (``warm_ms``). The host time per back-to-back
   call (host clock, ended by a synchronize) is printed beside them; the
   plain version's is a CUDA-event mean, as in phase 1.
11. The sharded paths (``flechasdb_tpu_torch.parallel``), run after
   phase 8 while phases 3, 5 and 7 hold their state. (a) A world of one
   over NCCL in this process (the group's first collective timed apart):
   ``build_sharded`` at the headline and SIFT shapes bit-equal to
   ``parallel.build._build_fn`` with the same seed, the sharded/unsharded
   time printed; ``ShardedIndex`` on both layouts against phase 3's
   bucketed results for the 1000 SIFT queries, and 64 ``query_range``s
   against ``DeviceIndex.query_range``; ``preload(mesh=)`` of phase 5's
   stored headline and SIFT databases (both bucketed) and of both
   flat tiers at the SIFT corpus against phases 5 and 7; the
   ``with_mesh`` streamed build at the SIFT shape against the unsharded
   one (0 rows may differ). (b) A gloo world of two worker processes of
   this script (``--rank``, ``--world``, ``--work``), both on
   ``cuda:0``: two same-seed SIFT builds bit-equal, both ranks' arrays
   equal, recall@10 within 0.01 of phase 3's, the share of partition
   indices equal to (a)'s printed, ``ShardedIndex(layout="bucketed")``
   of phase 3's arrays equal to (a)'s, the ``with_mesh`` streamed build
   with each chunk split across the ranks (both ranks' codes equal, 0
   rows differing from an unsharded streamed build); no jax imported. A
   worker's failure or timeout fails the run. Every sharded call of the
   phase runs after its unsharded reference and is counted alone: each
   build must launch K-B and the pass (and K-C at the SIFT shape), each
   bucketed query batch K-A.
12. The ``dot`` and ``cosine`` metrics at the SIFT shape, run after phase
   11 on phase 3's data and state. MIPS (``benchmarks/sweep.py:194-270``):
   ``with_metric("dot")`` with phase 3's P, D, C and seed, every array
   and id bit-equal to phase 3's build and its launches the same
   (training is L2 for every metric); exact MIPS ground truth by
   ``ops.exact.exact_topk(metric="dot")`` on the card, 64 queries of it
   held to float64 inner products; ``DeviceIndex(layout="bucketed",
   metric="dot")`` (K-A on the MIPS tables) at nprobe 1, 5, 10 and 50 and
   with ``query_rerank(100)`` at nprobe 5 and 10: recall@10, coarse@10
   and the batch times, rerank at nprobe 10 at least 0.9 and at least the
   ADC recall; ``Database.query_batch`` on the policy's layout;
   64 queries of each layout, with and without rerank, and 64 range
   searches (a negative inner-product radius) on each, against the CPU
   plain path. Its tree: the root's metric ``dot``, 8 cold queries (no
   kernel) equal to the in-memory database's, ``preload()`` on buckets
   (the policy held to bucketed, :func:`layout_policy`) and
   ``query_batch(1000)`` through K-A bit-equal to the in-memory database
   on buckets, ``publish_label`` → ``resolve_label`` → ``load_labeled``
   (``examples/query_metric.py``). Cosine (``examples/query_metric.py:
   27-40``): ``with_metric("cosine")`` over the same non-unit rows,
   ground truth ``exact_topk`` over the normalized corpus, recall@10 on
   both layouts with and without rerank, 64 queries of each equal to the
   CPU path; ``FlatDatabase(metric="cosine")`` on the card equal to the
   ground truth up to ties (no kernel); a zero query raising the JAX
   package's ``InvalidArgs`` on the in-memory, flat, cold stored and
   preloaded stored surfaces; the tree saved and loaded with its metric,
   8 cold queries, ``preload`` and 1000 queries equal to the in-memory
   database's. Each leg is counted alone: each build must launch K-B,
   K-C and one pass a round, each bucketed batch K-A.
13. The GIST1M shape (``benchmarks/sweep.py:272-309``), nothing cut, run
   after phase 9 has freed its corpus: 1,000,000 x 960 rows and 1000
   queries drawn on the card by ``synth.gmm_pair_device`` (256
   components, intrinsic 32), copied to the host once; exact ground
   truth by ``exact_topk`` at M=960. ``DatabaseBuilder(x, device="cuda")
   .with_partitions(1024).with_divisions(60).with_clusters(256)
   .with_residues(False)`` twice with one seed: the arrays and ids
   bit-equal, the second's parts timed at its events (UUIDs, upload,
   coarse seeding, coarse rounds on K-B at M=960, K=1024, division, PQ
   seeding, PQ rounds on K-C at B=60, copy-out), the rounds a fit and the
   builds' peak device memory printed; then ``with_fast_math()`` (K-B
   fast, K-C fast): its recall@10 within 0.02 of the full build's and its
   PQ inertia within 5%. Each build must launch its two kernels and one
   pass a round, and not the other numerics'. Serving the full build:
   ``DeviceIndex(layout="bucketed")`` (packed, 15 words a slot; K-A) at
   nprobe 1, 5, 10 and 50 and ``query_rerank`` of the top 100 at
   nprobe 10 against the corpus on the card (at least 0.9 and at least
   the ADC recall): recall@10, coarse@10, the batch times and the
   batches' peak device memory; 64 queries with and without rerank equal
   to the CPU plain path on the same buckets and the host corpus;
   ``Database.query_batch`` on the policy's layout, 64 equal to the
   buckets'.

Launch counts are zeroed just before each path (the build and its
queries, phases 4, 5, 6, 7, 8, 9, each sharded call of 11 and each leg
of 12 and 13) and read just after; every kernel a
path runs must have run, and every Lloyd round must have been followed
by one cluster-sum pass. The line before the last is the kernels' JSON
record: a row per TPU kernel of the JAX package, one for the
cluster-sum pass (the sum halves of the two Lloyd kernels; its
``library_ms`` is ``index_add_`` of the same sums), and one for the
bucketed top-k, which replaces no TPU kernel (its ``library_ms`` is
``torch.topk`` of kk over every slot, which keeps no order among equal
keys; its ``overhead_bytes``, the stage-1 candidates written and read
back, are left out of its bound), and one for the tables kernel, which
replaces none either (GIST1M's shape, Deep10M's under ``deep10m``; its
``library_ms`` is the plain formula's time, the PyTorch the port ran
before it), with its
counterpart's launches over the paths (phases 2 to 9 and 11 to 13, the
two ranks of phase 11 included), its time
(``ms_by`` names the method; K-A's rows
also carry ``warm_ms`` and ``host_ms``; K-B fast's, K-C's and K-C fast's
``assign_ms`` and ``assign_bound_ms``, the assignment alone at K-B's PQ
shape and K-C's SIFT PQ shape; K-B's and K-B fast's ``deep10m``, their
rounds at phase 1's Deep10M shapes beside their bounds and the pass's
device time there, and K-B's final assignment round of phase 9; the four
Lloyd rows' ``gist``, the round at their GIST shape of phase 1, the pass's
device time there and, but for K-B, the assignment alone, beside their
bounds), its plain version's and its
bound from this run's inputs: the larger of bytes over 3.35 TB/s and
operations over the rate of the units the kernel runs on, the H100 SXM's
published peaks (K-B, K-C: TF32 tensor cores, 494.7 TFLOP/s; their
fast_math variants: bf16 tensor cores, 989.4 TFLOP/s; K-A: fp32, 67
TFLOP/s; the top-k: bytes alone, the live keys, the cells' lengths and
buckets read, the rows gathered and the outputs written; the tables as
``portbench/roofline/tables.py`` reckons them: each table written once,
the probed centroids (each at most once), queries and codebooks read
once, 2·cells·C·M operations at the fp32 rate). The
operations are those the function needs (2·B·N·K·M for a
Lloyd round), not those of a route: the 3xTF32 product issues three times
as many.
The last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero with no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N, M, P, D, C = 100_000, 1536, 100, 12, 256
K_TOP, NPROBE, N_BATCH, N_SINGLE = 10, 5, 64, 8
SIFT_N, SIFT_NQ, SIFT_M, SIFT_P, SIFT_D = 1_000_000, 1000, 128, 1024, 8
SIFT_NPROBE, RERANK, N_CHECK = 10, 100, 64
N_ADD, LANGS = 10_000, ("en", "es", "ja", "pt")
RTOL, ATOL = 1e-4, 1e-5          # the query path's parity tolerance
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3  # Lloyd sums: f32, in another fixed order
TIE_REL = 1e-5                   # Lloyd picks may differ only this close
FP32_FLOPS, HBM_BYTES = 67e12, 3.35e12   # H100 SXM published peaks
L2_FLUSH_BYTES = 256 << 20                # over the H100's 50 MB of L2
TF32_FLOPS = 494.7e12                     # H100 SXM dense TF32
BF16_FLOPS = 989.4e12                     # H100 SXM dense bf16
OPQ_ITERS = 6                    # benchmarks/sweep.py's sift-opq config
CLI_N, CLI_M, CLI_P, CLI_D, CLI_C = 5000, 1024, 10, 8, 25  # __main__.py's
CLI_NPROBE = 3
N_RECALL = 1000                  # headline queries for recall
# The f64 build: phase 3's first rows, cut from 100,000 so that the host
# oracle (numpy, up to 100 rounds a fit) keeps phase 8 within a minute.
F64_N, F64_P = 20_000, 100
# Phase 9: the JAX package's Deep10M scale-up (benchmarks/deep10m.py:31-165),
# nothing cut; the coarse and PQ fits' capped samples (parallel/build.py's
# COARSE_TRAIN_CAP, PQ_TRAIN_CAP) are phase 1's shapes too.
DEEP_N, DEEP_NQ, DEEP_M, DEEP_P, DEEP_D = 10_000_000, 200, 96, 4096, 8
DEEP_NPROBES, DEEP_NPROBE, DEEP_CHECK = (8, 32, 128), 32, 10_000
DEEP_COARSE_N, DEEP_PQ_N = 2 << 20, 1 << 20
DEEP_RERANK_RECORD = 0.990       # the JAX record (benchmarks/RESULTS.md:209)
# Phase 12: benchmarks/sweep.py:248-270's MIPS rows on phase 3's data,
# (nprobe, rerank depth or None).
MIPS_ROWS = ((1, None), (5, None), (10, None), (50, None), (5, RERANK),
             (10, RERANK))
# Phase 13: the JAX package's GIST1M shape (benchmarks/sweep.py:272-309),
# nothing cut.
GIST_N, GIST_NQ, GIST_M, GIST_P, GIST_D = 1_000_000, 1000, 960, 1024, 60
GIST_NPROBES, GIST_NPROBE = (1, 5, 10, 50), 10

SRC_A = "flechasdb_tpu_torch/csrc/adc_scan.cu"
SRC_B = "flechasdb_tpu_torch/csrc/lloyd_round.cu"
SRC_BF = "flechasdb_tpu_torch/csrc/lloyd_round_fast.cu"
SRC_C = "flechasdb_tpu_torch/csrc/lloyd_grouped.cu"
SRC_CF = "flechasdb_tpu_torch/csrc/lloyd_grouped_fast.cu"
SRC_S = "flechasdb_tpu_torch/csrc/cluster_sums.cu"
SRC_T = "flechasdb_tpu_torch/csrc/bucketed_topk.cu"
SRC_PT = "flechasdb_tpu_torch/csrc/probed_tables.cu"
REPLACES = {
    "indexed": "flechasdb_tpu/ops/pallas_scan.py:528",
    "pipe": "flechasdb_tpu/ops/pallas_scan.py:320",
    "lookup": "flechasdb_tpu/ops/pallas_scan.py:133",
    "round": "flechasdb_tpu/ops/pallas_kmeans.py:36",
    "grouped": "flechasdb_tpu/ops/pallas_kmeans.py:143",
    # The fast_math=True branches of the same two kernels.
    "round_fast": "flechasdb_tpu/ops/pallas_kmeans.py:93",
    "grouped_fast": "flechasdb_tpu/ops/pallas_kmeans.py:189",
    # The sum halves of _round_kernel (:121-140) and of
    # _grouped_round_kernel (:208-224).
    "sums": "flechasdb_tpu/ops/pallas_kmeans.py:121,208",
    # No Pallas kernel: XLA's lax.top_k over every slot.
    "topk": "none (lax.top_k, flechasdb_tpu/ops/bucketed.py:346)",
    # No Pallas kernel: XLA's expansion of the probed tables.
    "tables": "none (XLA, flechasdb_tpu/ops/bucketed.py:125)",
}
#: The bucketed top-k's two kernels, a call.
TOPK_KERNELS = ("topk_cells_kernel", "topk_merge_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Time of one warm call of ``fn``: the mean over ``reps`` back-to-back
    calls between two CUDA events, median of five such means."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def device_ms(torch, fn, reps: int, kernel) -> dict:
    """Times ``reps`` calls of ``fn``: ``ms``, the device time of one
    launch of the kernels whose name holds ``kernel`` (``torch.profiler``'s
    CUDA activity, their total time over the launches it recorded: it may
    miss one; ``kernel`` a tuple of names: the time of all of them over
    the launches of the first, a call), each call after a read of
    ``L2_FLUSH_BYTES`` that evicts
    its inputs from L2; ``warm_ms``, the same over back-to-back calls;
    ``by``, the method; ``host_ms``, the host clock per back-to-back call,
    ended by a synchronize. A window in which the profiler records no
    such launch is profiled again, up to three times (the profiler has
    dropped a whole window's kernel records on the H100 while the wrapper
    counted every launch); raises where none records one."""
    from torch.profiler import ProfilerActivity, profile
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps

    def profiled(cold: bool):
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    if cold:
                        flush.sum()
                    fn()
                torch.cuda.synchronize()
            total = count = 0
            for e in prof.key_averages():
                if any(name in e.key for name in names):
                    total += getattr(e, "self_device_time_total", None) \
                        or getattr(e, "self_cuda_time_total", 0)
                    count += e.count if names[0] in e.key else 0
            if count:
                return total / count / 1e3, count
            keys = sorted({e.key[:60] for e in prof.key_averages()})[:8]
            log(f"profile window {attempt + 1} recorded no launch of "
                f"{kernel} (recorded: {keys}); profiling again")
        raise AssertionError(f"the profiler recorded no launch of {kernel}")

    ms, count = profiled(True)
    warm_ms, _ = profiled(False)
    what = "a launch" if len(names) == 1 else "a call of " + ", ".join(names)
    return {"ms": ms, "warm_ms": warm_ms, "host_ms": host_ms,
            "profiled": count,
            "by": f"torch.profiler, {what}, L2 flushed before each call"}


def scan_case(torch, label: str, call, plain, bound_, reps: int) -> dict:
    """K-A's ``call`` against its ``plain`` version (raises where they
    disagree): the case phase 8 times."""
    got, want = call(), plain()
    torch.cuda.synchronize()
    err = scan_error(torch, got, want)
    log(f"K-A {label}: max_abs_err {err:.3g}  bound {bound_[0]:.4f} ms "
        f"({bound_[1]})")
    return {"label": label, "err": err, "call": call, "plain": plain,
            "bound": bound_, "reps": reps}


def time_scan(torch, case: dict) -> None:
    """Adds K-A's :func:`device_ms` and its plain version's CUDA-event
    time to ``case``."""
    case.update(device_ms(torch, case["call"], case["reps"],
                          "adc_scan_kernel"))
    case["plain_ms"] = cuda_ms(torch, case["plain"], case["reps"])
    log(f"K-A {case['label']}: kernel {case['ms']:.4f} ms device with a "
        f"cold L2, {case['warm_ms']:.4f} ms back to back "
        f"({case['profiled']} launches profiled), host "
        f"{case['host_ms'] * 1e3:.1f} us a call  plain "
        f"{case['plain_ms']:.4f} ms  bound {case['bound'][0]:.4f} ms "
        f"({case['bound'][1]})")


def bound(nbytes: float, flops: float, rate: float = FP32_FLOPS,
          ops: str = "operations") -> tuple[float, str]:
    """The least time (ms) for the work, and which of the two sets it:
    ``flops`` run at ``rate``, named ``ops`` when they bind."""
    by_bytes, by_ops = nbytes / HBM_BYTES * 1e3, flops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, ops)


def lloyd_bound(x_bytes: int, b: int, n: int, k: int, m: int, rate: float,
                ops: str):
    """A Lloyd round reads x and the centroids once and writes indices,
    sums and counts; it needs 2·B·N·K·m flops, run at ``rate``, the peak
    of the units the kernel runs on (``ops`` names them)."""
    io = x_bytes + 4 * (b * k * m + b * k) + 4 * (b * n + b * k * m + b * k)
    return bound(io, 2.0 * b * n * k * m, rate, ops)


def scan_bound(codes, ftab, bidx, lengths, d: int):
    """K-A reads each probed bucket's live codes once, every table, the
    bucket indices and lengths (when given), and writes [G, L]; D adds a
    live slot."""
    g, l = ftab.shape[0], codes.shape[2]
    rows = codes.shape[1]
    buckets = bidx.long().unique()
    if lengths is None:               # adc_lookup: codes and tables only
        live_slots = float(len(buckets) * l)
        cell_slots = float(g * l)
        extra = 0
    else:
        first = {int(p): int(n) for p, n in zip(bidx.tolist(),
                                                lengths.tolist())}
        live_slots = float(sum(first[int(p)] for p in buckets.tolist()))
        cell_slots = float(lengths.sum())
        extra = 8 * g
    io = 4 * (rows * live_slots + ftab.numel() + g * l) + extra
    return bound(io, cell_slots * d)


def setup(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    global CARD
    CARD = smi.stdout.strip()
    log(CARD)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    from flechasdb_tpu_torch import _kernels
    nvcc = subprocess.run([_kernels._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}  "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    log(f"device: {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _kernels.load()
    log(f"kernel build + load: {time.perf_counter() - t0:.3f} s")
    from flechasdb_tpu_torch import _native
    t0 = time.perf_counter()
    route = ("native (native/fastio.cc, built with g++)"
             if _native.available() else "python (zlib, hashlib, numpy)")
    log(f"host IO runtime of the stored tier (hash, deflate, host scan): "
        f"{route}; build + load {time.perf_counter() - t0:.3f} s")
    if _kernels.build_log:
        log(_kernels.build_log.strip())
        for line in kernel_ptxas(_kernels.build_log):
            log(line)
            require(not line.startswith(("K-B fast ptxas KS",
                                         "K-C fast ptxas M"))
                    or ", 0 bytes spill stores" in line,
                    f"a fast kernel spills registers: {line}")


def kernel_ptxas(build_log: str) -> list:
    """From ``ptxas -v``: a line per K-B instance (float4 or scalar
    loads), per instance of the pass's dense ``tile_sums`` (fast, copy
    path, listed rows, columns a lane), per K-C and K-C fast instance (its
    subvector width M) and per K-B fast instance (k16 steps a chunk,
    chunked or resident): registers, stack frame and spills; the fast
    kernels' shared memory is dynamic (``ops.lloyd.fast_tiling``'s and
    ``grouped_fast_tiling``'s ``smem``, printed at each shape). Then each
    of ptxas's performance warnings about the fast kernels."""
    out, name, frame = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif name and "spill" in line:
            frame = line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            regs = regs.group(1) if regs else "?"
            kb = re.search(r"\d+assign_kernelILb([01])E", name)
            ts = re.search(r"tile_sumsILb([01])ELi(\d)ELb([01])ELi(\d)E",
                           name)
            w = re.search(r"grouped_round_kernelILi(\d+)EE", name)
            f = re.search(r"assign_fast_kernelILi(\d+)ELb([01])E", name)
            cf = re.search(r"grouped_fast_assignILi(\d+)EE", name)
            if kb:
                loads = "float4" if kb.group(1) == "1" else "scalar"
                out.append(f"K-B ptxas {loads} loads: {regs} registers, "
                           f"{frame}")
            elif ts:
                fast_, copy, listed, cpt = ts.groups()
                out.append(f"pass ptxas tile_sums "
                           f"{'fast ' if fast_ == '1' else ''}"
                           f"{('bulk', 'tensor', 'scalar')[int(copy)]} copy"
                           f"{', listed' if listed == '1' else ''}, {cpt} "
                           f"column(s) a lane: {regs} registers, {frame}")
            elif w:
                out.append(f"K-C ptxas M={w.group(1)}: {regs} registers, "
                           f"{frame}")
            elif cf:
                out.append(f"K-C fast ptxas M={cf.group(1)}: {regs} "
                           f"registers, {frame}")
            elif f:
                out.append(f"K-B fast ptxas KS={f.group(1)} "
                           f"{'chunked' if f.group(2) == '1' else 'resident'}"
                           f": {regs} registers at entry (setmaxnreg: "
                           f"consumers 152, producer 40), {frame}")
            name = None
        elif "Performance" in line and ("assign_fast_kernel" in line
                                        or "grouped_fast_assign" in line):
            out.append(("K-B fast" if "assign_fast_kernel" in line
                        else "K-C fast") + " ptxas warning: " + line.strip())
    return out


# --- phase 1: kernel parity -------------------------------------------------

def pack(torch, raw, d):
    p, _, l = raw.shape
    words = torch.zeros((p, -(-d // 4), l), dtype=torch.int32,
                        device=raw.device)
    for di in range(d):
        words[:, di // 4] |= raw[:, di] << (8 * (di % 4))
    return words


def scan_inputs(torch, gen, d, c, packed, l=2048, g=N_BATCH * NPROBE):
    """K-A's ``(bcodes, ftab, bidx, lengths)``: P random buckets, packed
    or not, G random tables and cells, random lengths (one cell empty, one
    full)."""
    dev = "cuda"
    raw = torch.randint(0, c, (P, d, l), generator=gen, device=dev,
                        dtype=torch.int32)
    codes = pack(torch, raw, d) if packed else raw
    ftab = torch.rand((g, d * c), generator=gen, device=dev)
    bidx = torch.randint(0, P, (g,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens = torch.randint(0, l + 1, (g,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0], lens[1] = 0, l
    return codes, ftab, bidx, lens


def parity_scan(torch, gen, d, c, packed, l=2048, g=N_BATCH * NPROBE):
    from flechasdb_tpu_torch.ops import scan
    args = scan_inputs(torch, gen, d, c, packed, l, g)
    return scan_case(
        torch, f"adc_scan D={d} C={c} rows={args[0].shape[1]} G={g} L={l} "
        f"table {d * c * 4 // 1024} KB",
        lambda: scan.adc_lookup_indexed(*args, d=d),
        lambda: scan.adc_lookup_indexed_plain(*args, d=d),
        scan_bound(*args, d), 20)


def parity_lookup(torch, gen, g=640, d=8, c=256, l=1280):
    """``adc_lookup`` at the roofline's SIFT shape (benchmarks/roofline.py:
    166-182): 64 queries x nprobe 10 pre-gathered unpacked buckets."""
    from flechasdb_tpu_torch.ops import scan
    codes = torch.randint(0, c, (g, d, l), generator=gen, device="cuda",
                          dtype=torch.int32)
    ftab = torch.rand((g, d * c), generator=gen, device="cuda")
    return scan_case(
        torch, f"adc_lookup G={g} D={d} C={c} L={l} unpacked",
        lambda: scan.adc_lookup(codes, ftab, d=d),
        lambda: scan.adc_lookup_plain(codes, ftab, d=d),
        scan_bound(codes, ftab, torch.arange(g), None, d), 50)


def scan_error(torch, got, want) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"K-A shape {got.shape} != {want.shape}")
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError("K-A +inf slots differ from the plain version")
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    bound_ = ATOL + RTOL * want[fin].abs()
    if bool((diff > bound_).any()):
        raise AssertionError(f"K-A disagrees: max abs err "
                             f"{float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def parity_lloyd(torch, gen, b, n, k, m, dup=False, time_it=True,
                 grouped=False, fast=False, skew=False, ordered=False):
    """K-B (or, ``grouped``, K-C on the regrouped data) against its plain
    version; K-C also against K-B's assignment. Picks may differ only
    where two centroids are within TIE_REL of a tie. ``fast``: the
    fast_math variants against the plain fast versions, ties measured on
    the bf16-rounded operands, the sums against sums of the bf16-rounded
    x (which sums of the f32 x must miss). A second call on the same
    inputs must return the same indices, sums and counts bit for bit.
    The sums must lie within the tolerance of the f64 sums and, except
    under ``skew``, of the plain f32 ``index_add_`` too: ``skew`` puts
    over half the rows next to centroid 0, and a serial f32 sum over them
    drifts beyond the tolerance by itself (its error is printed).
    ``time_it`` also times the cluster-sum pass alone (``_launch_sums``,
    which holds no host sync; CUDA events here, its device time from
    ``torch.profiler`` in phase 10, through the returned case) and
    ``index_add_``, the one PyTorch call that forms the same sums, and
    logs the route and tiling the pass took. ``ordered``: the sums and
    counts must equal ``cluster_sums_ordered``'s bit for bit (the dense
    route's order, in plain PyTorch)."""
    from flechasdb_tpu_torch.ops import lloyd
    dev = "cuda"
    name = ("K-C lloyd_grouped" if grouped else "K-B lloyd_round") \
        + (" fast" if fast else "") + (" skewed" if skew else "")
    x = torch.randn((b, n, m), generator=gen, device=dev)
    x /= x.norm(dim=(0, 2), keepdim=True)        # unit rows across B·m
    pick = torch.randint(0, n, (k,), generator=gen, device=dev)
    c = x[:, pick].contiguous()
    if skew:
        crowd = n // 2 + n // 8
        x[:, :crowd] = c[:, :1] + 1e-3 * torch.randn(
            (b, crowd, m), generator=gen, device=dev)
    twins = [7, k - 1] + ([200] if k > 200 else [])
    if dup:
        for j in twins:
            c[:, j] = c[:, 3]
    if grouped:
        xg = lloyd.regroup_divisions(x)

        def kernel():
            return lloyd.lloyd_round_grouped(xg, c, fast_math=fast)

        def plain():
            return lloyd.lloyd_round_grouped_plain(xg, c, fast_math=fast)
        # The function reads the B divisions, not the grouping's pad ones.
        x_bytes = x.numel() * 4
    else:
        def kernel():
            return lloyd.lloyd_round(x, c, fast_math=fast)

        def plain():
            return lloyd.lloyd_round_plain(x, c, fast_math=fast)
        x_bytes = x.numel() * 4
    idx, sums, counts = kernel()
    again = kernel()
    p_idx, p_sums, p_counts = plain()
    torch.cuda.synchronize()
    require(all(torch.equal(u, v) for u, v in zip((idx, sums, counts),
                                                   again)),
            f"{name}: two calls on the same inputs differ")
    if dup and bool(torch.isin(idx, torch.tensor(twins, device=dev)).any()):
        raise AssertionError(f"{name} picked a later duplicate centroid")
    ties = tie_rows(x, c, idx, p_idx, f"{name} against its plain version",
                    fast)
    if grouped:
        # K-C splits, multiplies and accumulates as K-B does, so their
        # distances and picks are expected to be equal (0 rows differ);
        # K-C fast issues a division's k16 steps as K-B fast does on the
        # ungrouped data where the division starts a step (m >= 16), and
        # stages its norms in K-B fast's order: 0 rows may differ there.
        kb_ties = tie_rows(x, c, idx,
                           lloyd.lloyd_round(x, c, fast_math=fast)[0],
                           f"K-C against K-B{' fast' if fast else ''}", fast)
        require(not fast or m < 16 or kb_ties == 0,
                f"{name}: {kb_ties} rows differ from K-B fast's")
    # Sums and counts checked against the plain scatter of the kernel's
    # own assignment, so tie rows do not blur the check.
    flat = (idx.long() + k * torch.arange(b, device=dev)[:, None]
            ).reshape(-1)

    def scatter(v, dtype=torch.float32):
        return torch.zeros((b * k, m), device=dev, dtype=dtype).index_add_(
            0, flat, v.reshape(-1, m).to(dtype)).reshape(b, k, m)

    def off(got, want):
        return bool(((got.double() - want.double()).abs()
                     > SUM_ATOL + SUM_RTOL * want.double().abs()).any())

    xs = lloyd._bf16(x) if fast else x
    ref, ref64 = scatter(xs), scatter(xs, torch.float64)
    ref_counts = torch.bincount(flat, minlength=b * k).reshape(b, k)
    if not torch.equal(counts, ref_counts.float()):
        raise AssertionError(f"{name} counts differ")
    err = float((sums - ref).abs().max())
    err64 = float((sums.double() - ref64).abs().max())
    plain64 = float((ref.double() - ref64).abs().max())
    if off(sums, ref64):
        raise AssertionError(f"{name} sums disagree with the f64 sums: "
                             f"max abs err {err64}")
    if not skew and off(sums, ref):
        raise AssertionError(f"{name} sums disagree: max abs err {err}")
    if fast and n >= 1000:  # a few rows a cluster may round alike
        f32 = scatter(x)
        if not bool(((sums - f32).abs() > SUM_ATOL + SUM_RTOL * f32.abs())
                    .any()):
            raise AssertionError(f"{name} sums match sums of the f32 x, "
                                 "not of the bf16-rounded x")
    if ties == 0 and not torch.equal(counts, p_counts):
        raise AssertionError(f"{name} counts differ from the plain version")
    g = lloyd.GROUP_WIDTH // m if grouped else 1
    tiling = lloyd.sum_tiling(b, n, k, m, g)
    if ordered:
        o_sums, o_counts = lloyd.cluster_sums_ordered(x, idx, k, fast,
                                                      tiling)
        require(torch.equal(sums, o_sums) and torch.equal(counts, o_counts),
                f"{name}: the dense route's sums differ from "
                "cluster_sums_ordered's")
        log(f"  {name}: sums and counts bit-equal to cluster_sums_ordered "
            f"(S={tiling.cols}, R={tiling.rows})")
    ms = plain_ms = kb_ms = float("nan")
    sums_case = assign_case = None
    if fast and not grouped:
        # The card's staging against its plain version: the bf16
        # centroids bit for bit; the norms, summed in another order, within
        # M f32 rounding steps of each (2^-23 M relative), +inf past K.
        t = lloyd.fast_tiling(b, n, k, m)
        _, cs_k, ccp_k = lloyd._assign_fast(x, c)
        cs_p, ccp_p = lloyd.stage_centroids(c, t)
        fin = torch.isfinite(ccp_p)
        norm_err = float(((ccp_k[fin] - ccp_p[fin]).abs()
                          / ccp_p[fin].abs().clamp_min(1e-30)).max())
        require(torch.equal(cs_k.view(torch.int16), cs_p.view(torch.int16))
                and torch.equal(fin, torch.isfinite(ccp_k))
                and norm_err <= m * 2.0 ** -23,
                f"{name}: the card's staged centroids differ from "
                f"stage_centroids' (norms {norm_err:.3g} apart)")
        log(f"  K-B fast tiling: {t.regime}, {t.rows} rows a block "
            f"({t.row_blocks} row blocks), Kp="
            f"{t.kp}, Mp={t.mp}, chunk {t.chunk}, {t.stages} ring slots, "
            f"{t.smem} bytes of shared memory; staging bit-equal to "
            f"stage_centroids', norms within {norm_err:.3g} relative")
    if fast and grouped:
        # K-C fast's staging on the card against its plain version, as
        # K-B fast's above.
        t = lloyd.grouped_fast_tiling(b, n, k, m)
        _, cs_k, ccp_k = lloyd._assign_grouped_fast(xg, c)
        cs_p, ccp_p = lloyd.stage_grouped_centroids(c, t)
        fin = torch.isfinite(ccp_p)
        norm_err = float(((ccp_k[fin] - ccp_p[fin]).abs()
                          / ccp_p[fin].abs().clamp_min(1e-30)).max())
        require(torch.equal(cs_k.view(torch.int16), cs_p.view(torch.int16))
                and torch.equal(fin, torch.isfinite(ccp_k))
                and norm_err <= m * 2.0 ** -23,
                f"{name}: the card's staged centroids differ from "
                f"stage_grouped_centroids' (norms {norm_err:.3g} apart)")
        log(f"  K-C fast tiling: {t.groups} groups of {t.g} divisions, "
            f"{t.per_pass} a pass in {t.passes} pass(es), {t.rows} rows a "
            f"block ({t.row_blocks} row blocks), Kp={t.kp}, {t.stages} ring "
            f"slots, {t.smem} bytes of shared memory; staging bit-equal to "
            f"stage_grouped_centroids', norms within {norm_err:.3g} "
            "relative")
    if time_it and (fast or grouped):
        # The assignment alone (a fast kernel's staging apart), timed by
        # device time in phase 10: x and the centroids read once, idx
        # written; 2 B N K M operations at the units' rate.
        rate, ops = ((BF16_FLOPS, "operations (bf16 tensor cores)") if fast
                     else (TF32_FLOPS, "operations (TF32 tensor cores)"))
        launch, key = (
            (lambda: lloyd._assign_grouped_fast(xg, c), "grouped_fast_assign")
            if fast and grouped else
            (lambda: lloyd._assign_grouped(xg, c), "grouped_round_kernel")
            if grouped else
            (lambda: lloyd._assign_fast(x, c), "assign_fast_kernel"))
        assign_case = {
            "name": name, "launch": launch, "key": key,
            "bound": bound(x_bytes + 4 * (b * k * m + b * n),
                           2.0 * b * n * k * m, rate, ops)}
    if time_it:
        ms = cuda_ms(torch, kernel, 5)
        plain_ms = cuda_ms(torch, plain, 5)
        if grouped:
            kb_ms = cuda_ms(torch, lambda: lloyd.lloyd_round(x, c), 5)
        launch = sum_pass(lloyd, xg if grouped else x, idx, k, m, g, fast)
        sums_ms = cuda_ms(torch, launch, 5)
        sums_plain_ms = cuda_ms(torch, lambda: lloyd.cluster_sums_plain(
            x, idx, k, fast), 5)
        library_ms = cuda_ms(torch, lambda: scatter(xs), 5)
        # x once, idx once; sums and counts written.
        sums_bound = bound(x_bytes + 4 * (b * n + b * k * m + b * k),
                           float(b * n * m))
        sums_case = {"name": name, "shape": f"B={b} N={n} K={k} M={m}",
                     "route": tiling.route,
                     "tiling": tiling._asdict(), "events_ms": sums_ms,
                     "plain_ms": sums_plain_ms, "bound": sums_bound,
                     "library_ms": library_ms, "launch": launch}
        log(f"  cluster_sums pass alone ({tiling.route} route, "
            f"S={tiling.cols} R={tiling.rows}): {sums_ms:.3f} ms (CUDA "
            f"events, no host sync)  plain {sums_plain_ms:.3f} ms  "
            f"index_add_ {library_ms:.3f} ms  bound {sums_bound[0]:.3f} ms "
            f"({sums_bound[1]})")
    bms, by = (lloyd_bound(x_bytes, b, n, k, m, BF16_FLOPS,
                           "operations (bf16 tensor cores)") if fast else
               lloyd_bound(x_bytes, b, n, k, m, TF32_FLOPS,
                           "operations (TF32 tensor cores)"))
    log(f"{name} B={b} N={n} K={k} M={m}{' dup' if dup else ''}: "
        f"{ties} tie rows differ"
        + (f", {kb_ties} rows from K-B's (0 expected)" if grouped else "")
        + f"  two calls bit-equal; largest count {int(counts.max())}; sums "
        f"max_abs_err {err:.3g} (plain f32), {err64:.3g} (f64; the plain "
        f"f32 sums' own {plain64:.3g})  "
        f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
        + (f"  K-B on the ungrouped data {kb_ms:.3f} ms" if grouped
           else "") + f"  bound {bms:.3f} ms ({by})")
    return (err64 if skew else err), ms, plain_ms, bms, by, sums_case, \
        assign_case


#: The cluster-sum pass's kernels (``csrc/cluster_sums.cu``): the dense
#: route's, then the sort route's.
PASS_KERNELS = ("tile_sums", "combine_tiles", "tile_count", "tile_scan",
                "cluster_scan", "place", "chunk_sum", "combine")


def sum_pass(lloyd, xin, idx, k, m, g, fast):
    """One cluster-sum pass over ``idx`` as a round launches it
    (``_launch_sums``: no range check, no host sync)."""
    b, n = idx.shape
    return lambda: lloyd._launch_sums(xin, idx, b, n, k, m, g, fast)


def profile_kernels(torch, fn, keys, reps: int = 5) -> tuple[dict, dict]:
    """``torch.profiler``'s CUDA activity over ``reps`` back-to-back calls
    of ``fn`` after a warm one: the device time (µs) and the launches of
    each of ``keys``, a kernel counted under the longest key its name
    holds. A window that records none is profiled again, up to three
    times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    longest_first = sorted(keys, key=len, reverse=True)
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = dict.fromkeys(keys, 0.0)
        calls = dict.fromkeys(keys, 0)
        for e in prof.key_averages():
            name = next((k for k in longest_first if k in e.key), None)
            if name:
                by[name] += getattr(e, "self_device_time_total", None) \
                    or getattr(e, "self_cuda_time_total", 0)
                calls[name] += e.count
        if any(calls.values()):
            return by, calls
        log(f"profile window {attempt + 1} recorded no launch of {keys}; "
            "profiling again")
    raise AssertionError(f"the profiler recorded no launch of {keys}")


def pass_device_ms(torch, fn, reps: int = 5) -> dict:
    """Device time of a pass ``fn`` (:func:`profile_kernels` over the
    pass's kernels), over the calls it recorded (launches of the route's
    first kernel): ``ms`` in all and ``by_kernel``."""
    by, calls = profile_kernels(torch, fn, PASS_KERNELS, reps)
    first = calls["tile_sums"] or calls["tile_count"]
    return {"ms": sum(by.values()) / first / 1e3, "calls": first,
            "by_kernel": {k: v / first / 1e3 for k, v in by.items()
                          if calls[k]}}


def kernel_device_ms(torch, fn, key: str, reps: int = 5) -> dict:
    """Device time of one launch of the kernel whose name holds ``key``
    (:func:`profile_kernels`): ``ms``, and the launches recorded,
    ``calls``."""
    by, calls = profile_kernels(torch, fn, (key,), reps)
    return {"ms": by[key] / calls[key] / 1e3, "calls": calls[key]}


def parity_sort_route(torch, gen) -> float:
    """The pass's sort route, above the dense route's K limit (K=8192 at
    N=50k, M=8), full and fast: two calls bit-equal, the counts
    ``bincount``'s, the sums within the tolerance of the f64 sums.
    Returns the largest error against the plain f32 ``index_add_``."""
    from flechasdb_tpu_torch.ops import lloyd
    b, n, k, m = 1, 50_000, 8192, 8
    require(lloyd.sum_tiling(b, n, k, m, 1).route == "sort",
            f"K={k} at M={m} does not take the sort route")
    x = torch.randn((b, n, m), generator=gen, device="cuda")
    idx = torch.randint(0, k, (b, n), generator=gen, device="cuda",
                        dtype=torch.int32)
    flat = idx.long().reshape(-1)
    worst = 0.0
    for fast in (False, True):
        sums, counts = lloyd.cluster_sums(x, idx, k, fast)
        again = lloyd.cluster_sums(x, idx, k, fast)
        torch.cuda.synchronize()
        require(torch.equal(sums, again[0]) and torch.equal(counts, again[1]),
                "the sort route: two calls differ")
        xs = (lloyd._bf16(x) if fast else x).reshape(-1, m)
        want = torch.zeros((k, m), dtype=torch.float64, device="cuda") \
            .index_add_(0, flat, xs.double())
        f32 = torch.zeros((k, m), device="cuda").index_add_(0, flat, xs)
        require(torch.equal(counts[0], torch.bincount(flat, minlength=k)
                            .float()), "the sort route's counts differ")
        require(bool(((sums[0].double() - want).abs()
                      <= SUM_ATOL + SUM_RTOL * want.abs()).all()),
                "the sort route's sums disagree with the f64 sums")
        err = float((sums[0] - f32).abs().max())
        worst = max(worst, err)
        log(f"cluster_sums sort route B={b} N={n} K={k} M={m}"
            f"{' fast' if fast else ''}: two calls bit-equal; sums "
            f"max_abs_err {err:.3g} (plain f32), "
            f"{float((sums[0].double() - want).abs().max()):.3g} (f64)")
    return worst


def tie_rows(x, c, got, want, what: str, fast: bool = False):
    """The rows where two assignments of ``x`` to ``c`` differ; raises
    unless each such row's two centroids lie within TIE_REL of a tie
    (float64 distances, relative to the row's distance scale; ``fast``:
    the cross term of the bf16-rounded operands, as the fast variants
    rank)."""
    from flechasdb_tpu_torch.ops.lloyd import _bf16
    mism = (got != want).nonzero()
    if len(mism):
        bb, ii = mism[:, 0], mism[:, 1]
        x64 = (_bf16(x[bb, ii]) if fast else x[bb, ii]).double()
        c64 = (_bf16(c) if fast else c).double()
        cc64 = (c.double() ** 2).sum(-1)

        def dist(kk):
            ck = c64[bb, kk.long()]
            return cc64[bb, kk.long()] - 2 * (x64 * ck).sum(-1)

        scale = (x64 * x64).sum(-1) + cc64.max()
        gap = (dist(got[bb, ii]) - dist(want[bb, ii])).abs()
        if bool((gap > TIE_REL * scale).any()):
            raise AssertionError(
                f"{what}: assignment differs beyond ties at {len(mism)} rows")
    return len(mism)


# --- phases 2 and 3: the paths ----------------------------------------------

def same_results(got, want, what: str) -> int:
    """Distances position by position; rows equal up to distance ties.
    Returns the number of rows that sat in a tie and swapped."""
    swapped = 0
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results != {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.isclose(g.squared_distance, w.squared_distance,
                          rtol=RTOL, atol=ATOL):
            raise AssertionError(
                f"{what}[{i}]: distance {g.squared_distance} != "
                f"{w.squared_distance}")
        if g.vector_id != w.vector_id:
            twin = [r for r in want if r.vector_id == g.vector_id]
            if not (twin and np.isclose(
                    twin[0].squared_distance, g.squared_distance,
                    rtol=RTOL, atol=ATOL)) and i != len(got) - 1:
                raise AssertionError(f"{what}[{i}]: row differs outside "
                                     "a distance tie")
            swapped += 1
    return swapped


def same_arrays(got, want, what: str) -> int:
    """:func:`same_results` for host ``(dists, rows)`` arrays."""
    gd, gr = got
    wd, wr = want
    if not np.array_equal(np.isinf(gd), np.isinf(wd)):
        raise AssertionError(f"{what}: +inf slots differ")
    fin = np.isfinite(wd)
    if not np.allclose(gd[fin], wd[fin], rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: distances differ")
    swapped = 0
    for b, i in zip(*np.nonzero((gr != wr) & fin)):
        twin = np.flatnonzero(wr[b] == gr[b, i])
        if not (twin.size and np.isclose(wd[b, twin[0]], gd[b, i],
                                         rtol=RTOL, atol=ATOL)) \
                and i != gr.shape[1] - 1:
            raise AssertionError(f"{what}[{b}, {i}]: row differs outside "
                                 "a distance tie")
        swapped += 1
    return swapped


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


LLOYD_KERNELS = ("lloyd_round", "lloyd_grouped", "lloyd_round_fast",
                 "lloyd_grouped_fast")


def one_sum_pass_a_round(launches: dict, what: str) -> None:
    """Every K-B or K-C round is followed by one cluster-sum pass."""
    rounds = sum(launches[k] for k in LLOYD_KERNELS)
    require(rounds > 0 and launches["cluster_sums"] == rounds,
            f"{what}: {launches['cluster_sums']} cluster-sum passes for "
            f"{rounds} Lloyd rounds")


def build_db(torch, ft, x, p, d, c, seed):
    """Zeroes the launch counts and builds on the card: ``(db, seconds,
    launches after the build)``."""
    from flechasdb_tpu_torch import _kernels
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = (ft.DatabaseBuilder(x, device="cuda").with_partitions(p)
          .with_divisions(d).with_clusters(c).with_seed(seed).build())
    torch.cuda.synchronize()
    return db, time.perf_counter() - t0, dict(_kernels.LAUNCHES)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def headline_data(seed: int):
    """bench.py's N x M unit rows and N_BATCH + N_SINGLE noisy queries."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, M), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(N, N_BATCH + N_SINGLE, replace=False)]
    q = q + 0.02 * rng.standard_normal(q.shape, dtype=np.float32)
    return x, q


def slice_run(torch, seed: int):
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels

    t0 = time.perf_counter()
    x, q = headline_data(seed)
    log(f"data {N}x{M} (numpy, seed {seed}): "
        f"{time.perf_counter() - t0:.3f} s")

    db, build_s, after_build = build_db(torch, ft, x, P, D, C, seed)
    batch, cold_ms = timed(lambda: db.query_batch(q[:N_BATCH], k=K_TOP,
                                                  nprobe=NPROBE))
    batch, warm_ms = timed(lambda: db.query_batch(q[:N_BATCH], k=K_TOP,
                                                  nprobe=NPROBE))
    singles, single_ms = [], []
    for v in q[N_BATCH:]:
        res, ms = timed(lambda: db.query(v, k=K_TOP, nprobe=NPROBE))
        singles.append(res)
        single_ms.append(ms)
    launches = dict(_kernels.LAUNCHES)
    layout = db._device_state().layout
    log(f"build: {build_s:.3f} s  launches after build {after_build}")
    log(f"query_batch({N_BATCH}): first {cold_ms:.3f} ms (builds the "
        f"device index), warm {warm_ms:.3f} ms; query: median "
        f"{statistics.median(single_ms):.3f} ms over {N_SINGLE}")
    log(f"launches over the slice: {launches}  layout {layout}")
    require(layout == "bucketed", f"layout {layout!r} is not bucketed")
    require(after_build["lloyd_round"] > 0, "the build launched no "
            "lloyd_round")
    one_sum_pass_a_round(after_build, "the headline build")
    require(launches["adc_scan"] > 0, "the queries launched no adc_scan")

    check_build(db, x, P, D, C)
    ref = ft.Database(**ft.to_arrays(db), device="cpu")
    swapped = 0
    for b, got in enumerate(batch):
        want = ref.query_batch(q[b:b + 1], k=K_TOP, nprobe=NPROBE)[0]
        swapped += same_results(got, want, f"query_batch[{b}]")
    for i, got in enumerate(singles):
        want = ref.query(q[N_BATCH + i], k=K_TOP, nprobe=NPROBE)
        swapped += same_results(got, want, f"query[{i}]")
    log(f"results agree with the CPU plain path ({swapped} tie swaps)")
    state = {"x": x, "q": q[:N_BATCH], "db": db, "ref": ref, "batch": batch,
             "q_single": q[N_BATCH:], "singles": singles}
    return launches, scan_at_main_path(torch, db._device_state(),
                                       q[:N_BATCH], NPROBE,
                                       "the slice's"), state


def check_build(db, x, p, d, c) -> None:
    """Shapes, ranges, and quantization that beats the data's spread."""
    n, m = x.shape
    require(db.partition_centroids.shape == (p, m), "centroid shape")
    require(db.codebooks.shape == (d, c, m // d), "codebook shape")
    require(db.codes.shape == (n, d) and int(db.codes.max()) < c, "codes")
    require(0 <= db.partition_indices.min()
            and db.partition_indices.max() < p, "partition indices")
    for a in (db.partition_centroids, db.codebooks, db.residues):
        require(bool(np.isfinite(a).all()), "non-finite build output")
    sub = np.random.default_rng(0).choice(n, min(n, 10_000), replace=False)
    coarse = db.residues[sub]
    spread = ((x[sub] - x[sub].mean(0)) ** 2).sum()
    recon = db.codebooks[np.arange(d)[None, :], db.codes[sub]]  # [n, D, m]
    pq_err = ((coarse - recon.reshape(len(sub), m)) ** 2).sum()
    coarse_err = (coarse ** 2).sum()
    log(f"quantization: coarse {coarse_err / spread:.4f} of the spread, "
        f"PQ {pq_err / coarse_err:.4f} of the residue energy")
    require(coarse_err < spread and pq_err < coarse_err,
            "the build did not quantize the data")


def main_path_scan_args(torch, index, q, nprobe, metric="l2"):
    """K-A's arguments ``(bcodes, ftab, bidx, lengths)`` and ``d`` as a
    path's query batch gives them: its bucketed index and the tables of
    its queries (``metric="dot"``: the MIPS tables)."""
    from flechasdb_tpu_torch.ops import adc, bucketed
    bk = index.buckets
    d, c, _ = index.codebooks.shape
    qd = torch.as_tensor(q, device="cuda")
    coarse = adc.coarse_scores(qd, index.centroids, metric)
    probed = torch.sort(coarse, dim=1, stable=True).indices[:, :nprobe]
    tables = bucketed.probed_tables(qd, index.centroids, index.codebooks,
                                    probed, metric, coarse=coarse,
                                    rotation=index.rotation)
    return (bk.codes, tables.reshape(-1, d * c).contiguous(),
            probed.reshape(-1).to(torch.int32).contiguous(),
            bk.lengths[probed].reshape(-1).contiguous()), d


def scan_at_main_path(torch, index, q, nprobe, what, metric="l2"):
    """K-A against its plain version on a path's own bucketed index and
    the tables of its query batch (these launches are not counted in the
    path's run, which has ended)."""
    from flechasdb_tpu_torch.ops import scan
    args, d = main_path_scan_args(torch, index, q, nprobe, metric)
    return scan_case(
        torch, f"adc_scan at {what} buckets: codes "
        f"{tuple(index.buckets.codes.shape)} G={args[1].shape[0]}",
        lambda: scan.adc_lookup_indexed(*args, d=d),
        lambda: scan.adc_lookup_indexed_plain(*args, d=d),
        scan_bound(*args, d), 20)


def topk_bytes(lens: np.ndarray, l: int, b: int, kk: int) -> tuple:
    """The bucketed top-k's bytes: ``(needed, overhead)``. Needed, the
    function's: each cell's live keys read once, its length and bucket,
    each winner's row gathered, and the values, flat indices and rows
    written. Overhead, the design's: the stage-1 candidates (8 bytes
    each: each 4096-slot tile's kk smallest, tile 0's pad slots below kk
    among them) written and read back, mostly from L2."""
    tile = 4096
    cands = 0
    for n in lens.tolist():
        for t0 in range(0, l, tile):
            end = min(t0 + tile, l)
            live = min(n, end) - t0
            cands += min(kk, end) if t0 == 0 else max(0, min(kk, live))
    g = len(lens)
    needed = 4 * int(lens.sum()) + 8 * g + b * kk * (4 + 4 + 8 + 4)
    return needed, 16 * cands


def topk_at_main_path(torch, index, q, nprobe: int, what: str) -> dict:
    """The bucketed top-k on a path's own K-A keys: ``_probe_scan`` of the
    batch ``q`` at ``nprobe`` on the bucketed ``index`` gives ``vdist``,
    the cells' lengths and buckets, as ``query_bucketed`` passes them;
    ``ops.topk.bucketed_topk`` must equal ``bucketed_topk_plain`` (the
    stable sort and its index arithmetic) bit for bit, values (as bits:
    −0 is not +0 there), flat indices and rows, at kk=K_TOP and
    kk=RERANK (these launches are not counted in the path's run, which
    has ended). Returns the case phase 10 times, at kk=RERANK."""
    from flechasdb_tpu_torch.ops import bucketed, topk
    bk, brows = index.buckets, index.buckets.rows
    qd = torch.as_tensor(q, device="cuda")
    vdist, _, _, bidx, lens = bucketed._probe_scan(
        qd, index.centroids, index.codebooks, bk, 0, nprobe, index.metric,
        index.rotation)
    b, _, l = vdist.shape
    vdist = vdist.reshape(b * nprobe, l)
    for kk in (K_TOP, RERANK):
        kw = dict(nprobe=nprobe, kk=kk)
        require(topk.kernel_takes(kk, nprobe * l),
                f"kk={kk} at nprobe·L={nprobe * l} takes the sort's route")
        got = topk.bucketed_topk(vdist, lens, bidx, brows, **kw)
        want = topk.bucketed_topk_plain(vdist, lens, bidx, brows, **kw)
        same = [torch.equal(got[0].view(torch.int32),
                            want[0].contiguous().view(torch.int32)),
                torch.equal(got[1], want[1]), torch.equal(got[2], want[2])]
        require(all(same), f"bucketed_topk at {what} keys, kk={kk}: values, "
                f"flat indices, rows equal to the stable sort's: {same}")
    lens_h = lens.cpu().numpy()
    needed, overhead = topk_bytes(lens_h, l, b, RERANK)
    kw = dict(nprobe=nprobe, kk=RERANK)
    live = int(lens_h.sum())
    log(f"bucketed_topk at {what} keys (B={b}, nprobe={nprobe}, L={l}, "
        f"{live} live slots, {100 * live / vdist.numel():.1f}%): values, "
        f"flat indices and rows bit-equal to the stable sort's at kk="
        f"{K_TOP} and kk={RERANK}; bytes needed {needed}, candidates "
        f"written and read back {overhead}")
    return {"label": f"bucketed_topk at {what} keys: B={b}, nprobe="
            f"{nprobe}, L={l}, kk={RERANK}",
            "shape": {"B": b, "nprobe": nprobe, "L": l, "kk": RERANK,
                      "live_slots": live,
                      "fill": live / vdist.numel()},
            "call": lambda: topk.bucketed_topk(vdist, lens, bidx, brows,
                                               **kw),
            "plain": lambda: topk.bucketed_topk_plain(vdist, lens, bidx,
                                                      brows, **kw),
            "library": lambda: torch.topk(vdist.reshape(b, -1), RERANK,
                                          dim=1, largest=False),
            "bound": bound(needed, 0.0), "overhead_bytes": overhead,
            "reps": 20}


def time_topk(torch, case: dict) -> None:
    """Adds the top-k's :func:`device_ms` over both its kernels, and the
    CUDA-event times of its plain version and of ``torch.topk``, to
    ``case``."""
    case.update(device_ms(torch, case.pop("call"), case["reps"],
                          TOPK_KERNELS))
    case["plain_ms"] = cuda_ms(torch, case.pop("plain"), 3)
    case["library_ms"] = cuda_ms(torch, case.pop("library"), 3)
    log(f"{case['label']}: kernel {case['ms']:.4f} ms device a call with a "
        f"cold L2, {case['warm_ms']:.4f} ms back to back ({case['profiled']}"
        f" calls profiled), host {case['host_ms'] * 1e3:.1f} us a call  "
        f"plain {case['plain_ms']:.4f} ms  torch.topk "
        f"{case['library_ms']:.4f} ms  bound {case['bound'][0]:.4f} ms "
        f"({case['bound'][1]}; the candidates' "
        f"{case['overhead_bytes'] / HBM_BYTES * 1e3:.4f} ms more at HBM's "
        "rate)")


def parity_tables(torch, gen, what: str, b: int, nprobe: int, d: int,
                  sub: int, p: int) -> dict:
    """Phase 1: ``probed_tables`` on the card (the kernel) against
    ``l2_tables_plain`` at a serving cell's shape, the probes the first
    ``nprobe`` of a stable sort as the main path takes them; its bound as
    the benchmark's ``portbench/roofline/tables.py`` reckons it. Returns
    the case phase 10 times."""
    from flechasdb_tpu_torch import _kernels
    from flechasdb_tpu_torch.ops import bucketed
    from portbench.roofline import tables as tables_roofline
    m = d * sub
    q = torch.randn((b, m), generator=gen, device="cuda")
    cents = torch.randn((p, m), generator=gen, device="cuda")
    books = torch.randn((d, C, sub), generator=gen, device="cuda")
    scores = torch.rand((b, p), generator=gen, device="cuda")
    probed = torch.sort(scores, dim=1, stable=True).indices[:, :nprobe]
    before = _kernels.LAUNCHES["probed_tables"]
    got = bucketed.probed_tables(q, cents, books, probed)
    want = bucketed.l2_tables_plain(q, cents, books, probed)
    torch.cuda.synchronize()
    require(_kernels.LAUNCHES["probed_tables"] == before + 1,
            f"the tables at {what}'s shape launched no probed_tables")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    require(bool(torch.allclose(got, want, rtol=RTOL, atol=RTOL * scale)),
            f"probed_tables at {what}'s shape: max_abs_err {err:.3g} over "
            f"a largest entry of {scale:.4g}")
    cells = b * nprobe
    read, written, flops = tables_roofline.work(cells=cells, b=b, p=p, m=m,
                                                d=d, c=C)
    bound_ = bound(read + written, flops)
    shape = (f"B={b}, nprobe={nprobe}, D={d}, C={C}, sub={sub}, P={p}: "
             f"{cells} cells")
    log(f"probed_tables at {what}'s shape ({shape}): max_abs_err {err:.3g} "
        f"(largest entry {scale:.4g})  bound {bound_[0]:.4f} ms "
        f"({bound_[1]})")
    del got, want
    return {"label": f"probed_tables at {what}'s shape", "shape": shape,
            "err": err, "bound": bound_, "reps": 20,
            "call": lambda: bucketed.probed_tables(q, cents, books, probed),
            "plain": lambda: bucketed.l2_tables_plain(q, cents, books,
                                                      probed)}


def time_tables(torch, case: dict) -> None:
    """Adds the tables kernel's :func:`device_ms` and the plain formula's
    CUDA-event time to ``case``."""
    case.update(device_ms(torch, case.pop("call"), case["reps"],
                          "probed_tables_kernel"))
    case["plain_ms"] = cuda_ms(torch, case.pop("plain"), 3)
    log(f"{case['label']}: kernel {case['ms']:.4f} ms device with a cold "
        f"L2, {case['warm_ms']:.4f} ms back to back ({case['profiled']} "
        f"launches profiled), host {case['host_ms'] * 1e3:.1f} us a call  "
        f"plain formula {case['plain_ms']:.4f} ms  bound "
        f"{case['bound'][0]:.4f} ms ({case['bound'][1]}): "
        f"{100 * case['bound'][0] / case['ms']:.1f}% of it")


def ground_truth(torch, x, q, k: int) -> np.ndarray:
    """Exact k nearest rows on the card: f32 expanded distances pick 4k
    candidates, a subtract-then-square re-score orders them."""
    from flechasdb_tpu_torch.ops.distance import full_f32
    xd = torch.as_tensor(x, device="cuda")
    xx = (xd * xd).sum(1)
    out = []
    with full_f32():
        for s in range(0, len(q), 250):
            qd = torch.as_tensor(q[s:s + 250], device="cuda")
            d = xx[None, :] - 2.0 * qd @ xd.T
            cand = torch.topk(d, 4 * k, dim=1, largest=False).indices
            exact = ((xd[cand] - qd[:, None, :]) ** 2).sum(-1)
            order = torch.sort(exact, dim=1, stable=True).indices[:, :k]
            out.append(cand.gather(1, order).cpu().numpy())
    return np.concatenate(out)


def host_arrays(results, row_of, k: int):
    """``query_batch`` results as ``(dists [B, k], rows [B, k])`` corpus
    rows, ``+inf`` past the reachable vectors."""
    dists = np.full((len(results), k), np.inf, np.float32)
    rows = np.full((len(results), k), -1, np.int64)
    for b, rs in enumerate(results):
        dists[b, :len(rs)] = [r.squared_distance for r in rs]
        rows[b, :len(rs)] = [row_of[r.vector_id] for r in rs]
    return dists, rows


def sift_run(torch, seed: int):
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels, synth
    from flechasdb_tpu_torch.host import bucket_len
    from flechasdb_tpu_torch.serving import DeviceIndex

    t0 = time.perf_counter()
    x, q = synth.gmm_pair(np.random.default_rng(seed), SIFT_N, SIFT_NQ,
                          SIFT_M, n_clusters=256, intrinsic=12)
    log(f"SIFT data {SIFT_N}x{SIFT_M} + {SIFT_NQ} queries (numpy GMM, seed "
        f"{seed}): {time.perf_counter() - t0:.3f} s")

    db, build_s, after_build = build_db(torch, ft, x, SIFT_P, SIFT_D, C,
                                        seed)
    arrays = (db.partition_centroids, db.codebooks,
              db.codes.astype(np.int32), db.partition_indices)
    # The JAX package's sweep serves this configuration from buckets
    # whatever the skew (benchmarks/sweep.py:121-128); so does this path.
    index, index_ms = timed(lambda: DeviceIndex(
        *arrays, layout="bucketed", metric=db.metric, device="cuda"))
    orig, orig_ms = timed(db._device_originals)
    kw = dict(k=K_TOP, nprobe=SIFT_NPROBE)
    _, cold_ms = timed(lambda: index.query(q, **kw))
    adc_ms = []
    for _ in range(3):
        adc, ms = timed(lambda: index.query(q, **kw))
        adc_ms.append(ms)
    _, rr_cold_ms = timed(lambda: index.query_rerank(q, orig, rerank=RERANK,
                                                     **kw))
    rr_ms = []
    for _ in range(3):
        rr, ms = timed(lambda: index.query_rerank(q, orig, rerank=RERANK,
                                                  **kw))
        rr_ms.append(ms)
    launches = dict(_kernels.LAUNCHES)
    log(f"SIFT build: {build_s:.3f} s  launches after build {after_build}")
    log(f"SIFT DeviceIndex(layout='bucketed'): {index_ms:.3f} ms, buckets "
        f"{tuple(index.buckets.codes.shape)}; originals upload "
        f"{orig_ms:.3f} ms")
    log(f"SIFT DeviceIndex.query({SIFT_NQ}, k={K_TOP}, nprobe={SIFT_NPROBE})"
        f": first {cold_ms:.3f} ms, warm {statistics.median(adc_ms):.3f} ms "
        f"(median of 3: {', '.join(f'{v:.3f}' for v in adc_ms)}); "
        f"query_rerank({RERANK}): first {rr_cold_ms:.3f} ms, warm "
        f"{statistics.median(rr_ms):.3f} ms (median of 3: "
        f"{', '.join(f'{v:.3f}' for v in rr_ms)})")
    log(f"launches over the SIFT path: {launches}")
    require(after_build["lloyd_grouped"] > 0,
            "the SIFT build launched no lloyd_grouped")
    require(after_build["lloyd_round"] > 0,
            "the SIFT build launched no lloyd_round")
    one_sum_pass_a_round(after_build, "the SIFT build")
    require(launches["adc_scan"] > after_build["adc_scan"],
            "the SIFT queries launched no adc_scan")
    require(launches["bucketed_topk"] > after_build["bucketed_topk"],
            "the SIFT queries launched no bucketed_topk")
    require(launches["probed_tables"] > after_build["probed_tables"],
            "the SIFT queries launched no probed_tables")
    check_build(db, x, SIFT_P, SIFT_D, C)

    t0 = time.perf_counter()
    gt = ground_truth(torch, x, q, K_TOP)

    coarse = coarse_at(db.partition_indices, gt, adc[2])
    r_adc, r_rr = recall_at(adc[1], gt), recall_at(rr[1], gt)
    log(f"SIFT quality over {SIFT_NQ} queries ({time.perf_counter() - t0:.3f}"
        f" s): recall@10 {r_adc:.4f}  coarse@10 {coarse:.4f}  recall@10 "
        f"after rerank {RERANK} {r_rr:.4f}")
    require(coarse >= 0.95, f"coarse@10 {coarse} < 0.95")
    require(r_rr >= 0.9 and r_rr >= r_adc,
            f"rerank recall {r_rr} below 0.9 or the ADC recall {r_adc}")

    # Database.query_batch, which serves from the layout the card's policy
    # picks for this corpus (serving.card_layout).
    counts = np.bincount(db.partition_indices, minlength=SIFT_P)
    _, qb_cold_ms = timed(lambda: db.query_batch(q, **kw))
    qb_res, qb_ms = timed(lambda: db.query_batch(q, **kw))
    qbr_res, qbr_ms = timed(lambda: db.query_batch(q, rerank=RERANK, **kw))
    log(f"SIFT partitions: largest {counts.max()}, smallest {counts.min()}, "
        f"bucket length {bucket_len(counts)}; Database.query_batch serves "
        f"from the {db._device_state().layout} layout: first {qb_cold_ms:.3f}"
        f" ms (builds its device index), warm {qb_ms:.3f} ms, rerank="
        f"{RERANK} {qbr_ms:.3f} ms")

    t0 = time.perf_counter()
    ref = ft.Database(**ft.to_arrays(db), device="cpu")
    row_of = {vid: i for i, vid in enumerate(db.vector_ids)}
    qc = q[:N_CHECK]
    swapped = 0
    for rr_depth, mine, got in ((None, adc, qb_res), (RERANK, rr, qbr_res)):
        want = ref.query_batch(qc, rerank=rr_depth, **kw)
        swapped += same_arrays((mine[0][:N_CHECK], mine[1][:N_CHECK]),
                               host_arrays(want, row_of, K_TOP),
                               f"SIFT bucketed rerank={rr_depth}")
        for b in range(N_CHECK):
            swapped += same_results(got[b], want[b],
                                    f"SIFT query_batch rerank={rr_depth} [{b}]")
    log(f"SIFT results of {N_CHECK} queries, from the bucketed index and from"
        f" Database.query_batch, agree with the CPU plain path "
        f"({ref._device_state().layout} layout), with and without rerank "
        f"({swapped} tie swaps; {time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    masked = DeviceIndex(*arrays, layout="masked", metric=db.metric,
                         device="cuda")
    masked.query(q, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, masked_ms = timed(lambda: masked.query(q, **kw))
    peak = torch.cuda.max_memory_allocated() - base
    m_d, m_r, m_p = masked.query(qc, **kw)
    b_d, b_r, b_p = index.query(qc, **kw)
    require(np.array_equal(m_p, b_p), "masked layout probed other partitions")
    swapped = same_arrays((m_d, m_r), (b_d, b_r), "masked vs bucketed")
    swapped += same_arrays(
        masked.query_rerank(qc, orig, rerank=RERANK, **kw),
        index.query_rerank(qc, orig, rerank=RERANK, **kw),
        "masked vs bucketed, rerank")
    log(f"masked layout ({masked._masked_batch_limit()} queries a chunk): "
        f"warm DeviceIndex.query of {SIFT_NQ} queries {masked_ms:.3f} ms, "
        f"peak device memory above its inputs {peak / 2**20:.1f} MiB of a "
        f"{masked.hbm_budget_bytes / 2**20:.0f} MiB budget; gives the "
        f"bucketed results for {N_CHECK} queries, with and without rerank "
        f"({swapped} tie swaps; {time.perf_counter() - t0:.3f} s)")
    require(peak <= masked.hbm_budget_bytes,
            f"the masked scan took {peak} bytes, over its budget")
    state = {"index": index, "arrays": arrays, "q": q, "adc": adc, "db": db,
             "batch": qb_res, "x": x, "gt": gt, "recall": r_adc,
             "build_launches": after_build}
    return launches, scan_at_main_path(torch, index, q, SIFT_NPROBE,
                                       "the SIFT path's"), state


# --- phase 4: filters, range search and updates ------------------------------

def near(a: float, b: float) -> bool:
    return abs(a - b) <= ATOL + RTOL * abs(b)


def same_hits(got, want, radius: float, what: str, cap=None) -> int:
    """Two range answers for one query, ``(rows, keys)`` ascending: the
    rows both hold have keys within the tolerance (so the orders agree up
    to ties), and a row only one holds has its key within the tolerance
    of the radius or, under a ``cap`` that a side fills, of that side's
    last key. Returns the number of such rows."""
    (g_rows, g_keys), (w_rows, w_keys) = got, want
    for keys in (g_keys, w_keys):
        require(bool(np.all(np.diff(keys) >= 0)), f"{what}: not ascending")
        require(bool(np.all(keys <= radius)), f"{what}: a key over the "
                "radius")
    edges = [radius] + [float(k[-1]) for k in (g_keys, w_keys)
                        if cap is not None and len(k) == cap]
    g, w = dict(zip(np.asarray(g_rows).tolist(), g_keys.tolist())), \
        dict(zip(np.asarray(w_rows).tolist(), w_keys.tolist()))
    for r in g.keys() & w.keys():
        require(near(g[r], w[r]), f"{what}: row {r} key {g[r]} != {w[r]}")
    only = [(r, k) for side, other in ((g, w), (w, g))
            for r, k in side.items() if r not in other]
    for r, k in only:
        require(any(near(k, e) for e in edges),
                f"{what}: row {r} (key {k}) is in one answer only")
    return len(only)


def hits(results, row_of):
    """``QueryResult`` list as ``(rows, keys)`` arrays."""
    return (np.array([row_of[r.vector_id] for r in results], np.int64),
            np.array([r.squared_distance for r in results], np.float32))


def headline_filters(ft, tenant, lang):
    """The phase's filters, each with its mask computed apart in numpy:
    tenant isolation (10%), a tenant and a language (about 2.5%), a
    language pair or the first two tenants, and one that matches
    nothing."""
    pair = [LANGS[0], LANGS[2]]
    return [
        ("Eq(tenant, 3)", ft.Eq("tenant", 3), tenant == 3),
        (f"Eq(tenant, 3) & Eq(lang, {LANGS[1]!r})",
         ft.Eq("tenant", 3) & ft.Eq("lang", LANGS[1]),
         (tenant == 3) & (lang == 1)),
        (f"In(lang, {pair}) | Range(tenant, hi=1)",
         ft.In("lang", pair) | ft.Range("tenant", hi=1),
         np.isin(lang, [0, 2]) | (tenant <= 1)),
        ("~Exists(tenant)", ~ft.Exists("tenant"), np.zeros(len(tenant),
                                                           bool)),
    ]


def filters_part(ft, db, ref, masked, q, cases, row_of) -> None:
    """Every filter through ``query_batch`` with and without rerank and
    ``query``, against numpy's mask and the CPU plain path; the bucketed
    and masked ``DeviceIndex`` under the same ``row_mask``."""
    index = db._device_state()
    for name, where, want_mask in cases:
        db._invalidate_filters()
        mask, first_ms = timed(lambda: db._filter_mask(where))
        _, mask_ms = timed(lambda: db._filter_mask(where))
        require(np.array_equal(mask, want_mask), f"{name}: mask differs "
                "from numpy's")
        db.query_batch(q, K_TOP, NPROBE, where=where)
        db.query_batch(q, K_TOP, NPROBE, rerank=RERANK, where=where)
        got, ms = timed(lambda: db.query_batch(q, K_TOP, NPROBE,
                                               where=where))
        got_rr, rr_ms = timed(lambda: db.query_batch(
            q, K_TOP, NPROBE, rerank=RERANK, where=where))
        one, one_ms = timed(lambda: db.query(q[0], K_TOP, NPROBE,
                                             where=where))
        for rs in got + got_rr + [one]:
            require(all(want_mask[row_of[r.vector_id]] for r in rs),
                    f"{name}: a result fails the filter")
        if not want_mask.any():
            require(not any(got + got_rr + [one]),
                    f"{name}: results for a filter that matches nothing")
        swapped = 0
        for rr, mine in ((None, got), (RERANK, got_rr)):
            want = ref.query_batch(q, K_TOP, NPROBE, rerank=rr, where=where)
            for b in range(len(q)):
                swapped += same_results(mine[b], want[b],
                                        f"{name} rerank={rr} [{b}]")
        swapped += same_results(one, ref.query(q[0], K_TOP, NPROBE,
                                               where=where), f"{name} query")
        b_d, b_r, b_p = index.query(q, K_TOP, NPROBE, row_mask=mask)
        m_d, m_r, m_p = masked.query(q, K_TOP, NPROBE, row_mask=mask)
        require(np.array_equal(b_p, m_p), f"{name}: layouts probed apart")
        swapped += same_arrays((m_d, m_r), (b_d, b_r), f"{name} masked")
        log(f"filter {name}: {int(want_mask.sum())} rows; mask first use "
            f"{first_ms:.3f} ms (column cache built), cached {mask_ms:.3f} "
            f"ms; warm query_batch({len(q)}) {ms:.3f} ms, rerank={RERANK} "
            f"{rr_ms:.3f} ms, query {one_ms:.3f} ms; "
            f"{sum(map(len, got))} results, equal to the CPU path and the "
            f"masked layout ({swapped} tie swaps)")


def range_part(ft, db, ref, masked, q, row_of, tenant, sift) -> None:
    """Range search at the headline (bucketed and masked, against the CPU
    path and against each query's top-10) and at the SIFT buckets."""
    from flechasdb_tpu_torch.serving import DeviceIndex
    index = db._device_state()
    d11 = host_arrays(db.query_batch(q, K_TOP + 1, NPROBE), row_of,
                      K_TOP + 1)[0]
    radius = float(np.median((d11[:, K_TOP - 1] + d11[:, K_TOP]) / 2))
    index.query_range(q, radius, NPROBE)
    ms = []
    for _ in range(3):
        got, t = timed(lambda: index.query_range(q, radius, NPROBE))
        ms.append(t)
    edge = 0
    for what, other in (("the CPU path", ref._device_state()),
                        ("the masked layout", masked)):
        want = other.query_range(q, radius, NPROBE)
        for b in range(len(q)):
            edge += same_hits(got[b], want[b], radius,
                              f"range vs {what} [{b}]")
    top = db.query_batch(q, K_TOP, NPROBE)
    for b in range(len(q)):
        lim = db.query_range(q[b], radius, NPROBE, limit=K_TOP)
        near_top = [r for r in top[b] if r.squared_distance <= radius]
        edge += same_hits(hits(lim, row_of), hits(near_top, row_of),
                          radius, f"range limit={K_TOP} vs top-{K_TOP} [{b}]",
                          cap=K_TOP)
    where, n_hits = ft.Eq("tenant", 3), 0
    for b in range(8):
        res = db.query_range(q[b], radius, NPROBE, where=where)
        require(all(tenant[row_of[r.vector_id]] == 3 for r in res),
                "filtered range: a row fails the filter")
        edge += same_hits(hits(res, row_of), hits(ref.query_range(
            q[b], radius, NPROBE, where=where), row_of), radius,
            f"filtered range [{b}]")
        n_hits += len(res)
    require(n_hits > 0, "filtered range found nothing")
    log(f"range, headline: radius {radius:.6f} (median over {len(q)} "
        f"queries of the 10th/11th midpoint); DeviceIndex.query_range("
        f"{len(q)}) warm {statistics.median(ms):.3f} ms (median of 3: "
        f"{', '.join(f'{v:.3f}' for v in ms)}), "
        f"{sum(len(r) for r, _ in got)} hits; equal to the CPU path, the "
        f"masked layout and each query's top-{K_TOP} under the radius; "
        f"Eq(tenant, 3) range {n_hits} hits over 8 queries ({edge} rows "
        "at the radius or cap)")

    s_index, s_q = sift["index"], sift["q"]
    s_radius = float(np.median(sift["adc"][0][:, K_TOP - 1]))
    kw = dict(radius=s_radius, nprobe=SIFT_NPROBE)
    _, s_first = timed(lambda: s_index.query_range(s_q, **kw))
    s_ms = []
    for _ in range(3):
        s_got, t = timed(lambda: s_index.query_range(s_q, **kw))
        s_ms.append(t)
    cpu = DeviceIndex(*sift["arrays"], layout="bucketed", device="cpu")
    s_want = cpu.query_range(s_q[:N_CHECK], **kw)
    edge = sum(same_hits(s_got[b], s_want[b], s_radius, f"SIFT range [{b}]")
               for b in range(N_CHECK))
    log(f"range, SIFT buckets: radius {s_radius:.3f} (median 10th "
        f"distance); DeviceIndex(layout='bucketed').query_range({len(s_q)},"
        f" nprobe={SIFT_NPROBE}) first {s_first:.3f} ms, warm "
        f"{statistics.median(s_ms):.3f} ms (median of 3: "
        f"{', '.join(f'{v:.3f}' for v in s_ms)}), "
        f"{sum(len(r) for r, _ in s_got)} hits, {N_CHECK} equal to the CPU "
        f"path ({edge} rows at the radius)")


def updates_part(torch, ft, db, x, q, batch, tenant, seed, row_of):
    """``add_vectors`` of N_ADD unit rows, queries against the CPU path,
    ``encode`` of built rows, then ``remove_vectors`` back to the build.
    Returns the index the add gave (its buckets, for K-A's check)."""
    from flechasdb_tpu_torch.ops.encode import encode
    rng = np.random.default_rng(seed + 1)
    new = rng.standard_normal((N_ADD, M), dtype=np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    before = (db.partition_indices, db.codes, db.residues,
              list(db.vector_ids), dict(db.attribute_table))
    l0 = db._device_state().buckets.codes.shape[2]
    ids, add_ms = timed(lambda: db.add_vectors(new, seed=seed))
    require(db._dev is None and db._dev_orig is None,
            "add_vectors kept the old device index")
    got_new, first_ms = timed(lambda: db.query_batch(new[:N_BATCH], K_TOP,
                                                     NPROBE))
    grown = db._device_state()
    _, warm_ms = timed(lambda: db.query_batch(new[:N_BATCH], K_TOP, NPROBE))
    for i, rs in enumerate(got_new):
        require(ids[i] in [r.vector_id for r in rs],
                f"added row {i} is not in its own top {K_TOP}")
    ref = ft.Database(**ft.to_arrays(db), device="cpu")
    where = ft.Eq("tenant", 3)
    swapped = 0
    for qs, kw in ((new[:N_BATCH], {}), (q, {}), (q, {"where": where})):
        mine = db.query_batch(qs, K_TOP, NPROBE, **kw)
        want = ref.query_batch(qs, K_TOP, NPROBE, **kw)
        for b in range(len(qs)):
            swapped += same_results(mine[b], want[b], f"after add [{b}]")
    for rs in mine:                     # the filtered queries, run last
        require(all(r.vector_id in row_of and tenant[row_of[r.vector_id]]
                    == 3 for r in rs), "a filtered query after the add "
                "returned a row without the attribute")
    log(f"add_vectors({N_ADD}): {add_ms:.3f} ms; bucket length {l0} -> "
        f"{grown.buckets.codes.shape[2]}; query_batch({N_BATCH}) of added "
        f"rows first {first_ms:.3f} ms (rebuilds the device index), warm "
        f"{warm_ms:.3f} ms; each finds itself in its top {K_TOP}; equal to "
        f"the CPU path, filtered too ({swapped} tie swaps)")

    xe = torch.tensor(x[:N_ADD], device="cuda")
    pidx, codes = (t.cpu().numpy() for t in encode(
        xe, torch.tensor(db.partition_centroids, device="cuda"),
        torch.tensor(db.codebooks, device="cuda")))
    same_p = pidx == before[0][:N_ADD]
    other_c = (codes != before[1][:N_ADD])[same_p].any(axis=1)
    log(f"encode of {N_ADD} built rows on the card: {int((~same_p).sum())} "
        f"differ from the build's partition, {int(other_c.sum())} of the "
        "others in a code (no threshold: the build assigns with 3xTF32 "
        "against its pre-update centroids, encode in full f32)")

    n, rm_ms = timed(lambda: db.remove_vectors(ids))
    require(n == N_ADD, f"remove_vectors removed {n}")
    for name, a, b in zip(("partition_indices", "codes", "residues"),
                          (db.partition_indices, db.codes, db.residues),
                          before):
        require(np.array_equal(a, b), f"{name} differ from before the add")
    require(db.vector_ids == before[3] and db.attribute_table == before[4],
            "ids or attributes differ from before the add")
    after = db.query_batch(q, K_TOP, NPROBE)
    swapped = exact = 0
    for b in range(len(q)):
        swapped += same_results(after[b], batch[b], f"after remove [{b}]")
        exact += sum(g.squared_distance == w.squared_distance
                     and g.vector_id == w.vector_id
                     for g, w in zip(after[b], batch[b]))
    log(f"remove_vectors({N_ADD}): {rm_ms:.3f} ms; host arrays equal to "
        f"before the add; query_batch({len(q)}) gives phase 2's results "
        f"({exact} of {sum(map(len, batch))} distances bit-equal, "
        f"{swapped} tie swaps)")
    return grown


def updates_run(torch, seed: int, head: dict, sift: dict):
    """Phase 4 over phase 2's database and phase 3's SIFT index: the launch
    counts are zeroed before it and read after it."""
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels
    from flechasdb_tpu_torch.serving import DeviceIndex
    db, ref, x, q = head["db"], head["ref"], head["x"], head["q"]
    rng = np.random.default_rng(seed + 2)
    tenant = np.arange(N) % 10
    lang = rng.integers(0, len(LANGS), N)
    row_of = {vid: i for i, vid in enumerate(db.vector_ids)}
    t0 = time.perf_counter()
    for i in range(N):
        db.set_attribute_at(i, ("tenant", int(tenant[i])))
        db.set_attribute_at(i, ("lang", LANGS[lang[i]]))
    log(f"set_attribute_at x {2 * N}: {time.perf_counter() - t0:.3f} s")
    masked = DeviceIndex(db.partition_centroids, db.codebooks,
                         db.codes.astype(np.int32), db.partition_indices,
                         layout="masked", device="cuda")

    _kernels.reset_launches()
    torch.cuda.synchronize()
    filters_part(ft, db, ref, masked, q, headline_filters(ft, tenant, lang),
                 row_of)
    range_part(ft, db, ref, masked, q, row_of, tenant, sift)
    grown = updates_part(torch, ft, db, x, q, head["batch"], tenant, seed,
                         row_of)
    head["tenant"], head["lang"] = tenant, lang
    launches = dict(_kernels.LAUNCHES)
    log(f"launches over phase 4: {launches}")
    require(launches["adc_scan"] > 0, "phase 4 launched no adc_scan")
    return launches, scan_at_main_path(torch, grown, q, NPROBE,
                                       "the updated headline's")


# --- phase 5: the stored tier ------------------------------------------------

def tree_files(base: Path) -> dict:
    return {f.relative_to(base).as_posix(): f.read_bytes()
            for f in sorted(base.rglob("*")) if f.is_file()}


def loaded(sdb) -> int:
    return sum(p is not None for p in sdb._partitions)


def level_flip(path: Path) -> None:
    """Changes one byte of a stored zlib stream: its header's level hint
    (FLG 0x9C, level 6, to 0xDA). The stream still inflates to the same
    payload, so only the content hash can catch the change."""
    raw = bytearray(path.read_bytes())
    require(raw[:2] == b"\x78\x9c", f"{path.name}: not a level-6 zlib "
            "stream")
    raw[1] = 0xDA
    path.write_bytes(bytes(raw))


def stored_headline(ft, head: dict, work: Path):
    """Save, round trip, cold queries, preload and warm queries of phase
    2's database (with phase 4's attributes); a flipped byte. Returns the
    stored database (its device index, for K-A's check)."""
    db, q, batch = head["db"], head["q"], head["batch"]
    qs, singles = head["q_single"], head["singles"]
    tenant, lang = head["tenant"], head["lang"]
    row_of = {vid: i for i, vid in enumerate(db.vector_ids)}
    fs = ft.LocalFileSystem(work / "headline")
    root, save_ms = timed(lambda: ft.save_database(db, fs))
    files = tree_files(work / "headline")
    mem, mat_ms = timed(lambda: ft.load_database(
        fs, f"{root}.binpb", device="cuda").to_database())
    root2, resave_ms = timed(lambda: ft.save_database(
        mem, ft.LocalFileSystem(work / "resaved")))
    del mem
    require(root2 == root, f"the round trip saved root {root2} != {root}")
    require(tree_files(work / "resaved") == files,
            "the round trip's tree differs from the first save's")
    log(f"stored headline: save_database {save_ms:.3f} ms, "
        f"{len(files)} files, {sum(map(len, files.values()))} bytes; "
        f"load_database -> to_database {mat_ms:.3f} ms, save again "
        f"{resave_ms:.3f} ms: root {root}, every file byte-equal")

    sdb, load_ms = timed(lambda: ft.load_database(fs, f"{root}.binpb",
                                                  device="cuda"))
    cold_ms, swapped = [], 0
    for i, v in enumerate(qs):
        got, ms = timed(lambda: sdb.query(v, K_TOP, NPROBE))
        cold_ms.append(ms)
        require(loaded(sdb) <= NPROBE * (i + 1),
                f"cold query {i} loaded {loaded(sdb)} partitions")
        swapped += same_results(got, singles[i], f"cold query[{i}]")
        for r in got:
            row = row_of[r.vector_id]
            require(r.get_attribute("tenant") == int(tenant[row])
                    and r.get_attribute("lang") == LANGS[lang[row]],
                    f"cold query[{i}]: attributes of row {row} differ")
    first_loaded = loaded(sdb)
    _, again_ms = timed(lambda: sdb.query(qs[0], K_TOP, NPROBE))
    log(f"stored headline, cold (host scan): load_database {load_ms:.3f} ms;"
        f" first query {cold_ms[0]:.3f} ms, the next {N_SINGLE - 1} "
        f"{', '.join(f'{v:.3f}' for v in cold_ms[1:])} ms, the first "
        f"again {again_ms:.3f} ms; {first_loaded} of {P} partitions "
        f"loaded; equal to phase 2's Database.query ({swapped} tie swaps);"
        " tenant and lang read back")

    _, preload_ms = timed(sdb.preload)
    index = sdb._dev[0]
    require(index.layout == "bucketed" and index.device.type == "cuda",
            f"preload built a {index.layout} index on {index.device}")
    _, first_ms = timed(lambda: sdb.query_batch(q, K_TOP, NPROBE))
    got, warm_ms = timed(lambda: sdb.query_batch(q, K_TOP, NPROBE))
    for b, (g, w) in enumerate(zip(got, batch)):
        require([(r.vector_id, r.squared_distance) for r in g]
                == [(r.vector_id, r.squared_distance) for r in w],
                f"preloaded query_batch[{b}] differs from phase 2's")
    one, one_ms = timed(lambda: sdb.query(qs[0], K_TOP, NPROBE))
    swapped = same_results(one, singles[0], "preloaded query")
    name, where, mask = headline_filters(ft, tenant, lang)[1]
    sdb.query_batch(q, K_TOP, NPROBE, where=where)
    fgot, f_ms = timed(lambda: sdb.query_batch(q, K_TOP, NPROBE,
                                               where=where))
    fwant = db.query_batch(q, K_TOP, NPROBE, where=where)
    for b in range(len(q)):
        require(all(mask[row_of[r.vector_id]] for r in fgot[b]),
                f"{name}: a stored result fails the filter")
        swapped += same_results(fgot[b], fwant[b], f"stored {name} [{b}]")
    radius = float(np.median([rs[K_TOP - 1].squared_distance
                              for rs in batch]))
    rwant = db._device_state().query_range(q, radius, NPROBE)
    rgot, r_ms = timed(lambda: [sdb.query_range(v, radius, NPROBE)
                                for v in q])
    edge = sum(same_hits(hits(rgot[b], row_of), rwant[b], radius,
                         f"stored query_range [{b}]") for b in range(len(q)))
    log(f"stored headline, warm: preload {preload_ms:.3f} ms; "
        f"query_batch({N_BATCH}) first {first_ms:.3f} ms, warm "
        f"{warm_ms:.3f} ms, every row and distance bit-equal to phase 2's;"
        f" query {one_ms:.3f} ms; query_batch(where={name}) {f_ms:.3f} ms "
        f"against numpy's mask and the in-memory database ({swapped} tie "
        f"swaps); query_range x {len(q)} {r_ms:.3f} ms, "
        f"{sum(map(len, rgot))} hits, equal to DeviceIndex.query_range "
        f"({edge} rows at the radius)")

    shutil.copytree(work / "headline", work / "flipped")
    level_flip(work / "flipped" / "partitions" /
               f"{sdb.root.partition_ids[0]}.binpb")
    broken = ft.load_database(ft.LocalFileSystem(work / "flipped"),
                              f"{root}.binpb", device="cuda")
    broken.get_partition(1)
    try:
        broken.get_partition(0)
    except ft.VerificationFailure as e:
        log(f"flipped byte in partition 0's file: VerificationFailure: {e}")
    else:
        raise AssertionError("a flipped partition file loaded")
    return sdb


def stored_sift(ft, sift: dict, work: Path) -> None:
    """Save, lazy cold queries, preload and 1000 warm queries of phase 3's
    database."""
    db, q, want = sift["db"], sift["q"], sift["batch"]
    fs = ft.LocalFileSystem(work / "sift")
    root, save_ms = timed(lambda: ft.save_database(db, fs))
    size = sum(f.stat().st_size for f in (work / "sift").rglob("*.binpb"))
    sdb, load_ms = timed(lambda: ft.load_database(fs, f"{root}.binpb",
                                                  device="cuda"))
    cold_ms, swapped = [], 0
    for i in range(N_SINGLE):
        before = loaded(sdb)
        got, ms = timed(lambda: sdb.query(q[i], K_TOP, SIFT_NPROBE))
        cold_ms.append(ms)
        require(loaded(sdb) - before <= SIFT_NPROBE,
                f"SIFT cold query {i} loaded {loaded(sdb) - before} "
                "partitions")
        swapped += same_results(got, want[i], f"SIFT cold query[{i}]")
    n_loaded = loaded(sdb)
    _, preload_ms = timed(sdb.preload)
    layout = sdb._dev[0].layout
    require(layout == "bucketed", f"the policy picked {layout}")
    got, qb_ms = timed(lambda: sdb.query_batch(q, K_TOP, SIFT_NPROBE))
    exact = 0
    for b in range(len(q)):
        swapped += same_results(got[b], want[b], f"SIFT stored [{b}]")
        exact += sum(g.squared_distance == w.squared_distance
                     for g, w in zip(got[b], want[b]))
    sift["stored_db"], sift["stored_batch"] = sdb, got
    log(f"stored SIFT: save_database {save_ms:.3f} ms, {size} bytes; "
        f"load_database {load_ms:.3f} ms; {N_SINGLE} cold queries at "
        f"nprobe={SIFT_NPROBE}: {', '.join(f'{v:.3f}' for v in cold_ms)} ms,"
        f" {n_loaded} of {SIFT_P} partitions loaded; preload "
        f"{preload_ms:.3f} ms ({layout} layout); query_batch({len(q)}) "
        f"{qb_ms:.3f} ms, equal to phase 3's Database.query_batch "
        f"({exact} of {sum(map(len, want))} distances bit-equal, {swapped} "
        "tie swaps)")


def stored_golden(ft) -> None:
    """``tests/fixtures/goldendb`` (read-only) loaded on the card, queried
    cold and after preload, against its recorded results."""
    import uuid
    fix = Path(__file__).resolve().parent / "tests" / "fixtures"
    root = (fix / "goldendb_root.txt").read_text().strip()
    x = np.load(fix / "goldendb_vectors.npy")
    expected = [line.split(",") for line in
                (fix / "goldendb_expected.txt").read_text().splitlines()]
    sdb = ft.load_database(ft.LocalFileSystem(fix / "goldendb"),
                           f"{root}.binpb", device="cuda")
    cold = sdb.query(x[10], k=5, nprobe=4)
    sdb.preload()
    warm = sdb.query(x[10], k=5, nprobe=4)
    for what, res in (("cold", cold), ("preloaded", warm)):
        require(len(res) == len(expected), f"goldendb {what}: "
                f"{len(res)} results")
        for r, (vid, pi, vi, dist) in zip(res, expected):
            require(r.vector_id == uuid.UUID(vid)
                    and r.partition_index == int(pi)
                    and r.vector_index == int(vi)
                    and abs(r.squared_distance - float(dist)) <= 1e-4,
                    f"goldendb {what}: {r} != {vid},{pi},{vi},{dist}")
    log(f"goldendb on the card: cold and preloaded ({sdb._dev[0].layout}) "
        "queries give the recorded results")


def stored_run(torch, head: dict, sift: dict, work: Path):
    """Phase 5: the launch counts are zeroed before it and read after. Its
    trees stay in ``work`` for phase 7."""
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels
    _kernels.reset_launches()
    torch.cuda.synchronize()
    sdb = stored_headline(ft, head, work)
    head["stored_db"] = sdb              # phase 11 preloads it on a mesh
    stored_launches = _kernels.LAUNCHES["adc_scan"]
    stored_sift(ft, sift, work)
    stored_golden(ft)
    launches = dict(_kernels.LAUNCHES)
    log(f"launches over phase 5: {launches}")
    require(stored_launches > 0, "the preloaded headline launched no "
            "adc_scan")
    return launches, scan_at_main_path(torch, sdb._dev[0], head["q"], NPROBE,
                                       "the stored headline's")


# --- phase 6: fast-math training and OPQ -------------------------------------

def event_timed_build(torch, builder):
    """``builder.build_with_events``, the device synchronized at the edges
    of the coarse fit and of the PQ fit (OPQ's whole fit under
    ``with_opq``): ``(db, build s, coarse fit s, PQ fit s)``."""
    marks = {}

    def on(e):
        name = type(e).__name__
        if name in ("StartingPartitioning", "FinishedPartitioning",
                    "FinishedQuantization") or (
                name == "StartingQuantization" and name not in marks):
            torch.cuda.synchronize()
            marks[name] = time.perf_counter()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = builder.build_with_events(on)
    torch.cuda.synchronize()
    return (db, time.perf_counter() - t0,
            marks["FinishedPartitioning"] - marks["StartingPartitioning"],
            marks["FinishedQuantization"] - marks["StartingQuantization"])


def pq_error(torch, db, residues=None) -> float:
    """Mean over rows of ``‖residue·R − reconstruction‖²`` (``R`` the OPQ
    rotation, or none), on the card: the PQ inertia a row. ``residues``:
    a tensor on the card in the place of ``db.residues``."""
    from flechasdb_tpu_torch.ops import kmeans, opq
    m = db.vector_size
    rot = (torch.eye(m, device="cuda") if db.rotation is None
           else torch.as_tensor(db.rotation, device="cuda"))
    pq = kmeans.KMeansResult(
        torch.as_tensor(db.codebooks, device="cuda"),
        torch.as_tensor(np.ascontiguousarray(db.codes.T.astype(np.int64)),
                        device="cuda"), None, None)
    if residues is None:
        residues = torch.as_tensor(db.residues, device="cuda")
    return opq.quantization_error(residues, rot, pq, d=db.num_divisions)


def recall_at(rows: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(rows[b].tolist()) & set(gt[b].tolist()))
                          / gt.shape[1] for b in range(len(gt))]))


def agreement(torch, head: dict) -> tuple[float, float]:
    """One Lloyd round, fast against full, from phase 2's centroids: the
    share of equal picks at the coarse fit (K-B, B=1, K=100, M=1536) and
    at the PQ fit (K-B, B=12, K=256, m=128, on phase 2's residues)."""
    from flechasdb_tpu_torch.ops import lloyd
    db = head["db"]
    out = []
    for x, c in (
            (torch.as_tensor(head["x"], device="cuda")[None],
             torch.as_tensor(db.partition_centroids, device="cuda")[None]),
            (torch.as_tensor(db.residues, device="cuda")
             .reshape(N, D, M // D).transpose(0, 1).contiguous(),
             torch.as_tensor(db.codebooks, device="cuda"))):
        full = lloyd.lloyd_round(x, c)[0]
        fast = lloyd.lloyd_round(x, c, fast_math=True)[0]
        out.append(float((full == fast).float().mean()))
        del x, c, full, fast
    return out[0], out[1]


def fast_headline(torch, ft, head: dict, seed: int) -> None:
    """``with_fast_math()`` at the headline shape, against phase 2's
    full-precision build: recall@10 over N_RECALL queries, PQ inertia."""
    x, full = head["x"], head["db"]
    rng = np.random.default_rng(seed + 3)
    qr = x[rng.choice(N, N_RECALL, replace=False)]
    qr = qr + 0.02 * rng.standard_normal(qr.shape, dtype=np.float32)
    gt = ground_truth(torch, x, qr, K_TOP)
    db, build_s, coarse_s, pq_s = event_timed_build(
        torch, ft.DatabaseBuilder(x, device="cuda").with_partitions(P)
        .with_divisions(D).with_clusters(C).with_seed(seed).with_fast_math())
    check_build(db, x, P, D, C)
    layout = db._device_state().layout
    recalls = []
    for d in (full, db):
        row_of = {vid: i for i, vid in enumerate(d.vector_ids)}
        res = d.query_batch(qr, K_TOP, NPROBE)
        recalls.append(recall_at(host_arrays(res, row_of, K_TOP)[1], gt))
    errs = pq_error(torch, full), pq_error(torch, db)
    log(f"fast headline: build {build_s:.3f} s (coarse fit {coarse_s:.3f} s,"
        f" PQ fit {pq_s:.3f} s), {layout} layout; recall@10 over "
        f"{N_RECALL} queries at nprobe={NPROBE}: {recalls[1]:.4f} "
        f"(phase 2's build {recalls[0]:.4f}); PQ inertia a row "
        f"{errs[1]:.6f} (phase 2's {errs[0]:.6f}, ratio "
        f"{errs[1] / errs[0]:.4f})")
    require(abs(recalls[1] - recalls[0]) <= 0.02,
            f"fast recall {recalls[1]} not within 0.02 of {recalls[0]}")
    require(abs(errs[1] - errs[0]) <= 0.05 * errs[0],
            f"fast PQ inertia {errs[1]} not within 5% of {errs[0]}")


def fast_sift(torch, ft, sift: dict, seed: int) -> None:
    """``with_fast_math()`` at the SIFT shape (K-B fast at K=1024, K-C fast
    at m=16), against phase 3's build."""
    from flechasdb_tpu_torch.serving import DeviceIndex
    x, q, gt = sift["x"], sift["q"], sift["gt"]
    db, build_s, coarse_s, pq_s = event_timed_build(
        torch, ft.DatabaseBuilder(x, device="cuda").with_partitions(SIFT_P)
        .with_divisions(SIFT_D).with_clusters(C).with_seed(seed)
        .with_fast_math())
    check_build(db, x, SIFT_P, SIFT_D, C)
    index = DeviceIndex(db.partition_centroids, db.codebooks,
                        db.codes.astype(np.int32), db.partition_indices,
                        layout="bucketed", device="cuda")
    _, rows, probed = index.query(q, K_TOP, SIFT_NPROBE)
    recall = recall_at(rows, gt)
    coarse = coarse_at(db.partition_indices, gt, probed)
    log(f"fast SIFT: build {build_s:.3f} s (coarse fit {coarse_s:.3f} s, PQ"
        f" fit {pq_s:.3f} s); recall@10 {recall:.4f} (phase 3's "
        f"{sift['recall']:.4f}), coarse@10 {coarse:.4f}; PQ inertia a row "
        f"{pq_error(torch, db):.4f} (phase 3's {pq_error(torch, sift['db']):.4f})")
    require(abs(recall - sift["recall"]) <= 0.02,
            f"fast SIFT recall {recall} not within 0.02 of {sift['recall']}")
    require(coarse >= 0.95, f"fast SIFT coarse@10 {coarse} < 0.95")


def sift_opq(torch, ft, sift: dict, seed: int, work: Path):
    """The JAX package's ``sift-opq`` configuration on phase 3's data:
    build (OPQ's parts timed), quality, K-A on rotated tables against the
    CPU path and the masked layout, the stored round trip, an add.
    Returns the bucketed index (for K-A's check)."""
    from flechasdb_tpu_torch.ops import opq as opq_mod
    from flechasdb_tpu_torch.serving import DeviceIndex
    x, q, gt, base = sift["x"], sift["q"], sift["gt"], sift["db"]
    times = {}
    real = opq_mod.fit_opq
    # The builder imports fit_opq at build time: this one also times its
    # parts.
    opq_mod.fit_opq = lambda *a, **kw: real(*a, times=times, **kw)
    try:
        db, build_s, coarse_s, opq_s = event_timed_build(
            torch, ft.DatabaseBuilder(x, device="cuda")
            .with_partitions(SIFT_P).with_divisions(SIFT_D).with_clusters(C)
            .with_seed(seed).with_opq(OPQ_ITERS))
    finally:
        opq_mod.fit_opq = real
    check_build(db, x, SIFT_P, SIFT_D, C)
    rot = db.rotation
    orth = float(np.abs(rot.astype(np.float64) @ rot.T.astype(np.float64)
                        - np.eye(SIFT_M)).max())
    log(f"SIFT-OPQ: build {build_s:.3f} s (coarse fit {coarse_s:.3f} s, OPQ "
        f"fit {opq_s:.3f} s, {OPQ_ITERS} iterations: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(times.items()))
        + f"); max|RR^T - I| {orth:.3g}")
    require(orth <= 1e-4, f"the rotation is not orthogonal: {orth}")

    arrays = (db.partition_centroids, db.codebooks,
              db.codes.astype(np.int32), db.partition_indices)
    index = DeviceIndex(*arrays, layout="bucketed", rotation=rot,
                        device="cuda")
    kw = dict(k=K_TOP, nprobe=SIFT_NPROBE)
    _, first_ms = timed(lambda: index.query(q, **kw))
    adc, warm_ms = timed(lambda: index.query(q, **kw))
    recall = recall_at(adc[1], gt)
    cpu = DeviceIndex(*arrays, layout="bucketed", rotation=rot, device="cpu")
    swapped = same_arrays((adc[0][:N_CHECK], adc[1][:N_CHECK]),
                          cpu.query(q[:N_CHECK], **kw)[:2],
                          "SIFT-OPQ bucketed vs the CPU path")
    masked = DeviceIndex(*arrays, layout="masked", rotation=rot,
                         device="cuda")
    m_d, m_r, m_p = masked.query(q, **kw)
    require(np.array_equal(m_p, adc[2]), "SIFT-OPQ: layouts probed apart")
    swapped += same_arrays((m_d, m_r), adc[:2], "SIFT-OPQ masked vs bucketed")
    log(f"SIFT-OPQ DeviceIndex(layout='bucketed', rotation=R).query("
        f"{SIFT_NQ}): first {first_ms:.3f} ms, warm {warm_ms:.3f} ms; "
        f"recall@10 {recall:.4f} (phase 3's {sift['recall']:.4f}); "
        f"{N_CHECK} queries equal to the CPU path, {SIFT_NQ} to the masked "
        f"layout ({swapped} tie swaps)")
    require(recall >= sift["recall"] - 0.02,
            f"OPQ recall {recall} below phase 3's {sift['recall']} - 0.02")

    fs = ft.LocalFileSystem(work / "sift-opq")
    root, save_ms = timed(lambda: ft.save_database(db, fs))
    rotations = list((work / "sift-opq" / "rotations").glob("*.binpb"))
    require(len(rotations) == 1, f"the tree holds {len(rotations)} "
            "rotation files")
    sdb = ft.load_database(fs, f"{root}.binpb", device="cuda")
    swapped = 0
    for i in range(N_SINGLE):
        swapped += same_results(sdb.query(q[i], **kw), db.query(q[i], **kw),
                                f"SIFT-OPQ cold query[{i}]")
    _, preload_ms = timed(sdb.preload)
    require(sdb._dev[0].rotation is not None, "preload dropped the rotation")
    got, qb_ms = timed(lambda: sdb.query_batch(q, **kw))
    want = db.query_batch(q, **kw)
    for b in range(len(q)):
        require([(r.vector_id, r.squared_distance) for r in got[b]]
                == [(r.vector_id, r.squared_distance) for r in want[b]],
                f"SIFT-OPQ preloaded query_batch[{b}] differs")
    log(f"SIFT-OPQ stored: save_database {save_ms:.3f} ms (rotation "
        f"{rotations[0].name}); {N_SINGLE} cold queries equal to the "
        f"in-memory ones ({swapped} tie swaps); preload {preload_ms:.3f} ms "
        f"({sdb._dev[0].layout} layout); query_batch({SIFT_NQ}) "
        f"{qb_ms:.3f} ms, every row and distance bit-equal to the in-memory "
        "database's")

    built = ft.Database(**ft.to_arrays(db), device="cuda")  # before the add
    rng = np.random.default_rng(seed + 4)
    new = x[rng.choice(SIFT_N, N_ADD, replace=False)] \
        + 0.05 * rng.standard_normal((N_ADD, SIFT_M), dtype=np.float32)
    ids, add_ms = timed(lambda: db.add_vectors(new, seed=seed))
    res, q_ms = timed(lambda: db.query_batch(new[:N_BATCH], **kw))
    found = sum(ids[i] in [r.vector_id for r in rs]
                for i, rs in enumerate(res))
    ref = ft.Database(**ft.to_arrays(db), device="cpu")
    swapped = 0
    for b, want in enumerate(ref.query_batch(new[:16], **kw)):
        swapped += same_results(res[b], want, f"SIFT-OPQ after add [{b}]")
    log(f"SIFT-OPQ add_vectors({N_ADD}): {add_ms:.3f} ms; query_batch("
        f"{N_BATCH}) of added rows {q_ms:.3f} ms, {found} of {N_BATCH} find "
        f"themselves in their top {K_TOP}; 16 equal to the CPU path "
        f"({swapped} tie swaps)")
    return index, built


def opq_against_pq(torch, db, base, seed: int) -> None:
    """The SIFT-OPQ build's coarse fit must equal phase 3's bit for bit
    (the same data and seed, and every Lloyd sum on the card in a fixed
    order): the same partition centroids, partition indices and vector
    ids. Then its quantization error against phase 3's PQ configuration
    fitted on the same residuals, and against phase 3's own error."""
    from flechasdb_tpu_torch.ops import kmeans, opq
    for name in ("partition_centroids", "partition_indices"):
        got, want = getattr(db, name), getattr(base, name)
        require(got.dtype == want.dtype and np.array_equal(got, want),
                f"SIFT-OPQ's {name} differ from phase 3's: max abs diff "
                f"{np.abs(got.astype(np.float64) - want).max()}")
    require(db.vector_ids == base.vector_ids,
            "SIFT-OPQ's vector ids differ from phase 3's")
    r = torch.as_tensor(db.residues, device="cuda")
    divided = r.reshape(len(r), SIFT_D, -1).transpose(0, 1).contiguous()
    pq = kmeans.fit(divided, C, torch.Generator("cuda").manual_seed(seed))
    del divided
    e_same = opq.quantization_error(r, torch.eye(SIFT_M, device="cuda"), pq,
                                    d=SIFT_D)
    e_opq, e_base = pq_error(torch, db), pq_error(torch, base)
    log(f"SIFT-OPQ quantization error a row {e_opq:.4f}; plain PQ on the "
        f"same residuals {e_same:.4f}; phase 3's PQ {e_base:.4f} (the coarse"
        " fit bit-equal to phase 3's)")
    require(e_opq <= e_same, f"OPQ error {e_opq} above plain PQ's {e_same} "
            "on the same residuals")


def fast_opq_run(torch, seed: int, head: dict, sift: dict, work: Path):
    """Phase 6: one round's agreement first, then the launch counts are
    zeroed before the three builds and their queries and read after. The
    SIFT-OPQ tree stays in ``work`` for phase 7."""
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels
    agree = agreement(torch, head)
    log(f"one Lloyd round from phase 2's centroids, fast against full: "
        f"{agree[0]:.5f} of the coarse picks, {agree[1]:.5f} of the PQ picks"
        " equal")
    require(agree[0] >= 0.95, f"fast coarse agreement {agree[0]} < 0.95")
    _kernels.reset_launches()
    torch.cuda.synchronize()
    fast_headline(torch, ft, head, seed)
    fast_sift(torch, ft, sift, seed)
    index, opq_db = sift_opq(torch, ft, sift, seed, work)
    launches = dict(_kernels.LAUNCHES)
    log(f"launches over phase 6: {launches}")
    for name in ("lloyd_round_fast", "lloyd_grouped_fast", "lloyd_round",
                 "lloyd_grouped", "adc_scan"):
        require(launches[name] > 0, f"phase 6 launched no {name}")
    one_sum_pass_a_round(launches, "phase 6")
    opq_against_pq(torch, opq_db, sift["db"], seed)
    return launches, scan_at_main_path(torch, index, sift["q"], SIFT_NPROBE,
                                       "the SIFT-OPQ path's rotated")


# --- phase 8: the f64 build ---------------------------------------------------

def f64_run(torch, sift: dict, seed: int):
    """Phase 8: ``DatabaseBuilder(x, np.float64, device="cuda")`` over the
    first F64_N rows of phase 3's data cast to f64 (P=F64_P, D=8, C=256;
    trained on the host by the numpy oracle, so it launches no kernel; the
    rows are cut from 100,000 to keep the phase within a minute), then
    phase 3's 1000 queries at k=10, nprobe=10 through
    ``Database.query_batch`` on the card, on the layout the JAX policy
    picks (masked for this skewed corpus, as for phase 3's), and through
    ``DeviceIndex(layout="bucketed")``, as phase 3 serves the same corpus:
    K-A must launch, both must equal the same database served on the CPU
    up to ties, and 64 corpus rows, queried with ``rerank=100``, must find
    themselves first. The build time and recall@10 against exact ground
    truth are printed. Returns ``(launches, K-A case)``."""
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels
    from flechasdb_tpu_torch.serving import DeviceIndex
    x = sift["x"][:F64_N].astype(np.float64)
    x32, q = x.astype(np.float32), sift["q"]
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = (ft.DatabaseBuilder(x, np.float64, device="cuda")
          .with_partitions(F64_P).with_divisions(SIFT_D).with_clusters(C)
          .with_seed(seed).build())
    build_s = time.perf_counter() - t0
    built = dict(_kernels.LAUNCHES)
    require(not any(built.values()), f"the f64 build launched {built}")
    check_build(db, x32, F64_P, SIFT_D, C)
    kw = dict(k=K_TOP, nprobe=SIFT_NPROBE)
    res, first_ms = timed(lambda: db.query_batch(q, **kw))
    _, warm_ms = timed(lambda: db.query_batch(q, **kw))
    layout = db._device_state().layout
    index = DeviceIndex(db.partition_centroids, db.codebooks,
                        db.codes.astype(np.int32), db.partition_indices,
                        layout="bucketed", device="cuda")
    adc, bucket_ms = timed(lambda: index.query(q, **kw))
    launches = dict(_kernels.LAUNCHES)
    require(launches["adc_scan"] > 0, "the f64 database's queries launched "
            "no adc_scan")
    row_of = {vid: i for i, vid in enumerate(db.vector_ids)}
    recall = recall_at(adc[1], ground_truth(torch, x32, q, K_TOP))
    want = host_arrays(ft.Database(**ft.to_arrays(db), device="cpu")
                       .query_batch(q, **kw), row_of, K_TOP)
    swapped = same_arrays(host_arrays(res, row_of, K_TOP), want,
                          f"f64 query_batch ({layout})")
    swapped += same_arrays(adc[:2], want, "f64 bucketed DeviceIndex")
    selfs = db.query_batch(x32[:N_CHECK], rerank=RERANK, **kw)
    found = sum(r[0].vector_id == db.vector_ids[i]
                for i, r in enumerate(selfs))
    log(f"f64 build ({F64_N} x {SIFT_M}, P={F64_P}, D={SIFT_D}, C={C}, host "
        f"oracle): {build_s:.3f} s; query_batch({len(q)}) on the {layout} "
        f"layout: first {first_ms:.3f} ms, warm {warm_ms:.3f} ms; "
        f"DeviceIndex(layout='bucketed').query({len(q)}) first "
        f"{bucket_ms:.3f} ms; recall@10 {recall:.4f}; both equal to the "
        f"CPU path ({swapped} tie swaps); {found} of {N_CHECK} corpus rows "
        f"first for themselves (rerank={RERANK}); launches {launches}")
    require(found == N_CHECK, f"only {found} of {N_CHECK} corpus rows "
            "found themselves first")
    return launches, scan_at_main_path(torch, index, q, SIFT_NPROBE,
                                       "the f64 build's")


# --- phase 7: the async tier, the flat tier and the CLI ---------------------

def root_of(base: Path) -> str:
    """The one root manifest's hash at the top of a saved tree."""
    roots = [p.stem for p in base.glob("*.binpb")]
    require(len(roots) == 1, f"{base.name}: {len(roots)} root manifests")
    return roots[0]


def fields(results) -> list:
    return [(r.vector_id, r.partition_index, r.vector_index,
             r.squared_distance) for r in results]


def async_queries(fs, root: str, qs, nprobe: int, where=None,
                  attrs=()) -> tuple:
    """Loads ``root`` through the async tier and runs ``qs`` one by one,
    cold and then again warm: ``(cold results, cold ms, warm results,
    warm ms, attribute values of the cold results)``."""
    import asyncio
    from flechasdb_tpu_torch import asyncdb

    async def run():
        adb = await asyncdb.load_database(fs, f"{root}.binpb")
        out = []
        for _ in range(2):
            res, ms = [], []
            for v in qs:
                t0 = time.perf_counter()
                res.append(await adb.query(v, K_TOP, nprobe, where=where))
                ms.append((time.perf_counter() - t0) * 1e3)
            out += [res, ms]
        values = [[await asyncio.gather(*(r.get_attribute(a) for r in rs))
                   for a in attrs] for rs in out[0]]
        return (*out, values)

    return asyncio.run(run())


def counting_store(base: Path):
    """An ``AsyncLocalFileSystem`` that counts the partition files open at
    once (their reads run off the event loop, so cold loads overlap)."""
    from flechasdb_tpu_torch.asyncdb import AsyncLocalFileSystem

    class Counting(AsyncLocalFileSystem):
        in_flight = peak = 0

        async def open_hashed_file(self, path, compressed=False):
            if not (compressed and path.startswith("partitions/")):
                return await super().open_hashed_file(path, compressed)
            self.in_flight += 1
            self.peak = max(self.peak, self.in_flight)
            try:
                return await super().open_hashed_file(path, compressed)
            finally:
                self.in_flight -= 1

    return Counting(base)


def async_tier(ft, head: dict, sift: dict, work: Path) -> None:
    """The async tier on phase 5's and phase 6's trees, against the sync
    cold tier on the same trees (bit for bit) and phase 3's K-A results;
    the async save of phase 2's database against phase 5's tree."""
    import asyncio
    from flechasdb_tpu_torch import asyncdb
    q = sift["q"][:N_SINGLE]
    root = root_of(work / "sift")
    fs = counting_store(work / "sift")
    cold, cold_ms, warm, warm_ms, _ = async_queries(fs, root, q,
                                                    SIFT_NPROBE)
    sync = ft.load_database(ft.LocalFileSystem(work / "sift"),
                            f"{root}.binpb", device="cuda")
    for i, v in enumerate(q):
        want = fields(sync.query(v, K_TOP, SIFT_NPROBE))
        require(fields(cold[i]) == want and fields(warm[i]) == want,
                f"async SIFT query[{i}] differs from the sync cold tier")
    row_of = {vid: i for i, vid in enumerate(sift["db"].vector_ids)}
    adc = sift["adc"]
    swapped = same_arrays(host_arrays(cold, row_of, K_TOP),
                          (adc[0][:N_SINGLE], adc[1][:N_SINGLE]),
                          "async SIFT vs K-A")
    log(f"async SIFT tree: {N_SINGLE} cold queries at nprobe={SIFT_NPROBE} "
        f"{', '.join(f'{v:.3f}' for v in cold_ms)} ms, warm "
        f"{', '.join(f'{v:.3f}' for v in warm_ms)} ms; at most {fs.peak} "
        "partition files open at once; every row and distance bit-equal "
        "to the sync cold tier, equal to phase 3's bucketed K-A results "
        f"({swapped} tie swaps)")

    root = root_of(work / "headline")
    name, where, mask = headline_filters(ft, head["tenant"], head["lang"])[1]
    row_of = {vid: i for i, vid in enumerate(head["db"].vector_ids)}
    qs = head["q_single"]
    cold, cold_ms, _, warm_ms, values = async_queries(
        asyncdb.AsyncLocalFileSystem(work / "headline"), root, qs, NPROBE,
        where=where, attrs=("tenant", "lang"))
    sync = ft.load_database(ft.LocalFileSystem(work / "headline"),
                            f"{root}.binpb", device="cuda")
    for i, v in enumerate(qs):
        want = sync.query(v, K_TOP, NPROBE, where=where)
        require(fields(cold[i]) == fields(want),
                f"async headline {name} [{i}] differs from the sync tier")
        require(values[i] == [[r.get_attribute(a) for r in want]
                              for a in ("tenant", "lang")],
                f"async headline [{i}]: attributes differ")
        require(all(mask[row_of[r.vector_id]] for r in cold[i]),
                f"async headline {name} [{i}]: a row fails the filter")
    log(f"async headline tree, where={name}: {N_SINGLE} cold queries "
        f"{', '.join(f'{v:.3f}' for v in cold_ms)} ms, warm median "
        f"{statistics.median(warm_ms):.3f} ms; {sum(map(len, cold))} rows, "
        "bit-equal to the sync cold tier, tenant and lang equal")

    fs = ft.LocalFileSystem(work / "headline-async")
    got, save_ms = timed(lambda: asyncio.run(asyncdb.save_database(
        head["db"], fs)))
    require(got == root, f"the async save's root {got} != {root}")
    require(tree_files(work / "headline-async")
            == tree_files(work / "headline"),
            "the async save's tree differs from the sync save's")
    log(f"async save_database of phase 2's database: {save_ms:.3f} ms, the "
        "sync save's root and every file byte-equal")

    root = root_of(work / "sift-opq")
    cold, cold_ms, _, _, _ = async_queries(
        asyncdb.AsyncLocalFileSystem(work / "sift-opq"), root, q,
        SIFT_NPROBE)
    sync = ft.load_database(ft.LocalFileSystem(work / "sift-opq"),
                            f"{root}.binpb", device="cuda")
    for i, v in enumerate(q):
        require(fields(cold[i]) == fields(sync.query(v, K_TOP, SIFT_NPROBE)),
                f"async SIFT-OPQ query[{i}] differs from the sync tier")
    log(f"async SIFT-OPQ tree (rotation read): {N_SINGLE} cold queries "
        f"{', '.join(f'{v:.3f}' for v in cold_ms)} ms, bit-equal to the "
        "sync cold tier")


def exact_bound(b: int, n: int, m: int) -> tuple[float, str]:
    """The exact scan's least time: ``[B, M]`` and ``[N, M]`` f32 read once,
    ``2·B·N·M`` f32 operations outside the tensor cores (the scan ranks in
    full f32)."""
    return bound(4 * (b * m + n * m), 2 * b * n * m)


def flat_rows(results) -> np.ndarray:
    return np.array([[r.vector_index for r in rs] for rs in results])


def flat_against_truth(rows: np.ndarray, gt: np.ndarray, x, q,
                       what: str) -> int:
    """The flat rows equal the exact ground truth up to ties: where a row
    differs, the two rows' exact distances (float64) agree within the
    tolerance. Returns the number of such rows."""
    swapped = 0
    for b in np.flatnonzero((rows != gt).any(axis=1)):
        def exact(r):
            return ((x[r].astype(np.float64) - q[b]) ** 2).sum(axis=1)
        require(np.allclose(exact(rows[b]), exact(gt[b]), rtol=RTOL,
                            atol=ATOL), f"{what}[{b}]: rows differ from the "
                "ground truth outside a tie")
        swapped += int((rows[b] != gt[b]).sum())
    return swapped


def flat_hits(results):
    return (np.array([r.vector_index for r in results], np.int64),
            np.array([r.squared_distance for r in results], np.float32))


def flat_corpus(torch, ft, x, q, gt, ids, what: str):
    """``FlatDatabase(x, device="cuda")``: upload, the batch's host and
    device times against the exact scan's bound, the ground truth and the
    CPU plain path (``N_CHECK`` queries). Returns ``(database, results,
    CPU database)``."""
    from flechasdb_tpu_torch.ops.exact import exact_topk
    db = ft.FlatDatabase(x, vector_ids=ids, device="cuda")
    torch.cuda.synchronize()
    _, up_ms = timed(lambda: (db.preload(), torch.cuda.synchronize()))
    _, first_ms = timed(lambda: db.query_batch(q, K_TOP))
    ms = []
    for _ in range(3):
        res, t = timed(lambda: db.query_batch(q, K_TOP))
        ms.append(t)
    qd = torch.as_tensor(q, device="cuda")
    scan_ms = cuda_ms(torch, lambda: exact_topk(qd, db._dev, k=K_TOP), 3)
    bms, by = exact_bound(len(q), len(x), x.shape[1])
    swapped = flat_against_truth(flat_rows(res), gt, x, q, what)
    cpu = ft.FlatDatabase(x, vector_ids=ids, device="cpu")
    want = cpu.query_batch(q[:N_CHECK], K_TOP)
    for b in range(N_CHECK):
        swapped += same_results(res[b], want[b], f"{what} vs CPU [{b}]")
    log(f"flat {what} ({len(x)} x {x.shape[1]}, "
        f"{x.nbytes / 2**20:.0f} MiB on the card): upload {up_ms:.3f} ms; "
        f"query_batch({len(q)}, k={K_TOP}) first {first_ms:.3f} ms, warm "
        f"{statistics.median(ms):.3f} ms (median of 3); exact_topk device "
        f"time {scan_ms:.3f} ms (CUDA events), bound {bms:.3f} ms ({by}); "
        f"equal to the exact ground truth and, for {N_CHECK} queries, to "
        f"the CPU plain path ({swapped} tie swaps)")
    return db, res, cpu


def flat_tier(torch, ft, head: dict, sift: dict, seed: int,
              work: Path) -> None:
    """The flat tier on the card at both corpora: batches against the exact
    ground truth and the CPU path, a filter and range search at the
    headline, the SIFT corpus saved, loaded, preloaded and queried, sync
    and async."""
    import asyncio
    from flechasdb_tpu_torch.asyncdb import AsyncLocalFileSystem
    x, q = sift["x"], sift["q"]
    db, res, cpu = flat_corpus(torch, ft, x, q, sift["gt"],
                               sift["db"].vector_ids, "SIFT")
    del cpu

    xh = head["x"]
    rng = np.random.default_rng(seed + 3)          # fast_headline's queries
    qr = xh[rng.choice(N, N_RECALL, replace=False)]
    qr = qr + 0.02 * rng.standard_normal(qr.shape, dtype=np.float32)
    hdb, _, hcpu = flat_corpus(torch, ft, xh, qr,
                               ground_truth(torch, xh, qr, K_TOP),
                               head["db"].vector_ids, "headline")
    for d in (hdb, hcpu):
        d.attribute_table = {vid: dict(a) for vid, a in
                             head["db"].attribute_table.items()}
    name, where, mask = headline_filters(ft, head["tenant"], head["lang"])[0]
    hq = head["q"]
    got, f_ms = timed(lambda: hdb.query_batch(hq, K_TOP, where=where))
    want = hcpu.query_batch(hq, K_TOP, where=where)
    swapped = 0
    for b in range(len(hq)):
        require(all(mask[r.vector_index] for r in got[b]),
                f"flat {name} [{b}]: a row fails the filter")
        swapped += same_results(got[b], want[b], f"flat {name} [{b}]")
    edge, n_hits = 0, 0
    for b in range(N_SINGLE):
        keys = [r.squared_distance for r in hdb.query(hq[b], K_TOP + 1)]
        radius = (keys[K_TOP - 1] + keys[K_TOP]) / 2
        rgot = hdb.query_range(hq[b], radius)
        n_hits += len(rgot)
        edge += same_hits(flat_hits(rgot), flat_hits(hcpu.query_range(
            hq[b], radius)), radius, f"flat query_range [{b}]")
    log(f"flat headline query_batch({len(hq)}, where={name}) {f_ms:.3f} ms, "
        f"equal to the CPU path ({swapped} tie swaps); query_range of "
        f"{N_SINGLE} queries: {n_hits} hits, equal to the CPU path ({edge} "
        "rows at the radius)")
    del hdb, hcpu

    fs = ft.LocalFileSystem(work / "flat-sift")
    root, save_ms = timed(lambda: ft.save_flat_database(db, fs))
    sift["flat_batch"] = res
    size = sum(f.stat().st_size for f in (work / "flat-sift").rglob("*"))
    sdb, load_ms = timed(lambda: ft.load_flat_database(fs, f"{root}.binpb",
                                                       device="cuda"))
    _, pre_ms = timed(lambda: (sdb.preload(), torch.cuda.synchronize()))
    require(sdb._dev[0].device.type == "cuda", "the stored corpus is not "
            "on the card")
    sift["flat_stored"] = sdb
    got = sdb.query_batch(q, K_TOP)
    require([[(r.vector_id, r.squared_distance) for r in rs] for rs in got]
            == [[(r.vector_id, r.squared_distance) for r in rs]
                for rs in res], "the stored flat batch differs from the "
            "in-memory one")

    async def run():
        adb = await ft.load_flat_database_async(
            AsyncLocalFileSystem(work / "flat-sift"), f"{root}.binpb",
            device="cuda")
        return [await adb.query(v, K_TOP) for v in q[:N_SINGLE]]

    agot, a_ms = timed(lambda: asyncio.run(run()))
    swapped = 0
    for i in range(N_SINGLE):
        swapped += same_results(agot[i], sdb.query(q[i], K_TOP),
                                f"async flat [{i}]")
    log(f"flat SIFT stored: save_flat_database {save_ms:.3f} ms "
        f"({len(sdb.root.chunk_ids)} chunks, {size} bytes); "
        f"load_flat_database {load_ms:.3f} ms; preload {pre_ms:.3f} ms; "
        f"query_batch({len(q)}) bit-equal to the in-memory database's; "
        f"load_flat_database_async + {N_SINGLE} queries {a_ms:.3f} ms, "
        f"the same rows ({swapped} tie swaps)")


def cli_output(what: str, done: tuple, need: str, results: int) -> None:
    """A CLI command's ``(exit code, output, seconds)``: it exited 0 and
    printed ``need`` and ``results`` result lines."""
    rc, out, s = done
    require(rc == 0, f"CLI {what} exited {rc}:\n{out}")
    lines = out.splitlines()
    require(any(need in line for line in lines),
            f"CLI {what} printed no {need!r}:\n{out}")
    n = sum(line.startswith(f"{i}: ") for line in lines for i in range(10))
    require(n == results, f"CLI {what} printed {n} result lines")
    log(f"CLI {what}: exit 0 in {s:.3f} s ({len(lines)} lines, {n} "
        "results)")


def cli_run(torch, work: Path):
    """The CLI: ``generate`` through ``main`` in this process, its launch
    counts zeroed just before it and read just after (K-B builds, K-A
    queries), then K-A against its plain version at the saved tree's
    buckets; ``verify`` and ``gc --dry-run`` through ``main``; ``load``
    through ``python -m flechasdb_tpu_torch`` in a subprocess. Returns
    ``(launches, K-A case)``."""
    import contextlib
    import io
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels
    from flechasdb_tpu_torch.__main__ import main as cli
    db = work / "cli"

    def in_process(*argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli([*argv, str(db)], device="cuda")
        torch.cuda.synchronize()
        return rc, out.getvalue(), time.perf_counter() - t0

    torch.cuda.synchronize()
    _kernels.reset_launches()
    done = in_process("generate")
    launches = dict(_kernels.LAUNCHES)
    cli_output("generate", done, "saved database", K_TOP)
    log(f"launches over the CLI's generate: {launches}")
    for name in ("lloyd_round", "adc_scan"):
        require(launches[name] > 0, f"the CLI's generate launched no {name}")
    one_sum_pass_a_round(launches, "the CLI's generate")
    sdb = ft.load_database(ft.LocalFileSystem(db), f"{root_of(db)}.binpb",
                           device="cuda")
    sdb.preload()
    qv = np.random.default_rng(CLI_N).random((1, CLI_M), dtype=np.float32)
    qv /= np.linalg.norm(qv)
    case = scan_at_main_path(torch, sdb._dev[0], qv, CLI_NPROBE,
                             "the CLI's")
    cli_output("verify", in_process("verify"), "all artifacts verified", 0)
    cli_output("gc --dry-run", in_process("gc", "--dry-run"), "0 orphaned",
               0)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "flechasdb_tpu_torch", "load", str(db)],
        capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    cli_output("python -m flechasdb_tpu_torch load",
               (out.returncode, out.stdout + out.stderr,
                time.perf_counter() - t0), "[1] listed results", 2 * K_TOP)
    return launches, case


def tiers_run(torch, seed: int, head: dict, sift: dict, work: Path):
    """Phase 7: the launch counts are zeroed before it; the async and flat
    tiers must launch none (host scan, cuBLAS). Returns the CLI's
    ``(launches, K-A case)``."""
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    async_tier(ft, head, sift, work)
    t1 = time.perf_counter()
    flat_tier(torch, ft, head, sift, seed, work)
    torch.cuda.synchronize()
    tiers = dict(_kernels.LAUNCHES)
    require(not any(tiers.values()), f"the async and flat tiers launched "
            f"kernels: {tiers}")
    t2 = time.perf_counter()
    out = cli_run(torch, work)
    log(f"phase 7 parts: async {t1 - t0:.3f} s, flat {t2 - t1:.3f} s, CLI "
        f"{time.perf_counter() - t2:.3f} s")
    return out


# --- phase 9: the Deep10M shape ----------------------------------------------

def widen(torch, t):
    """``t`` as int32 where it is uint16 (PyTorch's CUDA support for
    uint16 is partial), before it is indexed or compared; as it is
    otherwise."""
    return t.int() if t.dtype == torch.uint16 else t


class ReadCounter:
    """A host array that records every read of the streamed build:
    ``("rows", count, sorted and unique)`` for a gather, ``("slice", lo,
    hi)`` for a contiguous read."""

    def __init__(self, x):
        self._x = x
        self.shape = x.shape
        self.reads = []

    def __getitem__(self, key):
        if isinstance(key, slice):
            self.reads.append(("slice", key.start, key.stop))
        else:
            rows = np.asarray(key)
            self.reads.append(("rows", len(rows),
                               bool((np.diff(rows) > 0).all())))
        return self._x[key]


class PartTimer:
    """An event handler that synchronizes the card at each build event and
    keeps ``(event name, inner event name or None, host time)``."""

    def __init__(self, torch):
        self._torch = torch
        self.marks = [("start", None, time.perf_counter())]

    def __call__(self, e):
        self._torch.cuda.synchronize()
        inner = getattr(e, "event", None)
        self.marks.append((type(e).__name__,
                           None if inner is None else type(inner).__name__,
                           time.perf_counter()))

    def at(self, name, nth=0):
        """The time of the ``nth`` event so named (-1: the last)."""
        return [t for n, i, t in self.marks if name in (n, i)][nth]

    def end(self):
        self._torch.cuda.synchronize()
        self.marks.append(("end", None, time.perf_counter()))


def deep_fit_rounds(marks) -> tuple[int, int]:
    """The rounds of a build's coarse and PQ fits: its round events before
    and after the subvector division."""
    names = [i or n for n, i, _ in marks]
    split = names.index("StartingSubvectorDivision")
    return (names[:split].count("FinishedCentroidUpdate"),
            names[split:].count("FinishedCentroidUpdate"))


def global_rows(pidx: np.ndarray, p: int):
    """``(order, starts)``: the corpus row of local index ``v`` in
    partition ``q`` is ``order[starts[q] + v]`` (the database's local
    indices inverted)."""
    order = np.argsort(pidx, kind="stable")
    starts = np.zeros(p + 1, np.int64)
    np.cumsum(np.bincount(pidx, minlength=p), out=starts[1:])
    return order, starts


def result_rows(results, order, starts, k: int) -> np.ndarray:
    rows = np.full((len(results), k), -1, np.int64)
    for b, rs in enumerate(results):
        rows[b, :len(rs)] = [order[starts[r.partition_index]
                                   + r.vector_index] for r in rs]
    return rows


def deep_encode_check(torch, x, built) -> None:
    """``ops.encode.encode`` of DEEP_CHECK corpus rows against the build's
    centroids and codebooks: partitions equal to the build's up to
    near-ties (K-B's 3xTF32 product against full f32), and codes, where
    the partitions agree, equal up to near-ties of the residual."""
    from flechasdb_tpu_torch.ops.encode import encode
    rows = torch.linspace(0, len(x) - 1, DEEP_CHECK, device="cuda").long()
    cents, books = built.partition_centroids, built.codebooks
    xs = x[rows]
    pidx, codes = encode(xs, cents, books)
    mine_p = widen(torch, built.partition_indices)[rows].long()
    mine_c = built.codes[rows].long()
    x64, c64 = xs.double(), cents.double()

    def pdist(p):
        return ((x64 - c64[p]) ** 2).sum(-1)

    scale = (x64 ** 2).sum(-1) + (c64 ** 2).sum(-1).max()
    pdiff = mine_p != pidx.long()
    require(not bool((pdiff & ((pdist(mine_p) - pdist(pidx.long())).abs()
                               > TIE_REL * scale)).any()),
            "the build's partitions differ from encode's outside near-ties")
    same = ~pdiff
    r = (x64 - c64[mine_p]).reshape(len(xs), DEEP_D, -1)[same]
    b64 = books.double()
    dd = torch.arange(DEEP_D, device="cuda")[None, :]

    def cdist(code):
        return ((r - b64[dd, code]) ** 2).sum(-1)

    got, want = mine_c[same], codes.long()[same]
    cscale = (r ** 2).sum(-1) + (b64 ** 2).sum(-1).max()
    cdiff = got != want
    require(not bool((cdiff & ((cdist(got) - cdist(want)).abs()
                               > TIE_REL * cscale)).any()),
            "the build's codes differ from encode's outside near-ties")
    log(f"Deep10M encode check: {DEEP_CHECK} rows through ops.encode.encode;"
        f" {int(pdiff.sum())} partitions and {int(cdiff.sum())} codes "
        "differ, each at a near-tie")


def deep_staged(torch, x, seed: int):
    """Two same-seed ``build_staged`` calls (bit-equal; the second's parts
    timed at its events), with the launch counts zeroed before them."""
    from flechasdb_tpu_torch import _kernels
    from flechasdb_tpu_torch.parallel import build as pbuild
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = pbuild.build_staged(x, DEEP_P, DEEP_D, C, seed)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    timer = PartTimer(torch)
    second = pbuild.build_staged(x, DEEP_P, DEEP_D, C, seed, timer)
    timer.end()
    launches = dict(_kernels.LAUNCHES)
    for name, u, v in zip(pbuild.ShardedBuild._fields, first, second):
        require(torch.equal(widen(torch, u), widen(torch, v)),
                f"two same-seed staged builds differ in {name}")
    require(launches["lloyd_round"] > 0, "the staged builds launched no "
            "lloyd_round")
    require(launches["lloyd_grouped"] == 0 and
            launches["lloyd_round_fast"] == 0,
            f"the staged builds took another kernel: {launches}")
    one_sum_pass_a_round(launches, "the staged builds")
    coarse_r, pq_r = deep_fit_rounds(timer.marks)
    t = timer.at
    parts = {
        "coarse seeding": t("FinishedCentroidInitialization")
        - t("StartingCentroidInitialization"),
        "coarse rounds": t("FinishedCentroidUpdate", coarse_r - 1)
        - t("FinishedCentroidInitialization"),
        f"final assignment ({DEEP_N} rows, K-B and the pass)":
        t("StartingSubvectorDivision")
        - t("FinishedCentroidUpdate", coarse_r - 1),
        "sample residuals": t("FinishedSubvectorDivision")
        - t("StartingSubvectorDivision"),
        "PQ fit": t("FinishedCentroidUpdate", -1)
        - t("FinishedSubvectorDivision"),
        "_encode_chunked": t("end") - t("FinishedCentroidUpdate", -1),
    }
    pops = int(torch.unique(widen(torch, second.partition_indices)).numel())
    log(f"Deep10M build_staged({DEEP_N} x {DEEP_M}, P={DEEP_P}, D={DEEP_D}, "
        f"C={C}): first {first_s:.3f} s, second (timed at its events) "
        f"{t('end') - t('start'):.3f} s, the arrays bit-equal; rounds: coarse "
        f"{coarse_r}, PQ {pq_r}; partitions populated {pops}; parts: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()))
    log(f"Deep10M staged builds' launches: {launches}")
    # The final assignment's round alone, after the counts were read:
    # K-B over all rows against the trained centroids, then the pass.
    from flechasdb_tpu_torch.ops import lloyd
    xr, cr = x[None], second.partition_centroids[None]
    idx = lloyd.lloyd_round(xr, cr)[0]
    round_ms = cuda_ms(torch, lambda: lloyd.lloyd_round(xr, cr), 1)
    pass_ms = cuda_ms(torch, sum_pass(lloyd, xr, idx, DEEP_P, DEEP_M, 1,
                                      False), 1)
    bms, by = lloyd_bound(x.numel() * 4, 1, DEEP_N, DEEP_P, DEEP_M,
                          TF32_FLOPS, "operations (TF32 tensor cores)")
    tiling = lloyd.sum_tiling(1, DEEP_N, DEEP_P, DEEP_M, 1)
    log(f"Deep10M final assignment's round (K-B B=1 N={DEEP_N} K={DEEP_P} "
        f"M={DEEP_M}): {round_ms:.3f} ms, the pass alone {pass_ms:.3f} ms "
        f"({tiling.route} route, S={tiling.cols}, R={tiling.rows}; CUDA "
        f"events), bound {bms:.3f} ms ({by})")
    final = {"shape": f"K-B lloyd_round, the final assignment B=1 "
             f"N={DEEP_N} K={DEEP_P} M={DEEP_M}", "ms": round_ms,
             "bound_ms": bms, "bound_by": by, "pass_ms": pass_ms,
             "pass_route": tiling.route}
    return second, launches, final


def deep_serve(torch, q_dev, x, xh, built, gt: np.ndarray):
    """The staged build's ``DeviceIndex(layout="bucketed")`` (its buckets
    made by ``ops.bucketed.bucketize``), ``query_bucketed`` at each of
    DEEP_NPROBES in query chunks as ``benchmarks/deep10m.py`` sizes them,
    recall@10, the rerank row (``query_rerank`` of the top RERANK at
    DEEP_NPROBE against the device corpus ``x``), and 64 queries at
    DEEP_NPROBE against the CPU plain path on the same buckets, with and
    without rerank (the host corpus ``xh``). Returns ``(recall at
    DEEP_NPROBE, the launch counts read after the timed queries and before
    the checks, K-A case, top-k case)``."""
    from flechasdb_tpu_torch import _kernels
    from flechasdb_tpu_torch.ops.bucketed import Buckets, query_bucketed
    from flechasdb_tpu_torch.serving import DeviceIndex, _rerank_exact
    t0 = time.perf_counter()
    pidx = built.partition_indices.cpu().numpy().astype(np.int32)
    index = DeviceIndex(built.partition_centroids.cpu().numpy(),
                        built.codebooks.cpu().numpy(),
                        built.codes.cpu().numpy().astype(np.int32), pidx,
                        layout="bucketed", device="cuda")
    torch.cuda.synchronize()
    bucket_s = time.perf_counter() - t0
    cents, books, bk = index.centroids, index.codebooks, index.buckets
    counts = np.bincount(pidx, minlength=DEEP_P)
    words, l_pad = bk.codes.shape[1], bk.codes.shape[2]
    log(f"Deep10M buckets: DeviceIndex(layout='bucketed') {bucket_s:.3f} s; "
        f"avg_len {counts.mean():.1f}, max_len {counts.max()}, l_pad {l_pad}"
        f", packed words {words}, padded bytes "
        f"{DEEP_P * l_pad * (words + 1) * 4}")

    def run(nprobe):
        per_q = nprobe * l_pad * (DEEP_D + 2) * 4
        cb = max(1, min(len(q_dev), int(1.5e9 / per_q)))
        outs = [query_bucketed(q_dev[i:i + cb], cents, books, bk, k=K_TOP,
                               nprobe=nprobe)
                for i in range(0, len(q_dev), cb)]
        return (torch.cat([o[0] for o in outs]).cpu().numpy(),
                torch.cat([o[1] for o in outs]).cpu().numpy(), cb)

    recalls = {}
    for nprobe in DEEP_NPROBES:
        _, rows, cb = run(nprobe)
        recalls[nprobe] = recall_at(rows, gt)
        ms = []
        for _ in range(3):
            _, t = timed(lambda: run(nprobe))
            ms.append(t)
        log(f"Deep10M query_bucketed({len(q_dev)}, k={K_TOP}, nprobe={nprobe})"
            f" in chunks of {cb}: recall@10 {recalls[nprobe]:.4f}, batch "
            f"{statistics.median(ms):.3f} ms (median of 3: "
            f"{', '.join(f'{v:.3f}' for v in ms)})")
    qh = q_dev.cpu().numpy()
    kw = dict(k=K_TOP, nprobe=DEEP_NPROBE, rerank=RERANK)
    rr = index.query_rerank(qh, x, **kw)
    rr_ms = []
    for _ in range(3):
        _, t = timed(lambda: index.query_rerank(qh, x, **kw))
        rr_ms.append(t)
    served = dict(_kernels.LAUNCHES)
    require(served["bucketed_topk"] > 0, "the Deep10M queries launched no "
            "bucketed_topk")
    require(served["probed_tables"] > 0, "the Deep10M queries launched no "
            "probed_tables")
    r_rr = recall_at(rr[1], gt)
    log(f"Deep10M DeviceIndex.query_rerank({len(qh)}, k={K_TOP}, nprobe="
        f"{DEEP_NPROBE}, rerank={RERANK}) against the {DEEP_N}-row corpus "
        f"on the card: recall@10 {r_rr:.4f} (ADC {recalls[DEEP_NPROBE]:.4f}"
        f"; the JAX record {DEEP_RERANK_RECORD}, benchmarks/RESULTS.md:209), "
        f"batch {statistics.median(rr_ms):.3f} ms (median of 3: "
        f"{', '.join(f'{v:.3f}' for v in rr_ms)})")
    for lo, hi in zip(DEEP_NPROBES, DEEP_NPROBES[1:]):
        require(recalls[hi] >= recalls[lo], f"recall fell from nprobe {lo} "
                f"({recalls[lo]}) to {hi} ({recalls[hi]})")
    require(r_rr >= 0.95 and r_rr >= recalls[DEEP_NPROBE],
            f"Deep10M rerank recall {r_rr} below 0.95 or the ADC recall "
            f"{recalls[DEEP_NPROBE]}")

    t0 = time.perf_counter()
    qc = q_dev[:N_CHECK]
    got = query_bucketed(qc, cents, books, bk, k=K_TOP, nprobe=DEEP_NPROBE)
    want = query_bucketed(qc.cpu(), cents.cpu(), books.cpu(),
                          Buckets(*(a.cpu() for a in bk)), k=RERANK,
                          nprobe=DEEP_NPROBE)
    swapped = same_arrays((got[0].cpu().numpy(), got[1].cpu().numpy()),
                          (want[0][:, :K_TOP].numpy(),
                           want[1][:, :K_TOP].numpy()),
                          "Deep10M staged buckets vs CPU")
    want_rr = _rerank_exact(qc.cpu(), want[1], torch.isfinite(want[0]),
                            torch.from_numpy(xh), k=K_TOP)
    swapped += same_arrays((rr[0][:N_CHECK], rr[1][:N_CHECK]),
                           tuple(t.numpy() for t in want_rr),
                           "Deep10M staged rerank vs CPU")
    log(f"Deep10M staged: {N_CHECK} queries at nprobe={DEEP_NPROBE} equal to "
        f"the CPU plain path on the same buckets, with and without rerank "
        f"{RERANK} (the host corpus) ({swapped} tie swaps; "
        f"{time.perf_counter() - t0:.3f} s)")
    case = scan_at_main_path(torch, index, qh[:N_CHECK], DEEP_NPROBE,
                             "the Deep10M staged build's")
    t_case = topk_at_main_path(torch, index, qh, DEEP_NPROBE,
                               "the Deep10M staged build's")
    return recalls[DEEP_NPROBE], served, case, t_case


def deep_streamed(torch, ft, xh, q, gt: np.ndarray, seed: int,
                  staged_recall: float) -> None:
    """``StreamingDatabaseBuilder`` over the host copy of the corpus
    ``xh`` (DEEP_N rows) behind a read counter: the reads, the parts'
    times, ``Database.query_batch`` at DEEP_NPROBE on the policy's layout
    (recall against the staged build's, 64 queries against the CPU
    path), and the ``InvalidArgs`` of a database without residues."""
    from flechasdb_tpu_torch.parallel import COARSE_TRAIN_CAP, PQ_TRAIN_CAP
    from flechasdb_tpu_torch.streaming import CHUNK_BYTES
    src = ReadCounter(xh)
    timer = PartTimer(torch)
    db = (ft.StreamingDatabaseBuilder(src, device="cuda")
          .with_partitions(DEEP_P).with_divisions(DEEP_D).with_clusters(C)
          .with_seed(seed).build(timer))
    timer.end()
    t = timer.at
    parts = {
        "_make_uuids": t("FinishedIdAssignment") - t("StartingIdAssignment"),
        "sample gather": t("StartingPartitioning") - t("FinishedIdAssignment"),
        "coarse fit": t("FinishedPartitioning") - t("StartingPartitioning"),
        "PQ sample assignment": t("FinishedSubvectorDivision")
        - t("StartingSubvectorDivision"),
        "PQ fit": t("FinishedQuantization", -1)
        - t("StartingQuantization"),
        "encode stream": t("end") - t("FinishedQuantization", -1),
    }
    chunk_rows = CHUNK_BYTES // (4 * DEEP_M)
    first, rest = src.reads[0], src.reads[1:]
    cap = max(COARSE_TRAIN_CAP, PQ_TRAIN_CAP)
    require(first[0] == "rows" and first[1] <= cap and first[2],
            f"the training gather read {first}, not at most {cap} sorted "
            "unique rows")
    require([r[1:] for r in rest] == [
        (lo, min(lo + chunk_rows, DEEP_N))
        for lo in range(0, DEEP_N, chunk_rows)]
        and all(r[0] == "slice" for r in rest),
        "the encode stream read other than its chunks in order")
    log(f"Deep10M StreamingDatabaseBuilder({DEEP_N} x {DEEP_M}, "
        f"P={DEEP_P}, D={DEEP_D}, C={C}): {t('end') - t('start'):.3f} s; "
        f"reads: one gather of {first[1]} sorted unique rows, then "
        f"{len(rest)} chunks of at most {chunk_rows} rows in order; parts: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()))

    kw = dict(k=K_TOP, nprobe=DEEP_NPROBE)
    res, first_ms = timed(lambda: db.query_batch(q, **kw))
    res, warm_ms = timed(lambda: db.query_batch(q, **kw))
    order, starts = global_rows(db.partition_indices, DEEP_P)
    recall = recall_at(result_rows(res, order, starts, K_TOP), gt)
    log(f"Deep10M streamed: Database.query_batch({len(q)}, nprobe="
        f"{DEEP_NPROBE}) on the {db._device_state().layout} layout: first "
        f"{first_ms:.3f} ms (builds the device index), warm {warm_ms:.3f} "
        f"ms; recall@10 {recall:.4f} (staged {staged_recall:.4f})")
    require(abs(recall - staged_recall) <= 0.03, f"the streamed build's "
            f"recall {recall} is not within 0.03 of the staged build's "
            f"{staged_recall}")
    t0 = time.perf_counter()
    ref = ft.Database(**ft.to_arrays(db), device="cpu")
    want = ref.query_batch(q[:N_CHECK], **kw)
    swapped = sum(same_results(res[b], want[b], f"Deep10M streamed [{b}]")
                  for b in range(N_CHECK))
    log(f"Deep10M streamed: {N_CHECK} queries equal to the CPU path on the "
        f"{ref._device_state().layout} layout ({swapped} tie swaps; "
        f"{time.perf_counter() - t0:.3f} s)")
    for what, call in (("query_batch(rerank=100)", lambda: db.query_batch(
            q[:2], rerank=RERANK, **kw)), ("reconstruct(0)",
                                           lambda: db.reconstruct(0))):
        try:
            call()
        except ft.InvalidArgs:
            continue
        raise AssertionError(f"the streamed database's {what} did not raise "
                             "InvalidArgs")


def deep_run(torch, seed: int):
    """Phase 9: the JAX package's Deep10M scale-up on the card
    (``benchmarks/deep10m.py``): data, the staged build, its serving, the
    streamed build. Returns ``(launches, K-A case, the final assignment's
    round timed, the top-k case)``."""
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels, synth
    from flechasdb_tpu_torch.ops.exact import exact_topk
    gen = torch.Generator("cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    x, q = synth.gmm_pair_device(gen, DEEP_N, DEEP_NQ, DEEP_M,
                                 n_clusters=1024, intrinsic=12)
    torch.cuda.synchronize()
    log(f"Deep10M data {DEEP_N} x {DEEP_M} + {DEEP_NQ} queries "
        f"(synth.gmm_pair_device, 1024 components, intrinsic 12, seed "
        f"{seed}): {time.perf_counter() - t0:.3f} s; peak device memory "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB over "
        f"{(torch.cuda.memory_allocated() - base) / 2**30:.3f} GiB held")
    t0 = time.perf_counter()
    gt = exact_topk(q, x, k=K_TOP)[1].cpu().numpy()
    log(f"Deep10M ground truth (exact_topk, {DEEP_NQ} queries): "
        f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    built, launches, final = deep_staged(torch, x, seed)
    log(f"Deep10M staged builds' peak device memory "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB")
    deep_encode_check(torch, x, built)
    t0 = time.perf_counter()
    xh = x[:DEEP_N].cpu().numpy()
    log(f"Deep10M corpus to the host {time.perf_counter() - t0:.3f} s "
        f"({xh.nbytes} bytes): the CPU rerank check and the streamed build "
        "read it")
    _kernels.reset_launches()
    staged_recall, served, case, t_case = deep_serve(torch, q, x, xh,
                                                     built, gt)
    require(served["adc_scan"] > 0, "the Deep10M queries launched no "
            "adc_scan")
    del built
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    deep_streamed(torch, ft, xh, q.cpu().numpy(), gt, seed, staged_recall)
    streamed = dict(_kernels.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"Deep10M streamed build and queries: launches {streamed}; peak "
        f"device memory {peak:.3f} GiB")
    require(streamed["lloyd_round"] > 0, "the streamed build launched no "
            "lloyd_round")
    one_sum_pass_a_round(streamed, "the streamed build")
    total = {k: launches[k] + served[k] + streamed[k] for k in launches}
    del x, q
    torch.cuda.empty_cache()
    return total, case, final, t_case


# --- phase 11: the sharded paths ---------------------------------------------

#: The kernels each sharded build must launch (K-C at the SIFT shape's
#: subvector width of 16; the headline's 128 runs K-B).
HEAD_BUILD = ("lloyd_round", "cluster_sums")
SIFT_BUILD = ("lloyd_round", "lloyd_grouped", "cluster_sums")
#: The card's name and power limit, as setup() read them from nvidia-smi.
CARD = "not read"


def counted(torch, fn):
    """``fn()`` with the launch counts zeroed just before it and read just
    after it, the card synchronized at both edges: ``(out, host ms,
    launches)``."""
    from flechasdb_tpu_torch import _kernels
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, dict(_kernels.LAUNCHES)


def needs(launches: dict, names, what: str) -> None:
    for name in names:
        require(launches[name] > 0, f"{what} launched no {name}")


def add_launches(total: dict, launches: dict) -> None:
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count


def sharded_builds(torch, mesh, head: dict, sift: dict, seed: int,
                   total: dict):
    """``build_sharded`` on a world of one against ``_build_fn`` with the
    same seed, at the headline and SIFT shapes: every array bit-equal.
    ``_build_fn`` runs first; each sharded build's own launches go to
    ``total``. Returns the SIFT build."""
    from flechasdb_tpu_torch.parallel import build_sharded
    from flechasdb_tpu_torch.parallel.build import _build_fn
    out = None
    for name, x, p, d, kernels in (
            ("headline", head["x"], P, D, HEAD_BUILD),
            ("SIFT", sift["x"], SIFT_P, SIFT_D, SIFT_BUILD)):
        want, u_ms, _ = counted(torch, lambda: _build_fn(
            x, seed, p=p, d=d, c=C, device="cuda"))
        got, s_ms, launches = counted(torch, lambda: build_sharded(
            x, p, d, C, seed, mesh=mesh))
        needs(launches, kernels, f"build_sharded ({name})")
        add_launches(total, launches)
        for field, g, w in zip(got._fields, got, want):
            require(g.dtype == w.dtype and torch.equal(g, w),
                    f"{name}: build_sharded's {field} differs from "
                    "_build_fn's")
        log(f"build_sharded, world of one, {name} ({len(x)} x "
            f"{x.shape[1]}, P={p}, D={d}, C={C}): {s_ms / 1e3:.3f} s, "
            f"launches {launches}; _build_fn {u_ms / 1e3:.3f} s; "
            f"sharded/unsharded {s_ms / u_ms:.4f}; all four arrays bit-equal")
        out = got
    return out


def sharded_serving(torch, mesh, sift: dict, total: dict):
    """``ShardedIndex`` on both layouts against phase 3's bucketed
    ``DeviceIndex`` (1000 queries), and 64 range queries after their
    ``DeviceIndex`` reference. Returns the bucketed results."""
    from flechasdb_tpu_torch.serving import ShardedIndex
    q, adc = sift["q"], sift["adc"]
    kw = dict(k=K_TOP, nprobe=SIFT_NPROBE)
    out = {}
    for layout in ("bucketed", "masked"):
        index, up_ms, up = counted(torch, lambda: ShardedIndex(
            *sift["arrays"], layout=layout, metric=sift["db"].metric,
            mesh=mesh))
        _, first_ms, first = counted(torch, lambda: index.query(q, **kw))
        got, ms, warm = counted(torch, lambda: index.query(q, **kw))
        if layout == "bucketed":
            needs(first, ("adc_scan",), "ShardedIndex(bucketed).query")
            needs(warm, ("adc_scan",), "ShardedIndex(bucketed).query")
        for launches in (up, first, warm):
            add_launches(total, launches)
        require(np.array_equal(got[2], adc[2]),
                f"ShardedIndex({layout}) probed other partitions")
        swapped = same_arrays(got[:2], adc[:2], f"ShardedIndex({layout})")
        exact = int(np.sum(got[0] == adc[0]))
        log(f"ShardedIndex(layout={layout!r}) -> {index.layout}: build "
            f"{up_ms:.3f} ms; query({len(q)}, k={K_TOP}, nprobe="
            f"{SIFT_NPROBE}) first {first_ms:.3f} ms, warm {ms:.3f} ms, "
            f"adc_scan launches {first['adc_scan']} + {warm['adc_scan']}; "
            f"equal to phase 3's DeviceIndex(layout='bucketed') ({exact} of "
            f"{got[0].size} distances bit-equal, {swapped} tie swaps)")
        out[layout] = (index, got)
    index = out["bucketed"][0]
    radius = float(np.median(adc[0][:, K_TOP - 1]))
    qs = q[:N_CHECK]
    want = sift["index"].query_range(qs, radius, SIFT_NPROBE)
    got, ms, launches = counted(
        torch, lambda: index.query_range(qs, radius, SIFT_NPROBE))
    needs(launches, ("adc_scan",), "ShardedIndex(bucketed).query_range")
    add_launches(total, launches)
    edge = sum(same_hits(got[b], want[b], radius, f"sharded range [{b}]")
               for b in range(N_CHECK))
    log(f"ShardedIndex(bucketed).query_range({N_CHECK}, radius "
        f"{radius:.3f}, nprobe={SIFT_NPROBE}) {ms:.3f} ms, "
        f"{sum(len(r) for r, _ in got)} hits, adc_scan launches "
        f"{launches['adc_scan']}; equal to DeviceIndex.query_range ({edge} "
        "rows at the radius)")
    return out["bucketed"][1]


def sharded_tiers(torch, ft, mesh, head: dict, sift: dict,
                  total: dict) -> None:
    """``preload(mesh=)`` of phase 5's stored databases (the headline one
    and the SIFT one, both bucketed by the policy) and of both flat
    tiers at the SIFT corpus (phase 7's stored one), each against its
    phase's results. The stored databases are those phases' objects,
    their partitions and chunks already read."""
    for name, sdb, q, nprobe, want in (
            ("headline", head["stored_db"], head["q"], NPROBE,
             head["batch"]),
            ("SIFT", sift["stored_db"], sift["q"], SIFT_NPROBE,
             sift["stored_batch"])):
        _, pre_ms, pre = counted(torch, lambda: sdb.preload(mesh=mesh))
        got, qb_ms, served = counted(
            torch, lambda: sdb.query_batch(q, K_TOP, nprobe))
        layout = sdb._dev[0].layout
        if name == "headline":
            require(layout == "sharded-bucketed", f"the stored headline's "
                    f"preload(mesh=) built a {layout} index")
            needs(served, ("adc_scan",), "the stored headline's sharded "
                  "query_batch")
        add_launches(total, pre)
        add_launches(total, served)
        swapped = sum(same_results(got[b], want[b],
                                   f"sharded stored {name} [{b}]")
                      for b in range(len(q)))
        log(f"stored {name} preload(mesh=) {pre_ms:.3f} ms ({layout}); "
            f"query_batch({len(q)}, nprobe={nprobe}) {qb_ms:.3f} ms, "
            f"adc_scan launches {served['adc_scan']}; equal to phase 5's "
            f"preloaded results ({swapped} tie swaps)")
    q, want = sift["q"], sift["flat_batch"]
    mem = ft.FlatDatabase(sift["x"], vector_ids=sift["db"].vector_ids,
                          device="cuda")
    stored = sift["flat_stored"]
    for name, db in (("FlatDatabase", mem), ("StoredFlatDatabase", stored)):
        _, pre_ms, pre = counted(torch, lambda: db.preload(mesh=mesh))
        got, ms, served = counted(torch, lambda: db.query_batch(q, K_TOP))
        add_launches(total, pre)
        add_launches(total, served)
        swapped = sum(same_results(got[b], want[b], f"sharded {name} [{b}]")
                      for b in range(len(q)))
        log(f"{name}.preload(mesh=) {pre_ms:.3f} ms; query_batch({len(q)},"
            f" k={K_TOP}) {ms:.3f} ms; equal to phase 7's ({swapped} tie "
            "swaps)")
    del mem


def streamed_builder(ft, x, seed: int, mesh=None):
    """The streamed build of the SIFT shape (its default chunks of 524,288
    rows), sharded over ``mesh`` when one is given."""
    b = (ft.StreamingDatabaseBuilder(x, device="cuda")
         .with_partitions(SIFT_P).with_divisions(SIFT_D)
         .with_clusters(C).with_seed(seed))
    return b if mesh is None else b.with_mesh(mesh)


def rows_differ(a, b) -> int:
    """Rows whose codes or partition differ between two databases."""
    return int(np.sum((a.codes != b.codes).any(axis=1)
                      | (a.partition_indices != b.partition_indices)))


def sharded_streamed(torch, ft, mesh, sift: dict, seed: int,
                     total: dict) -> None:
    """``with_mesh`` at the SIFT shape after the unsharded streamed build
    of the same seed: codes and partition indices bit-identical."""
    x = sift["x"]
    base, b_ms, _ = counted(torch, lambda: streamed_builder(
        ft, x, seed).build())
    shard, s_ms, launches = counted(torch, lambda: streamed_builder(
        ft, x, seed, mesh).build())
    needs(launches, SIFT_BUILD, "the with_mesh streamed build")
    add_launches(total, launches)
    differ = rows_differ(base, shard)
    log(f"streamed build at the SIFT shape: unsharded {b_ms / 1e3:.3f} s, "
        f"with_mesh {s_ms / 1e3:.3f} s, launches {launches}; rows whose "
        f"codes or partition differ: {differ}")
    require(differ == 0, f"with_mesh: {differ} rows differ from the "
            "unsharded streamed build")
    require(base.vector_ids == shard.vector_ids, "with_mesh: other ids")


def world_of_two(torch, sift: dict, seed: int, work: Path, built_one,
                 served_one) -> dict:
    """A gloo world of two worker processes of this script on ``cuda:0``:
    each builds the SIFT shape twice, serves 1000 queries and runs the
    ``with_mesh`` streamed build. Returns the two workers' launches
    added."""
    np.save(work / "w2-x.npy", sift["x"])
    np.save(work / "w2-q.npy", sift["q"])
    np.savez(work / "w2-index.npz", *sift["arrays"])
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
         "--rank", str(r), "--world", "2", "--work", str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=420)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines():
            log(f"  [rank {r}] {line}")
        require(pr.returncode == 0, f"world-of-two rank {r} exited "
                f"{pr.returncode}")
    ranks = [dict(np.load(work / f"w2-r{r}.npz")) for r in range(2)]
    for key in ("cents", "books", "pidx", "codes", "stream_digest"):
        require(np.array_equal(ranks[0][key], ranks[1][key]),
                f"world of two: the ranks' {key} differ")
    pidx_one = built_one.partition_indices.to(torch.int32).cpu().numpy()
    share = float(np.mean(ranks[0]["pidx"] == pidx_one))
    gt = sift["gt"]
    rows = ranks[0]["own_rows"]
    recall = float(np.mean([len(set(rows[b].tolist()) & set(gt[b].tolist()))
                            / K_TOP for b in range(len(rows))]))
    swapped = same_arrays((ranks[0]["d"], ranks[0]["r"]), served_one[:2],
                          "world of two, ShardedIndex(bucketed)")
    require(np.array_equal(ranks[0]["p"], served_one[2]),
            "world of two probed other partitions")
    log(f"world of two (gloo, both ranks on cuda:0): build_sharded "
        f"{', '.join(f'{v:.3f}' for v in ranks[0]['secs'])} s (rank 0), "
        f"the two runs and both ranks bit-equal; partition indices equal "
        f"to the world of one's: {share:.4f}; recall@10 {recall:.4f} "
        f"(phase 3's {sift['recall']:.4f}); ShardedIndex(bucketed) of phase"
        f" 3's arrays: query({len(sift['q'])}) {float(ranks[0]['serve_ms']):.3f}"
        f" ms, equal to the world of one's ({swapped} tie swaps); with_mesh "
        f"streamed build {float(ranks[0]['stream_s']):.3f} s (rank 0), both "
        f"ranks' codes equal, {int(ranks[0]['stream_differ'])} rows differ "
        f"from rank 0's unsharded streamed build")
    require(abs(recall - sift["recall"]) <= 0.01,
            f"world of two: recall {recall} is not within 0.01 of phase 3's "
            f"{sift['recall']}")
    total = {}
    for rk in ranks:
        add_launches(total, {name: int(count) for name, count in zip(
            rk["launch_names"].tolist(), rk["launch_counts"].tolist())})
    return total


def mesh_worker(args) -> None:
    """One rank of :func:`world_of_two` (``--rank``, ``--world``,
    ``--work``): joins the gloo world on ``cuda:0``, builds the SIFT shape
    twice (the runs must be bit-equal), serves its own build and phase 3's
    arrays through ``ShardedIndex(layout="bucketed")``, runs the
    ``with_mesh`` streamed build (each chunk split across the ranks; rank 0
    then holds it against an unsharded streamed build, 0 rows may differ),
    and writes its arrays, results, times and the sharded calls' own
    launch counts to ``--work``."""
    import datetime
    import hashlib

    import torch
    import torch.distributed as dist
    work = Path(args.work)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{work / 'gloo-store'}",
        rank=args.rank, world_size=args.world,
        timeout=datetime.timedelta(seconds=300))
    try:
        import flechasdb_tpu_torch as ft
        from flechasdb_tpu_torch.parallel import build_sharded, corpus_mesh
        from flechasdb_tpu_torch.serving import ShardedIndex
        mesh = corpus_mesh(device="cuda:0")
        x = np.load(work / "w2-x.npy", mmap_mode="c")   # each rank reads
                                                         # its own block
        q = np.load(work / "w2-q.npy")
        with np.load(work / "w2-index.npz") as f:
            arrays = [f[f"arr_{i}"] for i in range(4)]
        # Phase 3's configuration, read from its arrays.
        (p, _), (d, c, _) = arrays[0].shape, arrays[1].shape
        total, builds, secs = {}, [], []
        for _ in range(2):
            b, ms, launches = counted(torch, lambda: build_sharded(
                x, p, d, c, args.seed, mesh=mesh))
            needs(launches, SIFT_BUILD, f"rank {args.rank}'s build_sharded")
            add_launches(total, launches)
            builds.append(b)
            secs.append(ms / 1e3)
        for field, a, b in zip(builds[0]._fields, *builds):
            require(torch.equal(a, b), f"the two builds' {field} differ")
        cents, pidx, books, codes = (t.cpu().numpy() for t in builds[0])
        pidx = pidx.astype(np.int32)
        own, _, launches = counted(torch, lambda: ShardedIndex(
            cents, books, codes.astype(np.int32), pidx, layout="bucketed",
            mesh=mesh).query(q, K_TOP, SIFT_NPROBE))
        needs(launches, ("adc_scan",), f"rank {args.rank}'s ShardedIndex")
        add_launches(total, launches)
        theirs = ShardedIndex(*arrays, layout="bucketed", mesh=mesh)
        theirs.query(q, K_TOP, SIFT_NPROBE)
        res, serve_ms, launches = counted(
            torch, lambda: theirs.query(q, K_TOP, SIFT_NPROBE))
        needs(launches, ("adc_scan",), f"rank {args.rank}'s ShardedIndex")
        add_launches(total, launches)
        stream, stream_ms, launches = counted(torch, lambda: streamed_builder(
            ft, x, args.seed, mesh).build())
        if args.rank == 0:               # training runs on rank 0 alone
            needs(launches, SIFT_BUILD, "rank 0's with_mesh streamed build")
        add_launches(total, launches)
        log(f"launches of the sharded calls {total}; builds {secs} s; "
            f"serve {serve_ms:.3f} ms; with_mesh streamed build "
            f"{stream_ms / 1e3:.3f} s")
        digest = hashlib.sha256(
            np.ascontiguousarray(stream.codes).tobytes()
            + np.ascontiguousarray(stream.partition_indices).tobytes())
        differ = -1
        if args.rank == 0:
            base = streamed_builder(ft, x, args.seed).build()
            differ = rows_differ(base, stream)
            log(f"with_mesh against the unsharded streamed build: {differ} "
                "rows differ")
            require(differ == 0, f"with_mesh over two ranks: {differ} rows "
                    "differ from the unsharded streamed build")
            require(base.vector_ids == stream.vector_ids,
                    "with_mesh over two ranks: other ids")
        require(not any(m == "jax" or m.startswith("jax.")
                        or m.split(".")[0] == "flechasdb_tpu"
                        for m in sys.modules), "jax was imported")
        np.savez(work / f"w2-r{args.rank}.npz", cents=cents, books=books,
                 pidx=pidx, codes=codes, own_rows=own[1], d=res[0], r=res[1],
                 p=res[2], secs=np.asarray(secs),
                 serve_ms=np.asarray(serve_ms),
                 stream_s=np.asarray(stream_ms / 1e3),
                 stream_digest=np.frombuffer(digest.digest(), np.uint8),
                 stream_differ=np.asarray(differ),
                 launch_names=np.asarray(list(total)),
                 launch_counts=np.asarray(list(total.values())))
    finally:
        dist.destroy_process_group()


def sharded_run(torch, seed: int, head: dict, sift: dict, work: Path):
    """Phase 11: (a) a world of one over NCCL in this process, (b) a gloo
    world of two worker processes sharing the card. Each sharded call's
    launches are counted on their own, after its unsharded reference ran;
    the sum of those counts, the workers' added, is returned."""
    import datetime

    import flechasdb_tpu_torch as ft
    import torch.distributed as dist
    from flechasdb_tpu_torch.parallel import corpus_mesh
    from flechasdb_tpu_torch.parallel.mesh import sum_ranks
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"file://{work / 'nccl-store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    one = {}
    try:
        mesh = corpus_mesh(device="cuda:0")
        # The group's first collective sets up its communicator; timed
        # apart from the builds.
        _, first_ms, _ = counted(torch, lambda: sum_ranks(
            mesh, torch.zeros(1, device=mesh.device)))
        log(f"world of one ({mesh.backend}): group set-up "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms, first collective "
            f"{first_ms:.3f} ms")
        built = sharded_builds(torch, mesh, head, sift, seed, one)
        served = sharded_serving(torch, mesh, sift, one)
        sharded_tiers(torch, ft, mesh, head, sift, one)
        sharded_streamed(torch, ft, mesh, sift, seed, one)
    finally:
        dist.destroy_process_group()
    log(f"launches of phase 11 (a)'s sharded calls: {one}")
    t1 = time.perf_counter()
    two = world_of_two(torch, sift, seed, work, built, served)
    log(f"launches of phase 11 (b)'s sharded calls, both ranks: {two}")
    log(f"phase 11 parts: (a) {t1 - t0:.3f} s, (b) "
        f"{time.perf_counter() - t1:.3f} s ({CARD})")
    total = dict(one)
    add_launches(total, two)
    return total



# --- phase 12: the metrics ----------------------------------------------------

#: The host fields a dot or cosine build must share with phase 3's build,
#: bit for bit (training is L2 for every metric).
ARRAY_FIELDS = ("partition_centroids", "partition_indices", "codebooks",
                "codes", "residues")
#: flechasdb_tpu/metrics.py:63-67's message for a zero query row.
ZERO_QUERY = "cosine metric: query 0 has zero norm (no direction)"


def bit_equal(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


@contextlib.contextmanager
def layout_policy(layout: str):
    """The layout policy held to ``layout`` while the block runs: the
    limits of the CPU's rule (``host.PAD_LIMIT``) and of the card's
    (``serving.CARD_PAD_LIMIT``) past any padding (bucketed) or 0
    (masked), then restored."""
    from flechasdb_tpu_torch import host, serving
    before = host.PAD_LIMIT, serving.CARD_PAD_LIMIT
    limit = float("inf") if layout == "bucketed" else 0.0
    host.PAD_LIMIT = serving.CARD_PAD_LIMIT = limit
    try:
        yield
    finally:
        host.PAD_LIMIT, serving.CARD_PAD_LIMIT = before


def database_on(ft, db, layout: str, device: str = "cuda"):
    """A ``Database`` on ``db``'s arrays whose device index, built here,
    has ``layout``."""
    out = ft.Database(**ft.to_arrays(db), device=device)
    with layout_policy(layout):
        got = out._device_state().layout
    require(got == layout, f"the index took the {got} layout")
    return out


def metric_builder(ft, x, seed: int, metric: str):
    """Phase 3's build (P, D, C and seed) under ``metric``."""
    return (ft.DatabaseBuilder(x, device="cuda").with_partitions(SIFT_P)
            .with_divisions(SIFT_D).with_clusters(C).with_seed(seed)
            .with_metric(metric))


def coarse_at(pidx: np.ndarray, gt: np.ndarray, probed: np.ndarray) -> float:
    """The share of the true neighbours whose partition was probed."""
    return float(np.mean([np.isin(pidx[gt[b]], probed[b]).mean()
                          for b in range(len(gt))]))


def same_ids(got, want) -> bool:
    """Two result lists bit for bit: ids and distances."""
    return ([(r.vector_id, r.squared_distance) for r in got]
            == [(r.vector_id, r.squared_distance) for r in want])


def mips_truth_check(torch, xd, qd, keys, rows) -> None:
    """``exact_topk(metric="dot")``'s keys and rows for ``qd`` against
    float64 inner products on the card: the keys within the tolerance of
    the float64 k smallest ``−⟨q, x⟩``, and each row's float64 key too
    (rows equal up to ties). ``smallest_k`` turns the negative keys into
    ordered integers, so a sign slip there shows here."""
    keys64 = -(qd.double() @ xd.double().T)                  # [B, N]
    best = torch.topk(keys64, K_TOP, dim=1, largest=False).values
    best = torch.sort(best, dim=1).values
    mine = keys64.gather(1, rows.long())
    for what, got in (("keys", keys.double()), ("rows' keys", mine)):
        off = (got - best).abs() > ATOL + RTOL * best.abs()
        require(not bool(off.any()), f"exact_topk(metric='dot') {what} "
                "differ from the float64 inner products")


def mips_leg(torch, ft, sift: dict, seed: int, total: dict) -> dict:
    """The MIPS build on phase 3's data (bit-equal to phase 3's, with its
    launches), exact MIPS ground truth, ``sweep.py``'s rows on buckets,
    ``Database.query_batch`` on the policy's layout, 64 queries of each
    layout and 64 range searches against the CPU path."""
    from flechasdb_tpu_torch.ops.exact import exact_topk
    from flechasdb_tpu_torch.serving import DeviceIndex
    x, q, base = sift["x"], sift["q"], sift["db"]
    db, build_ms, launches = counted(
        torch, lambda: metric_builder(ft, x, seed, "dot").build())
    add_launches(total, launches)
    needs(launches, SIFT_BUILD, "the MIPS build")
    one_sum_pass_a_round(launches, "the MIPS build")
    require(launches == sift["build_launches"], f"the MIPS build's launches "
            f"{launches} differ from phase 3's {sift['build_launches']}")
    for name in ARRAY_FIELDS:
        require(bit_equal(getattr(db, name), getattr(base, name)),
                f"the MIPS build's {name} differ from phase 3's")
    require(db.vector_ids == base.vector_ids and db.metric == "dot",
            "the MIPS build's ids or metric")
    log(f"MIPS build (with_metric('dot'), {SIFT_N} x {SIFT_M}, P={SIFT_P}, "
        f"D={SIFT_D}, C={C}): {build_ms / 1e3:.3f} s, launches {launches} "
        f"(phase 3's build the same); every array and id bit-equal to phase "
        "3's build")

    xd, qd = (torch.as_tensor(a, device="cuda") for a in (x, q))
    (gt_keys, gt_rows), gt_ms, _ = counted(
        torch, lambda: exact_topk(qd, xd, k=K_TOP, metric="dot"))
    gt = gt_rows.cpu().numpy().astype(np.int64)
    mips_truth_check(torch, xd, qd[:N_CHECK], gt_keys[:N_CHECK],
                     gt_rows[:N_CHECK])
    del xd
    log(f"MIPS ground truth (exact_topk(metric='dot'), {SIFT_NQ} queries): "
        f"{gt_ms:.3f} ms; {N_CHECK} queries' keys and rows equal to float64"
        " inner products on the card")

    index = DeviceIndex(*sift["arrays"], layout="bucketed", metric="dot",
                        device="cuda")
    orig = db._device_originals()

    def serve():
        out = {}
        for nprobe, rr in MIPS_ROWS:
            def fn(nprobe=nprobe, rr=rr):
                if rr is None:
                    return index.query(q, K_TOP, nprobe)
                return index.query_rerank(q, orig, K_TOP, nprobe, rr)
            out[nprobe, rr] = fn(), [timed(fn)[1] for _ in range(3)]
        return out
    rows, _, served = counted(torch, serve)
    add_launches(total, served)
    needs(served, ("adc_scan",), "the MIPS bucketed batches")
    probed = {n: rows[n, None][0][2] for n, rr in MIPS_ROWS if rr is None}
    recalls = {}
    for (nprobe, rr), (res, ms) in rows.items():
        recalls[nprobe, rr] = recall_at(res[1], gt)
        log(f"MIPS DeviceIndex(layout='bucketed', metric='dot') nprobe="
            f"{nprobe}{f' rerank={rr}' if rr else ''}: recall@10 "
            f"{recalls[nprobe, rr]:.4f}, coarse@10 "
            f"{coarse_at(base.partition_indices, gt, probed[nprobe]):.4f}, "
            f"batch of {SIFT_NQ} {statistics.median(ms):.3f} ms (median of "
            f"3: {', '.join(f'{v:.3f}' for v in ms)})")
    r_adc, r_rr = recalls[SIFT_NPROBE, None], recalls[SIFT_NPROBE, RERANK]
    require(r_rr >= 0.9 and r_rr >= r_adc, f"MIPS rerank recall {r_rr} "
            f"below 0.9 or the ADC recall {r_adc}")

    kw = dict(k=K_TOP, nprobe=SIFT_NPROBE)
    _, first_ms = timed(lambda: db.query_batch(q, **kw))
    (qb, qbr), qb_ms, launches = counted(torch, lambda: (
        db.query_batch(q, **kw), db.query_batch(q, rerank=RERANK, **kw)))
    add_launches(total, launches)
    layout = db._device_state().layout
    log(f"MIPS Database.query_batch({SIFT_NQ}) on the {layout} layout (the "
        f"policy's): first {first_ms:.3f} ms (builds its device index); "
        f"warm, without and with rerank={RERANK}, {qb_ms:.3f} ms; recall@10 "
        f"{recall_at(host_arrays(qb, sift['row_of'], K_TOP)[1], gt):.4f}, "
        f"after rerank "
        f"{recall_at(host_arrays(qbr, sift['row_of'], K_TOP)[1], gt):.4f}")

    t0 = time.perf_counter()
    qc = q[:N_CHECK]
    cpu = DeviceIndex(*sift["arrays"], layout="bucketed", metric="dot",
                      device="cpu")
    orig_cpu = torch.as_tensor(
        base.residues + base.partition_centroids[base.partition_indices])
    swapped = same_arrays(tuple(a[:N_CHECK] for a in rows[SIFT_NPROBE,
                                                          None][0][:2]),
                          cpu.query(qc, **kw)[:2], "MIPS bucketed vs CPU")
    swapped += same_arrays(
        tuple(a[:N_CHECK] for a in rows[SIFT_NPROBE, RERANK][0]),
        cpu.query_rerank(qc, orig_cpu, rerank=RERANK, **kw),
        "MIPS bucketed rerank vs CPU")
    ref = ft.Database(**ft.to_arrays(db), device="cpu")
    for rr, got in ((None, qb), (RERANK, qbr)):
        want = ref.query_batch(qc, rerank=rr, **kw)
        for b in range(N_CHECK):
            swapped += same_results(got[b], want[b],
                                    f"MIPS query_batch rerank={rr} [{b}]")
    log(f"MIPS: {N_CHECK} queries of each layout (bucketed, "
        f"{ref._device_state().layout}), with and without rerank, equal to "
        f"the CPU plain path ({swapped} tie swaps; "
        f"{time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    radius = float(np.median(rows[SIFT_NPROBE, None][0][0][:N_CHECK,
                                                           K_TOP - 1]))
    require(radius < 0, f"the MIPS radius {radius} is not a negative "
            "inner-product key")
    got, range_ms, launches = counted(torch, lambda: index.query_range(
        qc, radius, SIFT_NPROBE))
    add_launches(total, launches)
    needs(launches, ("adc_scan",), "the MIPS range batch on buckets")
    want = cpu.query_range(qc, radius, SIFT_NPROBE)
    edge = sum(same_hits(got[b], want[b], radius, f"MIPS range [{b}]")
               for b in range(N_CHECK))
    row_of, n_hits = sift["row_of"], 0
    for b in range(N_CHECK):
        mine = hits(db.query_range(qc[b], radius, SIFT_NPROBE), row_of)
        edge += same_hits(mine, hits(ref.query_range(
            qc[b], radius, SIFT_NPROBE), row_of), radius,
            f"MIPS Database.query_range [{b}]")
        n_hits += len(mine[0])
    require(n_hits > 0, "the MIPS range searches found nothing")
    log(f"MIPS range: radius {radius:.3f} (median 10th key, −⟨q, x⟩); "
        f"DeviceIndex.query_range({N_CHECK}) on buckets {range_ms:.3f} ms "
        f"and {N_CHECK} Database.query_range calls on the {layout} layout "
        f"({n_hits} hits), equal to the CPU path ({edge} rows at the "
        f"radius; {time.perf_counter() - t0:.3f} s)")
    return {"db": db, "index": index, "gt": gt}


def mips_stored(torch, ft, mips: dict, sift: dict, work: Path,
                total: dict) -> None:
    """The MIPS tree: its root's metric, 8 cold queries (no kernel) equal
    to the in-memory database's, ``preload`` on buckets and 1000 queries
    through K-A bit-equal to the in-memory database's on buckets, and a
    published label resolved and loaded."""
    db, q = mips["db"], sift["q"]
    fs = ft.LocalFileSystem(work / "mips")
    root, save_ms = timed(lambda: ft.save_database(db, fs))
    sdb = ft.load_database(fs, f"{root}.binpb", device="cuda")
    require(sdb.metric == "dot", f"the MIPS root's metric is {sdb.metric!r}")
    cold, _, launches = counted(torch, lambda: [
        timed(lambda: sdb.query(q[i], K_TOP, SIFT_NPROBE))
        for i in range(N_SINGLE)])
    require(not any(launches.values()), f"the cold queries launched "
            f"{launches}")
    swapped = sum(same_results(got, db.query(q[i], K_TOP, SIFT_NPROBE),
                               f"MIPS cold query[{i}]")
                  for i, (got, _) in enumerate(cold))
    mem = database_on(ft, db, "bucketed")
    want, _, launches = counted(torch, lambda: mem.query_batch(
        q, K_TOP, SIFT_NPROBE))
    add_launches(total, launches)
    with layout_policy("bucketed"):
        _, preload_ms = timed(sdb.preload)
    layout = sdb._dev[0].layout
    require(layout == "bucketed", f"the preloaded index is {layout}")
    got, qb_ms, launches = counted(torch, lambda: sdb.query_batch(
        q, K_TOP, SIFT_NPROBE))
    add_launches(total, launches)
    needs(launches, ("adc_scan",), "the preloaded MIPS batch")
    require(all(same_ids(g, w) for g, w in zip(got, want)),
            "the preloaded MIPS batch differs from the in-memory one")
    ft.publish_label(fs, root)
    resolved = ft.resolve_label(fs)
    require(resolved == root, f"the label resolved to {resolved}")
    labeled = ft.load_labeled(fs, device="cuda")
    require(labeled.metric == "dot" and same_ids(
        labeled.query(q[0], K_TOP, SIFT_NPROBE), cold[0][0]),
        "the labeled root answers otherwise")
    log(f"MIPS stored: save_database {save_ms:.3f} ms; root metric "
        f"{sdb.metric!r}; {N_SINGLE} cold queries "
        f"{', '.join(f'{ms:.3f}' for _, ms in cold)} ms (no kernel), equal "
        f"to the in-memory database ({swapped} tie swaps); preload "
        f"{preload_ms:.3f} ms ({layout}); query_batch({len(q)}) "
        f"{qb_ms:.3f} ms through adc_scan, bit-equal to the in-memory "
        f"database on buckets; publish_label -> resolve_label -> "
        f"load_labeled: the same root and answers")


def zero_query_raises(ft, name: str, call) -> None:
    """``call`` (a zero query under cosine) raises ``InvalidArgs`` with
    the JAX package's message."""
    try:
        call()
    except ft.InvalidArgs as e:
        require(str(e) == ZERO_QUERY, f"{name}: {e}")
        return
    raise AssertionError(f"{name} answered a zero cosine query")


def cosine_leg(torch, ft, sift: dict, seed: int, work: Path,
               total: dict) -> None:
    """The cosine build on phase 3's (non-unit) rows: recall on both
    layouts against exact L2 ground truth over the normalized corpus, 64
    queries of each against the CPU path, the flat tier, the zero query
    on every surface, and the stored round trip."""
    from flechasdb_tpu_torch.host import normalize_rows
    from flechasdb_tpu_torch.ops.exact import exact_topk
    x, q = sift["x"], sift["q"]
    db, build_ms, launches = counted(
        torch, lambda: metric_builder(ft, x, seed, "cosine").build())
    add_launches(total, launches)
    needs(launches, SIFT_BUILD, "the cosine build")
    one_sum_pass_a_round(launches, "the cosine build")
    norms = np.linalg.norm(x, axis=1)
    xn, qn = normalize_rows(x), normalize_rows(q, "query")
    gt = exact_topk(torch.as_tensor(qn, device="cuda"),
                    torch.as_tensor(xn, device="cuda"),
                    k=K_TOP)[1].cpu().numpy()
    log(f"cosine build (with_metric('cosine'), rows of norm "
        f"{norms.min():.3f} to {norms.max():.3f}): {build_ms / 1e3:.3f} s, "
        f"launches {launches}")
    row_of = {vid: i for i, vid in enumerate(db.vector_ids)}
    kw = dict(k=K_TOP, nprobe=SIFT_NPROBE)
    qc = q[:N_CHECK]
    for layout in ("bucketed", "masked"):
        served = database_on(ft, db, layout)
        (adc, rr), ms, launches = counted(torch, lambda: (
            served.query_batch(q, **kw),
            served.query_batch(q, rerank=RERANK, **kw)))
        add_launches(total, launches)
        if layout == "bucketed":
            needs(launches, ("adc_scan",), "the cosine batches on buckets")
        t0 = time.perf_counter()
        ref = database_on(ft, db, layout, device="cpu")
        swapped = 0
        for depth, got in ((None, adc), (RERANK, rr)):
            want = ref.query_batch(qc, rerank=depth, **kw)
            for b in range(N_CHECK):
                swapped += same_results(got[b], want[b], f"cosine {layout} "
                                        f"rerank={depth} [{b}]")
        log(f"cosine Database.query_batch({SIFT_NQ}) on the {layout} layout, "
            f"without and with rerank={RERANK}: {ms:.3f} ms; recall@10 "
            f"{recall_at(host_arrays(adc, row_of, K_TOP)[1], gt):.4f}, after"
            f" rerank {recall_at(host_arrays(rr, row_of, K_TOP)[1], gt):.4f}"
            f"; {N_CHECK} equal to the CPU path ({swapped} tie swaps; "
            f"{time.perf_counter() - t0:.3f} s)")

    def flat_batch():
        flat = ft.FlatDatabase(x, vector_ids=db.vector_ids, metric="cosine",
                               device="cuda")
        return flat, flat.query_batch(q, K_TOP)
    (flat, res), flat_ms, launches = counted(torch, flat_batch)
    require(not any(launches.values()), f"the flat tier launched {launches}")
    swapped = flat_against_truth(flat_rows(res), gt, xn, qn, "cosine flat")
    log(f"cosine FlatDatabase on the card: build and query_batch("
        f"{SIFT_NQ}) {flat_ms:.3f} ms, equal to the exact ground truth "
        f"({swapped} tie swaps)")

    fs = ft.LocalFileSystem(work / "cosine")
    root, save_ms = timed(lambda: ft.save_database(db, fs))
    sdb = ft.load_database(fs, f"{root}.binpb", device="cuda")
    require(sdb.metric == "cosine", f"the cosine root's metric is "
            f"{sdb.metric!r}")
    cold, _, launches = counted(torch, lambda: [
        sdb.query(q[i], **kw) for i in range(N_SINGLE)])
    require(not any(launches.values()), f"the cold queries launched "
            f"{launches}")
    swapped = sum(same_results(got, db.query(q[i], **kw),
                               f"cosine cold query[{i}]")
                  for i, got in enumerate(cold))
    zero = np.zeros(SIFT_M, np.float32)
    surfaces = [
        ("Database.query", lambda: db.query(zero, **kw)),
        ("Database.query_batch", lambda: db.query_batch(zero[None], **kw)),
        ("FlatDatabase.query", lambda: flat.query(zero, K_TOP)),
        ("StoredDatabase.query (cold)", lambda: sdb.query(zero, **kw))]
    for name, call in surfaces:
        zero_query_raises(ft, name, call)
    _, preload_ms = timed(sdb.preload)
    surfaces.append(("StoredDatabase.query_batch (preloaded)",
                     lambda: sdb.query_batch(zero[None], **kw)))
    zero_query_raises(ft, *surfaces[-1])
    got = sdb.query_batch(q, **kw)
    want = db.query_batch(q, **kw)
    exact = 0
    for b in range(len(q)):
        swapped += same_results(got[b], want[b], f"cosine stored [{b}]")
        exact += same_ids(got[b], want[b])
    log(f"cosine stored: save_database {save_ms:.3f} ms, root metric "
        f"{sdb.metric!r}; {N_SINGLE} cold queries equal to the in-memory "
        f"database; preload {preload_ms:.3f} ms ({sdb._dev[0].layout}), "
        f"query_batch({len(q)}) equal to the in-memory batch ({exact} of "
        f"{len(q)} bit-equal, {swapped} tie swaps); a zero query raises "
        f"InvalidArgs({ZERO_QUERY!r}) on {len(surfaces)} surfaces: "
        + ", ".join(name for name, _ in surfaces))


def metrics_run(torch, seed: int, sift: dict, work: Path):
    """Phase 12: ``dot`` and ``cosine`` at the SIFT shape, on phase 3's
    data and state. Each leg's launches are counted on their own; their
    sum and K-A's case at the MIPS buckets are returned."""
    import flechasdb_tpu_torch as ft
    t0 = time.perf_counter()
    total = {}
    sift["row_of"] = {vid: i for i, vid in enumerate(sift["db"].vector_ids)}
    mips = mips_leg(torch, ft, sift, seed, total)
    t1 = time.perf_counter()
    mips_stored(torch, ft, mips, sift, work, total)
    t2 = time.perf_counter()
    cosine_leg(torch, ft, sift, seed, work, total)
    log(f"launches over phase 12: {total}")
    log(f"phase 12 parts: MIPS {t1 - t0:.3f} s, MIPS stored {t2 - t1:.3f} "
        f"s, cosine {time.perf_counter() - t2:.3f} s ({CARD})")
    return total, scan_at_main_path(torch, mips["index"], sift["q"],
                                    SIFT_NPROBE, "the MIPS path's dot",
                                    metric="dot")


# --- phase 13: the GIST1M shape -----------------------------------------------

#: The kernels a GIST build launches: K-B for the coarse fit (M=960), K-C
#: for the PQ fit (m=16), or their fast variants under ``with_fast_math``.
GIST_BUILD = {False: ("lloyd_round", "lloyd_grouped"),
              True: ("lloyd_round_fast", "lloyd_grouped_fast")}


def gist_builder(ft, xh, seed: int, fast: bool = False):
    """``sweep.py``'s GIST build (P=1024, D=60, C=256) over the host rows,
    without residues (the rerank reads the corpus on the card)."""
    b = (ft.DatabaseBuilder(xh, device="cuda").with_partitions(GIST_P)
         .with_divisions(GIST_D).with_clusters(C).with_seed(seed)
         .with_residues(False))
    return b.with_fast_math() if fast else b


def gist_launches(launches: dict, fast: bool, what: str) -> None:
    """A GIST build launched its two kernels (and not the other
    numerics'), with one cluster-sum pass a round."""
    needs(launches, GIST_BUILD[fast], what)
    require(not any(launches[k] for k in GIST_BUILD[not fast])
            and launches["adc_scan"] == 0, f"{what} launched {launches}")
    one_sum_pass_a_round(launches, what)


def gist_parts(timer) -> tuple[dict, tuple[int, int]]:
    """A build's parts from its events (the card synchronized at each),
    and its fits' rounds."""
    rounds = deep_fit_rounds(timer.marks)
    t = timer.at
    parts = {
        "UUIDs": t("FinishedIdAssignment") - t("StartingIdAssignment"),
        "upload": t("StartingCentroidInitialization")
        - t("StartingPartitioning"),
        "coarse seeding": t("FinishedCentroidInitialization")
        - t("StartingCentroidInitialization"),
        "coarse rounds (K-B)": t("FinishedPartitioning")
        - t("FinishedCentroidInitialization"),
        "division": t("StartingCentroidInitialization", 1)
        - t("FinishedPartitioning"),
        "PQ seeding": t("FinishedCentroidInitialization", 1)
        - t("StartingCentroidInitialization", 1),
        "PQ rounds (K-C)": t("FinishedQuantization")
        - t("FinishedCentroidInitialization", 1),
        "copy-out": t("end") - t("FinishedQuantization", -1),
    }
    return parts, rounds


def gist_builds(torch, ft, xh, seed: int, total: dict):
    """The full build twice (bit-equal; the second's parts timed at its
    events), then the fast build. Returns ``(full, fast)``."""
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first, first_ms, launches = counted(
        torch, lambda: gist_builder(ft, xh, seed).build())
    add_launches(total, launches)
    gist_launches(launches, False, "the first GIST build")
    timer = PartTimer(torch)
    second, _, again = counted(
        torch, lambda: gist_builder(ft, xh, seed).build(timer))
    timer.end()
    add_launches(total, again)
    gist_launches(again, False, "the second GIST build")
    for name in ARRAY_FIELDS[:4]:
        require(bit_equal(getattr(first, name), getattr(second, name)),
                f"two same-seed GIST builds differ in {name}")
    require(first.vector_ids == second.vector_ids,
            "two same-seed GIST builds differ in their ids")
    parts, (coarse_r, pq_r) = gist_parts(timer)
    second_s = timer.at("end") - timer.at("start")
    del second
    log(f"GIST build ({GIST_N} x {GIST_M}, P={GIST_P}, D={GIST_D}, C={C}, "
        f"no residues): first {first_ms / 1e3:.3f} s, second (timed at its "
        f"events) {second_s:.3f} s, the arrays and ids bit-equal; rounds: "
        f"coarse {coarse_r}, PQ {pq_r}; launches {launches}, {again}; "
        f"parts: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()))
    pops = len(np.unique(first.partition_indices))
    counts = np.bincount(first.partition_indices, minlength=GIST_P)
    log(f"GIST build: partitions populated {pops}, largest {counts.max()}, "
        f"smallest {counts.min()}; peak device memory of the builds "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB")

    timer = PartTimer(torch)
    fast, fast_ms, launches = counted(
        torch, lambda: gist_builder(ft, xh, seed, fast=True).build(timer))
    timer.end()
    add_launches(total, launches)
    gist_launches(launches, True, "the fast GIST build")
    f_parts, f_rounds = gist_parts(timer)
    log(f"GIST fast build (with_fast_math()): {fast_ms / 1e3:.3f} s (the "
        f"full build's {second_s:.3f} s); rounds: coarse {f_rounds[0]}, PQ "
        f"{f_rounds[1]}; launches {launches}; parts: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in f_parts.items()))
    return first, fast


def gist_arrays(db):
    return (db.partition_centroids, db.codebooks, db.codes.astype(np.int32),
            db.partition_indices)


def gist_serve(torch, x, xh, qh, gt: np.ndarray, full, fast, total: dict):
    """Buckets at packed D=60 (15 words a slot) through K-A at
    GIST_NPROBES and the rerank row, the fast build's recall and inertia
    against the full build's, 64 queries against the CPU path on the
    same buckets, ``Database.query_batch`` on the policy's layout.
    Returns the bucketed index."""
    from flechasdb_tpu_torch.ops.bucketed import Buckets, query_bucketed
    from flechasdb_tpu_torch.serving import DeviceIndex, _rerank_exact
    index, index_ms = timed(lambda: DeviceIndex(
        *gist_arrays(full), layout="bucketed", device="cuda"))
    bk = index.buckets
    words, l_pad = bk.codes.shape[1], bk.codes.shape[2]
    require(words == 15, f"the GIST buckets hold {words} words a slot")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def serve():
        out = {}
        for nprobe in GIST_NPROBES:
            def fn(nprobe=nprobe):
                return index.query(qh, K_TOP, nprobe)
            out[nprobe] = fn(), [timed(fn)[1] for _ in range(3)]

        def rr():
            return index.query_rerank(qh, x, K_TOP, GIST_NPROBE, RERANK)
        out["rerank"] = rr(), [timed(rr)[1] for _ in range(3)]
        return out
    rows, _, served = counted(torch, serve)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    add_launches(total, served)
    needs(served, ("adc_scan",), "the GIST bucketed batches")
    pidx = full.partition_indices
    recalls = {}
    for key, (res, ms) in rows.items():
        recalls[key] = recall_at(res[1], gt)
        nprobe = GIST_NPROBE if key == "rerank" else key
        log(f"GIST DeviceIndex(layout='bucketed') nprobe={nprobe}"
            f"{f' rerank={RERANK}' if key == 'rerank' else ''}: recall@10 "
            f"{recalls[key]:.4f}, coarse@10 "
            f"{coarse_at(pidx, gt, rows[nprobe][0][2]):.4f}, batch of "
            f"{len(qh)} {statistics.median(ms):.3f} ms (median of 3: "
            f"{', '.join(f'{v:.3f}' for v in ms)})")
    log(f"GIST buckets: DeviceIndex {index_ms:.3f} ms, l_pad {l_pad}, "
        f"packed words {words}; peak device memory of the batches above "
        f"their inputs {peak:.3f} GiB")
    r_adc = recalls[GIST_NPROBE]
    require(recalls["rerank"] >= 0.9 and recalls["rerank"] >= r_adc,
            f"GIST rerank recall {recalls['rerank']} below 0.9 or the ADC "
            f"recall {r_adc}")

    fast_index = DeviceIndex(*gist_arrays(fast), layout="bucketed",
                             device="cuda")
    res, _, launches = counted(torch, lambda: fast_index.query(
        qh, K_TOP, GIST_NPROBE))
    add_launches(total, launches)
    needs(launches, ("adc_scan",), "the fast GIST batch")
    r_fast = recall_at(res[1], gt)
    def inertia(db):            # the databases keep no residues
        cents = torch.as_tensor(db.partition_centroids, device="cuda")
        pidx = torch.as_tensor(db.partition_indices, device="cuda").long()
        return pq_error(torch, db, x - cents[pidx])
    e_full, e_fast = inertia(full), inertia(fast)
    del fast_index
    log(f"GIST fast build at nprobe={GIST_NPROBE}: recall@10 {r_fast:.4f} "
        f"(the full build's {r_adc:.4f}); PQ inertia a row {e_fast:.4f} "
        f"(the full build's {e_full:.4f}, ratio {e_fast / e_full:.4f})")
    require(abs(r_fast - r_adc) <= 0.02, f"GIST fast recall {r_fast} not "
            f"within 0.02 of {r_adc}")
    require(abs(e_fast - e_full) <= 0.05 * e_full, f"GIST fast PQ inertia "
            f"{e_fast} not within 5% of {e_full}")

    t0 = time.perf_counter()
    cpu_bk = Buckets(*(a.cpu() for a in bk))
    xc = torch.from_numpy(xh)
    swapped = 0
    for s in range(0, N_CHECK, 16):
        qc = torch.from_numpy(qh[s:s + 16])
        want = query_bucketed(qc, index.centroids.cpu(),
                              index.codebooks.cpu(), cpu_bk, k=RERANK,
                              nprobe=GIST_NPROBE)
        adc = rows[GIST_NPROBE][0]
        swapped += same_arrays((adc[0][s:s + 16], adc[1][s:s + 16]),
                               (want[0][:, :K_TOP].numpy(),
                                want[1][:, :K_TOP].numpy()),
                               f"GIST buckets vs CPU [{s}:]")
        want_rr = _rerank_exact(qc, want[1], torch.isfinite(want[0]), xc,
                                k=K_TOP)
        rr = rows["rerank"][0]
        swapped += same_arrays((rr[0][s:s + 16], rr[1][s:s + 16]),
                               tuple(t.numpy() for t in want_rr),
                               f"GIST rerank vs CPU [{s}:]")
    log(f"GIST: {N_CHECK} queries at nprobe={GIST_NPROBE}, with and without "
        f"rerank {RERANK}, equal to the CPU plain path on the same buckets "
        f"({swapped} tie swaps; {time.perf_counter() - t0:.3f} s)")

    kw = dict(k=K_TOP, nprobe=GIST_NPROBE)
    _, first_ms = timed(lambda: full.query_batch(qh[:1], **kw))
    res, qb_ms, launches = counted(torch, lambda: full.query_batch(qh, **kw))
    add_launches(total, launches)
    layout = full._device_state().layout
    row_of = {vid: i for i, vid in enumerate(full.vector_ids)}
    mine = host_arrays(res, row_of, K_TOP)
    adc = rows[GIST_NPROBE][0]
    swapped = same_arrays((mine[0][:N_CHECK], mine[1][:N_CHECK]),
                          (adc[0][:N_CHECK], adc[1][:N_CHECK]),
                          "GIST Database.query_batch vs buckets")
    log(f"GIST Database.query_batch({len(qh)}) on the {layout} layout (the "
        f"policy's): first call {first_ms:.3f} ms (builds its device index),"
        f" {qb_ms:.3f} ms, launches {launches}; recall@10 "
        f"{recall_at(mine[1], gt):.4f}; {N_CHECK} equal to the bucketed "
        f"index ({swapped} tie swaps)")
    return index


def gist_run(torch, seed: int):
    """Phase 13: the GIST1M shape on the card, nothing cut. Returns
    ``(launches, K-A case)``."""
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import synth
    from flechasdb_tpu_torch.ops.exact import exact_topk
    gen = torch.Generator("cuda").manual_seed(seed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x, q = synth.gmm_pair_device(gen, GIST_N, GIST_NQ, GIST_M,
                                 n_clusters=256, intrinsic=32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    xh, qh = x.cpu().numpy(), q.cpu().numpy()
    log(f"GIST data {GIST_N} x {GIST_M} + {GIST_NQ} queries "
        f"(synth.gmm_pair_device, 256 components, intrinsic 32, seed "
        f"{seed}): {t1 - t0:.3f} s, to the host {time.perf_counter() - t1:.3f}"
        f" s ({xh.nbytes} bytes); peak device memory "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB over "
        f"{(torch.cuda.memory_allocated() - base) / 2**30:.3f} GiB held")
    (_, gt), gt_ms, _ = counted(torch, lambda: exact_topk(q, x, k=K_TOP))
    gt = gt.cpu().numpy().astype(np.int64)
    log(f"GIST ground truth (exact_topk at M={GIST_M}, {GIST_NQ} queries): "
        f"{gt_ms:.3f} ms")
    total = {}
    t0 = time.perf_counter()
    full, fast = gist_builds(torch, ft, xh, seed, total)
    t1 = time.perf_counter()
    index = gist_serve(torch, x, xh, qh, gt, full, fast, total)
    log(f"launches over phase 13: {total}")
    log(f"phase 13 parts: builds {t1 - t0:.3f} s, serving "
        f"{time.perf_counter() - t1:.3f} s ({CARD})")
    case = scan_at_main_path(torch, index, qh[:N_CHECK], GIST_NPROBE,
                             "the GIST path's")
    del x, q, full, fast, index
    gc.collect()
    torch.cuda.empty_cache()
    return total, case


def row(name, route, source, replaces, launches, err, ms, plain_ms, bms,
        by, ms_by="cuda events", **extra):
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "ms_by": ms_by, **extra}


def assign_fields(case) -> dict:
    """A Lloyd row's assignment alone (phase 10's device time of one launch
    of the assignment kernel) beside its bound."""
    return {"assign_ms": case["ms"], "assign_bound_ms": case["bound"][0],
            "assign_bound_by": case["bound"][1],
            "assign_ms_by": "torch.profiler, device time a launch, back to "
            "back"}


def deep_shape(case) -> dict:
    """A Lloyd row's time at a Deep10M shape of phase 1 (a round, CUDA
    events), its bound, and the pass's device time there (phase 10)."""
    _, ms, plain_ms, bms, by, sums, _ = case
    return {"shape": sums["name"] + " " + sums["shape"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "pass_ms": sums["ms"], "pass_route": sums["route"]}


def gist_shape(case) -> dict:
    """A Lloyd row's time at its GIST shape of phase 1 (as
    :func:`deep_shape`) and, where it was timed, its assignment alone
    beside that bound."""
    out = deep_shape(case)
    if case[6]:
        out.update(assign_fields(case[6]))
    return out


def sums_row(launches, err, case):
    """The cluster-sum pass's row, timed alone after the K-B round at the
    PQ shape: device time (:func:`pass_device_ms`); ``library_ms`` is
    ``index_add_`` of the same sums (the counts are a ``bincount``
    more)."""
    out = row("cluster_sums", "cuda", SRC_S, REPLACES["sums"], launches,
              err, case["ms"], case["plain_ms"], *case["bound"],
              "torch.profiler, device time a pass, back to back",
              sum_route=case["route"], events_ms=case["events_ms"])
    out["library_ms"] = case["library_ms"]
    return out


def scan_row(replaces, launches, err, case, name="adc_scan"):
    """A K-A row from a timed :func:`scan_case`: its device time with a
    cold L2, the method, and the warm and host times."""
    return row(name, "cuda", SRC_A, replaces, launches, err, case["ms"],
               case["plain_ms"], *case["bound"], case["by"],
               warm_ms=case["warm_ms"], host_ms=case["host_ms"])


def topk_row(launches, case):
    """The bucketed top-k's row from :func:`time_topk`: phase 9's keys,
    held bit-equal to the stable sort (``max_abs_err`` 0)."""
    out = row("bucketed_topk", "cuda", SRC_T, REPLACES["topk"], launches,
              0.0, case["ms"], case["plain_ms"], *case["bound"], case["by"],
              warm_ms=case["warm_ms"], host_ms=case["host_ms"],
              shape=case["shape"], overhead_bytes=case["overhead_bytes"])
    out["library_ms"] = case["library_ms"]
    return out


def tables_row(launches, cases):
    """The tables kernel's row from :func:`time_tables`: GIST1M's shape,
    Deep10M's under ``deep10m``; ``library_ms`` the plain formula's
    time."""
    gist, deep = cases
    out = row("probed_tables", "cuda", SRC_PT, REPLACES["tables"], launches,
              max(c["err"] for c in cases), gist["ms"], gist["plain_ms"],
              *gist["bound"], gist["by"], warm_ms=gist["warm_ms"],
              host_ms=gist["host_ms"], shape=gist["shape"],
              deep10m={k: deep[k] for k in ("shape", "ms", "warm_ms",
                                            "host_ms", "plain_ms")}
              | {"bound_ms": deep["bound"][0],
                 "bound_by": deep["bound"][1]})
    out["library_ms"] = gist["plain_ms"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:              # one rank of phase 11's world
        mesh_worker(args)
        return

    import torch
    t_all = time.perf_counter()
    setup(torch)

    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(args.seed)
    a_cases = [parity_scan(torch, gen, 12, 256, True),
               parity_scan(torch, gen, 8, 256, True),
               parity_scan(torch, gen, 12, 200, False),
               parity_scan(torch, gen, 256, 256, True, l=1152),
               parity_scan(torch, gen, 64, 1024, False, l=1152),
               parity_scan(torch, gen, GIST_D, C, True)]
    lookup = parity_lookup(torch, gen)
    b_cases = [parity_lloyd(torch, gen, 1, N, P, M),
               parity_lloyd(torch, gen, D, N, C, M // D, ordered=True),
               parity_lloyd(torch, gen, 1, 65_536, 1024, 128),
               parity_lloyd(torch, gen, 1, SIFT_N, SIFT_P, SIFT_M),
               parity_lloyd(torch, gen, D, N, C, M // D, dup=True,
                            time_it=False),
               parity_lloyd(torch, gen, 1, CLI_N, CLI_P, CLI_M,
                            time_it=False),
               parity_lloyd(torch, gen, CLI_D, CLI_N, CLI_C,
                            CLI_M // CLI_D, time_it=False),
               parity_lloyd(torch, gen, 1, SIFT_N, SIFT_P, SIFT_M,
                            skew=True)]
    c_cases = [parity_lloyd(torch, gen, 8, SIFT_N, C, 16, grouped=True,
                            ordered=True),
               parity_lloyd(torch, gen, 60, N, C, 16, grouped=True,
                            time_it=False),
               parity_lloyd(torch, gen, 16, N, C, 8, grouped=True,
                            time_it=False),
               parity_lloyd(torch, gen, 4, N, C, 32, grouped=True,
                            time_it=False),
               parity_lloyd(torch, gen, 8, N, C, 16, dup=True, grouped=True,
                            time_it=False)]
    bf_cases = [parity_lloyd(torch, gen, 1, N, P, M, fast=True),
                parity_lloyd(torch, gen, D, N, C, M // D, fast=True,
                             ordered=True),
                parity_lloyd(torch, gen, 1, 65_536, 1024, 128, fast=True),
                parity_lloyd(torch, gen, 1, SIFT_N, SIFT_P, SIFT_M,
                             fast=True),
                parity_lloyd(torch, gen, D, N, C, M // D, dup=True,
                             time_it=False, fast=True),
                # K-B fast's edges: duplicates across tiles at K=1024,
                # chunked bands (M=256; M=264 past a tile pair, K=257),
                # K=257 resident, one row a batch entry.
                parity_lloyd(torch, gen, 1, 65_536, 1024, 128, dup=True,
                             time_it=False, fast=True),
                parity_lloyd(torch, gen, 2, 20_000, 256, 256,
                             time_it=False, fast=True),
                parity_lloyd(torch, gen, 1, 20_000, 257, 264,
                             time_it=False, fast=True),
                parity_lloyd(torch, gen, 2, 30_000, 257, 128,
                             time_it=False, fast=True),
                parity_lloyd(torch, gen, 3, 1, P, 128, time_it=False,
                             fast=True)]
    cf_cases = [parity_lloyd(torch, gen, 8, SIFT_N, C, 16, grouped=True,
                             fast=True, ordered=True),
                parity_lloyd(torch, gen, 16, N, C, 8, grouped=True,
                             time_it=False, fast=True),
                parity_lloyd(torch, gen, 4, N, C, 32, grouped=True,
                             time_it=False, fast=True),
                parity_lloyd(torch, gen, 2, N, 300, 64, grouped=True,
                             time_it=False, fast=True),
                parity_lloyd(torch, gen, 8, N, C, 16, dup=True, grouped=True,
                             time_it=False, fast=True),
                # Duplicates across centroid tiles: copies of centroid 3
                # at 7, 200 and 1023.
                parity_lloyd(torch, gen, 8, N, 1024, 16, dup=True,
                             grouped=True, time_it=False, fast=True)]
    sort_err = parity_sort_route(torch, gen)
    # The Deep10M path's shapes (phase 9): the capped coarse fit, the PQ
    # fit at m=12 (K-B: 12 does not divide 128), K=4096 with copies of
    # centroid 3 in other tiles; full and fast, the dense route's sums
    # bit-equal to its order model at the first two.
    from flechasdb_tpu_torch.ops import lloyd
    for shape in ((1, DEEP_COARSE_N, DEEP_P, DEEP_M),
                  (DEEP_D, DEEP_PQ_N, C, DEEP_M // DEEP_D),
                  (1, 65_536, DEEP_P, DEEP_M), (1, DEEP_N, DEEP_P, DEEP_M)):
        log(f"Deep10M shape B={shape[0]} N={shape[1]} K={shape[2]} "
            f"M={shape[3]}: {lloyd.sum_tiling(*shape, 1)}; "
            f"{lloyd.fast_tiling(*shape)}")
    deep_cases = [parity_lloyd(torch, gen, 1, DEEP_COARSE_N, DEEP_P, DEEP_M,
                               fast=fast, ordered=True)
                  for fast in (False, True)]
    deep_cases += [parity_lloyd(torch, gen, DEEP_D, DEEP_PQ_N, C,
                                DEEP_M // DEEP_D, fast=fast, ordered=True)
                   for fast in (False, True)]
    deep_cases += [parity_lloyd(torch, gen, 1, 65_536, DEEP_P, DEEP_M,
                                dup=True, time_it=False, fast=fast)
                   for fast in (False, True)]
    b_cases += deep_cases[0::2]
    bf_cases += deep_cases[1::2]
    # The GIST path's shapes (phase 13): K-B and K-B fast at the coarse
    # fit (B=1, N=1M, K=1024, M=960), K-C and K-C fast at the PQ fit (B=60,
    # N=1M, K=256, m=16: the last of 8 groups holds 4 pad divisions), the
    # pass bit-equal to its order model at each.
    gist_pq = (GIST_D, GIST_N, C, GIST_M // GIST_D)
    log(f"GIST shape B=1 N={GIST_N} K={GIST_P} M={GIST_M}: "
        f"{lloyd.sum_tiling(1, GIST_N, GIST_P, GIST_M, 1)}; "
        f"{lloyd.fast_tiling(1, GIST_N, GIST_P, GIST_M)}")
    log(f"GIST shape B={GIST_D} N={GIST_N} K={C} M={GIST_M // GIST_D}: "
        f"{lloyd.sum_tiling(*gist_pq, lloyd.GROUP_WIDTH // gist_pq[3])}; "
        f"{lloyd.grouped_fast_tiling(*gist_pq)}")
    gist_cases = [parity_lloyd(torch, gen, 1, GIST_N, GIST_P, GIST_M,
                               fast=fast, ordered=True)
                  for fast in (False, True)]
    gist_cases += [parity_lloyd(torch, gen, *gist_pq, grouped=True,
                                fast=fast, ordered=True)
                   for fast in (False, True)]
    for cases, case in zip((b_cases, bf_cases, c_cases, cf_cases),
                           gist_cases):
        cases.append(case)
    t_cases = [parity_tables(torch, gen, "GIST1M", GIST_NQ, GIST_NPROBE,
                             GIST_D, GIST_M // GIST_D, GIST_P),
               parity_tables(torch, gen, "Deep10M", DEEP_NQ, DEEP_NPROBE,
                             DEEP_D, DEEP_M // DEEP_D, DEEP_P)]
    log(f"phase 1 (kernel parity): {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    slice_launches, a_main, head = slice_run(torch, args.seed)
    log(f"phase 2 (100k x 1536 slice): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sift_launches, a_sift, sift = sift_run(torch, args.seed)
    log(f"phase 3 (SIFT path): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    upd_launches, a_upd = updates_run(torch, args.seed, head, sift)
    log(f"phase 4 (filters, range search, updates): "
        f"{time.perf_counter() - t0:.3f} s")
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        stored_launches, a_stored = stored_run(torch, head, sift, work)
        log(f"phase 5 (the stored tier): {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        fo_launches, a_opq = fast_opq_run(torch, args.seed, head, sift, work)
        log(f"phase 6 (fast-math training and OPQ): "
            f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        cli_launches, a_cli = tiers_run(torch, args.seed, head, sift,
                                        work)
        log(f"phase 7 (the async tier, the flat tier, the CLI): "
            f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        f64_launches, a_f64 = f64_run(torch, sift, args.seed)
        log(f"phase 8 (the f64 build): {time.perf_counter() - t0:.3f} s")
        # Phase 11 runs here, while phases 3, 5 and 7 hold their state.
        t0 = time.perf_counter()
        mesh_launches = sharded_run(torch, args.seed, head, sift, work)
        log(f"phase 11 (the sharded paths): "
            f"{time.perf_counter() - t0:.3f} s")
        # Phase 12 runs here too, on phase 3's data and state.
        t0 = time.perf_counter()
        metric_launches, a_mips = metrics_run(torch, args.seed, sift, work)
        log(f"phase 12 (the dot and cosine metrics): "
            f"{time.perf_counter() - t0:.3f} s")
    del head, sift
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    deep_launches, a_deep, deep_final, topk_case = deep_run(torch,
                                                            args.seed)
    log(f"phase 9 (the Deep10M shape): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    gist_launches_, a_gist = gist_run(torch, args.seed)
    log(f"phase 13 (the GIST1M shape): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    a_cases += [a_main, a_sift, a_upd, a_stored, a_opq, a_cli, a_f64, a_deep,
                a_mips, a_gist]
    for case in a_cases + [lookup]:
        time_scan(torch, case)
    time_topk(torch, topk_case)
    for case in t_cases:
        time_tables(torch, case)
    lloyd_cases = b_cases + c_cases + bf_cases + cf_cases
    for case in (e[5] for e in lloyd_cases if e[5]):
        case.update(pass_device_ms(torch, case.pop("launch")))
        log(f"cluster-sum pass, {case['name']} ({case['route']} route): "
            f"{case['ms']:.4f} ms device a pass ({case['calls']} profiled; "
            + ", ".join(f"{k} {v:.4f}" for k, v in case["by_kernel"].items())
            + f"), CUDA events {case['events_ms']:.4f} ms, bound "
            f"{case['bound'][0]:.4f} ms, index_add_ "
            f"{case['library_ms']:.4f} ms")
    for case in (e[6] for e in lloyd_cases if e[6]):
        case.update(kernel_device_ms(torch, case.pop("launch"),
                                     case["key"]))
        log(f"assignment alone ({case['key']}), {case['name']}: "
            f"{case['ms']:.4f} ms device a launch ({case['calls']} "
            f"profiled), bound {case['bound'][0]:.4f} ms "
            f"({case['bound'][1]})")
    log(f"phase 10 (K-A, the top-k, the tables, cluster-sum pass and "
        f"assignment times): "
        f"{time.perf_counter() - t0:.3f} s")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    launches = {k: slice_launches[k] + sift_launches[k] + upd_launches[k]
                + stored_launches[k] + fo_launches[k] + cli_launches[k]
                + f64_launches[k] + deep_launches[k] + mesh_launches[k]
                + metric_launches.get(k, 0) + gist_launches_.get(k, 0)
                for k in slice_launches}
    a_err = max(case["err"] for case in a_cases)
    kernels = [
        scan_row(REPLACES["indexed"], launches["adc_scan"], a_err, a_main),
        scan_row(REPLACES["pipe"], launches["adc_scan"], a_err, a_sift),
        scan_row(REPLACES["lookup"], launches["adc_lookup"], lookup["err"],
                 lookup, "adc_lookup"),
        row("lloyd_round", "cuda", SRC_B, REPLACES["round"],
            launches["lloyd_round"], max(e[0] for e in b_cases),
            *b_cases[1][1:5], deep10m=[deep_shape(e) for e in
                                       deep_cases[0:4:2]] + [deep_final],
            gist=gist_shape(gist_cases[0])),
        row("lloyd_grouped", "cuda", SRC_C, REPLACES["grouped"],
            launches["lloyd_grouped"], max(e[0] for e in c_cases),
            *c_cases[0][1:5], **assign_fields(c_cases[0][6]),
            gist=gist_shape(gist_cases[2])),
        row("lloyd_round_fast", "cuda", SRC_BF, REPLACES["round_fast"],
            launches["lloyd_round_fast"], max(e[0] for e in bf_cases),
            *bf_cases[1][1:5], **assign_fields(bf_cases[1][6]),
            deep10m=[deep_shape(e) for e in deep_cases[1:4:2]],
            gist=gist_shape(gist_cases[1])),
        row("lloyd_grouped_fast", "cuda", SRC_CF, REPLACES["grouped_fast"],
            launches["lloyd_grouped_fast"], max(e[0] for e in cf_cases),
            *cf_cases[0][1:5], **assign_fields(cf_cases[0][6]),
            gist=gist_shape(gist_cases[3])),
        sums_row(launches["cluster_sums"],
                 max([e[0] for e in lloyd_cases] + [sort_err]),
                 b_cases[1][5]),
        topk_row(launches["bucketed_topk"], topk_case),
        tables_row(launches["probed_tables"], t_cases),
    ]
    log(f"total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
