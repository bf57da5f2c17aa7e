#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --pair-parent DIR   # K1-K9 against the tree in DIR, then stop
    python3 chip_smoke.py --ablate [DIR]      # kernels with parts cut out (K2, K8, K3, K5 also DIR's)
    python3 chip_smoke.py --capture-modes     # a capture while another thread copies to the card

1. Builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with nvcc
   (sm_90a) and prints the build time and the compiler's register report,
   and the count of tensor-core instructions in each instance of the
   tensor-core pass 1 (``csrc/mma_topk.cuh``; ``cuobjdump -sass``): HMMA in
   K1 classic's and K4's with a bf16 query, IMMA in K1 dot's (int8), TF32
   HMMA in K1 f32's (split TF32 over f32 rows) and in K4's with an f32 query
   over int8 and over int4 rows, HMMA in K7's classic score matrix
   (``score_matmul_bf16``) and IMMA in its dot one (``score_matmul_int8``),
   TF32 HMMA in K6's (``cosine_scores_tf32``, split TF32 on the same body,
   ``kernels/csrc/score_matmul.cuh``), HMMA in K9's bf16 attention
   (``flash_attention_bf16``) and TF32 HMMA in its f32 one
   (``flash_attention_tf32``, split TF32), HGMMA (wgmma) in its bf16
   backward's dK / dV and dQ kernels; an instance without them fails
   the run; the SASS instructions a column in K5's inner loop
   (``k5_columns``) and a compare in K2's and K8's (``lsh_compare_ops``).
2. Holds the fused top-k kernel (K1/K2) against its plain PyTorch version on
   the card in all four score modes (bf16, f32, int8, lsh), with unaligned
   shapes, ragged ``n_docs``, depth = N under massive ties, and ``filt``;
   for bf16 and int8 also 0/1 operands, scores that rise or fall with the
   doc id (every tile, or only the first, feeds the running lists; ids must
   be bit-equal), depth 3,072 at B = 1 and B = 65; for int8 also the full
   range, -128 / 127 only, and a ``[u; -u]`` dot query, at T = 600 (8-byte
   rows), 256 (16-byte rows) and 37; for f32 (split TF32 on tensor cores)
   also integer-valued 0/1 operands and rising / falling scores, bit for
   bit, depth = N and 3,072, and unit vectors at the cosine's T = 300, depth
   10, B = 256, 8 and 1, which a copy of the kernel without the doc's low
   tf32 part (K1_DOC_HI_ONLY) must fail; for lsh (K2) also copies of 4 doc
   rows whose depth-th count every split holds ("lsh-ties"), which a copy
   whose pass 2 cuts at that count without its id (K2_STRICT) must fail,
   all-sentinel queries, S = 1,500 and 37, depth 3,072 at B = 1, B = 2, 5
   and 8, and filt and n_docs at B = 1 and 40.
3. Holds the gathered fused top-k kernel (K3) against its plain version the
   same way, with row ids in random order, in 256-row blocks and in bound
   order (best block first), padding ids and whole 256-row splits of them,
   ``filt``, B = 1 over ~300k rows (bf16, and 0/1 operands whose every rank
   ties), and depth 3,000; at the graph traversal's shapes (f32, T = 300,
   depth = R = 4, 128 and 512, B = 1, 8 and 256, distinct scattered ids
   with padding ids; 0/1 rows bit for bit); and a copy of K3 with a strict
   threshold test (K3_STRICT), which must fail the cases whose top score
   fills every split's list ("ties-top", and in f32 at T = 300, R = 1,024,
   "ties-half-f32").
4. Holds the quantized kernels (K4 ``fused_topk_quantized``, K5
   ``fused_topk_gathered_quantized``) against their plain versions: int8
   and int4 (groups 32 and 64), bf16 and f32 queries, T = 600, 100 and 37,
   ragged ``n_docs``, ``filt``, 0/1 ties, ids in any order and >= n_docs,
   depth up to the plan's limit, B = 1 over ~300k kept rows; for K4 with a
   bf16 query also integer scores that rise or fall with the doc id (ids
   bit-equal), int4 at T = 600 whose last chunk reaches past the last
   group, depth 3,072 at B = 1 and 65, and a dot query; for K4 with an f32
   query (split TF32) over int8 rows and over int4 rows (groups 32 and 64)
   the same at T = 300, 37 and 600, depth = N, 2,200 and 3,072, a query of
   wide dynamic range that a copy of the kernel with only the query's high
   tf32 part must fail, and for int4 integer scores over distinct
   power-of-two group scales, bit-exact, that a copy folding every chunk
   with its row's first group scale must fail (the copies are built beside
   the others: PLANTED); for K5 also rows in bound order, whole splits of
   padding at depth 100 and 3,000, depth 4,096, int8 rows aligned to 4 and
   to 1, and "ties-top" cases at R = 299,776 that a copy with a strict
   threshold test (K5_STRICT) must fail.
5. Runs the ann-word2vec deployment (2,999,808 x 300, classic fake words,
   B = 256, depth 100, k 10) end to end through ``AnnIndex.build`` /
   ``search`` on the card, with the exact-cosine ground truth, and checks
   recall, the rerank identity and that the kernel carried the path; then
   dot scoring over the same index (K1 int8, on int8 tensor cores), and
   brute force over fp32 postings (``BruteForceConfig``, K1 f32) at B = 256,
   8 and 1, whose ids must equal the ground truth's.
6. Runs blockmax pruning on that index (10% and 25% of the 256-row blocks
   kept) through the facade, with recalls, and at every block kept holds
   classic, dot and lsh blockmax against the dense searches.
7. Builds the lexical-LSH index (b = 300, h = 1) of the same corpus and
   searches it at B = 256 on K1's lsh mode (K2), with recall.
8. Times build, searches (classic and dot at B = 256 and 1; blockmax at 8
   and 1), and each kernel beside its bound, its plain version and a
   library yardstick (K1 classic, f32 and dot at B = 256, 8 and 1; K3
   classic at B = 1, 8 and 256 and dot at B = 1 and 8, each with pass 1 and
   pass 2 apart), with
   CUDA events (median of 10 runs after a warm-up); traces five classic
   searches at B = 256, and five blockmax searches at B = 1, 8 and 256, with
   torch.profiler (device time per CUDA kernel, idle share).
9. Holds the dense score kernels (K6 ``cosine_scores``, K7 ``score_matmul``,
   K8 ``lsh_match_scores``) and the flash attention kernel (K9) against
   their plain versions: unaligned B / N / T, B = 1 and N = 1, int8 over its
   whole range and at -128 / 127, sentinels on both sides of K8 and a copy
   of K8 without its sentinel test (K8_NO_SENTINEL), which that case must
   fail; K8 at the edges of its plan (B = 1, 2, 5, 8, 9, 64, 65, 256; its
   doc tiles and splits; N = 1), S = 1, 3, 4, 37 and 1,500, rows 4 bytes
   off 16, queries equal to doc rows (counts up to S), all-sentinel
   queries, and 0xFFFFFFFE on both sides (it counts); K7 at the
   edges of its 128 x 256 tile and of its 32-column bf16 / 64-column int8
   chunks (B = 127..129 and 256, N = 127..129 and 255..257, T = 63..129
   and 600), int8
   rows of 600 bytes (its ring of 8-byte copies) and rows 1 byte off 16 (its
   register loader), classic held to the 1e-5 row rule and dot, f32 or int32
   out, bit for bit; and a copy of K7 whose ring skips the copies past T
   instead of zero-filling them (K7_RING_SKIPS_PAST_T), which every ring case
   whose last chunk ends inside the chunk, after more chunks than the ring
   has stages, must fail; K6 (split TF32 on K7's body) at the edges of its
   128 x 128 tile (B, N = 127..129, 255..257), of its 8-column k-steps and
   16-column chunks (T = 15..17, 31..33), of its loaders (rows 4-, 8- and
   16-byte aligned, and 4 bytes off 16) and of its resident queries (T =
   320, 321, 384, 385, 600), and a copy of K6 without the doc's low tf32
   part (K6_DOC_HI_ONLY), which its "unit-f32" cases (unit rows at T = 300,
   B = 129 and 256) must fail; K9 at every
   head width (32, 64, 96, 128), S = 1, 130 and 4096, f32 and bf16, MHA /
   GQA / MQA, the kernels' 64-key and 128-row tile edges (S = 63, 64, 65,
   127, 128, 129), GQA group 7 at S = 4096, and deepseek-coder-33b's 56 / 8
   heads at S = 4096; and two copies of the f32 kernel, one without q hi x
   k lo (K cut to tf32) and one without p lo x v hi (P cut to tf32)
   (K9_F32_K_HI_ONLY, K9_F32_P_HI_ONLY), each of which must fail at least
   one f32 case.
10. With the corpus and its fp32 and LSH indexes still on the card, drives
   the dense-score and attention entry points at full width: ``classic_scores`` and
   ``dot_scores`` at B = 256 (K7, on tensor cores), ``cosine_topk`` over the raw corpus (K6),
   ``lsh_topk`` over the (b = 300, h = 1) signatures (K8), and
   ``causal_attention`` for one attention layer of deepseek-coder-33b
   (56 / 8 heads, D 128, bf16) at S = 32,768 and of phi3-mini (32 / 32, D
   96) at S = 4,096, batch 1, in bf16 and in f32 (K9); holds their top-k
   against K1 / K2 and the plain versions, and times each kernel beside its
   bound, its plain version and its library yardstick (K9 f32, split TF32:
   the memory-efficient SDPA backend alone; K8 at B = 256, 8 and 1 with its
   plan), and ``cosine_topk`` and ``lsh_topk`` whole beside their
   ``common.stable_topk`` sort alone.
11. Frees those indexes and runs the quantized read path on the same corpus:
   classic with int8 and with int4 (group 32) postings and the int8 rerank
   store (K4), held to the reference's recall property (reranked R@10
   within 0.02 of fp32 postings reranked from the same int8 store);
   blockmax on the int4 index (K5) at 10% of the blocks, and at every block
   kept, classic and dot x int8 and int4, against the dense quantized
   search; brute force with int8 postings and with int4 postings (group
   32), both K4 with an f32 query, split TF32 on tensor cores; torch.profiler
   traces of the int8 classic search and of the int4 brute-force search at
   B = 256; and the times of all of these (K4 at B = 256, 8 and 1).
12. Filtered search on the same corpus, over the indexes the phases above
   build (none is built again): ``DocMetadata`` on the card (``cat`` on
   [0, 100), ``year`` on [2000, 2020), seeded) and its masks at ~1%
   (cat = 7), ~10% and ~50% (year ranges), and one of exactly 50 docs;
   ``AnnIndex.search(filt=)`` of fake words classic (K1 bf16), dot (K1
   int8), lexical LSH (K2), brute force over fp32 (K1 f32), the k-d tree's
   "pca" scan (K1 f32 at T = 9), classic over int8 and int4 postings and
   brute force over int8 (K4) held to each plain version with the same mask
   at B = 8 (every mask) and B = 256 (10%; not LSH), integer modes bit for
   bit, every id kept, an all-ones mask equal to the unfiltered search bit
   for bit; an all-zeros mask with and without rerank; filtered brute force
   equal to an exact f32 top-k over the kept rows; (B, N) masks row by row
   against (N,) ones (classic, dot, LSH); blockmax at every block (K3, and
   K5 on the int4 index) against the dense filtered search, and at n_keep
   1,171 with the 10% mask against the plain versions with ``gather_filt``'s
   mask; ``FilterMask`` native against depth inflation (extra 1,024); the
   tree backend's post-filter against ``mask_and_topk`` of its unfiltered
   result; a metadata index (100,000 rows, int8 postings) through save /
   load with bit-equal filtered searches; the times of the filtered classic
   search (B = 256, 8, 1 per selectivity; a per-query (B, N) mask at B =
   256), filtered blockmax and K5 with and without the mask, the mask
   builds, filtered recall through ``eval.recall_at(filter_mask=)``, and one
   RRF ``FusionStage`` of classic and LSH at B = 256 with its R@10.

13. The segmented mutable index and the packed single launch
   (``core/segments.py``, ``core/packed.py``) on the same corpus, after the
   phases above have freed their indexes (``drive_segments``): classic fp32
   in 16 flushed adds of 187,488 rows with the metadata's rows, 1% of the ids
   deleted (a seeded generator), the packed search (one CUDA graph replay of
   K1 over the 3,145,728-row superbuffer with the live mask), the
   per-segment loop and ``AnnIndex.build`` of the live rows bit-equal at B =
   256, 8 and 1 with and without rerank, and with the ~10% year predicate
   from ``global_metadata()`` at B = 8; ``force_merge(1)`` and the default
   ``TieredMergePolicy`` (16 adds settle at 2 segments) equal to the
   monolithic build; dot (int8 postings + int8 rerank, K1 int8), classic
   int4 (K4), LSH (K2), the kd scan (K1 f32 at T = 9) and brute force (K1
   f32) in 4 segments each, packed == loop bit for bit, against the
   monolithic build bit for bit (integer modes, classic) or by the near-tie
   rule (f32); packed blockmax at every block (K3 over the fp32 pack, K5
   over the int4 one) equal to the packed dense search; 10 NRT cycles of
   1,024 LSH rows written into the pack in place, replaying one graph (no
   new capture after the first), and 6 classic ones that repack and capture
   anew, each equal to the loop; two commit generations of a 100,000-row
   int8 index loaded on the card bit-equal to the writer's snapshots; the
   loop's, the packed path's and the monolithic search's times at 1, 4 and
   16 segments, launches and replays a search, the capture's time, the
   stat-view, pack, append, refresh, delete, merge, commit and load times,
   and the phase's peak device memory.  The packed search is also timed
   eagerly (the executable cache's entries the plain callables, no CUDA
   graph) beside its graph at 16 segments of full N and at 4 segments of
   100,000 rows; the classic NRT cycles print the cache's entries and the
   device memory allocated after each, which a dead pack's graphs must not
   grow.
14. The proximity graph ("hnsw", ``core/graph.py``; ``drive_graph``, after
   the k-d tree and persistence phases, before the quantized one): the
   Vamana-style build of the whole corpus through ``AnnIndex.build(x,
   GraphConfig())`` (its pools on K1 f32, 367 launches of 8,192 rows at
   depth 65), each stage timed; searches at B = 256, 8 and 1, depth 100 and
   10, with and without rerank (K3 f32, 33 launches a search, the traversal
   one CUDA graph), R@10 and R@(10,100) against the ground truth, the
   scored rows, the captured traversal against the eager one in turns, and
   the same traversal with K3's plain version on the card (queries whose
   ids differ counted); what R@10 is made of (the queries that reach their
   own row, and the share of a row's exact neighbours in its adjacency);
   each cached traversal's device memory; filtered search at ``GraphConfig(ef=320, beam=16)``
   with the ~10% and ~1% masks (no masked id; recall against the filtered
   exact top-k); K3 f32 at a traversal block and K1 f32 at a pools launch
   (its first 256 rows held to the plain version) beside bound, plain and
   library; the build and search of 100,000
   integer-valued rows bit for bit against the plain versions on the card;
   ``IndexWriter(GraphConfig(ef=192, beam=8))`` over 400,000 rows in 4
   adds with 1% deleted (the loop at most 0.01 below the monolithic R@10,
   both sides' scored rows printed; ``force_merge(1)`` equal to the
   monolithic build bit for bit); and save / load of a 100,000-row graph
   index, with its R@10.
15. Serving (``serve/ann_service.py``, ``launch/serve.py``; ``drive_serve``,
   after the filtered phase, on its classic fp32 index): 2,048 queries drawn
   as the launcher draws them through ``AnnService`` at max_batch 1, 8, 64
   and 256, match only bit-equal to ``AnnIndex.search`` on the same rows in
   one batch, reranked under the near-tie rule, each batch size's p50 / p99
   beside the facade's; the cache-hit time; the async micro-batcher in the
   launcher's open loop (Zipf s = 1.1 over 256 queries, max_wait_s 2 ms,
   queue_depth 256) at 1,000 QPS and near the rate the batch of 64
   implies, search only, every result held to the sync service's; NRT
   serving over full-N writers (LSH, classic: 90% of the rows first, then
   32 rows, 4 deletes and a refresh every 200 requests), each starting with
   a CUDA-graph capture forced to stand while another thread adds and
   deletes, with zero stale cache hits, the refresh times and the captures
   against replays; and the kd scan ("pca", in ``drive_kdtree``) and the
   graph (in ``drive_graph``) through the sync and async service.
16. The LM (``drive_lm``, the last phase): phi3-mini-3.8b at its full width
   and depth (32 layers, 3,821,079,552 parameters drawn by ``init_params``
   on the card from a seed) served through ``DecodeEngine``: 16 prompts
   from ``data/lm.py`` of 512 to 3,072 tokens through 8 slots of 4,096
   positions, 32 new tokens each.  It holds (a) K9 on layer 0's own q, k, v
   against its plain version (1e-2 row rule), (b) a two-layer cut of the
   model at S = 256 on the card against the CPU route (logits within 2e-2
   of their scale), (c) every generated token against a greedy recompute
   by ``prefill`` on the card, on the engine's own prefix (a parting only
   at a near-tie within (b)'s tolerance), (d) 32 K9 launches a prefill and
   no other kernel on the engine's run, (e) every request retired and
   every slot reused; and prints the parameter, cache and peak memory, the
   prefill time at each prompt length, the decode time a step at 8 active
   slots, tokens a second, and K9 at the longest prefill beside
   ``scaled_dot_product_attention(is_causal=True)``.
16a. Sharded training (``drive_sharded_train``, after the LM's training
   phase, ``drive_train``, whose crash-and-resume run takes 12 steps):
   phi3-mini-3.8b at full width on the port's one-process mesh.  (a) Data
   parallel over ``make_mesh((4,), ("data",))`` (4 x cuda:0): 4 layers,
   8 x 1,024 tokens split by ``shard_rows``, each shard's loss and
   gradients from ``loss_fn``; the mean loss within 2e-4 of the whole
   batch's, ``psum`` / 4 of the gradients within LM_GRAD_TOL of the whole
   batch's, and ``compressed_psum`` twice (the mean within half a grid
   step, the residual g32 - q scale bit for bit, the error-feedback
   identity); host times and ``wire_bytes``.  (b) GPipe over
   ``make_mesh((4,), ("pipe",))``: 8 layers, 4 microbatches of 1 x 1,024
   embedded tokens, the output bit-equal to the layers run one microbatch
   at a time, the gradients of the layers and the input within
   LM_GRAD_TOL, K9's launches 2 x 8 x 4 forward with lse and 8 x 4
   backward.  K9 at each path's shapes is held and timed (kernels-line
   rows ``flash_attention_{fwd,bwd}/phi3-mini-{data-parallel,gpipe}``).
   ``check_f32_matmul`` (after ``check_attention_bwd``) holds
   ``f32_matmul`` to f32's rule under ``fp32_precision = "tf32"`` and under
   ``allow_tf32`` in two threads.
16b. The kNN-LM example (``drive_knn_lm``): ``examples/knn_lm_torch.py``'s
   ``main`` at the reference's 200 steps on the card, every NLL finite and
   lambda 0 the LM's own, K9 and K1 launched; K1 classic at its datastore
   (B 512, N 8,192, T 256, depth 64) and K9 at the micro LM's training
   shape held and timed (rows ``fused_topk/knn-lm``,
   ``flash_attention_{fwd,bwd}/knn-lm-micro-train``).
17. GraphSAGE (``drive_gnn``, after the LM's training phase and after the
   ANN corpus is freed): 2 x 128 mean-SAGE at each cell's published graph,
   built by ``make_graph`` on the host (Cora's 2,708 / 10,556 at d 1,433;
   Reddit's 232,965 / 114,615,892 at d 602; ogbn-products' 2,449,029 /
   61,859,140 at d 100) and 128 molecules of 30 nodes: forwards and AdamW
   steps (Reddit's of the card's sampler, B 1,024, fanouts 15-10; ogbn-
   products' full-graph, its gather-scatter over edge slices), each held to
   the CPU route (Reddit's on 128 seeds of the card's batch; Cora's also
   with the card's gather-scatter over 11 edge slices, forward and backward;
   ogbn-products' too large for it), the sampler's invariants, the peak
   memory, a traced ``embeddings_full``.
18. The recsys towers (``drive_recsys``): FM, DeepFM, xDeepFM (33,554,432
   x 10) and DLRM (53,687,296 x 64, 13.75 GB) at their full tables:
   ``forward`` at serve_p99 (B 512) and serve_bulk (B 262,144; xDeepFM's CIN in
   row slices inside ``forward``), the serve_p99 batch's logits, loss and gradients held to
   the CPU route on the rows it reads, train_batch AdamW steps (B 65,536;
   xDeepFM in 8 microbatches; DLRM with a dense 13.75 GB table gradient, a
   traced step), each tower's peak; then retrieval_cand on DLRM: 64 user
   vectors, ``retrieval_topk`` over field 0's first 10^6 rows, those rows
   indexed by fake words (Q = 50) and searched at depth 100 with rerank (K1
   classic), the ground truth by ``exact_topk`` (K1 f32), each held to its
   plain version and to the CPU route on the same index, R@(10,100), and
   both K1 calls timed beside bound, plain and library (kernels-line rows
   ``fused_topk/retrieval_cand`` and ``fused_topk/f32-retrieval_cand``).

Exits non-zero on any failure, or when no CUDA device is available.  The
last two lines are a JSON object of per-kernel numbers and the JSON status
line ``{"ok": true, "device": {...}}``.

With ``--pair-parent DIR`` (DIR an earlier commit of this repository,
unpacked, e.g. by ``git archive``), it builds that tree's ``fused_topk.cu``
and ``fused_topk_quantized.cu`` beside this one's, calls them through the C
signatures of that tree's own sources, and times both on the ann-word2vec
inputs in turns (parent, this, this, parent), their results held to each
other: K1 classic at B = 256 and B = 1, K1 f32 at B = 256, 8 and 1, K1 dot
at B = 256, 8 and 1 (bit for bit), K4 with a bf16 query over int8 and int4
postings at B = 256, 8 and 1, and K4 with an f32 query over int8 and over
int4 postings at B = 256, 8 and 1 (and an integer case of each bit for
bit), K3 (blockmax stage 2, classic and dot; each tree's pass 1 and pass
2 apart), K1 lsh and K5, K7 (that tree's ``fakewords_score.cu``, built
against its own shared headers) in both modes at B = 256 on the index's
``scored`` and ``tf`` (dot bit for bit, classic under the row rule), K6
(that tree's ``cosine_score.cu``) at B = 256 over the raw corpus, and K8
(its ``lsh_match.cu``) at B = 256, 8 and 1 over the LSH signatures (bit for
bit); it
prints whether the SASS of every kernel instance that both trees build is
identical, for K1-K5, K6 and K8 (``cosine_score.cu``, ``lsh_match.cu``) and
K9; first, K9 of both trees (their ``flash_attention.cu``) at both bf16
attention layers and at phi3-mini's in f32, outputs held to each other,
then K9's backward of both trees (their ``flash_attention_bwd.cu``, each
through its own C signature from the same Python caller) at the eight
ATTN_BWD_CASES (bf16 and f32), dq, dk and dv held to each other, beside the bound, this
tree's wrapper and SDPA's backward (``pair_k9_bwd``; alone: ``c.pair_k9_bwd(d,
card, DIR)``).
K5 is paired over the int4 index at B = 256, 8 and 1 and over the int8
one at B = 8.  With ``--ablate [DIR]`` it
first times K7 at the cell's shapes (B = 256, N = 2,999,808, T = 600, both
modes) against copies with no stores (sums kept live), loads only (no
``mma``, no stores), stores only and products only (K7_ABLATIONS), and
with write-back stores, the queries streamed in place of resident, rings
of other depths and 16 warps (K7_VARIANTS, held to the kernel's output;
alone: ``python3 -c "import sys, torch; sys.path.insert(0, '.'); import
chip_smoke as c; c.ablate_k7(torch.device('cuda', 0), c.gpu_line())"``),
then K6 the same way at its cell (B = 256, N = 2,999,808, T = 300) against
K7's cuts, no fold and unmasked low parts (K6_ABLATIONS) and rings of 3 and
8 stages and streamed queries (K6_VARIANTS; alone: ``c.ablate_k6``), then
K9's bf16 kernel at both
attention layers against copies without the softmax, loads only, with 4
warps and with three stages (K9_ABLATIONS, K9_VARIANTS), and its f32 kernel
at phi3-mini's layer against the same cuts and variants and without the
fold and with Q split once into registers (K9_F32_ABLATIONS,
K9_F32_VARIANTS), each beside the SM clock and power draw, then K9's
backward at every ATTN_BWD_CASES case (one call, ten back to back, the
host's time to enqueue, each CUDA kernel's device time), and at phi3-mini's
training layer and deepseek-coder-33b's in bf16 and phi3-mini's layer and
GQA 7 in f32 against a loads-only and a products-only copy
(K9_BWD_ABLATIONS, ``ablate_k9_bwd``), each beside the SM clock and power
draw, then K2 at the
lexical-LSH path's shape (the (b = 300, h = 1) signatures, B = 256, 8 and 1)
with its top-k, its sentinel test and its compares cut out (K2_ABLATIONS;
also DIR's), its candidates a (query, split), registers, spills and SASS
instructions a compare, and variants held bit-equal to it (K2_VARIANTS;
alone: ``c.ablate_k2``), then K8 at the same signatures (B = 256, 8 and 1)
with its stores, its sentinel test and its compares cut out (K8_ABLATIONS;
also DIR's, and both in turns), its registers, spills and SASS
instructions a compare, and variants held bit-equal to it (K8_VARIANTS:
the other count of blocks a SM, other unrolls; alone: ``c.ablate_k8(d,
card, trees=(("this tree", "."), ("parent", "build/parent")))``), then K3 at the
blockmax path's shape with its inserts and its products cut out
(K3_ABLATIONS; also the K3 of the tree in DIR, e.g. the parent), each
kernel's pass 1 and pass 2 apart, K5 at the quantized blockmax path's
shape (int4 g32) with its top-k, its dequant and its products cut out
(K5_ABLATIONS; also DIR's), its SASS instructions a column and each
kernel's pass 1 and pass 2 apart in random and bound order (alone:
``c.ablate_k5``), K1 f32 at the ground truth's shape with
its running top-k and its products cut out (K1F32_ABLATIONS; also DIR's),
and the tensor-core pass 1 (K1 classic, K1
dot, K4 int8 and int4 with a bf16 query, K4 int8 and int4 with an f32 one)
against copies of it with the running top-k, the widening and the
products cut out (ABLATIONS; for the f32 query also the fold, the query's
split and its low tf32 part cut out, each also held to the plain version on
a case with small scores in the list: TF32_ABLATIONS), and K4 against its
loaders (LOADERS), on random operands at the cell's shapes.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call
# is the larger of bytes / memory rate and operations / peak rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "bf16": 989e12, "f32": 67e12, "int8": 1979e12, "tf32": 495e12,
    # INT32 (the lsh compare): 64 INT32 lanes per SM (Hopper architecture
    # white paper) x 132 SMs x 1.98 GHz boost clock.
    "int32": 16.7e12,
}
TOL = 1e-5  # rtol = atol for float scores
RUNS = 10
BLOCK = 256  # blockmax block size
KEEP_FRACTIONS = (0.10, 0.25)  # of the blocks: 1171 and 2929 of 11,718 at full size
RECALL_SLACK = 0.02  # quantized vs fp32 postings, same int8 rerank store (memory_budget.py)
GROUP = 32  # the int4 scale group of the quantized main path


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = RUNS, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``runs`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: float, ops: float, kind: str):
    """(least time in ms, "bytes" | "operations"): the larger of bytes over
    the memory rate and operations over the peak rate of ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(q, docs, n_docs: int, depth: int, kind: str, passes: int = 1):
    """Bound of one fused top-k call: each input read once, each output
    written once; ``passes`` x 2*B*N*T operations at the peak of ``kind``
    (B*N*S compares in lsh mode; "tf32" with 3 passes for K1 f32's
    split-TF32 product, three tf32 products per f32 one)."""
    b, t = q.shape
    nbytes = (q.numel() * q.element_size() + n_docs * t * docs.element_size()
              + b * depth * 8)
    ops = passes * (1.0 if kind == "int32" else 2.0) * b * n_docs * t
    return _bound(nbytes, ops, kind)


def gathered_bound_ms(q, store, row_ids, n_docs: int, depth: int, kind: str):
    """Bound of one gathered fused top-k call on this run's data: the query,
    the row ids, and each distinct in-range row read once (a row that
    several queries keep is needed once; padding rows are never read); the
    output written once; 2*T operations for each (query, in-range row)
    pair.  Returns (ms, bound_by, distinct rows)."""
    b, t = q.shape
    valid = (row_ids >= 0) & (row_ids < n_docs)
    pairs = int(valid.sum())
    distinct = int(torch.unique(row_ids[valid]).numel())
    nbytes = (q.numel() * q.element_size() + row_ids.numel() * 4
              + distinct * t * store.element_size() + b * depth * 8)
    return (*_bound(nbytes, 2.0 * pairs * t, kind), distinct)


def _packed_row_bytes(docs, scale) -> int:
    """Bytes one packed row and its scales take."""
    return docs.shape[1] * docs.element_size() + scale.shape[1] * 4


def quantized_bound_ms(q, docs, scale, n_docs: int, depth: int, kind: str, passes: int = 1):
    """Bound of one K4 call: the query, each of the n_docs packed rows and
    its scales read once, the output written once; ``passes`` x 2*B*N*T
    operations at the peak of ``kind`` (the query dtype's: the dequantized
    operand is in that dtype; "tf32" with 2 passes for the split-TF32
    product of an f32 query, which takes two tf32 products per element)."""
    b, t = q.shape
    nbytes = q.numel() * q.element_size() + n_docs * _packed_row_bytes(docs, scale) + b * depth * 8
    return _bound(nbytes, passes * 2.0 * b * n_docs * t, kind)


def gathered_quantized_bound_ms(q, docs, scale, row_ids, n_docs: int, depth: int, kind: str):
    """Bound of one K5 call on this run's data, as for K3: the query, the
    ids, each distinct in-range packed row and its scales once, the output
    once; 2*T operations for each (query, in-range row) pair.  Returns (ms,
    bound_by, distinct rows)."""
    b, t = q.shape
    valid = (row_ids >= 0) & (row_ids < n_docs)
    pairs = int(valid.sum())
    distinct = int(torch.unique(row_ids[valid]).numel())
    nbytes = (q.numel() * q.element_size() + row_ids.numel() * 4
              + distinct * _packed_row_bytes(docs, scale) + b * depth * 8)
    return (*_bound(nbytes, 2.0 * pairs * t, kind), distinct)


def compare(name, got, want, exact: bool) -> float:
    """Hold the kernel's (scores, ids) against the plain version's.  Exact
    modes: bit-equal.  Float modes: scores within rtol = atol = 1e-5, and
    ids equal at every rank whose plain score differs from both neighbours
    (the plain list carries one rank more than the kernel's) by more than
    that tolerance.  Returns the largest score difference."""
    gs, gi = (x.cpu() for x in got)
    ws, wi = (x.cpu() for x in want)
    d = gs.shape[1]
    if gs.shape != (ws.shape[0], d) or gi.dtype != torch.int32:
        raise AssertionError(f"{name}: shape/dtype {tuple(gs.shape)} {gi.dtype}")
    fin = torch.isfinite(ws[:, :d])
    if not torch.equal(fin, torch.isfinite(gs)):
        raise AssertionError(f"{name}: -inf slots differ")
    err = float((gs - ws[:, :d])[fin].abs().max()) if bool(fin.any()) else 0.0
    if exact:
        if not (torch.equal(gs, ws[:, :d]) and torch.equal(gi, wi[:, :d])):
            raise AssertionError(f"{name}: not bit-exact (max score err {err})")
        return err
    if not torch.allclose(gs, ws[:, :d], rtol=TOL, atol=TOL):
        raise AssertionError(f"{name}: scores differ by up to {err}")
    tol = TOL + TOL * ws.abs()
    gap = (ws[:, 1:] - ws[:, :-1]).abs()
    big = gap > tol[:, 1:]
    pad = torch.ones_like(big[:, :1])
    lone = torch.cat([pad, big], 1) & torch.cat([big, pad], 1)
    lone = lone[:, :d] | ~fin  # -inf slots must read -1 in both
    if not torch.equal(gi[lone], wi[:, :d][lone]):
        n_bad = int((gi[lone] != wi[:, :d][lone]).sum())
        raise AssertionError(f"{name}: {n_bad} ids differ away from near-ties")
    return err


def _instance(mangled: str) -> str:
    """``fused_topk_quantized_tf32_partial<4, 64, 128, 3, true>`` from a mangled kernel name:
    the kernel's name and its integer, bool and type template arguments
    (``dense_scores``: K8's kernel in trees before PR 29, which
    ``--pair-parent`` and ``--ablate`` build)."""
    m = re.search(r"(fused_topk_(?:gathered_quantized_partial|quantized_bf16_partial"
                  r"|quantized_tf32_partial|gathered_partial|bf16_partial|lsh_partial"
                  r"|int8_partial|f32_partial|partial|merge)"
                  r"|dense_scores|lsh_match_counts|score_matmul_(?:bf16|int8)|cosine_scores_tf32"
                  r"|flash_attention_(?:tf32|bf16|bwd_(?:dkdv|dq)_(?:bf16|f32)|bwd_delta|bwd_sum))"
                  r"(?:I((?:Li-?\d+E|Lb[01]E|[ft])+)E)?",
                  mangled)
    if m is None:
        return mangled.strip()[:72]
    args = [num or {"0": "false", "1": "true"}.get(flag) or {"f": "float", "t": "bf16"}[typ]
            for num, flag, typ in re.findall(r"Li(-?\d+)E|Lb([01])E|([ft])", m.group(2) or "")]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def build_kernels(names=None) -> float:
    from repro_torch.kernels import common

    t0 = time.perf_counter()
    logs = common.build(names)
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:  # names the instance the next lines report
                print(f"  nvcc[{name}] {_instance(line.split('Function properties for')[1])}")
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"  nvcc[{name}] {line.strip()}")
    print(f"kernel build: {seconds:.1f} s for {sorted(logs)} (nvcc, sm_90a)")
    return seconds


def sass_addressed(path: str):
    """{kernel instance: [(address, SASS instruction)]} of the library at
    ``path`` (``cuobjdump -sass``, encodings stripped), or None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    code, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = _instance(line.split("Function :")[1])
            code[fn] = []
        elif fn is not None:
            m = re.match(r"\s*/\*([0-9a-f]+)\*/\s*(.*?)\s*;", line)
            if m:
                code[fn].append((int(m.group(1), 16), m.group(2)))
    return code


def sass(path: str):
    """{kernel instance: its SASS instructions, addresses and encodings
    stripped} of the library at ``path``, or None where the toolkit has no
    cuobjdump."""
    code = sass_addressed(path)
    return None if code is None else {fn: [ins for _, ins in items] for fn, items in code.items()}


def sass_pairing(name: str, parent_lib: str) -> None:
    """Print which kernel instances this tree's library ``name`` and the
    parent's library at ``parent_lib`` both build, and whether their SASS
    is identical."""
    from repro_torch.kernels import common

    new_code, old_code = sass(common.library_path(name)), sass(parent_lib)
    if new_code is None or old_code is None:
        print("SASS of both trees: no cuobjdump in the CUDA toolkit")
        return
    both = sorted(set(new_code) & set(old_code))
    same = [fn for fn in both if new_code[fn] == old_code[fn]]
    print(f"SASS of {name}, this tree against the parent: {len(same)} of the {len(both)} "
          f"instances in both identical; differing: {sorted(set(both) - set(same))}; only "
          f"here: {sorted(set(new_code) - set(old_code))}; only in the parent: "
          f"{sorted(set(old_code) - set(new_code))}")


def sass_count(name: str, opcode: str):
    """Instructions matching the regular expression ``opcode`` (HMMA: bf16
    or tf32 tensor-core products; IMMA: int8 ones; ``HMMA\\.\\S*TF32``: tf32
    ones) per kernel instance in the SASS of library ``name``, or None
    where the toolkit has no cuobjdump."""
    from repro_torch.kernels import common

    code = sass(common.library_path(name))
    if code is None:
        return None
    return {fn: sum(1 for ins in lines if re.search(opcode, ins)) for fn, lines in code.items()}


# The tensor-core kernels in each library (the instances whose names start
# so) and the instruction their products assemble to: the pass 1 of
# mma_topk.cuh in K1 classic's instances and K4's with a bf16 query
# (mma.sync m16n8k16 bf16: HMMA), K1 dot's (m16n8k32 s8: IMMA), K1 f32's and
# K4's with an f32 query over int8 and over int4 rows (m16n8k8 tf32: HMMA on
# TF32 operands); K7's score matrices (classic: m16n8k16 bf16, HMMA; dot:
# m16n8k32 s8, IMMA) and K6's (split TF32: m16n8k8 tf32, HMMA on TF32
# operands); and K9's attention (bf16: m16n8k16 bf16, HMMA; f32: split TF32,
# m16n8k8 tf32, HMMA on TF32 operands) and its backward's dK / dV and dQ
# kernels (bf16: wgmma m64nNk16 bf16, HGMMA; f32: split TF32, m16n8k8 tf32,
# HMMA on TF32 operands).
TENSOR_CORE_KERNELS = (("fused_topk", "fused_topk_bf16_partial", "HMMA"),
                       ("fused_topk", "fused_topk_int8_partial", "IMMA"),
                       ("fused_topk", "fused_topk_f32_partial", r"HMMA\.\S*TF32"),
                       ("fused_topk_quantized", "fused_topk_quantized_bf16_partial", "HMMA"),
                       ("fused_topk_quantized", "fused_topk_quantized_tf32_partial<8,",
                        r"HMMA\.\S*TF32"),
                       ("fused_topk_quantized", "fused_topk_quantized_tf32_partial<4,",
                        r"HMMA\.\S*TF32"),
                       ("fakewords_score", "score_matmul_bf16", "HMMA"),
                       ("fakewords_score", "score_matmul_int8", "IMMA"),
                       ("cosine_score", "cosine_scores_tf32", r"HMMA\.\S*TF32"),
                       ("flash_attention", "flash_attention_bf16", "HMMA"),
                       ("flash_attention", "flash_attention_tf32", r"HMMA\.\S*TF32"),
                       ("flash_attention_bwd", "flash_attention_bwd_dkdv_bf16", "HGMMA"),
                       ("flash_attention_bwd", "flash_attention_bwd_dq_bf16", "HGMMA"),
                       ("flash_attention_bwd", "flash_attention_bwd_dkdv_f32", r"HMMA\.\S*TF32"),
                       ("flash_attention_bwd", "flash_attention_bwd_dq_f32", r"HMMA\.\S*TF32"))


def check_tensor_cores() -> None:
    """Every instance of the tensor-core kernels holds its tensor-core
    instructions (HMMA, IMMA, or HMMA on TF32 operands)."""
    for lib, kernel, opcode in TENSOR_CORE_KERNELS:
        counts = sass_count(lib, opcode)
        if counts is None:
            print("tensor-core instruction count: no cuobjdump in the CUDA toolkit")
            return
        label = "TF32 HMMA" if "TF32" in opcode else opcode
        mma = {k: v for k, v in counts.items() if k.startswith(kernel)}
        print(f"{label} instructions in the SASS of {lib} (cuobjdump -sass): {mma}; every other "
              f"kernel there: {sum(v for k, v in counts.items() if k not in mma)}")
        if not mma or not all(mma.values()):
            raise AssertionError(f"{kernel} has an instance without {label} instructions: {mma}")


def _inputs(kind: str, b: int, n: int, t: int, gen: torch.Generator, dev):
    if kind == "int8":
        q = torch.randint(-50, 50, (b, t), generator=gen, device=dev, dtype=torch.int8)
        d = torch.randint(-50, 50, (n, t), generator=gen, device=dev, dtype=torch.int8)
    elif kind == "ties":  # 0/1 operands: scores tie constantly
        q = torch.randint(0, 2, (b, t), generator=gen, device=dev, dtype=torch.int8)
        d = torch.randint(0, 2, (n, t), generator=gen, device=dev, dtype=torch.int8)
    elif kind == "ties-top":  # a query of two ones over 0/1 rows: a quarter of the rows score 2
        q = torch.zeros((b, t), device=dev, dtype=torch.int8)
        q[:, :2] = 1
        d = torch.randint(0, 2, (n, t), generator=gen, device=dev, dtype=torch.int8)
    elif kind == "ties-half-f32":  # f32 0/1 rows against one 1: half the rows score 1, the top
        q = torch.zeros((b, t), device=dev)
        q[:, 0] = 1.0
        d = torch.randint(0, 2, (n, t), generator=gen, device=dev).float()
    elif kind in ("ties-bf16", "ties-f32"):  # 0/1 floats: small integer scores, tied constantly
        dtype = torch.bfloat16 if kind == "ties-bf16" else torch.float32
        q = torch.randint(0, 2, (b, t), generator=gen, device=dev).to(dtype)
        d = torch.randint(0, 2, (n, t), generator=gen, device=dev).to(dtype)
    elif kind == "unit-f32":  # unit vectors: the exact cosine's operands
        q, d = (torch.nn.functional.normalize(torch.randn(shape, generator=gen, device=dev), dim=1)
                for shape in ((b, t), (n, t)))
    elif kind == "lifted-f32":  # the k-d tree scan's lift of points of norm <= 1, T = dims + 1
        from repro_torch.kernels.fused_topk import ops

        pq, pd = (torch.nn.functional.normalize(torch.randn(shape, generator=gen, device=dev),
                                                dim=1)
                  * torch.rand((shape[0], 1), generator=gen, device=dev)
                  for shape in ((b, t - 1), (n, t - 1)))
        q = torch.cat([2.0 * pq, torch.ones_like(pq[:, :1])], dim=1).contiguous()
        d = ops.lift_l2(pd)
    elif kind in ("rising", "falling", "rising-f32", "falling-f32"):
        # bf16 or f32, exact scores 4 id + (0..3): monotone in the id; every
        # value an integer below 2^11, so its own high tf32 part
        ids = torch.arange(n, device=dev)
        d = torch.randint(-3, 4, (n, t), generator=gen, device=dev)
        d[:, 0], d[:, 1] = ids // 256, ids % 256
        d[:, 2] = torch.randint(0, 4, (n,), generator=gen, device=dev)
        q = torch.zeros((b, t), device=dev)
        q[:, 0], q[:, 1] = 1024, 4
        q[:, 2] = torch.randint(0, 2, (b,), generator=gen, device=dev)
        dtype = torch.float32 if kind.endswith("f32") else torch.bfloat16
        q, d = (q if kind.startswith("rising") else -q).to(dtype), d.to(dtype)
    elif kind in ("rising-int8", "falling-int8"):
        # int8, exact scores 4 id - 51,200 + (0..3), monotone in the id (T >= 7,
        # N <= 29,184): doc columns 0-4 hold id // 128 - 100 against query
        # weights 127 (four times) and 4, column 5 id % 128 against 4, column 6
        # a random 0..3 against 0 or 1, the rest random in [-3, 3] against 0.
        ids = torch.arange(n, device=dev)
        d = torch.randint(-3, 4, (n, t), generator=gen, device=dev)
        d[:, :5] = (ids // 128 - 100)[:, None]
        d[:, 5] = ids % 128
        d[:, 6] = torch.randint(0, 4, (n,), generator=gen, device=dev)
        q = torch.zeros((b, t), dtype=torch.long, device=dev)
        q[:, :4], q[:, 4], q[:, 5] = 127, 4, 4
        q[:, 6] = torch.randint(0, 2, (b,), generator=gen, device=dev)
        q, d = (q if kind == "rising-int8" else -q).to(torch.int8), d.to(torch.int8)
    elif kind in ("int8-full", "int8-extremes"):  # every int8 value, or -128 and 127 only
        if kind == "int8-full":
            q, d = (torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                    for shape in ((b, t), (n, t)))
        else:
            q, d = (torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5, -128, 127)
                    .to(torch.int8) for shape in ((b, t), (n, t)))
    elif kind == "dot":  # the dot path's operands: [u; -u] over term counts 0..127
        u = torch.randint(0, 128, (b, t // 2), generator=gen, device=dev)
        q = torch.cat([u, -u], 1).to(torch.int8)
        d = torch.randint(0, 128, (n, t), generator=gen, device=dev, dtype=torch.int8)
    elif kind == "lsh":
        d = torch.randint(0, 7, (n, t), generator=gen, device=dev, dtype=torch.int32)
        q = d[torch.randint(0, n, (b,), generator=gen, device=dev)].clone()
        q[:, ::5] = -1  # sentinel slots never count
        q, d = q.view(torch.uint32), d.view(torch.uint32)
    elif kind == "lsh-ties":  # copies of 4 rows: a few counts, each held by N / 4 docs
        base = torch.randint(0, 7, (4, t), generator=gen, device=dev, dtype=torch.int32)
        base[:, ::5] = -1  # sentinels on both sides: equal, and never counted
        d = base[torch.randint(0, 4, (n,), generator=gen, device=dev)]
        q = d[torch.randint(0, n, (b,), generator=gen, device=dev)].clone()
        q, d = q.view(torch.uint32), d.view(torch.uint32)
    elif kind == "lsh-empty":  # all-sentinel queries: every count 0, ids in order
        d = torch.randint(-1, 7, (n, t), generator=gen, device=dev, dtype=torch.int32)
        q = torch.full((b, t), -1, device=dev, dtype=torch.int32)
        q, d = q.view(torch.uint32), d.view(torch.uint32)
    else:  # unit-scale floats: scores O(1)
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        q = (torch.randn((b, t), generator=gen, device=dev) / t**0.5).to(dtype)
        d = torch.randn((n, t), generator=gen, device=dev).to(dtype)
    return q, d


EXACT_KINDS = ("int8", "lsh", "lsh-ties", "lsh-empty", "ties", "ties-bf16", "rising", "falling",
               "rising-int8", "falling-int8", "int8-full", "int8-extremes", "dot", "ties-f32",
               "rising-f32", "falling-f32")  # integer scores


# K1 f32's planted fault: the split-TF32 product over f32 rows without the
# doc's low tf32 part (doc lo x q hi), so each doc value keeps ~1e-3 of its
# bits.  Every "unit-f32" case (the exact cosine's operands) must fail with
# it, which shows that those cases can see a doc cut to tf32.
K1_DOC_HI_ONLY = ("    mma_tf32(c, lo, b[0], b[1]);  // doc lo x q hi\n", "")


def build_planted_k1():
    """(name, topk): K1 built from a copy of this tree's sources with
    K1_DOC_HI_ONLY (``_tree_kernels``), called as ``topk(q, docs, depth)``."""
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    return ("doc-hi-only", _tree_kernels(kdir, os.path.join(ROOT, "build", "planted-k1"),
                                         names=("fused_topk",),
                                         edits=[K1_DOC_HI_ONLY])["fused_topk"])


# K2's planted fault: pass 2's threshold without its id, tau cut at (its
# score, -1), so every entry tied with the best of the splits' depth-th
# counts is cut.  K2's own register test needs no id (a count that ties the
# depth-th cannot rank: ids ascend within a block), so the id of the tie
# rule lives here.  Every "lsh-ties" case (the depth-th count held by
# docs of every split) must fail with it.
K2_STRICT = ("      xl[j] = rank_in<true>(xs + (size_t)j * depth, xi + (size_t)j * depth, depth, "
             "tau_s, tau_i);",
             "      xl[j] = rank_in<true>(xs + (size_t)j * depth, xi + (size_t)j * depth, depth, "
             "tau_s, -1);")


def build_planted_k2():
    """(name, topk): K2 built from a copy of this tree's sources with
    K2_STRICT (``_tree_kernels``), called as ``topk(q, docs, depth)``."""
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    return ("tau-without-id", _tree_kernels(kdir, os.path.join(ROOT, "build", "planted-k2"),
                                            names=("fused_topk",),
                                            edits=[K2_STRICT])["fused_topk"])


def check_kernels(dev, planted=None, planted_k2=None) -> dict:
    """The fused top-k kernel against its plain version, every score mode;
    on each "unit-f32" case also the copy with a planted fault (``planted``,
    from build_planted_k1, built here if not given), and on each "lsh-ties"
    case the copy of K2 with K2_STRICT (``planted_k2``, from
    build_planted_k2, likewise), each of which must fail the same
    comparison."""
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk

    gen = torch.Generator(device=dev).manual_seed(0)
    copy, bad_topk = planted or build_planted_k1()
    copy_k2, strict_k2 = planted_k2 or build_planted_k2()
    cases = []
    for kind in ("bf16", "f32", "int8", "lsh"):
        cases += [
            (kind, 4, 256, 64, 32, None, None),       # aligned
            (kind, 3, 513, 257, 37, None, None),      # unaligned B / N / T
            (kind, 40, 3000, 300, 100, None, None),   # depth 100, 32-query tiles
            (kind, 5, 700, 64, 50, None, 650),        # ragged: rows >= n_docs
            (kind, 6, 900, 100, 60, "shared", None),  # filt (N,)
            (kind, 37, 900, 100, 60, "per-query", 800),  # filt (B, N) + ragged
        ]
    cases += [
        ("ties", 3, 130, 16, 130, None, None),        # depth = N, massive ties
        ("ties", 33, 300, 16, 300, None, None),
        ("ties", 9, 1000, 16, 1000, "shared", None),
        ("f32", 1, 200_000, 300, 100, None, None),    # B = 1: many N-splits
        ("bf16", 300, 20_000, 600, 100, None, None),  # several query tiles
        # The tensor-core bf16 pass 1 where its running top-k must be exact:
        # integer scores, so ids are bit-equal to the plain version's.
        ("ties-bf16", 3, 130, 16, 130, None, None),   # depth = N, massive ties
        ("ties-bf16", 33, 300, 16, 300, None, None),
        ("ties-bf16", 9, 1000, 16, 1000, "shared", None),
        ("ties-bf16", 1, 5000, 64, 3072, None, None),  # the widest lists: merge by insert
        ("rising", 65, 20_000, 37, 100, None, None),   # every tile flushes
        ("rising", 1, 20_000, 600, 100, None, 19_000),
        ("falling", 65, 20_000, 600, 100, "per-query", None),  # only the first tiles flush
        ("falling", 5, 20_000, 257, 100, None, None),
        ("bf16", 1, 20_000, 600, 3072, None, None),    # depth 3,072 at B = 1
        ("bf16", 65, 20_000, 600, 100, None, None),    # B = 65 at T = 600
        # The tensor-core int8 pass 1 (K1 dot), exact: ids bit-equal.  Rows
        # of 600 bytes take the ring of 8-byte copies, 256 and 16 bytes the
        # 16-byte ring, 37 bytes registers; lists of 3,072 one register stage.
        ("rising-int8", 65, 20_000, 600, 100, None, None),  # every tile flushes
        ("falling-int8", 65, 20_000, 600, 100, "per-query", None),  # only the first
        ("rising-int8", 1, 20_000, 600, 100, None, 19_000),
        ("falling-int8", 5, 20_000, 37, 100, None, None),
        ("rising-int8", 65, 20_000, 37, 100, "shared", None),
        ("int8-full", 65, 20_000, 256, 100, None, None),
        ("int8-full", 3, 20_000, 256, 100, None, 19_900),
        ("int8-full", 3, 20_000, 600, 100, "shared", None),
        ("int8-full", 1, 20_000, 256, 3072, None, None),   # depth 3,072 at B = 1
        ("int8-extremes", 65, 5000, 600, 3072, None, None),  # and at B = 65
        ("int8-extremes", 70, 20_000, 600, 100, None, 19_999),
        ("ties", 65, 600, 600, 600, None, None),           # depth = N at T = 600
        ("dot", 65, 20_000, 600, 100, None, None),
        # The split-TF32 f32 pass 1 (K1 f32).  Integer values below 2^11 are
        # their own high tf32 part, so the sums are exact and ids bit-equal:
        # 0/1 operands at depth = N and 3,072, scores that rise or fall with
        # the doc id (rows of 300 f32 take the ring, of 37 registers).  Unit
        # vectors at the cosine's T = 300 and depth 10 at B = 256, 8 and 1,
        # which the copy without the doc's low part (K1_DOC_HI_ONLY) must fail.
        ("ties-f32", 3, 130, 16, 130, None, None),         # depth = N, massive ties
        ("ties-f32", 33, 300, 16, 300, None, None),
        ("ties-f32", 9, 1000, 16, 1000, "shared", None),
        ("ties-f32", 65, 600, 300, 600, None, None),       # depth = N at T = 300
        ("ties-f32", 1, 5000, 64, 3072, None, None),       # the widest lists: merge by insert
        ("rising-f32", 65, 20_000, 300, 100, None, None),  # every tile flushes
        ("rising-f32", 1, 20_000, 300, 100, None, 19_000),
        ("falling-f32", 65, 20_000, 300, 100, "per-query", None),  # only the first tiles flush
        ("falling-f32", 5, 20_000, 37, 100, None, None),
        ("rising-f32", 65, 20_000, 37, 100, "shared", None),
        ("f32", 1, 20_000, 300, 3072, None, None),         # depth 3,072 at B = 1
        ("unit-f32", 256, 100_000, 300, 10, None, None),
        ("unit-f32", 8, 100_000, 300, 10, None, None),
        ("unit-f32", 1, 100_000, 300, 10, None, None),
        # The k-d tree's lifted scan: T = dims + 1 = 9 and 5 (36- and 20-byte
        # rows: the register loader; the second tf32 k-step carries 1 or 5
        # live columns), the lift [2q; 1] x [d; -||d||^2] of points of norm
        # <= 1 at B = 256, 8 and 1, ragged n_docs, depth 100 and = N; and
        # 0/1 operands at those widths, bit for bit.
        ("lifted-f32", 256, 200_000, 9, 100, None, None),
        ("lifted-f32", 8, 200_000, 9, 100, None, None),
        ("lifted-f32", 1, 200_000, 9, 100, None, None),
        ("lifted-f32", 256, 200_000, 5, 100, None, None),
        ("lifted-f32", 8, 200_000, 5, 100, None, None),
        ("lifted-f32", 1, 200_000, 5, 100, None, None),
        ("lifted-f32", 8, 20_000, 9, 100, None, 19_001),
        ("lifted-f32", 1, 20_000, 5, 100, None, 19_999),
        ("lifted-f32", 65, 20_000, 9, 100, "shared", 19_500),
        ("lifted-f32", 3, 600, 9, 600, None, None),        # depth = N
        ("lifted-f32", 1, 3000, 5, 3000, None, None),
        ("ties-f32", 256, 20_000, 9, 100, None, None),
        ("ties-f32", 8, 20_000, 5, 100, None, 19_000),
        ("ties-f32", 1, 20_000, 9, 100, None, None),
        ("ties-f32", 3, 130, 9, 130, None, None),          # depth = N, massive ties
        ("ties-f32", 65, 600, 5, 600, None, None),
        # K2 (lsh): copies of 4 rows, so that the depth-th count is held by
        # docs of every split ("lsh-ties", which the copy with K2_STRICT must
        # fail); all-sentinel queries (every count 0: ids 0..depth-1, past
        # filt and n_docs); the paper's b = 50, h = 30 width (S = 1,500); S =
        # 37 (4-byte copies); depth 3,072 at B = 1; the query tiles of B = 2,
        # 5 and 8; filt and n_docs at B = 1 and 40.
        ("lsh-ties", 1, 200_000, 300, 100, None, None),
        ("lsh-ties", 8, 200_000, 300, 100, None, None),
        ("lsh-ties", 256, 100_000, 300, 100, None, None),
        ("lsh-ties", 3, 600_000, 37, 1000, None, None),    # N / 4 / splits >= depth
        ("lsh-ties", 1, 2_000_000, 64, 3072, None, None),
        ("lsh-empty", 1, 20_000, 300, 100, None, None),
        ("lsh-empty", 40, 20_000, 300, 100, "shared", 19_000),
        ("lsh-empty", 5, 20_000, 300, 100, "per-query", None),
        ("lsh", 8, 20_000, 1500, 100, None, None),
        ("lsh", 70, 20_000, 1500, 100, None, 19_990),
        ("lsh", 1, 20_000, 1500, 100, None, None),
        ("lsh", 65, 20_000, 37, 100, None, None),
        ("lsh", 1, 20_000, 37, 100, "shared", None),
        ("lsh", 1, 20_000, 300, 3072, None, None),
        ("lsh", 2, 20_000, 300, 100, None, None),
        ("lsh", 5, 20_000, 300, 100, None, None),
        ("lsh", 8, 20_000, 300, 100, None, None),
        ("lsh", 1, 20_000, 300, 100, "per-query", 19_000),
        ("lsh", 1, 20_000, 300, 100, "shared", None),
        ("lsh", 40, 20_000, 300, 100, "per-query", None),
        ("lsh", 40, 20_000, 300, 100, "shared", 19_500),
    ]
    worst = {}
    for kind, b, n, t, depth, filt_kind, n_docs in cases:
        q, d = _inputs(kind, b, n, t, gen, dev)
        filt = None
        if filt_kind == "shared":
            filt = torch.rand((n,), generator=gen, device=dev) < 0.3
        elif filt_kind == "per-query":
            filt = torch.rand((b, n), generator=gen, device=dev) < 0.05
        mode = "lsh" if kind.startswith("lsh") else "gemm"
        got = fused_topk(q, d, depth, mode=mode, filt=filt, n_docs=n_docs)
        torch.cuda.synchronize()
        nd = n if n_docs is None else n_docs
        want = ref.fused_topk_ref(q, d, min(depth + 1, nd), mode=mode, filt=filt, n_docs=n_docs)
        name = f"{kind} B={b} N={n} T={t} depth={depth} filt={filt_kind} n_docs={n_docs}"
        err = compare(name, got, want, exact=kind in EXACT_KINDS)
        worst[kind] = max(worst.get(kind, 0.0), err)
        print(f"  ok  {name}  max_abs_err={err:.3g}")
        if kind == "unit-f32":
            try:
                compare(f"{name}, {copy} copy", bad_topk(q, d, depth), want, exact=False)
            except AssertionError as fault:
                print(f"  ok  the {copy} copy fails: {fault}")
            else:
                raise AssertionError(f"{name}: the {copy} copy passed the comparison")
        if kind == "lsh-ties":
            try:
                compare(f"{name}, {copy_k2} copy", strict_k2(q, d, depth), want, exact=True)
            except AssertionError as fault:
                print(f"  ok  the {copy_k2} copy fails: {fault}")
            else:
                raise AssertionError(f"{name}: the {copy_k2} copy passed the comparison")
    print(f"fused_topk vs plain on the card: {len(cases)} cases, worst {worst}")
    return worst


def gathered_cases():
    """(kind, B, N, R, T, depth, ids, filt, n_docs) for check_gathered."""
    cases = []
    for kind in ("bf16", "f32", "int8", "lsh"):
        cases += [
            (kind, 4, 3000, 1024, 64, 32, "random", False, None),     # aligned rows
            (kind, 3, 2000, 700, 257, 37, "random", False, 1800),     # unaligned T, ids >= n_docs
            (kind, 5, 20_000, 2560, 300, 100, "blocks", False, None),  # 10 kept 256-row blocks
            (kind, 6, 3000, 900, 100, 60, "random", True, None),      # filt (B, R)
        ]
    cases += [
        ("ties", 3, 500, 300, 16, 300, "permutation", False, None),   # depth = R, massive ties
        ("ties", 2, 2048, 1024, 16, 1024, "blocks", True, None),      # ties + filt, depth = R
        ("int8", 4, 5000, 1280, 600, 100, "blocks", False, None),     # 600-byte rows: 8-byte loads
        ("bf16", 1, 400_000, 299_776, 600, 100, "blocks", False, None),  # B = 1: many splits
        # B = 1 at the main path's R: 0/1 operands (scores 0..16, every rank
        # tied), ids in random block order and best block first; a query
        # whose top score fills every split's list, blocks in descending id
        # order, so that each split's lowest ids come last (B = 1 and 8);
        # whole 256-row splits of padding; f32 and bf16 in bound order at
        # B = 8.
        ("ties", 1, 400_000, 299_776, 16, 100, "blocks", False, None),
        ("ties", 1, 400_000, 299_776, 16, 100, "bound", False, None),
        ("ties-top", 1, 400_000, 299_776, 16, 100, "descending", False, None),
        ("ties-top", 8, 400_000, 299_776, 16, 100, "descending", False, None),
        ("int8", 2, 50_000, 25_600, 600, 100, "padded-blocks", False, None),
        ("ties", 3, 50_000, 25_600, 16, 3000, "padded-blocks", False, None),
        ("bf16", 8, 400_000, 299_776, 600, 100, "bound", False, None),
        ("f32", 8, 100_000, 51_200, 300, 100, "bound", False, None),
    ]
    # The graph traversal's shapes (f32, T = 300, depth = R): the entry
    # block (R = 4) and its neighbour blocks (beam x total_degree: 128, and
    # 512 at ef 320 / beam 16), distinct scattered ids with padding ids
    # (n_docs) in place of the slots a traversal drops; 0/1 rows whose
    # scores tie constantly at depth = R, held bit for bit.  At R <= 512 a
    # split is one 256-row round (``gathered_row_plan``), so every row
    # reaches the counting merge and K3's threshold test never decides: the
    # K3_STRICT copy cannot fail there.  A last ties case at R = 1,024, B =
    # 256 (two splits of two rounds), depth 100, half the rows tied at the
    # top score and ids in descending order, holds the tie rule in f32 at
    # T = 300, and the K3_STRICT copy must fail it.
    for r in (4, 128, 512):
        cases += [("unit-f32", b, 100_000, r, 300, r, "scattered", False, None)
                  for b in (1, 8, 256)]
    cases += [
        ("ties-f32", 8, 100_000, 512, 300, 512, "scattered", False, None),
        ("ties-half-f32", 256, 100_000, 1024, 300, 100, "descending-scattered", False, None),
    ]
    return cases


def _row_ids(how: str, b: int, n: int, r: int, gen, dev, scores=None):
    """(B, R) int32 row ids: uniform over [0, 1.125 N) with every 17th id
    BIG_ID ("random"), whole 256-row blocks in random order ("blocks"), the
    same with every third block all BIG_ID ("padded-blocks": whole splits
    of padding where a split is 256 rows), the blocks with the best scores
    (``scores`` (B, N), the exact bound) best first, as blockmax stage 1
    orders them ("bound"), random blocks in descending id order
    ("descending"), or distinct ids of [0, N + 30) in random order
    ("permutation"), or distinct ids of [0, N) with every 9th slot N (the
    graph's padding, ``n_docs``), in random order ("scattered") or in
    descending id order ("descending-scattered")."""
    from repro_torch.kernels.common import BIG_ID

    if how in ("scattered", "descending-scattered"):
        ids = torch.stack([torch.randperm(n, generator=gen, device=dev)[:r] for _ in range(b)])
        if how == "descending-scattered":
            ids = torch.sort(ids, dim=1, descending=True)[0]
        ids[:, 1::9] = n
        return ids.to(torch.int32)

    if how == "bound":
        best = scores[:, :n // BLOCK * BLOCK].reshape(b, -1, BLOCK).amax(-1)
        blocks = torch.sort(best, dim=1, descending=True, stable=True)[1][:, :r // BLOCK]
        offsets = torch.arange(BLOCK, device=dev)
        return (blocks[:, :, None] * BLOCK + offsets).reshape(b, -1).to(torch.int32)
    if how == "descending":
        ids = _row_ids("blocks", b, n, r, gen, dev).view(b, -1, BLOCK)
        order = torch.sort(ids[:, :, 0], dim=1, descending=True)[1]
        return torch.gather(ids, 1, order[:, :, None].expand_as(ids)).reshape(b, -1)
    if how == "padded-blocks":
        ids = _row_ids("blocks", b, n, r, gen, dev).view(b, -1, BLOCK)
        ids[:, ::3] = BIG_ID
        return ids.reshape(b, -1)

    if how == "random":
        ids = torch.randint(0, n + n // 8, (b, r), generator=gen, device=dev, dtype=torch.int32)
        ids[:, ::17] = BIG_ID
        return ids
    if how == "permutation":
        return torch.stack([torch.randperm(n + 30, generator=gen, device=dev)[:r]
                            for _ in range(b)]).to(torch.int32)
    offsets = torch.arange(BLOCK, device=dev)
    blocks = torch.stack([torch.randperm(-(-n // BLOCK), generator=gen, device=dev)[:r // BLOCK]
                          for _ in range(b)])
    return (blocks[:, :, None] * BLOCK + offsets).reshape(b, -1).to(torch.int32)


# K3's planted fault: a strict > at the block list's threshold, which drops
# a row that ties the depth-th score with a lower id.  Every "ties-top"
# case (a quarter of the rows tie at the top score, so every split's list
# fills with them before its lowest ids, which come last) must fail with it.
K3_STRICT = ("const bool pass = my_ok && precedes(my_s, my_id, *ts, *ti);",
             "const bool pass = my_ok && my_s > *ts;")


def build_planted_k3():
    """(name, topk): K3 built from a copy of this tree's sources with
    K3_STRICT (``_tree_kernels``), called as ``topk(q, store, row_ids,
    depth, n_docs)``."""
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    return ("strict-threshold", _tree_kernels(kdir, os.path.join(ROOT, "build", "planted-k3"),
                                              names=("fused_topk",),
                                              edits=[K3_STRICT])["fused_topk_gathered"])


def check_gathered(dev, planted=None) -> dict:
    """The gathered fused top-k kernel (K3) against its plain version; on
    each "ties-top" case also the copy with a planted fault
    (``planted``, from build_planted_k3, built here if not given), which
    must fail the same comparison."""
    from repro_torch.kernels.common import BIG_ID
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk_gathered

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = gathered_cases()
    copy, bad_topk = planted or build_planted_k3()
    worst = {}
    for kind, b, n, r, t, depth, how, with_filt, n_docs in cases:
        q, store = _inputs(kind, b, n, t, gen, dev)
        scores = ref.scores_ref(q, store) if how == "bound" else None
        ids = _row_ids(how, b, n, r, gen, dev, scores)
        del scores
        filt = torch.rand((b, r), generator=gen, device=dev) < 0.5 if with_filt else None
        nd = n if n_docs is None else n_docs
        mode = "lsh" if kind == "lsh" else "gemm"
        got = fused_topk_gathered(q, store, ids, depth, nd, mode=mode, filt=filt)
        torch.cuda.synchronize()
        rows = ref.gather_rows(store, ids, nd)
        want = ref.gathered_topk_ref(q, rows, ids, min(depth + 1, r), nd, mode=mode, filt=filt)
        del rows
        name = (f"{kind} B={b} N={n} R={r} T={t} depth={depth} ids={how} filt={with_filt} "
                f"n_docs={n_docs}")
        err = compare(name, got, want, exact=kind in ("int8", "lsh", "ties", "ties-top",
                                                      "ties-f32", "ties-half-f32"))
        worst[kind] = max(worst.get(kind, 0.0), err)
        print(f"  ok  {name}  max_abs_err={err:.3g}")
        if kind in ("ties-top", "ties-half-f32"):
            bad = bad_topk(q, store, torch.where(filt, ids, BIG_ID) if with_filt else ids,
                           depth, nd)
            try:
                compare(f"{name}, {copy} copy", bad, want, exact=True)
            except AssertionError as fault:
                print(f"  ok  the {copy} copy fails: {fault}")
            else:
                raise AssertionError(f"{name}: the {copy} copy passed the comparison")
    print(f"fused_topk_gathered vs plain on the card: {len(cases)} cases, worst {worst}")
    return worst


def _quantized_inputs(kind: str, bits: int, group: int, qdtype: str, b: int, n: int, t: int,
                      gen: torch.Generator, dev):
    """(q, packed docs, scales).  "float": a random matrix of mixed row
    magnitudes packed by the port's builder, a unit-scale float query.
    "int": integer values with unit scales (int8 in [-50, 50], every int4
    nibble) and an integer query in [-20, 20], so every sum is exact.
    "ties": 0/1 values and query, so scores tie constantly.  "rising" /
    "falling" (unit scales): scores 4 id + (0..3) minus a constant, exact,
    that rise or fall with the doc id (every tile, or only the first, feeds
    the running lists), from int8 columns id // 128 - 100 and id % 128, or
    from the four base-16 digits of the id as int4 values.  "dot": a dot
    query ([u; -u], integers) over int8 postings packed by the port's
    builder from term counts in [0, 50] with a 127 in every row (scale 1).
    "wide" (f32): a float store as "float" and a query of wide dynamic
    range (|q| from 1e-3 to 1e3, random signs and mantissas), where one
    tf32 pass of the query is far outside the near-tie rule.  "pow2" (int4):
    every nibble, and each row's group scales distinct powers of two
    (pow2_scales), with the integer query of "int": every sum is exact.
    "ties-top": the 0/1 rows of "ties" against a query of two ones (columns
    0 and 1), so a quarter of the rows tie at the top score 2."""
    from repro_torch.core import builder
    from repro_torch.kernels.common import round_up

    dtype = torch.bfloat16 if qdtype == "bf16" else torch.float32
    if kind in ("rising", "falling"):
        ids = torch.arange(n, device=dev)
        q = torch.zeros((b, t), device=dev)
        if bits == 8:
            docs = torch.randint(-3, 4, (n, t), generator=gen, device=dev)
            docs[:, 0], docs[:, 1] = ids // 128 - 100, ids % 128
            docs[:, 2] = torch.randint(0, 4, (n,), generator=gen, device=dev)
            q[:, 0], q[:, 1] = 512, 4
            scale = torch.ones((n, 1), device=dev)
        else:
            tg = round_up(t, group)
            nib = torch.randint(0, 16, (n, tg), generator=gen, device=dev)
            for c, w in enumerate((4096, 256, 16, 1)):
                nib[:, c] = ids // w % 16
                q[:, c] = 4 * w
            nib[:, 4] = torch.randint(8, 12, (n,), generator=gen, device=dev)
            nib[:, t:] = 8
            docs = nib[:, 0::2] | (nib[:, 1::2] << 4)
            scale = torch.ones((n, tg // group), device=dev)
        q[:, 2 if bits == 8 else 4] = torch.randint(0, 2, (b,), generator=gen, device=dev)
        q = q if kind == "rising" else -q
        return q.to(dtype), docs.to(torch.int8 if bits == 8 else torch.uint8), scale
    if kind == "dot":
        tf = torch.randint(0, 51, (n, t), generator=gen, device=dev)
        tf[:, 0] = 127
        u = torch.randint(-20, 21, (b, t // 2), generator=gen, device=dev)
        pq = builder.quantize_postings(tf.float(), 8)
        return torch.cat([u, -u], 1).to(dtype), pq.q, pq.scale
    if kind in ("float", "wide"):
        m = torch.randn((n, t), generator=gen, device=dev)
        m *= 10 * torch.rand((n, 1), generator=gen, device=dev) + 0.01
        pq = builder.quantize_postings(m, bits, group or GROUP)
        if kind == "wide":
            sign = torch.randint(0, 2, (b, t), generator=gen, device=dev) * 2 - 1
            q = sign * 10.0 ** (6 * torch.rand((b, t), generator=gen, device=dev) - 3)
        else:
            q = torch.randn((b, t), generator=gen, device=dev) / t**0.5
        return q.to(dtype), pq.q, pq.scale
    lo, hi = (-20, 21) if kind in ("int", "pow2") else (0, 2)
    q = torch.randint(lo, hi, (b, t), generator=gen, device=dev).to(dtype)
    if kind == "ties-top":
        q = torch.zeros((b, t), device=dev, dtype=dtype)
        q[:, :2] = 1
    if bits == 8:
        lo, hi = (-50, 51) if kind == "int" else (0, 2)
        docs = torch.randint(lo, hi, (n, t), generator=gen, device=dev, dtype=torch.int8)
        return q, docs, torch.ones((n, 1), device=dev)
    tg = round_up(t, group)
    lo, hi = (0, 16) if kind in ("int", "pow2") else (8, 10)
    nib = torch.randint(lo, hi, (n, tg), generator=gen, device=dev, dtype=torch.uint8)
    nib[:, t:] = 8  # pad columns hold the value 0, as the builder writes them
    scale = (pow2_scales(n, tg // group, dev) if kind == "pow2"
             else torch.ones((n, tg // group), device=dev))
    return q, nib[:, 0::2] | (nib[:, 1::2] << 4), scale


def pow2_scales(n: int, n_groups: int, dev) -> torch.Tensor:
    """(n, n_groups) int4 group scales 2^((g + row) % 7 - 3): neighbouring
    groups of a row differ.  With integer queries in [-20, 20] and any
    nibbles, every product and partial sum of a row of up to 20 groups of 32
    is a multiple of 1/8 below 2^20: exact in f32, whatever the order."""
    g = torch.arange(n_groups, device=dev)[None, :] + torch.arange(n, device=dev)[:, None]
    return torch.exp2((g % 7 - 3).float())


def quantized_cases():
    """K4: (kind, bits, group, query dtype, B, N, T, depth, filt, n_docs);
    K5: (kind, bits, group, query dtype, B, N, R, T, depth, ids, filt, n_docs)."""
    k4 = [
        ("float", 8, 0, "bf16", 4, 3000, 600, 100, None, None),
        ("float", 4, 32, "bf16", 40, 3000, 600, 100, None, None),     # 32-query tiles
        ("float", 4, 64, "bf16", 37, 2000, 100, 60, "per-query", 1800),
        ("float", 8, 0, "f32", 5, 2000, 300, 50, "shared", None),
        ("float", 4, 32, "f32", 3, 2000, 100, 37, None, 1900),         # ragged n_docs
        ("float", 4, 64, "f32", 33, 3000, 600, 100, None, None),
        ("float", 4, 32, "bf16", 1, 200_000, 600, 100, None, None),    # B = 1: many N-splits
        ("int", 8, 0, "bf16", 40, 3000, 600, 100, None, None),
        ("int", 8, 0, "f32", 7, 2000, 300, 64, "per-query", None),
        ("int", 4, 32, "bf16", 6, 2000, 100, 60, "shared", 1900),
        ("int", 4, 64, "bf16", 300, 20_000, 600, 100, None, None),     # several query tiles
        ("ties", 8, 0, "bf16", 3, 130, 16, 130, None, None),           # depth = N
        ("ties", 4, 32, "bf16", 9, 1000, 64, 1000, "shared", None),
        ("ties", 4, 64, "bf16", 1, 5000, 64, 3072, None, None),        # the plan's depth limit
        # The tensor-core pass 1 (bf16 query) where its running top-k must be
        # exact: integer scores rising or falling with the id, ids bit-equal.
        ("rising", 8, 0, "bf16", 65, 20_000, 600, 100, None, None),    # every tile flushes
        ("falling", 8, 0, "bf16", 65, 20_000, 600, 100, "per-query", None),  # only the first
        ("rising", 8, 0, "bf16", 1, 20_000, 600, 100, None, 19_000),
        ("falling", 4, 32, "bf16", 65, 20_000, 600, 100, None, None),
        ("rising", 4, 32, "bf16", 65, 20_000, 100, 100, "shared", None),
        ("rising", 4, 64, "bf16", 1, 20_000, 600, 100, None, None),
        ("falling", 4, 32, "bf16", 1, 20_000, 600, 100, None, 19_001),
        # The packed staging's edges: int8 rows of 37 bytes (not 8-byte
        # aligned); int4 g32 at T = 600 (Tg 608: the last chunk's second
        # half lies past the 19th, last group) with ragged n_docs.
        ("int", 8, 0, "bf16", 5, 2000, 37, 60, None, None),
        ("float", 8, 0, "bf16", 70, 2000, 37, 60, "per-query", 1999),
        ("int", 4, 32, "bf16", 7, 3000, 600, 100, None, 2999),
        ("float", 4, 32, "bf16", 66, 3000, 600, 100, None, 2901),
        ("ties", 8, 0, "bf16", 1, 5000, 64, 3072, None, None),         # depth 3,072 at B = 1
        ("int", 8, 0, "bf16", 65, 5000, 600, 3072, None, None),        # and at B = 65
        ("int", 4, 32, "bf16", 65, 5000, 600, 3072, "shared", 4900),
        ("dot", 8, 0, "bf16", 40, 3000, 600, 100, None, None),         # dot query over int8 pq
        # The split-TF32 pass 1 (f32 query over int8 rows): rows of 300
        # bytes (4-byte aligned: the ring of 4-byte units), 37 (registers)
        # and 600 (8-byte); integer scores bit-exact in both tf32 parts
        # (ties, rising / falling with the id, depth = N and 3,072); a
        # query of wide range, which the hi-only copy must fail.
        ("float", 8, 0, "f32", 70, 3000, 300, 100, None, 2999),        # 64-query tiles
        ("float", 8, 0, "f32", 9, 2000, 37, 60, "per-query", 1999),
        ("int", 8, 0, "f32", 66, 3000, 37, 60, "shared", None),
        ("float", 8, 0, "f32", 40, 3000, 600, 100, "per-query", None),
        ("int", 8, 0, "f32", 3, 2000, 600, 100, None, 1900),
        ("ties", 8, 0, "f32", 3, 130, 16, 130, None, None),            # depth = N
        ("ties", 8, 0, "f32", 70, 300, 300, 300, "shared", None),      # and at 64-query tiles
        ("ties", 8, 0, "f32", 1, 5000, 64, 3072, None, None),          # depth 3,072 at B = 1
        ("int", 8, 0, "f32", 65, 5000, 300, 3072, None, None),         # and at B = 65
        ("rising", 8, 0, "f32", 65, 20_000, 300, 100, None, None),     # every tile flushes
        ("falling", 8, 0, "f32", 65, 20_000, 300, 100, "per-query", None),  # only the first
        ("rising", 8, 0, "f32", 1, 20_000, 300, 100, None, 19_000),
        ("falling", 8, 0, "f32", 1, 20_000, 37, 100, None, None),
        ("wide", 8, 0, "f32", 65, 3000, 300, 100, None, None),
        ("wide", 8, 0, "f32", 8, 3000, 300, 100, None, None),
        # Lists too wide for 256-doc tiles with the register loader but not
        # with the ring of 4-byte units: 1-byte rows take registers.
        ("int", 8, 0, "f32", 1, 5000, 37, 2200, None, None),
        ("float", 8, 0, "f32", 65, 5000, 37, 2200, "per-query", 4900),
        ("float", 8, 0, "f32", 1, 5000, 300, 2200, "shared", None),
        # The split-TF32 pass 1 over int4 rows (the register loader), each
        # chunk's sum times its group's scale: rows of 160 bytes (T = 300,
        # g32) and 320 (T = 600, g64), T = 37 (query rows of 148 bytes, not
        # 16-byte aligned); integer scores bit-exact, over unit scales and over
        # distinct power-of-two group scales ("pow2", which the
        # first-group-scale copy must fail); the wide-range query.
        ("float", 4, 32, "f32", 70, 3000, 300, 100, None, 2999),       # 64-query tiles
        ("float", 4, 64, "f32", 9, 2000, 37, 60, "per-query", 1999),
        ("int", 4, 32, "f32", 66, 3000, 37, 60, "shared", None),
        ("float", 4, 64, "f32", 40, 3000, 600, 100, "per-query", None),
        ("float", 4, 32, "f32", 3, 2000, 600, 100, None, 1900),        # Tg 608: 19 groups
        ("ties", 4, 32, "f32", 3, 130, 16, 130, None, None),           # depth = N
        ("ties", 4, 64, "f32", 70, 300, 300, 300, "shared", None),     # and at 64-query tiles
        ("ties", 4, 32, "f32", 1, 5000, 64, 3072, None, None),         # depth 3,072 at B = 1
        ("int", 4, 32, "f32", 65, 5000, 300, 3072, None, None),        # and at B = 65
        ("rising", 4, 32, "f32", 65, 20_000, 300, 100, None, None),    # every tile flushes
        ("falling", 4, 64, "f32", 65, 20_000, 300, 100, "per-query", None),  # only the first
        ("rising", 4, 32, "f32", 1, 20_000, 300, 100, None, 19_000),
        ("falling", 4, 32, "f32", 1, 20_000, 37, 100, None, None),
        ("pow2", 4, 32, "f32", 65, 3000, 300, 100, None, None),
        ("pow2", 4, 64, "f32", 8, 3000, 600, 100, "shared", 2950),
        ("pow2", 4, 32, "f32", 1, 3000, 37, 100, None, None),
        ("wide", 4, 32, "f32", 65, 3000, 300, 100, None, None),
        # 256-doc tiles hold lists up to depth 2,080 here (the register
        # loader's chunk scales); 2,200 takes 128-doc tiles.
        ("int", 4, 32, "f32", 1, 5000, 37, 2200, None, None),
        ("float", 4, 64, "f32", 65, 5000, 37, 2200, "per-query", 4900),
        ("float", 4, 32, "f32", 1, 5000, 300, 2080, "shared", None),
        ("pow2", 4, 32, "f32", 65, 5000, 300, 2200, None, None),
    ]
    k5 = [
        ("float", 8, 0, "bf16", 4, 3000, 1024, 600, 32, "random", False, None),
        ("float", 4, 32, "bf16", 3, 2000, 700, 600, 37, "random", False, 1800),
        ("float", 4, 64, "bf16", 5, 20_000, 2560, 100, 100, "blocks", False, None),
        ("float", 8, 0, "f32", 6, 3000, 900, 300, 60, "random", True, None),
        ("float", 4, 32, "f32", 2, 3000, 900, 100, 60, "random", True, None),
        ("int", 8, 0, "bf16", 4, 5000, 1280, 600, 100, "blocks", False, None),  # 8-byte rows
        ("int", 4, 64, "bf16", 3, 2000, 700, 100, 100, "random", True, 1800),
        ("ties", 4, 32, "bf16", 3, 500, 300, 64, 300, "permutation", False, None),  # depth = R
        ("ties", 8, 0, "bf16", 2, 2048, 1024, 16, 1024, "blocks", True, None),
        ("float", 4, 32, "bf16", 1, 400_000, 299_776, 600, 100, "blocks", False, None),  # B = 1
        # One list a block: a quarter of the rows tie at the top score, blocks
        # in descending id order, so that each split's lowest ids come last
        # (the strict-threshold copy must fail each, B = 1 and 8); whole
        # 256-row splits of padding at depth 100 and 3,000; blocks in bound
        # order (best first, as stage 1 gives them); a depth past the
        # per-warp lists' limit of the earlier design; int8 rows aligned to 4
        # (T = 100) and to 1 (T = 37).
        ("ties-top", 8, 0, "bf16", 1, 400_000, 299_776, 16, 100, "descending", False, None),
        ("ties-top", 8, 0, "bf16", 8, 400_000, 299_776, 16, 100, "descending", False, None),
        ("ties-top", 4, 32, "bf16", 1, 400_000, 299_776, 16, 100, "descending", False, None),
        ("ties-top", 4, 32, "f32", 8, 400_000, 299_776, 16, 100, "descending", False, None),
        ("int", 8, 0, "bf16", 2, 50_000, 25_600, 600, 100, "padded-blocks", False, None),
        ("ties", 4, 32, "bf16", 3, 50_000, 25_600, 16, 3000, "padded-blocks", False, None),
        ("float", 4, 32, "bf16", 8, 400_000, 299_776, 600, 100, "bound", False, None),
        ("ties", 8, 0, "f32", 1, 20_000, 10_240, 16, 4096, "blocks", False, None),
        ("ties", 4, 32, "bf16", 1, 20_000, 10_240, 64, 4096, "blocks", False, None),
        ("int", 8, 0, "bf16", 3, 2000, 700, 100, 60, "random", False, 1800),
        ("int", 8, 0, "f32", 4, 3000, 1024, 37, 50, "random", True, None),
        ("float", 8, 0, "bf16", 3, 2000, 700, 37, 60, "blocks", False, None),
    ]
    return k4, k5


# The planted faults of check_quantized, each K4 case of the kind named
# beside it run through a copy of K4 with it, which must fail there: the
# split-TF32 product without the query's low tf32 part (one tf32 pass, ~1e-3
# of q kept) on the "wide" cases; every int4 chunk folded with its row's
# first group scale on the "pow2" ones.
HI_ONLY = ("    mma_tf32(c, a, b[2], b[3]);\n", "")
FIRST_GROUP_SCALE = ("scale[(size_t)di * n_groups + e0 / group]",
                     "scale[(size_t)di * n_groups]")
PLANTED = {"wide": ("hi-only", HI_ONLY), "pow2": ("first-group-scale", FIRST_GROUP_SCALE)}


def build_planted() -> dict:
    """{case kind: (name, topk)}: K4 built from a copy of this tree's
    sources with each PLANTED fault (``_tree_kernels``, the nvcc runs at
    once), called as ``topk(q, pq, depth)``."""
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    with ThreadPoolExecutor() as pool:
        built = {kind: pool.submit(_tree_kernels, kdir, os.path.join(ROOT, "build", name),
                                   names=("fused_topk_quantized",), edits=[edit])
                 for kind, (name, edit) in PLANTED.items()}
        return {kind: (PLANTED[kind][0], fut.result()["fused_topk_quantized"])
                for kind, fut in built.items()}


# K5's planted fault: K3_STRICT, the same line in K5's pass 1 (a strict >
# at the block list's threshold).  Every K5 "ties-top" case must fail with it.
K5_STRICT = K3_STRICT


def build_planted_k5():
    """(name, topk): K5 built from a copy of this tree's sources with
    K5_STRICT (``_tree_kernels``), called as ``topk(q, pq, row_ids, depth,
    n_docs)``."""
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    return ("strict-threshold", _tree_kernels(
        kdir, os.path.join(ROOT, "build", "planted-k5"), names=("fused_topk_quantized",),
        edits=[K5_STRICT])["fused_topk_gathered_quantized"])


def check_quantized(dev, planted=None, planted_k5=None) -> dict:
    """K4 and K5 against their plain versions on the card; on each case of
    a kind in PLANTED also the copy of K4 with that fault (``planted``, from
    build_planted, built here if not given), and on each K5 "ties-top" case
    the copy of K5 with K5_STRICT (``planted_k5``, from build_planted_k5,
    likewise), each of which must fail the same comparison."""
    import types

    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import (
        fused_topk_gathered_quantized,
        fused_topk_quantized,
    )

    gen = torch.Generator(device=dev).manual_seed(2)
    k4, k5 = quantized_cases()
    planted = planted or build_planted()
    copy_k5, strict_k5 = planted_k5 or build_planted_k5()
    worst = {}
    for kind, bits, group, qdt, b, n, t, depth, filt_kind, n_docs in k4:
        q, docs, scale = _quantized_inputs(kind, bits, group, qdt, b, n, t, gen, dev)
        filt = None
        if filt_kind == "shared":
            filt = torch.rand((n,), generator=gen, device=dev) < 0.3
        elif filt_kind == "per-query":
            filt = torch.rand((b, n), generator=gen, device=dev) < 0.05
        got = fused_topk_quantized(q, docs, scale, depth, bits, group, filt=filt, n_docs=n_docs)
        torch.cuda.synchronize()
        nd = n if n_docs is None else n_docs
        want = ref.quantized_topk_ref(q, docs, scale, min(depth + 1, nd), bits, group, filt,
                                      n_docs)
        name = (f"K4 {kind} int{bits} g{group} {qdt} B={b} N={n} T={t} depth={depth} "
                f"filt={filt_kind} n_docs={n_docs}")
        err = compare(name, got, want, exact=kind not in ("float", "wide"))
        key = f"K4 {kind}"
        worst[key] = max(worst.get(key, 0.0), err)
        print(f"  ok  {name}  max_abs_err={err:.3g}")
        if kind in planted:
            copy, topk = planted[kind]
            bad = topk(q, types.SimpleNamespace(q=docs, scale=scale, bits=bits, group=group),
                       depth)
            # Held to the near-tie rule even where the kernel is held bit for bit.
            try:
                compare(f"{name}, {copy} copy", bad, want, exact=False)
            except AssertionError as fault:
                print(f"  ok  the {copy} copy fails: {fault}")
            else:
                raise AssertionError(f"{name}: the {copy} copy passed the comparison")
    for kind, bits, group, qdt, b, n, r, t, depth, how, with_filt, n_docs in k5:
        q, docs, scale = _quantized_inputs(kind, bits, group, qdt, b, n, t, gen, dev)
        scores = ref.quantized_scores_ref(q, docs, scale, bits, group) if how == "bound" else None
        ids = _row_ids(how, b, n, r, gen, dev, scores)
        del scores
        filt = torch.rand((b, r), generator=gen, device=dev) < 0.5 if with_filt else None
        nd = n if n_docs is None else n_docs
        got = fused_topk_gathered_quantized(q, docs, scale, ids, depth, nd, bits, group,
                                            filt=filt)
        torch.cuda.synchronize()
        want = ref.quantized_gathered_topk_ref(q, docs, scale, ids, min(depth + 1, r), nd, bits,
                                               group, filt)
        name = (f"K5 {kind} int{bits} g{group} {qdt} B={b} N={n} R={r} T={t} depth={depth} "
                f"ids={how} filt={with_filt} n_docs={n_docs}")
        err = compare(name, got, want, exact=kind != "float")
        key = f"K5 {kind}"
        worst[key] = max(worst.get(key, 0.0), err)
        print(f"  ok  {name}  max_abs_err={err:.3g}")
        if kind == "ties-top":
            bad = strict_k5(q, types.SimpleNamespace(q=docs, scale=scale, bits=bits, group=group),
                            ids, depth, nd)
            try:
                compare(f"{name}, {copy_k5} copy", bad, want, exact=True)
            except AssertionError as fault:
                print(f"  ok  the {copy_k5} copy fails: {fault}")
            else:
                raise AssertionError(f"{name}: the {copy_k5} copy passed the comparison")
    print(f"quantized kernels vs plain on the card: {len(k4)} K4 and {len(k5)} K5 cases, "
          f"worst {worst}")
    return worst


def compare_dense(name, got, want, exact: bool, tol: float = TOL) -> float:
    """Hold a kernel's dense output against the plain version's.  Exact:
    bit-equal.  Else, row by row (the last dimension: a query's scores, or
    one attention output row), so that a row of small values is held to its
    own scale and not to the largest in the output: each element within
    rtol = ``tol`` and atol = ``tol`` times the row's largest |want|, and
    the row's error norm within ``tol / 2`` of its norm (a whole row a few
    ``tol`` off).  Returns the largest difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype}, want "
                             f"{tuple(want.shape)} {want.dtype}")
    if not got.numel():
        return 0.0
    g, w = got.float(), want.float()
    diff = (g - w).abs_()
    err = float(diff.max())
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-exact (max err {err})")
        return err
    rows = float((torch.linalg.vector_norm(diff, dim=-1)
                  - tol / 2 * torch.linalg.vector_norm(w, dim=-1)).max())
    allowed = w.abs().mul_(tol).add_(tol * w.abs().amax(dim=-1, keepdim=True))
    excess = float(diff.sub_(allowed).max())  # NaN where either side is NaN
    if not (excess <= 0 and rows <= 0):
        raise AssertionError(f"{name}: differs by up to {err}, {excess:.3g} past an element's "
                             f"limit, a row's error norm {rows:.3g} past its limit (tol {tol})")
    return err


def dense_cases():
    """(kernel, kind, B, N, T) for check_dense: every kernel at aligned and
    unaligned B / N / T, B = 1 and N = 1, several query tiles; int8 over
    its whole range and at its extremes; lsh with sentinels on both sides;
    K7 at the edges of its 128-query x 256-doc tile, of its 64 x 64 warp
    tiles and of its 128-doc halves (B = 127, 128, 129 and 256; N = 127,
    128, 129, 255, 256, 257) and of its chunks (32 bf16 columns: T = 63,
    64, 65, 127, 128, 129; 64 int8 columns: T = 127, 128, 129), and at T =
    600, whose last chunk ends inside a k-step after more chunks than the
    ring has stages (int8 rows of 600 bytes: the ring of 8-byte copies);
    rows that the ring takes across the same edges (T a multiple of 8: the
    edges above are rows of 1 or 2 bytes' alignment, for the register
    loader); operands 1 byte (int8) or 2 bytes (bf16) past 16 (the register
    loader); K6 at the edges of its 128-query x 128-doc tile, of its
    8-column k-steps and 16-column chunks, of its loaders and of its
    resident queries (see the comment below)."""
    cases = []
    for b, n, t in ((4, 64, 32), (3, 513, 257), (8, 300, 100), (70, 1000, 600), (1, 1, 600),
                    (1, 3000, 300), (300, 2000, 64), (65, 129, 601)):
        cases += [("score_matmul", "bf16", b, n, t), ("score_matmul", "int8", b, n, t),
                  ("score_matmul", "int8/int32", b, n, t), ("cosine_scores", "f32", b, n, t),
                  ("lsh_match_scores", "lsh", b, n, t)]
    cases += [("score_matmul", "int8-extremes", 5, 700, 600),
              ("score_matmul", "int8-extremes/int32", 67, 300, 603),
              ("lsh_match_scores", "lsh-sentinels", 6, 700, 300)]
    for kinds, ts in ((("bf16",), (63, 64, 65, 127, 128, 129, 600)),
                      (("int8", "int8/int32"), (127, 128, 129, 600))):
        for j, t in enumerate(ts):
            for i, b in enumerate((127, 128, 129, 256)):
                cases += [("score_matmul", kind, b, (127, 255, 128, 256, 129, 257)[(i + j) % 6],
                           t) for kind in kinds]
    for kinds, ts in ((("bf16",), (56, 72, 136, 200, 328)),
                      (("int8", "int8/int32"), (120, 136, 392, 584))):
        for t in ts:
            cases += [("score_matmul", kind, b, n, t) for b, n in ((129, 127), (256, 257))
                      for kind in kinds]
    cases += [("score_matmul", "int8-extremes", 129, 129, 600),
              ("score_matmul", "int8-extremes/int32", 256, 128, 600),
              ("score_matmul", "int8-unaligned", 129, 129, 600),
              ("score_matmul", "int8-unaligned/int32", 256, 127, 600),
              ("score_matmul", "bf16-unaligned", 129, 128, 600)]
    # K6 at the edges of its 128 x 128 tile (B, N = 127..129, 255..257) and
    # of its 8-column k-steps and 16-column chunks (T = 15..17, 31..33), with
    # rows 4-byte aligned (T = 257: the register loader), 8-byte (T = 258)
    # and 16-byte (the rest: the ring, whose last chunk is partial after more
    # chunks than it has stages at T = 300, 321, 385 and 600), the queries
    # resident up to 384 columns (T = 320, 321, 384) and streamed past it
    # (T = 385, 600); rows 4 bytes off 16 (the register loader); and unit
    # rows at the cosine's T = 300 and B >= 129, which the copy without the
    # doc's low tf32 part (K6_DOC_HI_ONLY) must fail.
    for j, t in enumerate((15, 16, 17, 31, 32, 33, 257, 258, 300, 320, 321, 384, 385, 600)):
        cases += [("cosine_scores", "f32", b, (127, 255, 128, 256, 129, 257)[(i + j) % 6], t)
                  for i, b in enumerate((127, 129, 256))]
    cases += [("cosine_scores", "f32-unaligned", b, n, t)
              for b, n, t in ((129, 127, 16), (129, 257, 300), (256, 129, 600))]
    cases += [("cosine_scores", "unit-f32", b, n, 300) for b, n in ((129, 1000), (256, 3000))]
    # K8 at the edges of its plan (lsh_match_plan, 132 SMs x 2 blocks): the
    # query tiles of 1, 2, 4 and 8 rows at B <= 8 (B = 5: three padded rows)
    # and of 64 from B = 9 (B = 65: one row in the second); N at the doc
    # tiles' edges (128 docs at 64 queries, 256 below), at the splits'
    # (B = 1 and 8: 264 splits of one tile up to N = 67,584, of two past it;
    # B = 256: 66 splits of one tile up to N = 8,448), past them (whole
    # splits and a partial last one) and N = 1; S of 1, 3, 4, 37 and 1,500
    # (rows of 4 bytes, 12, 16, 148 and 6,000: 4-byte copies at S = 1, 3
    # and 37, one 4-slot step at S = 4, 47 chunks at the paper's b = 50, h =
    # 30); "lsh-unaligned": rows 4 bytes off 16 at S = 300 (4-byte copies);
    # "lsh-full": queries that are doc rows without sentinels (counts reach
    # S); "lsh-empty": all-sentinel queries (every count 0); "lsh-pad":
    # slots of 0xFFFFFFFE on both sides (they count) beside sentinels on
    # both sides (they do not).
    for b, n, t in ((1, 1, 300), (1, 255, 300), (1, 257, 37), (1, 67_584, 300),
                    (1, 67_585, 300), (1, 300_001, 4), (2, 256, 300), (2, 1, 3), (2, 513, 1),
                    (5, 513, 300), (5, 1, 1), (5, 1_000, 1_500), (8, 67_585, 300), (8, 256, 4),
                    (9, 127, 300), (9, 1, 37), (64, 128, 300), (64, 8_449, 3), (65, 129, 300),
                    (65, 1, 1_500), (256, 8_448, 300), (256, 8_449, 300), (256, 1, 300),
                    (256, 20_001, 37), (256, 3_000, 1_500)):
        cases.append(("lsh_match_scores", "lsh", b, n, t))
    cases += [("lsh_match_scores", kind, b, n, t)
              for kind in ("lsh-unaligned", "lsh-full", "lsh-empty", "lsh-pad")
              for b, n, t in ((1, 1_000, 300), (8, 513, 300), (65, 1_000, 300), (9, 300, 1_500))]
    return cases


def _off_16(x, offset: int):
    """A contiguous copy of ``x`` whose data start ``offset`` bytes past 16."""
    nbytes = x.numel() * x.element_size()
    buf = torch.empty(nbytes + offset, dtype=torch.uint8, device=x.device)
    y = buf[offset:].view(x.dtype).view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == offset and y.is_contiguous()
    return y


def _dense_inputs(kind: str, b: int, n: int, t: int, gen, dev):
    """Operands of one dense case (cosine: unit queries, raw rows and their
    inverse norms as the third, "unit-f32" unit rows; "-unaligned": the
    operands off 16 bytes, by 1 (int8), 2 (bf16) or 4 (f32))."""
    if "-unaligned" in kind:
        q, d, inv = _dense_inputs(kind.replace("-unaligned", ""), b, n, t, gen, dev)
        off = q.element_size()
        return _off_16(q, off), _off_16(d, off), inv
    if kind.startswith("int8"):
        if "extremes" in kind:  # -128 and 127 everywhere: sums up to T * 2**14
            q = torch.where(torch.rand((b, t), generator=gen, device=dev) < 0.5, -128, 127)
            d = torch.where(torch.rand((n, t), generator=gen, device=dev) < 0.5, -128, 127)
            return q.to(torch.int8), d.to(torch.int8), None
        return tuple(torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                     for shape in ((b, t), (n, t))) + (None,)
    if kind == "lsh-unaligned":  # rows 4 bytes off 16: 4-byte copies
        q, d, _ = _dense_inputs("lsh", b, n, t, gen, dev)
        return _off_16(q, 4), _off_16(d, 4), None
    if kind in ("lsh-empty", "lsh-full"):
        d = torch.randint(-1 if kind == "lsh-empty" else 0, 7, (n, t), generator=gen, device=dev,
                          dtype=torch.int32)
        if kind == "lsh-empty":  # all-sentinel queries: every count 0
            q = torch.full((b, t), -1, device=dev, dtype=torch.int32)
        else:  # doc rows without sentinels: counts up to S
            q = d[torch.randint(0, n, (b,), generator=gen, device=dev)].clone()
        return q.view(torch.uint32), d.view(torch.uint32), None
    if kind == "lsh-pad":  # 0xFFFFFFFE on both sides counts; sentinels on both sides do not
        d = torch.randint(0, 3, (n, t), generator=gen, device=dev, dtype=torch.int32)
        d[:, ::4] = -2
        d[:, 1::5] = -1
        q = d[torch.randint(0, n, (b,), generator=gen, device=dev)].clone()
        q[:, 2::7] = -1  # query-only sentinels too
        return q.view(torch.uint32), d.view(torch.uint32), None
    if kind.startswith("lsh"):
        q, d = _inputs("lsh", b, n, t, gen, dev)
        if kind == "lsh-sentinels":  # doc sentinels, some where the query's are, and sentinel - 1
            d.view(torch.int32)[:, ::3] = -1
            d.view(torch.int32)[:, 1::7] = -2
        return q, d, None
    if kind == "bf16":
        return _inputs("bf16", b, n, t, gen, dev) + (None,)
    if kind == "unit-f32":
        q, d = _inputs("unit-f32", b, n, t, gen, dev)
        return q, d, 1.0 / d.norm(dim=1)
    q = torch.randn((b, t), generator=gen, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    d = torch.randn((n, t), generator=gen, device=dev)
    d *= 10 * torch.rand((n, 1), generator=gen, device=dev) + 0.01
    return q, d, 1.0 / d.norm(dim=1)


# K7's planted fault: the ring skips the copies past T instead of
# zero-filling them, so a stage keeps there the bytes of the chunk it held
# before.  Every ring case (q and doc rows 8-byte aligned) whose last chunk
# ends inside the chunk after more chunks than the ring's K7_STAGES must
# fail with it: it shows that those cases can see stale bytes in the sums
# (the resident queries' chunks come through the same ring first).
K7_RING_SKIPS_PAST_T = ("    const bool ok = row_ok && eh < T;\n",
                        "    if (eh >= T) continue;\n    const bool ok = row_ok && eh < T;\n")
K7_STAGES = 4
K7_CHUNK_COLS = {torch.bfloat16: 32, torch.int8: 64}


def build_planted_k7():
    """(name, score): K7 built from a copy of this tree's source with
    K7_RING_SKIPS_PAST_T (``_score_matmul_kernel``), called as
    ``score(q, docs, out_dtype)``."""
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    out_dir = os.path.join(ROOT, "build", "planted-k7")
    return ("ring-skips-past-T", _score_matmul_kernel(kdir, out_dir, [K7_RING_SKIPS_PAST_T]))


# K6's planted fault: the split-TF32 product over f32 rows without the
# doc's low tf32 part (q hi x doc lo), so each doc value keeps ~1e-3 of its
# bits.  Every "unit-f32" case of check_dense (unit rows at the cosine's T =
# 300) must fail with it, which shows that those cases can see a doc cut to
# tf32.
K6_DOC_HI_ONLY = ("    mma_tf32(c, q_hi, b[2], b[3]);  // q hi x doc lo\n", "")


def _cosine_kernel(kdir: str, out_dir: str, edits=()):
    """K6 built from ``cosine_score.cu`` of the kernels directory ``kdir`` of
    some tree (``_library_copy``, with ``edits``) and called through that
    tree's own C signature (``_c_entry``).  Returns ``score(q, docs,
    inv_norm)``, which raises if the launch fails."""
    from repro_torch.kernels import common

    lib, text = _library_copy(kdir, "cosine_score", out_dir, edits)
    launch = _c_entry(lib, text, "cosine_scores_launch")

    def score(q, docs, inv_norm):
        out = torch.empty((q.shape[0], docs.shape[0]), dtype=torch.float32, device=q.device)
        err = launch(q=q.data_ptr(), docs=docs.data_ptr(), inv_norm=inv_norm.data_ptr(),
                     out=out.data_ptr(), B=q.shape[0], N=docs.shape[0], T=q.shape[1],
                     q_align=common.row_alignment(q), d_align=common.row_alignment(docs),
                     stream=torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"cosine_scores_launch of {kdir} failed: cudaError {err}")
        return out

    return score


def build_planted_k6():
    """(name, score): K6 built from a copy of this tree's sources with
    K6_DOC_HI_ONLY (``_cosine_kernel``), called as ``score(q, docs,
    inv_norm)``."""
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    return ("doc-hi-only", _cosine_kernel(kdir, os.path.join(ROOT, "build", "planted-k6"),
                                          [K6_DOC_HI_ONLY]))


def check_dense(dev, planted=None, planted_k6=None, planted_k8=None) -> dict:
    """K6 ``cosine_scores``, K7 ``score_matmul`` and K8 ``lsh_match_scores``
    against their plain versions on the card; on each K7 case that the ring
    takes with a partial last chunk after more than K7_STAGES chunks also
    the copy with a planted fault (``planted``, from build_planted_k7, built
    here if not given), on each K6 "unit-f32" case the copy of K6
    without the doc's low tf32 part (``planted_k6``, from
    build_planted_k6, built here if not given), and on the K8
    "lsh-sentinels" case the copy of K8 without the sentinel test
    (``planted_k8``, from build_planted_k8, built here if not given), each
    of which must fail the same comparison."""
    from repro_torch.kernels import common
    from repro_torch.kernels.cosine_score import ref as cosine_ref
    from repro_torch.kernels.cosine_score.kernel import cosine_scores
    from repro_torch.kernels.fakewords_score import ref as fw_ref
    from repro_torch.kernels.fakewords_score.kernel import score_matmul
    from repro_torch.kernels.lsh_match import ref as lsh_ref
    from repro_torch.kernels.lsh_match.kernel import lsh_match_scores

    gen = torch.Generator(device=dev).manual_seed(3)
    copy, bad_score = planted or build_planted_k7()
    copy_k6, bad_cosine = planted_k6 or build_planted_k6()
    copy_k8, bad_counts = planted_k8 or build_planted_k8()
    cases = dense_cases()
    worst, n_planted, n_planted_k6, n_planted_k8 = {}, 0, 0, 0
    for kernel, kind, b, n, t in cases:
        q, d, inv = _dense_inputs(kind, b, n, t, gen, dev)
        out = torch.int32 if kind.endswith("/int32") else torch.float32
        if kernel == "score_matmul":
            got, want = score_matmul(q, d, out), fw_ref.score_matmul_ref(q, d, out)
        elif kernel == "cosine_scores":
            got, want = cosine_scores(q, d, inv), cosine_ref.cosine_scores_ref(q, d, inv)
        else:
            got, want = lsh_match_scores(q, d), lsh_ref.lsh_match_scores_ref(q, d)
        torch.cuda.synchronize()
        name = f"{kernel} {kind} B={b} N={n} T={t}"
        exact = kernel != "cosine_scores" and not kind.startswith("bf16")
        err = compare_dense(name, got, want, exact=exact)
        key = f"{kernel} {kind}"
        worst[key] = max(worst.get(key, 0.0), err)
        print(f"  ok  {name}  max_abs_err={err:.3g}")
        if kind == "unit-f32":
            n_planted_k6 += 1
            try:
                compare_dense(f"{name}, {copy_k6} copy", bad_cosine(q, d, inv), want, exact=False)
            except AssertionError as fault:
                print(f"  ok  the {copy_k6} copy of K6 fails: {fault}")
            else:
                raise AssertionError(f"{name}: the {copy_k6} copy passed the comparison")
        if kind == "lsh-sentinels":
            n_planted_k8 += 1
            try:
                compare_dense(f"{name}, {copy_k8} copy", bad_counts(q, d), want, exact=True)
            except AssertionError as fault:
                print(f"  ok  the {copy_k8} copy of K8 fails: {fault}")
            else:
                raise AssertionError(f"{name}: the {copy_k8} copy passed the comparison")
        cols = K7_CHUNK_COLS.get(q.dtype)
        if (kernel == "score_matmul" and t % cols and -(-t // cols) > K7_STAGES
                and min(common.row_alignment(q), common.row_alignment(d)) >= 8):
            n_planted += 1
            try:
                compare_dense(f"{name}, {copy} copy", bad_score(q, d, out), want, exact=exact)
            except AssertionError as fault:
                print(f"  ok  the {copy} copy fails: {fault}")
            else:
                raise AssertionError(f"{name}: the {copy} copy passed the comparison")
    if n_planted == 0 or n_planted_k6 == 0 or n_planted_k8 == 0:
        raise AssertionError("no dense case exercises K7's ring past T, K6's doc low part or "
                             "K8's sentinel test")
    print(f"dense score kernels vs plain on the card: {len(cases)} cases ({n_planted} also "
          f"failed by the {copy} copy of K7, {n_planted_k6} by the {copy_k6} copy of K6, "
          f"{n_planted_k8} by the {copy_k8} copy of K8), worst {worst}")
    return worst


ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


# K9's planted faults: copies of the f32 kernel without q hi x k lo (each
# key cut to tf32, ~5e-4 of its bits) and without p lo x v hi (each
# probability cut to tf32).  Each must fail at least one f32 case of
# check_attention, which shows that those cases can see a dropped product
# of the split.
K9_F32_K_HI_ONLY = (
    "          mma_tf32(s[j + u], q_hi, kl[2 * u], kl[2 * u + 1]);  // q hi x k lo\n", "")
K9_F32_P_HI_ONLY = ("          mma_tf32(acc[4 * c + i], p_lo, v0[i], v1[i]);  // p lo x v hi\n", "")


def build_planted_k9() -> dict:
    """{name: attn}: K9 built from copies of this tree's source with
    K9_F32_K_HI_ONLY and with K9_F32_P_HI_ONLY (``_attention_kernel``),
    called as ``attn(q, k, v)``; both nvcc at once."""
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    with ThreadPoolExecutor() as pool:
        built = {name: pool.submit(_attention_kernel, kdir,
                                   os.path.join(ROOT, "build", f"planted-k9-{name}"), [edit])
                 for name, edit in (("k-hi-only", K9_F32_K_HI_ONLY),
                                    ("p-hi-only", K9_F32_P_HI_ONLY))}
        return {name: fut.result() for name, fut in built.items()}


def attention_cases():
    """(dtype, B, Hq, Hkv, S, D) for check_attention: every head width at
    S = 1, 130 and 4096 in both dtypes, MHA, GQA group 2 and MQA in turn;
    the edges of the kernels' 64-key and 128-row tiles (S = 63, 64, 65,
    127, 128, 129) in both dtypes, every head width in turn; GQA group 7
    (deepseek-coder-33b's) on one KV head at S = 4096 in both dtypes; and
    deepseek-coder-33b's 56 / 8 heads at S = 4096."""
    heads = ((4, 4), (4, 2), (8, 1))
    cases = []
    for d in (32, 64, 96, 128):
        for s in (1, 130, 4096):
            for dtype in (torch.float32, torch.bfloat16):
                hq, hkv = heads[len(cases) % 3]
                cases.append((dtype, 2 if s == 130 else 1, hq, hkv, s, d))
    for i, s in enumerate((63, 64, 65, 127, 128, 129)):
        for dtype in (torch.float32, torch.bfloat16):
            hq, hkv = heads[i % 3]
            cases.append((dtype, 2, hq, hkv, s, (32, 64, 96, 128)[i % 4]))
    cases += [(dtype, 1, 7, 1, 4096, 128) for dtype in (torch.float32, torch.bfloat16)]
    cases.append((torch.bfloat16, 1, 56, 8, 4096, 128))
    return cases


def _qkv(dtype, b: int, hq: int, hkv: int, s: int, d: int, gen, dev):
    return tuple(torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
                 for h in (hq, hkv, hkv))


def check_attention(dev, planted=None) -> dict:
    """K9 ``flash_attention`` against its plain version on the card; on
    each f32 case also the copies of the f32 kernel with a planted fault
    (``planted``, from build_planted_k9, built here if not given), each of
    which must fail at least one f32 case."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention

    planted = planted or build_planted_k9()
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = attention_cases()
    worst, failed = {}, dict.fromkeys(planted, 0)
    for dtype, b, hq, hkv, s, d in cases:
        q, k, v = _qkv(dtype, b, hq, hkv, s, d, gen, dev)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        name = f"flash_attention {str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} S={s} D={d}"
        want = ref.attention_ref(q, k, v)
        err = compare_dense(name, got, want, exact=False, tol=ATTN_TOL[dtype])
        worst[str(dtype)[6:]] = max(worst.get(str(dtype)[6:], 0.0), err)
        print(f"  ok  {name}  max_abs_err={err:.3g}")
        if dtype != torch.float32:
            continue
        for copy, attn in planted.items():
            try:
                compare_dense(f"{name}, {copy} copy", attn(q, k, v), want, exact=False,
                              tol=ATTN_TOL[dtype])
            except AssertionError as fault:
                failed[copy] += 1
                print(f"  ok  the {copy} copy of the f32 kernel fails: {fault}")
    print(f"flash_attention vs plain on the card: {len(cases)} cases, worst {worst}; f32 cases "
          f"failed by the planted copies: {failed}")
    if not all(failed.values()):
        raise AssertionError(f"a planted copy of the f32 kernel passed every f32 case: {failed}")
    return worst


# K9's backward (flash_attention_bwd.cu) at the training shapes: phi3-mini-3.8b's
# layer as one microbatch of the training phase gives it (B 4, S 1,024),
# deepseek-coder-33b's GQA layer (56 / 8 heads of 128) at S 2,048, every head
# width at S = 1,000 (not a multiple of the 64-key or 64-row tiles), and f32
# (split TF32) at phi3-mini's layer, S 512, at S = 1,000 and on GQA group 7.
# (name, dtype, B, Hq, Hkv, S, D); the first is the main path's shape.
ATTN_BWD_CASES = (("phi3-mini-3.8b train layer", torch.bfloat16, 4, 32, 32, 1024, 96),
                  ("deepseek-coder-33b layer", torch.bfloat16, 1, 56, 8, 2048, 128),
                  ("ragged D32", torch.bfloat16, 2, 8, 2, 1000, 32),
                  ("ragged D64", torch.bfloat16, 2, 8, 2, 1000, 64),
                  ("phi3-mini-3.8b layer f32", torch.float32, 1, 32, 32, 512, 96),
                  ("ragged D32 f32", torch.float32, 2, 8, 2, 1000, 32),
                  ("ragged D64 f32", torch.float32, 2, 8, 2, 1000, 64),
                  ("GQA 7 D128 f32", torch.float32, 1, 7, 1, 300, 128))
# The backward's tolerance: both sides compute the same formulas from the
# same out and lse in f32; the kernel's P and dS enter its bf16 products split
# into bf16 hi + lo (to 2^-16; rounded once, they miss the bf16 row rule: see
# flash_attention_bwd.cu), and both round the outputs to the dtype, so they
# sit ~1 bf16 ulp apart; its f32 products are split TF32 (each operand to
# 2^-22): K9's own row rules (ATTN_TOL) hold them.
# lse: the forward's ex2.approx sums against torch.logsumexp, within
# LSE_TOL (1 + |lse|) (measured 9.5e-7 in bf16, 3.3e-6 in f32).
LSE_TOL = 2e-5
# The planted faults: a copy of the backward whose Delta is 0 (dS = P dP),
# which every case must catch, and one whose f32 products leave out a lo x
# hi (each product's first operand rounded once to tf32: S's and dP's K, V
# or Q, dO, and P and dS in the gradients), which every f32 case must catch
# (tests/test_torch_flash_attention.py::test_bwd_tf32_kernel_needs_each_low_part
# drops each lo term alone).
K9_BWD_NO_DELTA = ("  const float delta = s;\n", "  const float delta = 0.f;\n")
K9_BWD_NO_A_LO = ("  mma_tf32(small, al, bh0, bh1);  // a lo x b hi\n", "")
K9_BWD_PLANTED = {"no-delta": ([K9_BWD_NO_DELTA], (torch.bfloat16, torch.float32)),
                  "f32 without a lo x b hi": ([K9_BWD_NO_A_LO], (torch.float32,))}


def _attention_bwd_kernel(kdir: str, out_dir: str, edits=()):
    """K9's backward built from ``flash_attention/csrc/flash_attention_bwd.cu``
    of the kernels directory ``kdir`` (``_library_copy``, with ``edits``),
    called through that tree's C signature, with this tree's plan and
    scratch (``kernel.bwd_scratch``).  Returns ``bwd(q, k, v, out, lse,
    dout) -> (dq, dk, dv)``, which raises if the launch fails."""
    from repro_torch.kernels.flash_attention.kernel import bwd_scratch

    lib, text = _library_copy(kdir, "flash_attention_bwd", out_dir, edits,
                              package="flash_attention")
    launch = _c_entry(lib, text, "flash_attention_bwd_launch")

    def bwd(q, k, v, out, lse, dout):
        b, hq, s, d = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        # This tree's plan and scratch: stats is as large as any tree's Delta
        # scratch (``delta`` before PR 39: (B, Hq, S) f32).
        hpb, stats, partial = bwd_scratch(q, k)
        err = launch(dtype={torch.float32: 0, torch.bfloat16: 1}[q.dtype], D=d, q=q.data_ptr(),
                     k=k.data_ptr(), v=v.data_ptr(), out=out.data_ptr(), dout=dout.data_ptr(),
                     lse=lse.data_ptr(), delta=stats.data_ptr(), stats=stats.data_ptr(),
                     partial=None if partial is None else partial.data_ptr(), dq=dq.data_ptr(),
                     dk=dk.data_ptr(), dv=dv.data_ptr(), B=b, Hq=hq, Hkv=k.shape[1], S=s,
                     heads_per_block=hpb, stream=torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd_launch of {kdir} failed: cudaError {err}")
        return dq, dk, dv

    return bwd


def build_planted_k9_bwd() -> dict:
    """{name: bwd}: K9's backward built from copies of this tree's source with
    each of K9_BWD_PLANTED's edits (``_attention_bwd_kernel``, both nvcc at
    once)."""
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    with ThreadPoolExecutor() as pool:
        built = {name: pool.submit(_attention_bwd_kernel, kdir,
                                   os.path.join(ROOT, "build", "planted-k9-bwd", str(j)), edits)
                 for j, (name, (edits, _)) in enumerate(K9_BWD_PLANTED.items())}
        return {name: fut.result() for name, fut in built.items()}


def compare_attention_grads(name, got, want, tol: float) -> float:
    """Hold (dq, dk, dv) to the plain version's: dk and dv row by row
    (``compare_dense``); dq too, except its row 0, which is zero in exact
    arithmetic (query 0 attends to key 0 alone: its probability is 1 and dP
    equals Delta), so each side gives its own rounding noise there: held
    within ``tol`` of the largest |dq| of its (batch, head).  Returns the
    largest difference."""
    err = compare_dense(f"{name} dq", got[0][..., 1:, :], want[0][..., 1:, :], exact=False,
                        tol=tol)
    row0 = got[0][..., 0, :].float().abs().amax(dim=-1)
    scale = want[0].float().abs().amax(dim=(-1, -2))
    if not bool((row0 <= tol * scale).all()):
        raise AssertionError(f"{name} dq row 0: {float(row0.max()):.3g} past {tol} of its head's "
                             f"largest |dq|")
    for label, g, w in (("dk", got[1], want[1]), ("dv", got[2], want[2])):
        err = max(err, compare_dense(f"{name} {label}", g, w, exact=False, tol=tol))
    return max(err, float(row0.max()))


def attention_bwd_bound_ms(q, k, kind: str, passes: int = 1):
    """Bound of one backward call: q, k, v, out, dout and lse read once, dq,
    dk and dv written once; ``passes`` x five products of 2 D operations per
    unmasked (query, key) pair, 2.5 x the forward's causal operations
    ("tf32" with 3 passes for the f32 kernels' split TF32; "f32" for the
    same products as CUDA-core FMA)."""
    b, hq, s, d = q.shape
    nbytes = (4 * q.numel() + 2 * k.numel()) * q.element_size() + 4 * b * hq * s * 4
    return _bound(nbytes, passes * 2.5 * 4.0 * b * hq * d * s * (s + 1) / 2, kind)


def _bwd_bound(q, k):
    """The backward's bound at its own products (bf16; f32: split TF32)."""
    return (attention_bwd_bound_ms(q, k, "bf16") if q.dtype == torch.bfloat16
            else attention_bwd_bound_ms(q, k, "tf32", passes=3))


def _sdpa_grad_ms(q, k, v, dout, subtracted: bool = False) -> tuple:
    """(forward ms, backward ms) of scaled_dot_product_attention
    (is_causal=True) on copies of q, k, v that require gradients: the
    backward alone, ``torch.autograd.grad`` of one output of the forward,
    which runs once outside the timed region (its graph retained).  The
    flash backend in bf16 (GQA by ``enable_gqa``); in f32, which flash does
    not take, the memory-efficient one, which takes no GQA, so there K and
    V are repeated to the query heads in the forward (``repeat_interleave``,
    whose backward sums the group's gradients).  With ``subtracted`` a third
    reading, the yardstick before PR 39: forward and backward timed together
    minus the forward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    group = q.shape[1] // k.shape[1]
    flash = q.dtype == torch.bfloat16

    def fwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION if flash else SDPBackend.EFFICIENT_ATTENTION):
            if flash or group == 1:
                return torch.nn.functional.scaled_dot_product_attention(
                    qg, kg, vg, is_causal=True, enable_gqa=group > 1)
            return torch.nn.functional.scaled_dot_product_attention(
                qg, kg.repeat_interleave(group, 1), vg.repeat_interleave(group, 1), is_causal=True)

    out = fwd()
    bwd_ms = timed(lambda: torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True))[0]
    fwd_ms = timed(fwd)[0]
    if not subtracted:
        return fwd_ms, bwd_ms
    return fwd_ms, bwd_ms, timed(lambda: torch.autograd.grad(fwd(), (qg, kg, vg), dout))[0] - fwd_ms


def attention_bwd_row(q, k, v, dout, label: str, card: str, extra=None) -> dict:
    """K9's forward with lse and its backward on q, k, v, dout (on the card)
    held and timed: the forward's output against ``attention_fwd_ref``'s
    (``compare_dense`` at ATTN_TOL) and bit-equal to ``flash_attention``'s,
    its lse within LSE_TOL of the plain version's;
    dq, dk and dv against ``attention_bwd_ref`` on the kernel's own out and
    lse (``compare_attention_grads`` at ATTN_TOL), bit-equal over two
    launches; ``extra(out, lse, want)`` then runs on them (the planted
    copies).  Times the backward, its plain version, the library's backward
    (SDPA, ``_sdpa_grad_ms``) and the bound (f32: split TF32, with the
    CUDA-core FMA bound beside it); the forward with lse, its plain version
    and SDPA's forward.  Returns {"err", "fwd_err", "lse_err", "ms", "plain_ms",
    "library_ms", "bound", "fwd_ms", "fwd_plain_ms", "fwd_library_ms",
    "fwd_bound"}."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import (flash_attention, flash_attention_bwd,
                                                            flash_attention_fwd)

    dtype = q.dtype
    out, lse = flash_attention_fwd(q, k, v)
    same = torch.equal(out, flash_attention(q, k, v))
    want_out, want_lse = ref.attention_fwd_ref(q, k, v)
    fwd_err = compare_dense(f"K9 forward with lse {label}", out, want_out, exact=False,
                            tol=ATTN_TOL[dtype])
    lse_err = float(((lse - want_lse).abs() / (1 + want_lse.abs())).max())
    del want_out, want_lse
    if not same or not lse_err <= LSE_TOL:
        raise AssertionError(f"K9 forward with lse, {label}: output equal to the plain "
                             f"entry's {same}, lse off by {lse_err:.3g} (1 + |lse|)")
    got = flash_attention_bwd(q, k, v, out, lse, dout)
    again = flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"K9 backward, {label}: two launches differ")
    want = ref.attention_bwd_ref(q, k, v, out, lse, dout)
    err = compare_attention_grads(f"K9 backward {label}", got, want, ATTN_TOL[dtype])
    if extra is not None:
        extra(out, lse, want)
    del got, again, want
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    ms, plain_ms = (timed(fn)[0] for fn in (
        lambda: flash_attention_bwd(q, k, v, out, lse, dout),
        lambda: ref.attention_bwd_ref(q, k, v, out, lse, dout)))
    fwd_ms, fwd_plain_ms = (timed(fn)[0] for fn in (
        lambda: flash_attention_fwd(q, k, v), lambda: ref.attention_fwd_ref(q, k, v)))
    lib_fwd, lib_bwd = _sdpa_grad_ms(q, k, v, dout)
    fwd_bound = attention_bound_ms(q, k, v, "bf16" if kind == "bf16" else "tf32",
                                   passes=1 if kind == "bf16" else 3)
    fma = "" if kind == "bf16" else (
        f", CUDA-core FMA bound {attention_bwd_bound_ms(q, k, 'f32')[0]:.4f} ms")
    r = {"err": err, "fwd_err": fwd_err, "lse_err": lse_err, "ms": ms, "plain_ms": plain_ms,
         "library_ms": lib_bwd, "bound": _bwd_bound(q, k), "fwd_ms": fwd_ms,
         "fwd_plain_ms": fwd_plain_ms, "fwd_library_ms": lib_fwd, "fwd_bound": fwd_bound}
    print(f"  ok  K9 backward {label}: max_abs_err {err:.3g} (row rule {ATTN_TOL[dtype]}, dq "
          f"row 0 at its head's scale), forward output max_abs_err {fwd_err:.3g} against the "
          f"plain version's, lse within {lse_err:.3g} (1 + |lse|), bit-equal over "
          f"two launches; on {card}: backward {ms:.3f} ms, bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}){fma}, plain {plain_ms:.3f}, SDPA backward (autograd.grad alone) "
          f"{r['library_ms']:.3f}; forward with lse {fwd_ms:.3f} ms, bound "
          f"{fwd_bound[0]:.3f} ({fwd_bound[1]}), plain {fwd_plain_ms:.3f}, SDPA forward "
          f"{lib_fwd:.3f}")
    return r


def check_attention_bwd(dev, card: str, planted=None) -> dict:
    """K9's forward with lse and its backward at ATTN_BWD_CASES on the card
    (``attention_bwd_row``); each planted copy (``build_planted_k9_bwd``)
    must fail every case of its dtypes (K9_BWD_PLANTED).  Returns {case
    name: ``attention_bwd_row``'s row}."""
    planted = planted or build_planted_k9_bwd()
    gen = torch.Generator(device=dev).manual_seed(37)
    rows, failed = {}, dict.fromkeys(planted, 0)
    for name, dtype, b, hq, hkv, s, d in ATTN_BWD_CASES:
        q, k, v = _qkv(dtype, b, hq, hkv, s, d, gen, dev)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        label = f"{name} ({_layer_label(q, k)})"

        def planted_fail(out, lse, want):
            for copy, bwd in planted.items():
                if dtype not in K9_BWD_PLANTED[copy][1]:
                    continue
                try:
                    compare_attention_grads(f"{label}, {copy} copy", bwd(q, k, v, out, lse, dout),
                                            want, ATTN_TOL[dtype])
                except AssertionError as fault:
                    failed[copy] += 1
                    print(f"  ok  the {copy} copy of the backward fails: {str(fault)[:160]}")

        rows[name] = attention_bwd_row(q, k, v, dout, label, card, planted_fail)
    want = {copy: sum(c[1] in dtypes for c in ATTN_BWD_CASES)
            for copy, (_, dtypes) in K9_BWD_PLANTED.items() if copy in planted}
    print(f"K9 backward vs plain on the card: {len(ATTN_BWD_CASES)} cases; failed by the planted "
          f"copies: {failed} (of {want})")
    if failed != want:
        raise AssertionError(f"a planted copy of the backward passed a case: {failed}, want {want}")
    return rows


def _checked(name: str, s, i, b: int, width: int, n: int, finite: bool = True) -> None:
    if s.shape != (b, width) or (finite and not bool(torch.isfinite(s).all())):
        raise AssertionError(f"{name}: bad shape {tuple(s.shape)} or non-finite scores")
    if not bool(((i >= 0) & (i < n)).all()):
        raise AssertionError(f"{name}: ids outside [0, {n})")


def _wrappers() -> tuple:
    """Every kernel wrapper of the port (each counts its launches)."""
    from repro_torch.kernels.cosine_score.kernel import cosine_scores
    from repro_torch.kernels.fakewords_score.kernel import score_matmul
    from repro_torch.kernels.flash_attention.kernel import (flash_attention, flash_attention_bwd,
                                                            flash_attention_fwd)
    from repro_torch.kernels.fused_topk import kernel
    from repro_torch.kernels.lsh_match.kernel import lsh_match_scores

    return (kernel.fused_topk, kernel.fused_topk_gathered, kernel.fused_topk_quantized,
            kernel.fused_topk_gathered_quantized, cosine_scores, score_matmul, lsh_match_scores,
            flash_attention, flash_attention_fwd, flash_attention_bwd)


def _reset_launches() -> None:
    for fn in _wrappers():
        fn.launches = 0


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def _only(path: str, kernel_name: str) -> int:
    """The launches of ``kernel_name`` since the last reset; raises unless
    it launched and no other kernel did."""
    counts = _launches()
    if counts[kernel_name] <= 0 or any(v for k, v in counts.items() if k != kernel_name):
        raise AssertionError(f"{path} did not run through {kernel_name} alone: {counts}")
    return counts[kernel_name]


def main(argv) -> int:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32 in plain versions
    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if argv[:1] == ["--capture-mode-trial"]:  # one trial, in a process of its own
        print(json.dumps(capture_mode_trial(dev, argv[1])))
        return 0
    if argv[:1] == ["--capture-modes"]:  # what another thread's copy does to a capture
        for mode in ("global", "thread_local"):
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--capture-mode-trial", mode],
                                 capture_output=True, text=True, timeout=300)
            lines = out.stdout.strip().splitlines()
            print(f"capture_error_mode={mode} (a fresh process, exit {out.returncode}; {card}): "
                  + (lines[-1] if lines else out.stderr[-600:]))
        return 0
    if argv[:1] == ["--pair-parent"]:  # K1-K5, K7 and K9 against an earlier tree's, then stop
        pair_k9(dev, card, argv[1])
        pair_k9_bwd(dev, card, argv[1])
        pair_parent(dev, card, argv[1])
        return 0
    if argv[:1] == ["--ablate"]:  # kernels with parts cut out, then stop
        ablate_k7(dev, card)
        ablate_k6(dev, card)
        ablate_k9(dev, card)
        ablate_k9_bwd(dev, card)
        build_kernels(["fused_topk", "fused_topk_quantized"])
        trees = [("this tree", ROOT)] + [("parent", d) for d in argv[1:2]]
        cell = _k2_cell(dev)
        ablate_k2(dev, card, trees, cell)
        ablate_k8(dev, card, trees, cell)
        del cell
        ablate_k3(dev, card, trees)
        ablate_k5(dev, card, trees)
        ablate_k1_f32(dev, card, trees)
        ablate(dev, card)
        return 0
    with ThreadPoolExecutor() as pool:  # the planted copies' nvcc beside the others
        planted = pool.submit(build_planted)
        planted_k1 = pool.submit(build_planted_k1)
        planted_k2 = pool.submit(build_planted_k2)
        planted_k3 = pool.submit(build_planted_k3)
        planted_k5 = pool.submit(build_planted_k5)
        planted_k7 = pool.submit(build_planted_k7)
        planted_k6 = pool.submit(build_planted_k6)
        planted_k9 = pool.submit(build_planted_k9)
        planted_k8 = pool.submit(build_planted_k8)
        planted_k9b = pool.submit(build_planted_k9_bwd)
        build_kernels()
        planted, planted_k1, planted_k2, planted_k3, planted_k5, planted_k7, planted_k6 = (
            planted.result(), planted_k1.result(), planted_k2.result(), planted_k3.result(),
            planted_k5.result(), planted_k7.result(), planted_k6.result())
        planted_k9, planted_k8 = planted_k9.result(), planted_k8.result()
        planted_k9b = planted_k9b.result()
    check_tensor_cores()
    print_k5_columns()
    print_lsh_compare_ops()
    check_kernels(dev, planted_k1, planted_k2)
    check_gathered(dev, planted_k3)
    check_quantized(dev, planted, planted_k5)
    check_dense(dev, planted_k7, planted_k6, planted_k8)
    check_attention(dev, planted_k9)
    attn_bwd = check_attention_bwd(dev, card, planted_k9b)
    check_f32_matmul(dev, card)
    from repro_torch.configs import ann_word2vec
    from repro_torch.core import eval as ev

    cell = ann_word2vec.ARCH.cell("ann_search")
    config = ann_word2vec.ARCH.make_model(cell)
    x, qx = make_inputs(dev, cell.get("n_docs"), cell.batch)
    depth, k = cell.get("depth"), cell.get("k")
    kernels, gt_i, idx, lidx, bm = drive(dev, card, x, qx, depth, k, config)
    kernels += drive_dense(dev, card, x, qx, gt_i, idx, lidx, depth, k, config)
    md, masks = make_filters(dev, x.shape[0], card)
    t0 = time.perf_counter()
    drive_filtered(dev, card, x, qx, gt_i, idx, lidx, bm, md, masks, depth, k, config)
    filtered_s = time.perf_counter() - t0
    fw_recall = float(ev.recall_at(gt_i, idx.search(qx, k=depth, depth=depth)[1]))
    del lidx, bm
    torch.cuda.empty_cache()
    drive_serve(dev, card, x, idx, config, depth, k)
    del idx
    torch.cuda.empty_cache()  # the fp32 indexes are gone: the later builds get the room
    kd_entry, kd = drive_kdtree(dev, card, x, qx, gt_i, depth, k, fw_recall)
    kernels.append(kd_entry)
    t0 = time.perf_counter()
    drive_filtered_kd(card, qx, kd, masks, depth)
    filtered_s += time.perf_counter() - t0
    drive_persistence(dev, card, x, qx, kd, config, depth, k, md)
    del kd
    torch.cuda.empty_cache()
    kernels += drive_graph(dev, card, x, qx, gt_i, depth, k, masks)
    quantized, quantized_filtered_s = drive_quantized(dev, card, x, qx, gt_i, depth, k, config,
                                                      masks)
    kernels += quantized
    torch.cuda.empty_cache()
    before_segments = drive_segments(dev, card, x, qx, depth, k, config, md)
    peak_segments = max(before_segments, torch.cuda.max_memory_allocated())
    drive_sharded(dev, card, x, qx, gt_i, depth, k, config, masks)
    kernels += drive_lm(dev, card)
    kernels += drive_train(dev, card, attn_bwd)
    kernels += drive_sharded_train(dev, card)
    kernels += drive_knn_lm(dev, card)
    peak = max(peak_segments, torch.cuda.max_memory_allocated())
    del x, qx, gt_i, md, masks  # the ANN corpus: the model phases get the card
    gc.collect()
    torch.cuda.empty_cache()
    peak = max(peak, drive_gnn(dev, card))
    rec_entries, rec_peak = drive_recsys(dev, card)
    kernels += rec_entries
    peak = max(peak, rec_peak)
    print(f"the filtered phases took {filtered_s + quantized_filtered_s:.1f} s (host clock)")
    print(f"peak device memory {peak / 1e9:.1f} GB (the whole run)")
    print(f"the whole run: {time.perf_counter() - t_run:.1f} s (host clock, the kernels' build "
          "included)")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _c_entry(lib, source: str, name: str):
    """The C entry ``name`` of ``lib``, bound with the parameter types its
    definition in ``source`` (the text of the .cu it was built from) gives,
    and called with keyword arguments named as there (extra ones are
    ignored): a tree's own signature, whatever it is."""
    import ctypes

    m = re.search(rf"^int\s+{name}\(([^)]*)\)", source, re.M)
    if m is None:
        raise ValueError(f"no definition of {name} in the source")
    names, types = [], []
    for param in m.group(1).split(","):
        typ, _, pname = " ".join(param.split()).rpartition(" ")
        typ, pname = typ + "*" * pname.count("*"), pname.lstrip("*")
        names.append(pname)
        types.append({"int": ctypes.c_int, "long long": ctypes.c_longlong,
                      "int*": ctypes.POINTER(ctypes.c_int)}.get(typ, ctypes.c_void_p))
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = types, ctypes.c_int
    return lambda **kw: fn(*(kw[n] for n in names))


def _tree_kernels(kdir: str, out_dir: str, names=("fused_topk", "fused_topk_quantized"),
                  edits=()) -> dict:
    """K1 (``fused_topk``: gemm mode, or lsh for uint32 operands), K3
    (``fused_topk_gathered``, in the same library), K4
    (``fused_topk_quantized``) and K5 (``fused_topk_gathered_quantized``,
    in K4's library), no filt, built with nvcc (in parallel) from the
    kernels directory ``kdir`` of some tree into ``out_dir`` (with the text
    ``edits`` applied to a copy of its ``fused_topk/csrc``, in every file
    that holds it; an edit that is a tuple of (old, new) pairs applies each
    pair whose old text a file holds, and at least one must be there), and
    called through their C entry points with that tree's launch plan and
    signatures (``_c_entry``).  Returns {name: topk}: K1's ``topk(q, docs,
    depth)``, K3's ``topk(q, store, row_ids, depth, n_docs)``, K4's
    ``topk(q, pq, depth)``, K5's ``topk(q, pq, row_ids, depth, n_docs)``."""
    import ctypes

    from repro_torch.kernels import common
    from repro_torch.kernels.fused_topk.kernel import alignment_bits

    csrc, shared = os.path.join(kdir, "fused_topk", "csrc"), os.path.join(kdir, "csrc")
    os.makedirs(out_dir, exist_ok=True)
    if edits:  # copies of fused_topk/csrc and of the shared headers, edited
        copy, shared_copy = os.path.join(out_dir, "csrc"), os.path.join(out_dir, "shared")
        for src, dst in ((csrc, copy), (shared, shared_copy)):
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(src, dst)
        files = [os.path.join(d, f) for d in (copy, shared_copy) for f in sorted(os.listdir(d))]
        texts = {f: open(f).read() for f in files}
        _apply_edits(texts, edits, f"fused_topk's sources in {kdir}")
        for f, text in texts.items():
            with open(f, "w") as out:
                out.write(text)
        csrc, shared = copy, shared_copy
    procs = {name: subprocess.Popen(
        [common._nvcc(), *common.NVCC_FLAGS, "-I", shared,
         "-o", os.path.join(out_dir, f"lib{name}.so"), os.path.join(csrc, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in names}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} of {kdir}:\n{log}")
        with open(os.path.join(out_dir, f"{name}.log"), "w") as f:  # ptxas -v, for ptxas_report
            f.write(log)

    def entry_points(name, entry):
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        text = open(os.path.join(csrc, f"{name}.cu")).read()
        return _c_entry(lib, text, f"{entry}_plan"), _c_entry(lib, text, f"{entry}_launch")

    def caller(name, entry, gathered):
        plan_fn, launch_fn = entry_points(name, entry)

        def run(q, docs, depth, row_ids=None, **args):
            b, t = q.shape
            plan = (ctypes.c_int * 8)()
            args.update(B=b, depth=depth, T=t, plan=plan, filt=None, filt_stride=0,
                        q=q.data_ptr(), docs=docs.data_ptr(), store=docs.data_ptr(),
                        sm_count=torch.cuda.get_device_properties(q.device).multi_processor_count,
                        stream=torch.cuda.current_stream().cuda_stream)
            args.setdefault("n_docs", docs.shape[0])
            if gathered:
                args.update(R=row_ids.shape[1], row_ids=row_ids.data_ptr())
            if plan_fn(**args) != 0:
                raise ValueError(f"{entry} of {kdir}: the plan refused the call")
            if gathered:  # (K, row splits, rows per split)
                k, splits, per = plan[:3]
                args.update(rows_per_split=per)
            else:  # (queries per block, K, N-splits, doc tiles per split, ...)
                bq, k, splits, per = plan[:4]
                args.update(bq=bq, tiles_per_split=per)
            part_s = torch.empty((splits, b, k), dtype=torch.float32, device=q.device)
            part_i = torch.empty((splits, b, k), dtype=torch.int32, device=q.device)
            out_s = torch.empty((b, depth), dtype=torch.float32, device=q.device)
            out_i = torch.empty((b, depth), dtype=torch.int32, device=q.device)
            err = launch_fn(**args, K=k, splits=splits, part_s=part_s.data_ptr(),
                            part_i=part_i.data_ptr(), out_s=out_s.data_ptr(),
                            out_i=out_i.data_ptr())
            if err != 0:
                raise RuntimeError(f"{entry}_launch of {kdir} failed: cudaError {err}")
            return out_s, out_i

        return run

    out = {}
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint32: 3}
    if "fused_topk" in names:
        k1 = caller("fused_topk", "fused_topk", False)
        k3 = caller("fused_topk", "fused_topk_gathered", True)
        # A tree that reads only the 16-byte bits of `aligned` (bits 0 and 1)
        # sees 8-byte rows as unaligned, as it did before the 8-byte bits.
        out["fused_topk"] = lambda q, docs, depth: k1(
            q, docs, depth, mode=codes[q.dtype], aligned=alignment_bits(q, docs))
        out["fused_topk_gathered"] = lambda q, store, row_ids, depth, n_docs: k3(
            q, store, depth, row_ids=row_ids, n_docs=n_docs, mode=codes[q.dtype],
            align=common.row_alignment(store))
    if "fused_topk_quantized" in names:
        k4 = caller("fused_topk_quantized", "fused_topk_quantized", False)
        k5 = caller("fused_topk_quantized", "fused_topk_gathered_quantized", True)
        out["fused_topk_quantized"] = lambda q, pq, depth: k4(
            q, pq.q, depth, qdtype=codes[q.dtype], bits=pq.bits, scale=pq.scale.data_ptr(),
            row_bytes=pq.q.shape[1], group=pq.group, n_groups=pq.scale.shape[1],
            d_align=common.row_alignment(pq.q), q_align=common.row_alignment(q))
        out["fused_topk_gathered_quantized"] = lambda q, pq, row_ids, depth, n_docs: k5(
            q, pq.q, depth, row_ids=row_ids, n_docs=n_docs, qdtype=codes[q.dtype], bits=pq.bits,
            scale=pq.scale.data_ptr(), row_bytes=pq.q.shape[1], group=pq.group,
            n_groups=pq.scale.shape[1], align=common.row_alignment(pq.q))
    return out


# Copies of the tensor-core pass 1 (csrc/mma_topk.cuh, so K1 classic's, K1
# dot's and K4's with a bf16 query alike) with a part cut out, for timing only (their
# results are wrong): without the running top-k (no candidate ever leaves
# the accumulators); without the widening of packed units too (the raw
# words are stored as they came, by either loader; K4 only: bf16 units are
# stored as they are anyway); and the loads alone (no products, no top-k).
_NO_TOPK = ("    if (chunk != n_chunks - 1) continue;\n",
            "    if (chunk != n_chunks - 1 || n_chunks > 0) continue;\n")
_NO_WIDEN = ("rows.widen(dst[i]);", "make_uint4(reinterpret_cast<const uint32_t*>(&dst[i])[0], "
             "reinterpret_cast<const uint32_t*>(&dst[i])[sizeof(dst[i]) / 4 - 1], 0, 0);")
_NO_WIDEN_RING = ("rows.widen(rows.read_raw(rd + (i * kThreads + tid) * kSlotWords));",
                  "make_uint4(rd[(i * kThreads + tid) * kSlotWords], "
                  "rd[(i * kThreads + tid) * kSlotWords + kSlotWords - 1], 0, 0);")
_NO_PRODUCTS = ("for (int ks = 0; ks < kKSteps; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {")
ABLATIONS = {
    "without the running top-k": [_NO_TOPK],
    "without the top-k and the widening": [_NO_TOPK, _NO_WIDEN, _NO_WIDEN_RING],
    "loads only": [_NO_TOPK, _NO_PRODUCTS],
}
# Copies of the split-TF32 product (K4 with an f32 query), each timed and
# held to the plain version on TF32_ACCURACY_CASE (rows of magnitude up to
# 10, small scores in the list): without the fold (the tensor cores' own
# running sum, which drifts outside the near-tie rule), without the query's
# split (the fragments go to both mma as loaded: what splitting as the query
# is staged could gain at most), and without the low part's mma (HI_ONLY:
# one tf32 pass).
TF32_ABLATIONS = {
    "no fold": [("  static constexpr bool kFold = true;", "  static constexpr bool kFold = false;")],
    "without the query split": [("      b[r] &= kTf32Bits;\n"
                                 "      b[2 + r] = __float_as_uint(x - __uint_as_float(b[r])) "
                                 "& kTf32Bits;\n",
                                 "      b[2 + r] = __float_as_uint(x);\n")],
    "hi only (one tf32 pass)": [HI_ONLY],
}
# (kind, B, N, T, depth): float rows of magnitude up to 10 with more than
# half of them in the list, so scores near 0 are held to ~1e-5.
TF32_ACCURACY_CASE = ("float", 40, 150, 600, 100)
# Copies of K4 and K1 dot with another loader (whole kernels, results
# checked): for K4 the raw-unit cp.async ring for int8 at 64-query tiles
# too (a bf16 query), or registers everywhere (fused_topk_quantized.cu picks
# per instance: for an f32 query over int8 the raw ring wherever the rows
# allow it; over int4 there is only the register loader, so both copies
# are the kernel as it is); for K1 dot registers in place of the ring of
# 8-byte copies.
LOADERS = {
    "raw ring everywhere": [("    if constexpr (BITS == 4) {\n      if (ring)",
                             "    if constexpr (true) {\n      if (ring)")],
    "registers everywhere": [("  const bool ring = d_align >= 8 && q_aligned;",
                              "  const bool ring = false;"),
                             ("  const bool ring = d_align >= 4 && q_aligned;",
                              "  const bool ring = false;"),
                             ("  const int ring = q_align < d_align ? q_align : d_align;",
                              "  const int ring = 1;")],
}


def ablate(dev, card: str) -> None:
    """The tensor-core pass 1 and its ablations (ABLATIONS) at the cell's
    shapes (2,999,808 x 600, depth 100; B = 256 and B = 1, and B = 8 for
    K1 dot and K4), timed in turns (full, each copy, full): K1 classic on
    random bf16 operands, K1 dot on a random [u; -u] int8 query over random
    term counts 0..127, K4 with a bf16 query on random int8 and int4
    (group 32) stores, and K4 with an f32 query on random int8 and int4
    (group 32) stores at the brute-force shapes (T = 300), also with
    TF32_ABLATIONS (their accuracy over both widths); K4 also against its
    two loaders and K1 dot against registers (LOADERS, results held to the
    kernel's)."""
    import types

    from repro_torch.kernels.fused_topk.kernel import fused_topk, fused_topk_quantized

    from repro_torch.kernels.fused_topk import ref

    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    copies = {**ABLATIONS, **TF32_ABLATIONS, **LOADERS}
    with ThreadPoolExecutor() as pool:  # every copy's nvcc at once
        cut = dict(zip(copies, pool.map(
            lambda j, name: _tree_kernels(
                kdir, os.path.join(ROOT, "build", "ablate", str(j)), edits=copies[name],
                names=("fused_topk_quantized",) if name in TF32_ABLATIONS else
                ("fused_topk", "fused_topk_quantized")),
            range(len(copies)), copies)))
    gen = torch.Generator(device=dev).manual_seed(6)
    kind, b, n_acc, t_acc, depth = TF32_ACCURACY_CASE
    for bits, group in ((8, 0), (4, GROUP)):
        q_acc, d_acc, s_acc = _quantized_inputs(kind, bits, group, "f32", b, n_acc, t_acc, gen,
                                                dev)
        pq_acc = types.SimpleNamespace(q=d_acc, scale=s_acc, bits=bits, group=group)
        want = ref.quantized_topk_ref(q_acc, d_acc, s_acc, depth + 1, bits, group)
        for name, fns in {"full": None, **{k: cut[k] for k in TF32_ABLATIONS}}.items():
            got = (fused_topk_quantized(q_acc, d_acc, s_acc, depth, bits, group) if fns is None
                   else fns["fused_topk_quantized"](q_acc, pq_acc, depth))
            err = float((got[0] - want[0][:, :depth]).abs().max())
            try:
                compare(name, got, want, exact=False)
                verdict = "inside the near-tie rule"
            except AssertionError as fault:
                verdict = f"outside it ({fault})"
            print(f"split-TF32 accuracy, {name}, {kind} int{bits} g{group} B={b} N={n_acc} "
                  f"T={t_acc} depth={depth}: max |score - plain| {err:.3g}, {verdict}")
    n, t = 2_999_808, 600
    q = (torch.randn((256, t), generator=gen, device=dev) / t**0.5).to(torch.bfloat16)
    docs = torch.randn((n, t), generator=gen, device=dev).to(torch.bfloat16)
    u = torch.randint(0, 128, (256, t // 2), generator=gen, device=dev)
    q_dot = torch.cat([u, -u], 1).to(torch.int8)
    t300 = 300
    q_f32 = torch.randn((256, t300), generator=gen, device=dev) / t300**0.5
    stores = {
        "K1 classic, random bf16": (None, docs),
        "K1 dot, random int8": ("dot", torch.randint(0, 128, (n, t), generator=gen, device=dev,
                                                     dtype=torch.int8)),
        "K4 int8, random bytes": (8, types.SimpleNamespace(
            bits=8, group=0, scale=torch.rand((n, 1), generator=gen, device=dev),
            q=torch.randint(-127, 128, (n, t), generator=gen, device=dev, dtype=torch.int8))),
        "K4 int4 g32, random nibbles": (4, types.SimpleNamespace(
            bits=4, group=GROUP, scale=torch.rand((n, -(-t // GROUP)), generator=gen, device=dev),
            q=torch.randint(0, 256, (n, -(-t // GROUP) * GROUP // 2), generator=gen, device=dev,
                            dtype=torch.uint8))),
        "K4 int8, f32 query, random bytes, T=300": (8, types.SimpleNamespace(
            bits=8, group=0, scale=torch.rand((n, 1), generator=gen, device=dev),
            q=torch.randint(-127, 128, (n, t300), generator=gen, device=dev, dtype=torch.int8))),
        "K4 int4 g32, f32 query, random nibbles, T=300": (4, types.SimpleNamespace(
            bits=4, group=GROUP, scale=torch.rand((n, -(-t300 // GROUP)), generator=gen,
                                                  device=dev),
            q=torch.randint(0, 256, (n, -(-t300 // GROUP) * GROUP // 2), generator=gen,
                            device=dev, dtype=torch.uint8))),
    }
    for label, (bits, store) in stores.items():
        f32 = "f32 query" in label
        for b in ((256, 1) if bits is None else (256, 8, 1)):
            qb = (q_dot if bits == "dot" else q_f32 if f32 else q)[:b]
            if bits in (None, "dot"):
                def full():
                    return fused_topk(qb, store, 100)
                runs = {name: (lambda fn=fns["fused_topk"]: fn(qb, store, 100))
                        for name, fns in cut.items() if name in ABLATIONS and "widen" not in name}
                if bits == "dot":
                    name = "registers everywhere"
                    runs[name] = lambda fn=cut[name]["fused_topk"]: fn(qb, store, 100)
                    compare(f"{label} B={b}: {name}", runs[name](), fused_topk(qb, store, 101),
                            exact=True)
            else:
                def full():
                    return fused_topk_quantized(qb, store.q, store.scale, 100, bits, store.group)
                runs = {name: (lambda fn=fns["fused_topk_quantized"]: fn(qb, store, 100))
                        for name, fns in cut.items() if f32 or name not in TF32_ABLATIONS}
                for name in LOADERS:
                    compare(f"{label} B={b}: {name}", runs[name](),
                            fused_topk_quantized(qb, store.q, store.scale, 101, bits, store.group),
                            exact=False)
            line = [f"full {cuda_ms(full):.3f} ms"]
            line += [f"{name} {cuda_ms(fn):.3f} ms" for name, fn in runs.items()]
            line.append(f"full {cuda_ms(full):.3f} ms")
            print(f"pass-1 ablation, {label}, B={b}, N={n}, T={qb.shape[1]}, "
                  f"depth 100, on {card}: " + "; ".join(line))
        del store
    print(f"ablations on {card}")


# Copies of K3 (fused_topk_gathered_partial, fused_topk.cu), for timing only
# (their results are wrong): the scores computed and kept live but never
# inserted into a list, and the loads alone (no products, no insert).  Each
# edit names its text in the kernel before the block-list design and
# after it, so that the same copies can be made of either tree.
K3_NO_INSERT = (
    ("    unsigned mask = __ballot_sync(kFull, my_ok && precedes(my_s, my_id, rs[K - 1], "
     "ri[K - 1]));\n",
     "    unsigned mask = __ballot_sync(kFull, my_ok && my_s == 1234.5f && precedes(my_s, my_id, "
     "rs[K - 1], ri[K - 1]));\n"),
    ("const bool pass = my_ok && precedes(my_s, my_id, *ts, *ti);",
     "const bool pass = my_ok && my_s == 1234.5f && precedes(my_s, my_id, *ts, *ti);"))
K3_NO_PRODUCTS = (
    ("for (int u = 0; u < kGatherRows; ++u) acc[u] = dot_pack<M>(acc[u], qv, dv[u]);",
     "for (int u = 0; u < kGatherRows; ++u) acc[u] += static_cast<Acc>(dv[u].x ^ dv[u].w ^ qv.x);"),
    ("for (int u = 0; u < kK3Rows; ++u) acc[u] = dot_pack<M>(acc[u], qv, dv[u][j]);",
     "for (int u = 0; u < kK3Rows; ++u) "
     "acc[u] += static_cast<Acc>(dv[u][j].x ^ dv[u][j].w ^ qv.x);"))
K3_ABLATIONS = {
    "full": [],
    "scores kept live, no insert": [K3_NO_INSERT],
    "loads only": [K3_NO_INSERT, K3_NO_PRODUCTS],
}


def ablate_k3(dev, card: str, trees=(("this tree", ROOT),)) -> None:
    """K3 at the blockmax main path's shape (bf16 store 2,999,808 x 600, 1171
    kept 256-row blocks a query in random order, depth 100), built from
    each tree's sources as it is and with parts cut out (K3_ABLATIONS),
    timed in turns (full, each copy, full) at B = 1 and 8; the full
    kernel's pass 1 and pass 2 apart (``kernel_split``) at B = 1, 8 and
    256; and, given two trees (label, root), e.g. this tree and its parent,
    their full kernels in turns (second, first, first, second) at each B."""
    n, t, keep, depth = 2_999_808, 600, 1171, 100
    gen = torch.Generator(device=dev).manual_seed(9)
    store = torch.randn((n, t), generator=gen, device=dev).to(torch.bfloat16)
    q = (torch.randn((256, t), generator=gen, device=dev) / t**0.5).to(torch.bfloat16)
    ids = _row_ids("blocks", 256, n, keep * BLOCK, gen, dev)
    with ThreadPoolExecutor() as pool:  # every copy's nvcc at once
        built = {(label, name): pool.submit(
            _tree_kernels, os.path.join(os.path.abspath(root), "src", "repro_torch", "kernels"),
            os.path.join(ROOT, "build", "ablate-k3", f"{label}-{j}".replace(" ", "-")),
            names=("fused_topk",), edits=K3_ABLATIONS[name])
            for label, root in trees for j, name in enumerate(K3_ABLATIONS)}
        cut = {}
        for (label, name), fut in built.items():
            cut.setdefault(label, {})[name] = fut.result()["fused_topk_gathered"]
    for bb in (1, 8, 256):
        args = (q[:bb], store, ids[:bb], depth, n)
        runs = {"runs": 5, "warmup": 1} if bb > 8 else {}
        if len(trees) > 1:
            (first, f_fn), (second, s_fn) = ((label, cut[label]["full"]) for label, _ in trees[:2])
            times = [cuda_ms(lambda i=i: (s_fn if i in (0, 3) else f_fn)(*args), **runs)
                     for i in range(4)]
            print(f"K3 in turns, random blocks, B={bb} on {card}: {second} {times[0]:.3f} ms, "
                  f"{first} {times[1]:.3f} ms, {first} {times[2]:.3f} ms, "
                  f"{second} {times[3]:.3f} ms")
        for label, fns in cut.items():
            if bb <= 8:
                line = [f"{name} {cuda_ms(lambda fn=fn: fn(*args)):.3f} ms"
                        for name, fn in fns.items()]
                line.append(f"full {cuda_ms(lambda: fns['full'](*args)):.3f} ms")
                print(f"K3 ablation ({label}), B={bb}, R={ids.shape[1]}, T={t}, depth {depth}, "
                      f"on {card}: " + "; ".join(line))
            print(f"K3 pass 1 / pass 2 ({label}, torch.profiler), B={bb}: "
                  + split_line(kernel_split(lambda: fns["full"](*args), runs=3 if bb > 8 else 5)))


# Copies of K5's pass 1 (fused_topk_gathered_quantized_partial,
# fused_topk_quantized.cu), for timing only (their results are wrong): the
# scores computed and kept live but never ranked; the dequant cut out (each
# column's product taken with a raw word of its unit, the int4 group scale
# folded in once a unit); and the loads alone (no products, no ranking).
# Each edit names its text in the kernel before the one-list design and
# after it, so that the same copies can be made of either tree.
K5_NO_TOPK = (
    K3_NO_INSERT[0],
    ("const bool pass = my_ok && precedes(my_s, my_id, *ts, *ti);",
     "const bool pass = my_ok && my_s == 1234.5f && precedes(my_s, my_id, *ts, *ti);"))
K5_NO_DEQUANT = (
    ("              acc[u] = fmaf(qe[e], v, acc[u]);\n",
     "              acc[u] = fmaf(qe[e], __uint_as_float(dv[u][0].u.x ^ dv[u][0].u.w) * gs[u], "
     "acc[u]);\n"),
    ("acc = fmaf(qv[4 * k + c], magic_byte(x, c) - 8388736.0f, acc);",
     "acc = fmaf(qv[4 * k + c], __uint_as_float(x), acc);"),
    ("float a = (magic_byte(lo, c) - 8388616.0f) * gs;",
     "float a = __uint_as_float(lo) * gs;"),
    ("float b = (magic_byte(hi, c) - 8388616.0f) * gs;",
     "float b = __uint_as_float(hi) * gs;"),
    ("        if constexpr (QT == kQBF16) round_bf16_pair(a, b);\n", ""))
K5_NO_PRODUCTS = (
    ("        for (int k4 = 0; k4 < kQuads; ++k4) {\n",
     "        for (int u = 0; u < kGatherRows; ++u) "
     "acc[u] += __uint_as_float(dv[u][0].u.x ^ dv[u][0].u.w) * gs[u];\n"
     "        for (int k4 = 0; k4 < 0; ++k4) {\n"),
    ("k5_chunk<QT, BITS>(acc, cur, qs, chunk, n_unit_rounds, lane8);",
     "for (int h = 0; h < kRowsPerLane; ++h) for (int j = 0; j < kUnitRounds; ++j) "
     "acc[h] += __uint_as_float(cur.unit[h][j].x ^ cur.unit[h][j].y) * cur.gs[h][j];"))
K5_ABLATIONS = {
    "full": [],
    "scores kept live, no top-k": [K5_NO_TOPK],
    "no dequant (raw words)": [K5_NO_DEQUANT],
    "loads only": [K5_NO_TOPK, K5_NO_PRODUCTS],
}


def _opcode(ins: str) -> str:
    """The mnemonic of a SASS instruction, its predicate and modifiers cut."""
    words = ins.split()
    word = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
    return word.split(".")[0]


def k5_columns(path: str) -> str:
    """Instructions a column in the inner loop of each K5 pass-1 instance of
    the library at ``path``: in its SASS, the longest run of products with
    the query (FFMA, one a column) in which no two FFMA lie more than 200
    instructions apart, from its first FFMA to its last; the instructions
    there over its FFMAs, and the 16 most common opcodes, a column each
    (the next chunk's loads, issued inside the run, count too)."""
    import collections

    code = sass(path)
    if code is None:
        return "no cuobjdump in the CUDA toolkit"
    out = []
    for fn, lines in sorted(code.items()):
        if not fn.startswith("fused_topk_gathered_quantized_partial"):
            continue
        ops = [_opcode(ins) for ins in lines if not ins.startswith((".", "{", "}"))]
        ffma = [i for i, op in enumerate(ops) if op == "FFMA"]
        runs, start = [], 0
        for k in range(1, len(ffma) + 1):
            if k == len(ffma) or ffma[k] - ffma[k - 1] > 200:
                runs.append(ffma[start:k])
                start = k
        run = max(runs, key=len, default=[])
        if len(run) < 16:
            out.append(f"{fn}: no run of 16 FFMA")
            continue
        count = collections.Counter(ops[run[0]:run[-1] + 1])
        top = ", ".join(f"{op} {c / len(run):.3f}" for op, c in count.most_common(16))
        out.append(f"{fn}: {sum(count.values()) / len(run):.3f} a column over {len(run)} FFMA "
                   f"({top})")
    return "; ".join(out)


def print_k5_columns() -> None:
    from repro_torch.kernels import common

    print("K5 instructions a column (cuobjdump -sass): "
          + k5_columns(common.library_path("fused_topk_quantized")))


def no_reuse_ms(q, docs, scale, row_ids) -> float:
    """K5's own floor: every (query, kept row) pair reads its packed row,
    its scales and its id, B x R x (row + scales + 4) bytes at the memory
    rate, as no row is shared between the queries that keep it."""
    return row_ids.numel() * (_packed_row_bytes(docs, scale) + 4) / HBM_BYTES_PER_S * 1e3


def ablate_k5(dev, card: str, trees=(("this tree", ROOT),)) -> None:
    """K5 at the quantized blockmax main path's shape (an int4 g32 store of
    2,999,808 x 600 random nibbles and scales, a bf16 query, 1171 kept
    256-row blocks a query, depth 100), built from each tree's sources as it
    is and with parts cut out (K5_ABLATIONS): each tree's instructions a
    column (``k5_columns``); the copies timed in turns (full, each copy,
    full) at B = 1, 8 and 256, blocks in random order; the full kernel's
    pass 1 and pass 2 apart (``kernel_split``) at B = 1, 8 and 256, blocks in
    random and in bound order (best block first by the plain scores); and,
    given two trees (label, root), e.g. this tree and its parent, their full
    kernels in turns (second, first, first, second) at each B and order."""
    import types

    from repro_torch.kernels.fused_topk import ref

    n, t, keep, depth = 2_999_808, 600, 1171, 100
    gen = torch.Generator(device=dev).manual_seed(11)
    n_groups = -(-t // GROUP)
    pq = types.SimpleNamespace(
        bits=4, group=GROUP, scale=torch.rand((n, n_groups), generator=gen, device=dev),
        q=torch.randint(0, 256, (n, n_groups * GROUP // 2), generator=gen, device=dev,
                        dtype=torch.uint8))
    q = (torch.randn((256, t), generator=gen, device=dev) / t**0.5).to(torch.bfloat16)
    scores = ref.quantized_scores_ref(q, pq.q, pq.scale, 4, GROUP)
    orders = {"random blocks": _row_ids("blocks", 256, n, keep * BLOCK, gen, dev),
              "bound order": _row_ids("bound", 256, n, keep * BLOCK, gen, dev, scores)}
    del scores
    torch.cuda.empty_cache()
    dirs = {(label, name): os.path.join(ROOT, "build", "ablate-k5",
                                        f"{label}-{j}".replace(" ", "-"))
            for label, _ in trees for j, name in enumerate(K5_ABLATIONS)}
    with ThreadPoolExecutor() as pool:  # every copy's nvcc at once
        built = {(label, name): pool.submit(
            _tree_kernels, os.path.join(os.path.abspath(root), "src", "repro_torch", "kernels"),
            dirs[label, name], names=("fused_topk_quantized",), edits=K5_ABLATIONS[name])
            for label, root in trees for name in K5_ABLATIONS}
        cut = {}
        for (label, name), fut in built.items():
            cut.setdefault(label, {})[name] = fut.result()["fused_topk_gathered_quantized"]
    for label, _ in trees:
        path = os.path.join(dirs[label, "full"], "libfused_topk_quantized.so")
        print(f"K5 instructions a column ({label}, cuobjdump -sass): {k5_columns(path)}")
    for order, ids in orders.items():
        for bb in (1, 8, 256):
            args = (q[:bb], pq, ids[:bb], depth, n)
            runs = {"runs": 5, "warmup": 1} if bb > 8 else {}
            if len(trees) > 1:
                (first, f_fn), (second, s_fn) = ((label, cut[label]["full"])
                                                 for label, _ in trees[:2])
                compare(f"K5 {order} B={bb}: {first} vs {second}", f_fn(*args),
                        s_fn(q[:bb], pq, ids[:bb], depth + 1, n), exact=False)
                times = [cuda_ms(lambda i=i: (s_fn if i in (0, 3) else f_fn)(*args), **runs)
                         for i in range(4)]
                print(f"K5 in turns, {order}, B={bb} on {card}: {second} {times[0]:.3f} ms, "
                      f"{first} {times[1]:.3f} ms, {first} {times[2]:.3f} ms, "
                      f"{second} {times[3]:.3f} ms")
            for label, fns in cut.items():
                if order == "random blocks":
                    line = [f"{name} {cuda_ms(lambda fn=fn: fn(*args), **runs):.3f} ms"
                            for name, fn in fns.items()]
                    line.append(f"full {cuda_ms(lambda: fns['full'](*args), **runs):.3f} ms")
                    print(f"K5 ablation ({label}), {order}, B={bb}, R={ids.shape[1]}, T={t}, "
                          f"depth {depth}, on {card}: " + "; ".join(line))
                print(f"K5 pass 1 / pass 2 ({label}, {order}, torch.profiler), B={bb} on {card}: "
                      + split_line(kernel_split(lambda: fns["full"](*args),
                                                runs=3 if bb > 8 else 5)))


# Copies of K1 f32 (fused_topk in f32 mode), for timing only (their results
# are wrong): without the running top-k, and the loads alone (no products,
# no top-k).  Each edit names its text in the tensor-core pass 1
# (mma_topk.cuh: the edits of ABLATIONS) and in the CUDA-core
# fused_topk_partial that ran K1 f32 before it (whose scores stay live,
# compared with a value they never take, and are never inserted), so that
# the same copies can be made of either tree.
K1F32_NO_TOPK = (_NO_TOPK, (
    "unsigned mask = __ballot_sync(kFull, valid && precedes(s, id, rs[K - 1], ri[K - 1]));",
    "unsigned mask = __ballot_sync(kFull, valid && s == 1234.5f && precedes(s, id, rs[K - 1], "
    "ri[K - 1]));"))
K1F32_NO_PRODUCTS = (_NO_PRODUCTS, ("for (int kk = 0; kk < kBK; ++kk) {",
                                    "for (int kk = 0; kk < 0; ++kk) {"))
K1F32_ABLATIONS = {
    "full": [],
    "without the running top-k": [K1F32_NO_TOPK],
    "loads only": [K1F32_NO_TOPK, K1F32_NO_PRODUCTS],
}


def ablate_k1_f32(dev, card: str, trees=(("this tree", ROOT),)) -> None:
    """K1 f32 at the ground truth's shape (2,999,808 random unit rows of 300
    f32, unit queries, depth 10), built from each tree's sources as it is
    and with parts cut out (K1F32_ABLATIONS), timed in turns (full, each
    copy, full) at B = 256, 8 and 1; and, given two trees (label, root),
    their full kernels in turns (second, first, first, second) at each B."""
    n, t, depth = 2_999_808, 300, 10
    gen = torch.Generator(device=dev).manual_seed(10)
    docs = torch.nn.functional.normalize(torch.randn((n, t), generator=gen, device=dev), dim=1)
    q = torch.nn.functional.normalize(torch.randn((256, t), generator=gen, device=dev), dim=1)
    with ThreadPoolExecutor() as pool:  # every copy's nvcc at once
        built = {(label, name): pool.submit(
            _tree_kernels, os.path.join(os.path.abspath(root), "src", "repro_torch", "kernels"),
            os.path.join(ROOT, "build", "ablate-k1f32", f"{label}-{j}".replace(" ", "-")),
            names=("fused_topk",), edits=K1F32_ABLATIONS[name])
            for label, root in trees for j, name in enumerate(K1F32_ABLATIONS)}
        cut = {}
        for (label, name), fut in built.items():
            cut.setdefault(label, {})[name] = fut.result()["fused_topk"]
    for bb in (256, 8, 1):
        qb = q[:bb]
        if len(trees) > 1:
            (first, f_fn), (second, s_fn) = ((label, cut[label]["full"]) for label, _ in trees[:2])
            compare(f"K1 f32 B={bb}: {first} vs {second}", f_fn(qb, docs, depth),
                    s_fn(qb, docs, depth + 1), exact=False)
            times = [cuda_ms(lambda i=i: (s_fn if i in (0, 3) else f_fn)(qb, docs, depth))
                     for i in range(4)]
            print(f"K1 f32 in turns, B={bb} on {card}: {second} {times[0]:.3f} ms, "
                  f"{first} {times[1]:.3f} ms, {first} {times[2]:.3f} ms, "
                  f"{second} {times[3]:.3f} ms")
        for label, fns in cut.items():
            line = [f"{name} {cuda_ms(lambda fn=fn: fn(qb, docs, depth)):.3f} ms"
                    for name, fn in fns.items()]
            line.append(f"full {cuda_ms(lambda: fns['full'](qb, docs, depth)):.3f} ms")
            print(f"K1 f32 ablation ({label}), B={bb}, N={n}, T={t}, depth {depth}, on {card}: "
                  + "; ".join(line))


# Copies of K2 (K1's lsh mode, fused_topk.cu), for timing only (their
# results are wrong): the counts accumulated and kept live (compared with a
# value they never take) but never tested against the lists; the compare
# without the query's sentinel test; the shared-memory slot loads at one
# address a chunk, so that the compiler hoists them and the same slots are
# compared again (what the compares cost without their LDS); and the loads
# alone (no compares, no top-k).  A fourth copy, K2_COUNT, is the kernel as
# it is plus a device counter of the candidates that reach the running
# lists (a sorted insert in fused_topk_partial, an append to the candidate
# buffer in fused_topk_lsh_partial), read through a C entry it adds
# (``k2_candidates``).  Each edit names its text in both of those pass-1
# designs, the warp-serial one of older trees and this one, so that the
# same copies can be made of either tree.
K2_NO_TOPK = ((K1F32_NO_TOPK[1][0], K1F32_NO_TOPK[1][1].replace("1234.5f", "-3.f")),
              ("        if (acc[i][j] > thr[i] && id < n_docs && (f == nullptr || f[id] != 0)) {",
               "        if (acc[i][j] == -3.f && acc[i][j] > thr[i] && id < n_docs &&\n"
               "            (f == nullptr || f[id] != 0)) {"))
K2_NO_SENTINEL = (("acc[i][j] = mac<M>(acc[i][j], a[i], b[j]);",
                   "acc[i][j] += static_cast<Acc>(a[i] == b[j]);"),
                  ("setp.eq.and.u32 p,", "setp.eq.u32 p,"),
                  (", q;\\n @p add", ";\\n @p add"),
                  *((f" setp.ne.u32 q, %{k}, 0xFFFFFFFF;\\n", "") for k in (8, 2, 1)))
K2_NO_COMPARES = (K1F32_NO_PRODUCTS[1],
                  ("    const int words = min(kBK, S - chunk * kBK);\n",
                   "    const int words = 0;\n"))
K2_ONE_SLOT_LOAD = (("b[j] = ds[(lane + 32 * j) * kSkew + kk];",
                     "b[j] = ds[(lane + 32 * j) * kSkew + 0 * kk];"),
                    ("qs + kk * BQ + warp * TM + 4 * g);", "qs + 0 * kk * BQ + warp * TM + 4 * g);"),
                    ("(dg + L::DG * j) * kLshStride + kk);", "(dg + L::DG * j) * kLshStride + 0 * kk);"),
                    ("(qg * L::TQ + i) * kLshStride + kk);", "(qg * L::TQ + i) * kLshStride + 0 * kk);"))
K2_ABLATIONS = {
    "full": [],
    "counts kept live, no top-k": [K2_NO_TOPK],
    "no sentinel test": [K2_NO_SENTINEL],
    "slot loads hoisted (the same slots compared again)": [K2_ONE_SLOT_LOAD],
    "loads only": [K2_NO_TOPK, K2_NO_COMPARES],
}
K2_COUNT = [
    ('#include "mma_topk.cuh"  // K1 classic\'s tensor-core pass 1; includes topk_merge.cuh\n',
     '#include "mma_topk.cuh"  // K1 classic\'s tensor-core pass 1; includes topk_merge.cuh\n'
     "__device__ unsigned long long g_k2_candidates;\n"),
    ('}  // extern "C"',
     "unsigned long long k2_candidates() {\n  unsigned long long v = 0, z = 0;\n"
     "  cudaMemcpyFromSymbol(&v, g_k2_candidates, sizeof(v));\n"
     "  cudaMemcpyToSymbol(g_k2_candidates, &z, sizeof(z));\n  return v;\n}\n"
     '}  // extern "C"'),
    (("          if (precedes(cs, cid, rs[K - 1], ri[K - 1])) warp_insert(rs, ri, K, cs, cid, lane);",
      "          if (precedes(cs, cid, rs[K - 1], ri[K - 1])) {\n"
      "            if (lane == 0) atomicAdd(&g_k2_candidates, 1ull);\n"
      "            warp_insert(rs, ri, K, cs, cid, lane);\n          }"),
     ("cs[r * kCap + c] = acc[i][j];",
      "cs[r * kCap + c] = acc[i][j];\n          atomicAdd(&g_k2_candidates, 1ull);")),
]
# Copies of K2 (this tree's) held bit-equal to it and timed beside it: a
# ring of two stages (two blocks a SM at 8 queries), the loop over a
# chunk's 4-slot steps not unrolled, or unrolled twice (not 4 times), a flush that
# merges only the buffers past its mark (the others wait for the next), and
# blocks of 512 threads at 64 queries (16 warps, a thread 2 queries x 8 docs).
_K2_UNROLL = "bool kAll, int kUnroll = 4>"  # lsh_chunk's default, K2's
K2_VARIANTS = {
    "2 stages": [("constexpr int kLshStages = 3;", "constexpr int kLshStages = 2;")],
    "steps not unrolled": [(_K2_UNROLL, _K2_UNROLL.replace("= 4", "= 1"))],
    "steps unrolled 2": [(_K2_UNROLL, _K2_UNROLL.replace("= 4", "= 2"))],
    "only buffers past BN / 4 merge at a flush": [
        ("        if (n == 0) continue;  // warp-uniform\n        merge_buffer<kCap>(ls + r * K",
         "        if (n == 0 || (n <= kFlushAt && !last)) continue;  // warp-uniform\n"
         "        merge_buffer<kCap>(ls + r * K")],
    "512 threads at 64 queries (2 x 8 a thread)": [
        ("  static constexpr int NT = kLshThreads;",
         "  static constexpr int NT = BQ == 64 ? 2 * kLshThreads : kLshThreads;"),
        ("  static constexpr int TQ = BQ < 4 ? BQ : 4;",
         "  static constexpr int TQ = BQ == 64 ? 2 : (BQ < 4 ? BQ : 4);")],
}
# The main path's lexical-LSH cell: b = 300 buckets, h = 1.
K2_LSH = {"buckets": 300, "hashes": 1}


def ptxas_report(log: str, prefix: str) -> str:
    """Registers and spill bytes ptxas -v reports for each kernel instance
    whose name (``_instance``) starts with ``prefix``, from an nvcc log."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = _instance(line.split("Function properties for")[1])
        elif fn and fn.startswith(prefix) and "spill" in line:
            out[fn] = line.strip()
        elif fn and fn.startswith(prefix) and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out[fn] = f"{regs.group(1) if regs else '?'} registers, {out.get(fn, '')}"
            fn = None
    return "; ".join(f"{k}: {v}" for k, v in sorted(out.items())) or f"no {prefix} instance"


# ALU-pipe SASS opcodes (64 INT32 lanes an SM on an H100); FADD, FFMA, FMUL,
# FSEL and IMAD issue to the FP32 pipe (128 lanes), LDS to the memory pipe.
ALU_OPCODES = {"ISETP", "IADD3", "LOP3", "SEL", "PLOP3", "SHF", "LEA", "IMNMX", "IABS", "P2R",
               "R2P", "PRMT", "MOV", "VIADD", "VIMNMX", "FLO", "POPC", "BREV"}
K2_INT32_MS = 13.796  # the cell's compares (2.3e11) at 16.7e12 INT32 op/s; K8's are the same
# The kernels whose compare loops lsh_compare_ops reads: K2's pass 1
# (``fused_topk_partial`` in trees before PR 28), and K8 (``dense_scores``
# in trees before PR 29).
K2_KERNELS = ("fused_topk_partial", "fused_topk_lsh_partial")
K8_KERNELS = ("dense_scores", "lsh_match_counts")


def lsh_compare_ops(path: str, kernels=K2_KERNELS, dump: str = "") -> str:
    """SASS instructions a compare in the inner loop of each instance of the
    library at ``path`` whose name starts with one of ``kernels`` (K2's
    pass 1, K2_KERNELS, or K8, K8_KERNELS): of the innermost loops (a backward
    branch and its target, holding no other) with at least 8 compares
    (ISETP.EQ or .NE between two registers: an equality of a query and a doc
    slot), the one with the most compares; its instructions over
    its compares, the ALU-pipe ones (ALU_OPCODES) apart with the floor they
    imply at the cell (ALU a compare x 13.796 ms: 64 INT32 lanes an SM) and
    the issue floor (all a compare x 13.796 / 2 ms: 128 instructions an SM a
    clock), and the 12 most common opcodes a compare.  ``dump``: a directory
    that gets the SASS of every innermost loop of 8 compares, a file each."""
    import collections

    code = sass_addressed(path)
    if code is None:
        return "no cuobjdump in the CUDA toolkit"
    compare = re.compile(r"^(@!?P\w+\s+)?ISETP\.(EQ|NE)\S*\s+P\w+,\s*P\w+,\s*R\d+(\.reuse)?,"
                         r"\s*R\d+(\.reuse)?,")
    out = []
    for fn, items in sorted(code.items()):
        if not fn.startswith(tuple(kernels)):
            continue
        at = {addr: k for k, (addr, _) in enumerate(items)}
        loops = []
        for k, (addr, ins) in enumerate(items):
            target = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)$", ins)
            if target and int(target.group(1), 16) <= addr and int(target.group(1), 16) in at:
                first = at[int(target.group(1), 16)]
                body = [i for _, i in items[first:k + 1]]
                n = sum(1 for i in body if compare.match(i))
                if n >= 8:  # K8's 1-query step unrolled twice: 8
                    loops.append((first, k, n, body))
        inner = [lp for lp in loops if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1]
                                                 for o in loops)]
        if not inner:
            out.append(f"{fn}: no loop of 8 compares")
            continue
        # the innermost loop with the most compares: the unrolled steps of a
        # whole query tile (the others: a tile with padded query rows)
        _, _, n, body = max(inner, key=lambda lp: (lp[2], -len(lp[3])))
        size = len(body)
        count = collections.Counter(_opcode(i) for i in body)
        alu = sum(c for op, c in count.items() if op in ALU_OPCODES) / n
        total = size / n
        top = ", ".join(f"{op} {c / n:.3f}" for op, c in count.most_common(12))
        out.append(f"{fn}: {total:.3f} a compare over a loop of {size} instructions and {n} "
                   f"compares, ALU {alu:.3f} (floor {alu * K2_INT32_MS:.2f} ms; issue floor "
                   f"{total * K2_INT32_MS / 2:.2f} ms) ({top})")
        if dump:
            os.makedirs(dump, exist_ok=True)
            for j, lp in enumerate(inner):
                name = re.sub(r"[^\w]+", "_", fn) + f"-{j}.sass"
                with open(os.path.join(dump, name), "w") as f:
                    f.write("\n".join(lp[3]) + "\n")
    return "; ".join(out)


def print_lsh_compare_ops() -> None:
    from repro_torch.kernels import common

    print("k2_compare_ops (cuobjdump -sass): "
          + lsh_compare_ops(common.library_path("fused_topk"), K2_KERNELS,
                            dump=os.path.join(ROOT, "build", "k2-loops")))
    print("k8_compare_ops (cuobjdump -sass): "
          + lsh_compare_ops(common.library_path("lsh_match"), K8_KERNELS,
                            dump=os.path.join(ROOT, "build", "k8-loops")))


def _k2_cell(dev):
    """(signatures of the cell's 256 queries, the index's (N, 300) uint32
    signatures): the lexical-LSH index (b = 300, h = 1) of the ann-word2vec
    corpus, as the main path builds it."""
    from repro_torch.configs import ann_word2vec
    from repro_torch.core import bruteforce, lexical_lsh
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import LexicalLshConfig

    cell = ann_word2vec.ARCH.cell("ann_search")
    x, qx = make_inputs(dev, cell.get("n_docs"), cell.batch)
    lcfg = LexicalLshConfig(**K2_LSH)
    sig = AnnIndex.build(x, lcfg, keep_vectors=False, device=dev).index.sig
    sig_q = lexical_lsh.encode(bruteforce.l2_normalize(qx), lcfg)
    del x, qx
    torch.cuda.empty_cache()
    return sig_q, sig


def ablate_k2(dev, card: str, trees=(("this tree", ROOT),), cell=None) -> None:
    """K2 at the lexical-LSH main path's shape (the (b = 300, h = 1)
    signatures of the ann-word2vec corpus, 2,999,808 x 300 uint32, the
    cell's queries, depth 100), built from each tree's sources as it is and
    with parts cut out (K2_ABLATIONS), timed in turns (full, each copy,
    full) at B = 256, 8 and 1; the full kernel's pass 1 and pass 2 apart
    (``kernel_split``); the candidates that reach the running lists per
    (query, split) (K2_COUNT); each tree's registers and spills (ptxas -v)
    and SASS instructions a compare (``lsh_compare_ops``); and, given two
    trees (label, root), e.g. this tree and its parent, their full kernels
    in turns (second, first, first, second) at each B, results held to each
    other bit for bit.  ``cell``: (sig_q, sig) where the caller has them."""
    import ctypes

    sig_q, sig = cell or _k2_cell(dev)
    n, depth = sig.shape[0], 100
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    variants = {**{name: edits for name, edits in K2_ABLATIONS.items()},
                "candidates counted": K2_COUNT}
    dirs = {(label, name): os.path.join(ROOT, "build", "ablate-k2",
                                        f"{label}-{j}".replace(" ", "-"))
            for label, _ in trees for j, name in enumerate({**variants, **K2_VARIANTS})}
    with ThreadPoolExecutor() as pool:  # every copy's nvcc at once
        built = {(label, name): pool.submit(
            _tree_kernels, os.path.join(os.path.abspath(root), "src", "repro_torch", "kernels"),
            dirs[label, name], names=("fused_topk",), edits=variants[name])
            for label, root in trees for name in variants}
        built_v = {name: pool.submit(
            _tree_kernels, os.path.join(ROOT, "src", "repro_torch", "kernels"),
            dirs[trees[0][0], name], names=("fused_topk",), edits=edits)
            for name, edits in K2_VARIANTS.items()}
        cut = {}
        for (label, name), fut in built.items():
            cut.setdefault(label, {})[name] = fut.result()["fused_topk"]
        other = {name: fut.result()["fused_topk"] for name, fut in built_v.items()}
    counters = {}
    for label, _ in trees:
        path = os.path.join(dirs[label, "full"], "libfused_topk.so")
        log = open(os.path.join(dirs[label, "full"], "fused_topk.log")).read()
        print(f"K2 pass 1, ptxas -v ({label}): "
              + ptxas_report(log, ("fused_topk_partial", "fused_topk_lsh_partial")))
        print(f"k2_compare_ops ({label}, cuobjdump -sass): "
              + lsh_compare_ops(path, K2_KERNELS, dump=os.path.join(
                  ROOT, "build", f"k2-loops-{label}".replace(" ", "-"))))
        lib = ctypes.CDLL(os.path.join(dirs[label, "candidates counted"], "libfused_topk.so"))
        lib.k2_candidates.restype = ctypes.c_ulonglong
        lib.fused_topk_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        counters[label] = lib
    for name in K2_VARIANTS:
        log = open(os.path.join(dirs[trees[0][0], name], "fused_topk.log")).read()
        print(f"K2 variant {name!r}, ptxas -v: " + ptxas_report(log, "fused_topk_lsh_partial<64"))
    for bb in (256, 8, 1):
        qb = sig_q[:bb]
        runs = {"runs": 5, "warmup": 1} if bb > 8 else {}
        if len(trees) > 1:
            (first, f_fn), (second, s_fn) = ((label, cut[label]["full"]) for label, _ in trees[:2])
            compare(f"K2 B={bb}: {first} vs {second}", f_fn(qb, sig, depth),
                    s_fn(qb, sig, depth + 1), exact=True)
            times = [cuda_ms(lambda i=i: (s_fn if i in (0, 3) else f_fn)(qb, sig, depth), **runs)
                     for i in range(4)]
            print(f"K2 in turns, B={bb} on {card}: {second} {times[0]:.3f} ms, "
                  f"{first} {times[1]:.3f} ms, {first} {times[2]:.3f} ms, "
                  f"{second} {times[3]:.3f} ms")
        for label, fns in cut.items():
            line = [f"{name} {cuda_ms(lambda fn=fn: fn(qb, sig, depth), **runs):.3f} ms"
                    for name, fn in fns.items() if name != "candidates counted"]
            line.append(f"full {cuda_ms(lambda: fns['full'](qb, sig, depth), **runs):.3f} ms")
            print(f"K2 ablation ({label}), B={bb}, N={n}, S={sig.shape[1]}, depth {depth}, on "
                  f"{card}: " + "; ".join(line) + "; the full kernel at "
                  + clock_power(lambda: fns["full"](qb, sig, depth)))
            if label == trees[0][0]:
                full = fns["full"]
                want = full(qb, sig, depth)
                line = []
                for name, fn in other.items():
                    compare(f"K2 {name} B={bb}", fn(qb, sig, depth), want, exact=True)
                    line.append(f"{name} {cuda_ms(lambda fn=fn: fn(qb, sig, depth), **runs):.3f}"
                                f" ms, full {cuda_ms(lambda: full(qb, sig, depth), **runs):.3f} ms")
                print(f"K2 variants ({label}, bit-equal to it), B={bb} on {card}: "
                      + "; ".join(line))
            print(f"K2 pass 1 / pass 2 ({label}, torch.profiler), B={bb} on {card}: "
                  + split_line(kernel_split(lambda: fns["full"](qb, sig, depth),
                                            runs=3 if bb > 8 else 5)))
            lib = counters[label]
            lib.k2_candidates()
            fns["candidates counted"](qb, sig, depth)
            torch.cuda.synchronize()
            total = lib.k2_candidates()
            plan = (ctypes.c_int * 8)()
            lib.fused_topk_plan(3, bb, n, depth, sm_count, plan)
            print(f"K2 candidates ({label}), B={bb}: {total} in all, plan (queries a block, K, "
                  f"splits, tiles a split, docs a tile) {tuple(plan[:5])}, "
                  f"{total / (bb * plan[2]):.1f} per (query, split)")


# K8's planted fault: the compare without the query's sentinel test (the
# edits of K2_NO_SENTINEL, which name the text of lsh_word in
# lsh_count.cuh), so a sentinel slot that a doc holds too counts.  The
# "lsh-sentinels" case of check_dense must fail with it.
K8_NO_SENTINEL = K2_NO_SENTINEL
# Copies of K8 with a part cut out, for timing only (their counts are
# wrong): no stores (the counts kept live, compared with a value they never
# take), no sentinel test (K2_NO_SENTINEL), and the loads alone (no
# compares, no stores).  Each edit names its text in both the CUDA-core
# tile that K8 ran before PR 29 (``dense_scores``) and lsh_match_counts, so
# that the same copies can be made of either tree.  In that older tile the
# loads-only copy loses its loads too (its staged words are never read, and
# the compiler drops them): its time there is no load time.
K8_NO_STORES = (("static_cast<int*>(out)[(size_t)qi * N + d] = static_cast<int>(acc[i][j]);",
                 "if (acc[i][j] == -3) static_cast<int*>(out)[(size_t)qi * N + d] = "
                 "static_cast<int>(acc[i][j]);"),
                ("    store_counts<BQ>(acc, ", "    if (acc[0][0] == -3.f) store_counts<BQ>(acc, "))
K8_NO_COMPARES = (K1F32_NO_PRODUCTS[1],
                  ("const int words = min(kBK, S - chunk * kBK);  // slots of this chunk",
                   "const int words = 0;  // slots of this chunk"))
K8_ABLATIONS = {
    "full": [],
    "no stores (counts kept live)": [K8_NO_STORES],
    "no sentinel test": [K8_NO_SENTINEL],
    "loads only": [K8_NO_STORES, K8_NO_COMPARES],
}
# Copies of K8 (this tree's) held bit-equal to it and timed beside it: the
# other count of resident blocks a SM (k8_blocks: __launch_bounds__ and the
# plan; one at 64 queries, two below), one with the steps unrolled 4 times
# (which needs more registers than two blocks leave), and a chunk's 4-slot
# steps not unrolled.
_K8_BLOCKS = "return bq == 64 ? 2 : 1;"
_K8_UNROLL = "constexpr int kK8Unroll = 2;"
K8_VARIANTS = {
    "1 block a SM": [(_K8_BLOCKS, "return 1;")],
    "1 block a SM, steps unrolled 4": [(_K8_BLOCKS, "return 1;"),
                                       (_K8_UNROLL, _K8_UNROLL.replace("2", "4"))],
    "2 blocks a SM": [(_K8_BLOCKS, "return 2;")],
    "steps not unrolled": [(_K8_UNROLL, _K8_UNROLL.replace("2", "1"))],
}


def _k8_kernel(kdir: str, out_dir: str, edits=()):
    """K8 built from ``lsh_match.cu`` of the kernels directory ``kdir`` of
    some tree (``_library_copy``, with ``edits``) and called through that
    tree's own C signature (``_c_entry``).  Returns ``score(sig_q,
    sig_d)``, which raises if the launch fails."""
    from repro_torch.kernels import common

    lib, text = _library_copy(kdir, "lsh_match", out_dir, edits)
    launch = _c_entry(lib, text, "lsh_match_scores_launch")

    def score(q, docs):
        out = torch.empty((q.shape[0], docs.shape[0]), dtype=torch.int32, device=q.device)
        err = launch(sig_q=q.data_ptr(), sig_d=docs.data_ptr(), out=out.data_ptr(),
                     B=q.shape[0], N=docs.shape[0], S=q.shape[1],
                     q_align=common.row_alignment(q), d_align=common.row_alignment(docs),
                     stream=torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"lsh_match_scores_launch of {kdir} failed: cudaError {err}")
        return out

    return score


def build_planted_k8():
    """(name, score): K8 built from a copy of this tree's sources with
    K8_NO_SENTINEL (``_k8_kernel``), called as ``score(sig_q, sig_d)``."""
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    return ("no-sentinel", _k8_kernel(kdir, os.path.join(ROOT, "build", "planted-k8"),
                                      [K8_NO_SENTINEL]))


def ablate_k8(dev, card: str, trees=(("this tree", ROOT),), cell=None) -> None:
    """K8 at the dense LSH cell (the main path's (b = 300, h = 1) signatures
    of the ann-word2vec corpus, 2,999,808 x 300 uint32, against the cell's
    queries), built from each tree's sources as it is and with parts cut out
    (K8_ABLATIONS), timed in turns (full, each copy, full) at B = 256, 8 and
    1, each beside the SM clock and power draw (``clock_power``); each
    tree's registers and spills (ptxas -v) and SASS instructions a compare
    (``lsh_compare_ops``); this tree's K8_VARIANTS (where ``trees`` holds
    it) held bit-equal to it and timed beside it; and, given two trees
    (label, root), e.g. this tree and its parent, their full kernels in
    turns (second, first, first, second) at each B, counts held to each
    other bit for bit.  ``cell``: (sig_q, sig) where the caller has them."""
    sig_q, sig = cell or _k2_cell(dev)
    own = [label for label, root in trees if os.path.abspath(root) == ROOT]  # the variants' tree
    copies = {(label, name): (root, edits) for label, root in trees
              for name, edits in K8_ABLATIONS.items()}
    copies.update({(label, name): (ROOT, edits) for label in own
                   for name, edits in K8_VARIANTS.items()})
    dirs = {key: os.path.join(ROOT, "build", "ablate-k8", f"{key[0]}-{j}".replace(" ", "-"))
            for j, key in enumerate(copies)}
    with ThreadPoolExecutor() as pool:  # every copy's nvcc at once
        built = {key: pool.submit(
            _k8_kernel, os.path.join(os.path.abspath(root), "src", "repro_torch", "kernels"),
            dirs[key], edits) for key, (root, edits) in copies.items()}
        fns = {key: fut.result() for key, fut in built.items()}
    for label, _ in trees:
        full_dir = dirs[label, "full"]
        log = open(os.path.join(full_dir, "lsh_match.log")).read()
        print(f"K8, ptxas -v ({label}): " + ptxas_report(log, K8_KERNELS))
        print(f"k8_compare_ops ({label}, cuobjdump -sass): "
              + lsh_compare_ops(os.path.join(full_dir, "liblsh_match.so"), K8_KERNELS,
                                dump=os.path.join(ROOT, "build",
                                                  f"k8-loops-{label}".replace(" ", "-"))))
    for label in own:
        for name in K8_VARIANTS:
            log = open(os.path.join(dirs[label, name], "lsh_match.log")).read()
            print(f"K8 variant {name!r}, ptxas -v: " + ptxas_report(log, K8_KERNELS))
    n, s = sig.shape
    for bb in (256, 8, 1):
        qb = sig_q[:bb]
        runs = {"runs": 5, "warmup": 1} if bb > 8 else {}
        if len(trees) > 1:
            (first, f_fn), (second, s_fn) = ((label, fns[label, "full"]) for label, _ in trees[:2])
            compare_dense(f"K8 B={bb}: {first} vs {second}", f_fn(qb, sig), s_fn(qb, sig),
                          exact=True)
            times = [cuda_ms(lambda i=i: (s_fn if i in (0, 3) else f_fn)(qb, sig), **runs)
                     for i in range(4)]
            print(f"K8 in turns, B={bb} on {card}: {second} {times[0]:.3f} ms, "
                  f"{first} {times[1]:.3f} ms, {first} {times[2]:.3f} ms, "
                  f"{second} {times[3]:.3f} ms")
            torch.cuda.empty_cache()
        for label, _ in trees:
            full = fns[label, "full"]
            line = [f"{name} {cuda_ms(lambda fn=fns[label, name]: fn(qb, sig), **runs):.3f} ms"
                    for name in K8_ABLATIONS]
            line.append(f"full {cuda_ms(lambda: full(qb, sig), **runs):.3f} ms")
            print(f"K8 ablation ({label}), B={bb}, N={n}, S={s}, on {card}: " + "; ".join(line)
                  + "; the full kernel at " + clock_power(lambda: full(qb, sig)))
            if label in own:
                want = full(qb, sig)
                line = []
                for name in K8_VARIANTS:
                    fn = fns[label, name]
                    compare_dense(f"K8 {name} B={bb}", fn(qb, sig), want, exact=True)
                    line.append(f"{name} {cuda_ms(lambda: fn(qb, sig), **runs):.3f} ms, full "
                                f"{cuda_ms(lambda: full(qb, sig), **runs):.3f} ms")
                del want
                print(f"K8 variants ({label}, bit-equal to it), B={bb} on {card}: "
                      + "; ".join(line))
            torch.cuda.empty_cache()


def _apply_edits(texts: dict, edits, where: str) -> None:
    """Apply ``edits`` to ``texts`` ({path: source text}, in place).  An edit
    is an (old, new) pair, every occurrence of old replaced in every text
    that holds it, or a tuple of such pairs (the same cut as it reads in
    several trees), each applied where its old text is; at least one old
    text of each edit must be there."""
    for edit in edits:
        pairs = edit if isinstance(edit[0], tuple) else (edit,)
        hits = 0
        for old, new in pairs:
            for f in texts:
                if old in texts[f]:
                    hits += 1
                    texts[f] = texts[f].replace(old, new)
        if not hits:
            raise ValueError(f"no file of {where} holds any of {[old for old, _ in pairs]!r}")


def _library_copy(kdir: str, name: str, out_dir: str, edits=(), package: str = ""):
    """(library, source text): the kernel source ``<package>/csrc/<name>.cu``
    (``package`` defaults to ``name``) of
    the kernels directory ``kdir`` of some tree, copied into ``out_dir`` with
    that tree's shared headers (``kdir/csrc``, into ``out_dir/shared``),
    ``edits`` (``_apply_edits``) applied to the copies, and built there with
    nvcc against the copied headers (its ptxas -v report in
    ``out_dir/<name>.log``)."""
    import ctypes

    from repro_torch.kernels import common

    csrc = os.path.join(kdir, package or name, "csrc")
    shared = os.path.join(out_dir, "shared")
    os.makedirs(out_dir, exist_ok=True)
    shutil.rmtree(shared, ignore_errors=True)
    shutil.copytree(os.path.join(kdir, "csrc"), shared)
    src, lib = (os.path.join(out_dir, f) for f in (f"{name}.cu", f"lib{name}.so"))
    shutil.copyfile(os.path.join(csrc, f"{name}.cu"), src)
    files = [src] + [os.path.join(shared, f) for f in sorted(os.listdir(shared))]
    texts = {f: open(f).read() for f in files}
    _apply_edits(texts, edits, f"{name}.cu's sources in {kdir}")
    for f, text in texts.items():
        with open(f, "w") as out:
            out.write(text)
    proc = subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-I", shared, "-I", csrc, "-o", lib,
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    with open(os.path.join(out_dir, f"{name}.log"), "w") as f:  # ptxas -v, for ptxas_report
        f.write(proc.stdout + proc.stderr)
    return ctypes.CDLL(lib), texts[src]


def _score_matmul_kernel(kdir: str, out_dir: str, edits=()):
    """K7 built from ``fakewords_score.cu`` of the kernels directory ``kdir``
    of some tree (``_library_copy``, with ``edits``) and called through that
    tree's own C signature (``_c_entry``).  Returns ``score(q, docs,
    out_dtype=torch.float32)``, which raises if the launch fails."""
    from repro_torch.kernels import common

    lib, text = _library_copy(kdir, "fakewords_score", out_dir, edits)
    launch = _c_entry(lib, text, "score_matmul_launch")

    def score(q, docs, out_dtype=torch.float32):
        out = torch.empty((q.shape[0], docs.shape[0]), dtype=out_dtype, device=q.device)
        err = launch(mode={torch.bfloat16: 1, torch.int8: 2}[q.dtype],
                     out_int=int(out_dtype == torch.int32), q=q.data_ptr(), docs=docs.data_ptr(),
                     out=out.data_ptr(), B=q.shape[0], N=docs.shape[0], T=q.shape[1],
                     q_align=common.row_alignment(q), d_align=common.row_alignment(docs),
                     stream=torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"score_matmul_launch of {kdir} failed: cudaError {err}")
        return out

    return score


def _attention_kernel(kdir: str, out_dir: str, edits=()):
    """K9 built from ``flash_attention.cu`` of the kernels directory ``kdir``
    of some tree (``_library_copy``, with ``edits``) and called through that
    tree's own C signature (``_c_entry``).  Returns ``attn(q, k, v)``, which
    raises if the launch fails."""
    lib, text = _library_copy(kdir, "flash_attention", out_dir, edits)
    launch = _c_entry(lib, text, "flash_attention_launch")

    def attn(q, k, v):
        b, hq, s, d = q.shape
        out = torch.empty_like(q)
        err = launch(dtype={torch.float32: 0, torch.bfloat16: 1}[q.dtype], D=d, q=q.data_ptr(),
                     k=k.data_ptr(), v=v.data_ptr(), out=out.data_ptr(), B=b, Hq=hq,
                     Hkv=k.shape[1], S=s, stream=torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_launch of {kdir} failed: cudaError {err}")
        return out

    return attn


def _attention_layers(dev, f32: bool = False) -> dict:
    """{name: (q, k, v)}: random bf16 operands of each ATTENTION_LAYERS layer;
    with ``f32`` also phi3-mini's, widened to f32 (``F32_LAYER``)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    layers = {name: _qkv(torch.bfloat16, 1, hq, hkv, s, d, gen, dev)
              for name, hq, hkv, s, d in ATTENTION_LAYERS}
    if f32:
        layers[F32_LAYER] = tuple(x.float() for x in layers[ATTENTION_LAYERS[1][0]])
    return layers


def _layer_label(q, k) -> str:
    return (f"{str(q.dtype)[6:]}, B={q.shape[0]}, Hq={q.shape[1]}, Hkv={k.shape[1]}, "
            f"S={q.shape[2]}, D={q.shape[3]}")


def pair_k9(dev, card: str, parent: str) -> None:
    """K9 of the tree ``parent`` (its own ``flash_attention.cu`` and C
    signature) and of this tree at both full-width layers (ATTENTION_LAYERS,
    bf16) and at phi3-mini's in f32, timed in turns (parent, this, this,
    parent; median of RUNS each), their outputs held to each other under
    the row rule of the dtype; and which instances the two libraries share
    with identical SASS."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention

    pair_dir = os.path.join(ROOT, "build", "pair-k9")
    with ThreadPoolExecutor() as pool:  # the parent's nvcc beside this tree's
        old = pool.submit(_attention_kernel, os.path.join(os.path.abspath(parent), "src",
                                                          "repro_torch", "kernels"), pair_dir)
        build_kernels(["flash_attention"])
        old = old.result()
    sass_pairing("flash_attention", os.path.join(pair_dir, "libflash_attention.so"))
    for name, (q, k, v) in _attention_layers(dev, f32=True).items():
        err = compare_dense(f"K9 {name}: this tree vs the parent", flash_attention(q, k, v),
                            old(q, k, v), exact=False, tol=ATTN_TOL[q.dtype])
        times = [cuda_ms(lambda i=i: (old if i in (0, 3) else flash_attention)(q, k, v))
                 for i in range(4)]
        print(f"pairing K9 {name} ({_layer_label(q, k)}) on {card}: parent {times[0]:.3f} ms, "
              f"this tree {times[1]:.3f} ms, this tree {times[2]:.3f} ms, parent "
              f"{times[3]:.3f} ms; max |this - parent| {err:.3g}")


def pair_k9_bwd(dev, card: str, parent: str) -> None:
    """K9's backward of the tree ``parent`` and of this tree at
    ATTN_BWD_CASES, each built from its own ``flash_attention_bwd.cu`` and
    called through its own C signature by the same Python caller
    (``_attention_bwd_kernel``, so that both carry the same host work),
    timed in turns (parent, this, this, parent; median of RUNS each), the
    two trees' dq, dk and dv held to each other under the dtype's row rule
    (``compare_attention_grads``); beside them this tree's wrapper
    (``flash_attention_bwd``, the main path's entry), the bound and SDPA's
    backward, timed alone and as the subtraction that was its reading before
    PR 39 (``_sdpa_grad_ms``); and which instances the two libraries share
    with identical SASS."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd

    pair_dir = os.path.join(ROOT, "build", "pair-k9-bwd")
    with ThreadPoolExecutor() as pool:  # both trees' nvcc at once
        old = pool.submit(_attention_bwd_kernel, os.path.join(os.path.abspath(parent), "src",
                                                              "repro_torch", "kernels"), pair_dir)
        new = pool.submit(_attention_bwd_kernel, os.path.join(ROOT, "src", "repro_torch",
                                                              "kernels"),
                          os.path.join(ROOT, "build", "pair-k9-bwd-this"))
        build_kernels(["flash_attention", "flash_attention_bwd"])
        old, new = old.result(), new.result()
    sass_pairing("flash_attention_bwd", os.path.join(pair_dir, "libflash_attention_bwd.so"))
    gen = torch.Generator(device=dev).manual_seed(39)
    for name, dtype, b, hq, hkv, s, d in ATTN_BWD_CASES:
        q, k, v = _qkv(dtype, b, hq, hkv, s, d, gen, dev)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        out, lse = flash_attention_fwd(q, k, v)
        args = (q, k, v, out, lse, dout)
        err = compare_attention_grads(f"K9 backward {name}: this tree vs the parent",
                                      new(*args), old(*args), ATTN_TOL[dtype])
        times = [cuda_ms(lambda i=i: (old if i in (0, 3) else new)(*args)) for i in range(4)]
        wrapper = cuda_ms(lambda: flash_attention_bwd(*args))
        lib_fwd, lib_bwd, lib_subtracted = _sdpa_grad_ms(q, k, v, dout, subtracted=True)
        bound = _bwd_bound(q, k)
        print(f"pairing K9 backward {name} ({_layer_label(q, k)}) on {card}: parent "
              f"{times[0]:.3f} ms, this tree {times[1]:.3f} ms, this tree {times[2]:.3f} ms, "
              f"parent {times[3]:.3f} ms; this tree's wrapper {wrapper:.3f} ms; bound "
              f"{bound[0]:.4f} ms ({bound[1]}); SDPA backward "
              f"alone {lib_bwd:.3f} ms, forward and backward minus forward {lib_subtracted:.3f} "
              f"(forward {lib_fwd:.3f}); max |this - parent| {err:.3g}")


# Copies of K9's backward, each timed against the kernel: the loads alone
# (bf16: the TMA ring and its barriers; f32: the cp.async ring; no products
# and no probabilities), and the products alone (the first stages' tiles
# loaded once and used for every iteration, no further loads); both give
# wrong gradients.  Each edit changes the kernels of both dtypes.
K9_BWD_ABLATIONS = {
    "loads only": [("constexpr bool kProducts = true;", "constexpr bool kProducts = false;"),
                   ("constexpr bool kF32Products = true;", "constexpr bool kF32Products = false;")],
    "products only": [("constexpr bool kLoads = true;", "constexpr bool kLoads = false;"),
                      ("constexpr bool kF32Loads = true;", "constexpr bool kF32Loads = false;")],
}
# The cases (indexes into ATTN_BWD_CASES) timed against K9_BWD_ABLATIONS:
# phi3-mini's training layer and deepseek-coder-33b's in bf16, phi3-mini's
# layer and GQA 7 in f32.
K9_BWD_ABLATED = (0, 1, 4, 7)


def ablate_k9_bwd(dev, card: str) -> None:
    """K9's backward at ATTN_BWD_CASES: one call timed alone (``cuda_ms``, as
    the other K9 rows), ten calls back to back (the device time a call where
    the host keeps ahead), the host's time to enqueue a call (20 calls, no
    synchronisation between them) and each CUDA kernel's device time a call
    (``kernel_split``), after each instance's registers and spills (ptxas
    -v); then, at K9_BWD_ABLATED, against K9_BWD_ABLATIONS,
    timed in turns (full, each copy, full), each beside the SM clock and
    power draw it runs at (``clock_power``)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd

    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    with ThreadPoolExecutor() as pool:  # every copy's nvcc at once
        built = {name: pool.submit(_attention_bwd_kernel, kdir,
                                   os.path.join(ROOT, "build", "ablate-k9-bwd", str(j)), edits)
                 for j, (name, edits) in enumerate(K9_BWD_ABLATIONS.items())}
        build_kernels(["flash_attention", "flash_attention_bwd"])
        cut = {name: fut.result() for name, fut in built.items()}
    from repro_torch.kernels import common

    log = common.library_path("flash_attention_bwd").with_suffix(".log").read_text()
    print("K9 backward, ptxas -v: " + ptxas_report(log, "flash_attention_bwd_d"))
    gen = torch.Generator(device=dev).manual_seed(39)
    for i, (name, dtype, b, hq, hkv, s, d) in enumerate(ATTN_BWD_CASES):
        q, k, v = _qkv(dtype, b, hq, hkv, s, d, gen, dev)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        args = (q, k, v, *flash_attention_fwd(q, k, v), dout)
        single = cuda_ms(lambda: flash_attention_bwd(*args))
        burst = cuda_ms(lambda: [flash_attention_bwd(*args) for _ in range(10)]) / 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            flash_attention_bwd(*args)
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        print(f"K9 backward {name} ({_layer_label(q, k)}) on {card}: one call {single:.3f} ms, "
              f"ten back to back {burst:.3f} ms a call, the host {host_us:.0f} us to enqueue a "
              f"call; device time a call: "
              f"{split_line(kernel_split(lambda: flash_attention_bwd(*args)))}")
        if i not in K9_BWD_ABLATED:
            continue
        runs = [("full", lambda: flash_attention_bwd(*args))]
        runs += [(label, lambda fn=fn: fn(*args)) for label, fn in cut.items()]
        runs.append(runs[0])
        line = [f"{label} {cuda_ms(fn):.3f} ms ({clock_power(fn)})" for label, fn in runs]
        print(f"K9 backward ablation, {name} ({_layer_label(q, k)}), on {card}: "
              + "; ".join(line))


# Copies of K9's kernels (flash_attention_bf16 and flash_attention_tf32;
# each edit changes both where both hold its text), each timed: without
# the online softmax (P = S: no max, exponential or rescale; results wrong),
# the loads alone (the cp.async ring, barriers and output, no products and
# no softmax; results wrong), both also with 4 warps, and two variants whose
# results are held to the plain version: a three-stage ring, and 4 warps
# (64-row query tiles, the first design: twice the KV bytes from L2).  The
# f32 kernel also without the fold (P V summed onto O by the tensor cores)
# and with Q split once into registers, each also held to the plain version
# (K9_F32_VARIANTS).
K9_NO_SOFTMAX = ("    online_softmax(s, m, l, alpha, scale_log2);\n",
                 "    alpha[0] = alpha[1] = 1.f;\n")
K9_NO_PRODUCTS = [("    for (int ks = 0; ks < Tl::kKSteps; ++ks) {\n",
                   "    for (int ks = 0; ks < 0; ++ks) {\n"),
                  ("    for (int kk = 0; kk < kMmaBK / 16; ++kk) {\n",
                   "    for (int kk = 0; kk < 0; ++kk) {\n"),
                  ("    for (int j = 0; j < kKeyFrags; ++j) {\n      // P of keys 8 j",
                   "    for (int j = 0; j < 0; ++j) {\n      // P of keys 8 j")]
K9_ABLATIONS = {
    "without the softmax (P = S)": [K9_NO_SOFTMAX],
    "loads only": [K9_NO_SOFTMAX, *K9_NO_PRODUCTS],
}
K9_FOUR_WARPS = ("constexpr int kMmaWarps = 8;", "constexpr int kMmaWarps = 4;")
K9_VARIANTS = {
    "3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "4 warps": [K9_FOUR_WARPS],
}
K9_ABLATIONS.update({f"4 warps, {name.split(' (')[0]}": [K9_FOUR_WARPS, *edits]
                     for name, edits in list(K9_ABLATIONS.items())})
K9_NO_FOLD = ("  static constexpr bool kFold = true;", "  static constexpr bool kFold = false;")
K9_Q_REGS = ("  static constexpr bool kQRegs = false;", "  static constexpr bool kQRegs = true;")
K9_F32_ABLATIONS = {name: K9_ABLATIONS[name] for name in ("without the softmax (P = S)",
                                                             "loads only")}
K9_F32_VARIANTS = {
    "no fold (P V onto O)": [K9_NO_FOLD],
    "Q split once into registers": [K9_Q_REGS],
    "Q split once into registers, no fold": [K9_Q_REGS, K9_NO_FOLD],
}


def ablate_k9(dev, card: str) -> None:
    """K9's bf16 kernel at both full-width layers (ATTENTION_LAYERS) against
    copies with parts cut out (K9_ABLATIONS) and other shapes (K9_VARIANTS,
    held to the plain version under the bf16 row rule), timed in turns
    (full, each copy, full); then its f32 kernel at phi3-mini's layer
    against K9_F32_ABLATIONS, K9_VARIANTS (held to the plain version under
    the f32 row rule) and K9_F32_VARIANTS (their largest error printed, and
    whether they keep the row rule), each time beside the SM clock and power
    draw it runs at (``clock_power``)."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention

    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    copies = {**K9_ABLATIONS, **K9_VARIANTS, **K9_F32_VARIANTS}
    with ThreadPoolExecutor() as pool:  # every copy's nvcc at once
        built = {name: pool.submit(_attention_kernel, kdir,
                                   os.path.join(ROOT, "build", "ablate-k9", str(j)), edits)
                 for j, (name, edits) in enumerate(copies.items())}
        build_kernels(["flash_attention"])
        cut = {name: fut.result() for name, fut in built.items()}
    for name, (q, k, v) in _attention_layers(dev, f32=True).items():
        f32 = q.dtype == torch.float32
        want = ref.attention_ref(q, k, v)
        for variant in [*K9_VARIANTS, *(K9_F32_VARIANTS if f32 else ())]:
            got = cut[variant](q, k, v)
            try:
                err = compare_dense(f"K9 {name}, {variant}", got, want, exact=False,
                                    tol=ATTN_TOL[q.dtype])
                verdict = "within the row rule"
            except AssertionError as fault:
                if variant in K9_VARIANTS:
                    raise
                err, verdict = float((got - want).abs().max()), f"past the row rule: {fault}"
            print(f"K9 {name}, {variant}: vs plain max_abs_err {err:.3g}, {verdict}")
            del got
        del want
        labels = [*(K9_F32_ABLATIONS if f32 else K9_ABLATIONS), *K9_VARIANTS,
                  *(K9_F32_VARIANTS if f32 else ())]
        runs = [("full", lambda: flash_attention(q, k, v))]
        runs += [(label, lambda fn=cut[label]: fn(q, k, v)) for label in labels]
        runs.append(runs[0])
        line = [f"{label} {cuda_ms(fn):.3f} ms" + (f" ({clock_power(fn)})" if f32 else "")
                for label, fn in runs]
        print(f"K9 ablation, {name} ({_layer_label(q, k)}), on {card}: " + "; ".join(line))


def pair_k7(card: str, old, operands: dict) -> None:
    """K7 of another tree (``old``, from ``_score_matmul_kernel``) and of
    this tree on each of ``operands`` ({label: (q, docs)}: bf16 classic or
    int8 dot, f32 out), their outputs held to each other (int8 bit for bit,
    bf16 under the row rule) and timed in turns (parent, this, this,
    parent; median of RUNS each)."""
    from repro_torch.kernels.fakewords_score.kernel import score_matmul

    for label, (q, docs) in operands.items():
        err = compare_dense(f"K7 {label}: this tree vs the parent", score_matmul(q, docs),
                            old(q, docs), exact=q.dtype == torch.int8)
        torch.cuda.empty_cache()
        times = [cuda_ms(lambda i=i: (old if i in (0, 3) else score_matmul)(q, docs))
                 for i in range(4)]
        print(f"pairing K7 {label} (N={docs.shape[0]}, T={q.shape[1]}) on {card}: parent "
              f"{times[0]:.3f} ms, this tree {times[1]:.3f} ms, this tree {times[2]:.3f} ms, "
              f"parent {times[3]:.3f} ms; max |this - parent| {err:.3g}")


def pair_k8(card: str, old, sig_q, sig) -> None:
    """K8 of this tree and of the parent (``old``, from ``_k8_kernel``) over
    the lexical-LSH signatures at B = 256, 8 and 1, counts held to each
    other bit for bit, timed in turns (parent, this, this, parent)."""
    from repro_torch.kernels.lsh_match.kernel import lsh_match_scores

    for bb in (256, 8, 1):
        qb = sig_q[:bb]
        compare_dense(f"K8 B={bb}: this tree vs the parent", lsh_match_scores(qb, sig),
                      old(qb, sig), exact=True)
        times = [cuda_ms(lambda i=i: (old if i in (0, 3) else lsh_match_scores)(qb, sig))
                 for i in range(4)]
        print(f"pairing K8 B={bb} (N={sig.shape[0]}, S={sig.shape[1]}) on {card}: parent "
              f"{times[0]:.3f} ms, this tree {times[1]:.3f} ms, this tree {times[2]:.3f} ms, "
              f"parent {times[3]:.3f} ms")
        torch.cuda.empty_cache()


def pair_k6(card: str, old, qn, x) -> None:
    """K6 of another tree (``old``, from ``_cosine_kernel``) and of this tree
    at the cell, as ``cosine_topk`` calls it (the unit queries ``qn`` against
    the raw corpus ``x`` and its inverse norms), their outputs held to each
    other under the row rule and timed in turns (parent, this, this,
    parent; median of RUNS each)."""
    from repro_torch.kernels.cosine_score.kernel import cosine_scores

    inv = 1.0 / torch.clamp(torch.linalg.vector_norm(x, dim=-1), min=1e-12)
    err = compare_dense(f"K6 B={qn.shape[0]}: this tree vs the parent", cosine_scores(qn, x, inv),
                        old(qn, x, inv), exact=False)
    torch.cuda.empty_cache()
    times = [cuda_ms(lambda i=i: (old if i in (0, 3) else cosine_scores)(qn, x, inv))
             for i in range(4)]
    print(f"pairing K6 f32 B={qn.shape[0]} (N={x.shape[0]}, T={x.shape[1]}) on {card}: parent "
          f"{times[0]:.3f} ms, this tree {times[1]:.3f} ms, this tree {times[2]:.3f} ms, "
          f"parent {times[3]:.3f} ms; max |this - parent| {err:.3g}")


def _k7_cell_operands(dev) -> dict:
    """{label: (q, docs)}: random operands of K7 at the ann-word2vec cell's
    shapes (B = 256, N = 2,999,808, T = 600): a bf16 query against bf16 rows
    (classic), and an int8 [u; -u] query against term counts 0..127 (dot)."""
    n, t = 2_999_808, 600
    gen = torch.Generator(device=dev).manual_seed(11)
    q = (torch.randn((256, t), generator=gen, device=dev) / t**0.5).to(torch.bfloat16)
    docs = torch.randn((n, t), generator=gen, device=dev).to(torch.bfloat16)
    u = torch.randint(0, 128, (256, t // 2), generator=gen, device=dev)
    tf = torch.randint(0, 128, (n, t), generator=gen, device=dev, dtype=torch.int8)
    return {"classic bf16 B=256": (q, docs),
            "dot int8 B=256": (torch.cat([u, -u], 1).to(torch.int8), tf)}


# Copies of K7 (fakewords_score.cu), for timing only (their results are
# wrong): without the stores (each pair of sums compared with a value it
# never takes, so they stay live), the loads alone (no mma, no stores), the
# stores alone (no chunk copied or multiplied: zeros written), and the
# products alone (on whatever the stages hold; no copies, no stores); and
# variants whose results are held to the kernel's: write-back stores
# (st.global.wb) in place of the streaming ones, the queries streamed
# through the ring beside each doc chunk in place of resident, rings of
# other depths, and 16 warps of 64 x 32 tiles in place of 8 of 64 x 64.
K7_NO_STORES = ("  if (d + 1 < N && (N & 1) == 0) {\n",
                "  if (v0 != O(-1234567) || v1 != v0) return;\n"
                "  if (d + 1 < N && (N & 1) == 0) {\n")
K7_NO_PRODUCTS = ("for (int ks = 0; ks < kKSteps; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {")
K7_NO_COPIES = ("  auto copy_next = [&]() {  // the next chunk into its stage of the ring\n",
                "  auto copy_next = [&]() {  // the next chunk into its stage of the ring\n"
                "    return;\n")
K7_ABLATIONS = {
    "no stores (sums kept live)": [K7_NO_STORES],
    "loads only (no mma, no stores)": [K7_NO_STORES, K7_NO_PRODUCTS],
    "stores only (no loads, no mma)": [K7_NO_COPIES, K7_NO_PRODUCTS],
    "products only (no loads, no stores)": [K7_NO_COPIES, K7_NO_STORES],
}
K7_VARIANTS = {
    "write-back stores": [("__stcs(", "__stwb(")],
    "queries streamed": [("  const bool resident = smem_bytes<Op>(true, kRingStages, n_chunks) "
                          "<= kMaxSmem;", "  const bool resident = false;")],
    "3 stages": [("constexpr int kRingStages = 4;", "constexpr int kRingStages = 3;")],
    "8 stages (classic's queries then streamed)": [("constexpr int kRingStages = 4;",
                                                    "constexpr int kRingStages = 8;")],
    "16 warps, 64 x 32 warp tiles": [("constexpr int kThreads = 256;",
                                      "constexpr int kThreads = 512;"),
                                     ("constexpr int kWarpsQ = 2, kWarpsD = 4;",
                                      "constexpr int kWarpsQ = 2, kWarpsD = 8;")],
}


def clock_power(fn, seconds: float = 1.0) -> str:
    """The card's median SM clock and power draw (``nvidia-smi``, every 50
    ms) while ``fn`` runs back to back for ``seconds``."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines() if "," in line]
    rows = rows[len(rows) // 4:]  # the sampler's first readings precede the load
    if not rows:
        return "clock not read"
    return (f"{statistics.median(float(r[0]) for r in rows):.0f} MHz, "
            f"{statistics.median(float(r[1]) for r in rows):.0f} W")


def ablate_k7(dev, card: str) -> None:
    """K7 at the cell's shapes (``_k7_cell_operands``) against copies with
    parts cut out (K7_ABLATIONS) and other designs (K7_VARIANTS, held to the
    kernel's output bit for bit: the same sums in the same order), timed in
    turns (full, each copy, full), each beside the SM clock and power draw
    it runs at (``clock_power``: the card may hold its power limit by
    lowering the clock)."""
    from repro_torch.kernels.fakewords_score.kernel import score_matmul

    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    copies = {**K7_ABLATIONS, **K7_VARIANTS}
    with ThreadPoolExecutor() as pool:  # every copy's nvcc at once
        built = {name: pool.submit(_score_matmul_kernel, kdir,
                                   os.path.join(ROOT, "build", "ablate-k7", str(j)), edits)
                 for j, (name, edits) in enumerate(copies.items())}
        build_kernels(["fakewords_score"])
        cut = {name: fut.result() for name, fut in built.items()}
    for label, (q, docs) in _k7_cell_operands(dev).items():
        for variant in K7_VARIANTS:
            compare_dense(f"K7 {label}, {variant}", cut[variant](q, docs), score_matmul(q, docs),
                          exact=True)
            torch.cuda.empty_cache()
        runs = [("full", lambda: score_matmul(q, docs))]
        runs += [(name, lambda fn=fn: fn(q, docs)) for name, fn in cut.items()]
        runs.append(runs[0])
        line = [f"{name} {cuda_ms(fn):.3f} ms ({clock_power(fn)})" for name, fn in runs]
        print(f"K7 ablation, {label} (N={docs.shape[0]}, T={q.shape[1]}), on {card}: "
              + "; ".join(line))


def _k6_cell_operands(dev):
    """(q, docs, inv_norm): random operands of K6 at the ann-word2vec cell's
    shapes (B = 256, N = 2,999,808, T = 300): unit queries against raw rows
    of norms 0.01-10, as check_dense's "f32" cases."""
    gen = torch.Generator(device=dev).manual_seed(12)
    return _dense_inputs("f32", 256, 2_999_808, 300, gen, dev)


# Copies of K6 (cosine_score.cu and its shared header score_matmul.cuh), for
# timing (each prints its largest difference from the kernel): K7's cuts
# (no stores, loads only, stores only, products only; results wrong), the
# products summed onto the row's sums with no fold, and the low tf32 parts
# left unmasked (equal to the kernel's where the mma reads only a
# register's top 19 bits); and variants whose results are held to the
# kernel's bit for bit (the same sums in the same order): rings of 3 and 8
# stages, and the queries streamed through the ring beside each doc chunk.
K6_ABLATIONS = {**K7_ABLATIONS,
                "no fold (products onto the row's sums)": [(
                    "  static constexpr bool kFold = true;",
                    "  static constexpr bool kFold = false;")]}
K6_VARIANTS = {name: K7_VARIANTS[name] for name in ("3 stages", "queries streamed")}
K6_VARIANTS["8 stages"] = K7_VARIANTS["8 stages (classic's queries then streamed)"]
K6_ABLATIONS["low parts not masked (the mma reads 19 bits)"] = [
    (f"{x}[{n} + r] = __float_as_uint(x - __uint_as_float({x}[r])) & kTf32Bits;",
     f"{x}[{n} + r] = __float_as_uint(x - __uint_as_float({x}[r]));")
    for x, n in (("a", 4), ("b", 2))]


def ablate_k6(dev, card: str) -> None:
    """K6 at the cell's shapes (``_k6_cell_operands``) against copies with
    parts cut out (K6_ABLATIONS) and other designs (K6_VARIANTS, held to the
    kernel's output bit for bit), timed in turns (full, each copy, full),
    each beside the SM clock and power draw it runs at (``clock_power``)."""
    from repro_torch.kernels.cosine_score.kernel import cosine_scores

    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    copies = {**K6_ABLATIONS, **K6_VARIANTS}
    with ThreadPoolExecutor() as pool:  # every copy's nvcc at once
        built = {name: pool.submit(_cosine_kernel, kdir,
                                   os.path.join(ROOT, "build", "ablate-k6", str(j)), edits)
                 for j, (name, edits) in enumerate(copies.items())}
        build_kernels(["cosine_score"])
        cut = {name: fut.result() for name, fut in built.items()}
    q, docs, inv = _k6_cell_operands(dev)
    full = cosine_scores(q, docs, inv)
    for name, fn in cut.items():
        got = fn(q, docs, inv)
        if name in K6_VARIANTS:
            compare_dense(f"K6, {name}", got, full, exact=True)
        print(f"K6, {name}: max |copy - kernel| {float((got - full).abs().max()):.3g}")
        del got
    del full
    torch.cuda.empty_cache()
    runs = [("full", lambda: cosine_scores(q, docs, inv))]
    runs += [(name, lambda fn=fn: fn(q, docs, inv)) for name, fn in cut.items()]
    runs.append(runs[0])
    line = [f"{name} {cuda_ms(fn):.3f} ms ({clock_power(fn)})" for name, fn in runs]
    print(f"K6 ablation, f32 B={q.shape[0]} (N={docs.shape[0]}, T={q.shape[1]}), on {card}: "
          + "; ".join(line))


def pair_parent(dev, card: str, parent: str) -> None:
    """K1-K5 of the tree ``parent`` (its own sources, plans and C
    signatures, ``_tree_kernels``) and of this tree on the same ann-word2vec
    inputs in one process, timed in turns (parent, this, this, parent;
    median of RUNS each), with the results
    held to each other (ids equal away from near-ties; integer scores bit
    for bit): K1 classic (bf16, the main path's call) at B = 256 and B = 1,
    K1 f32 (the ground truth's call) at B = 256, 8 and 1 and K1 dot (the dot search's
    call) at B = 256, 8 and 1 over the fp32 index; K3 (blockmax stage 2 at
    10% of the blocks, rows in bound order) classic at B = 256, 8 and 1,
    each tree's pass 1 and pass 2 apart (torch.profiler), and dot at B = 8
    and 1; K1 lsh (K2) at B = 256, 8 and 1 over the lexical-LSH signatures; K4
    with a bf16 query over int8 and int4 (group 32) postings at B = 256, 8
    and 1 (the quantized classic search's call), K5 over the int4 postings
    at 10% of the blocks at B = 256, 8 and 1, and K4 with an f32 query over int8 and over
    int4 (group 32) postings at B = 256, 8 and 1 (brute force's call), also
    with an integer query over unit scales (int8) or over distinct
    power-of-two group scales (int4; ``pow2_scales``), bit for bit; and K7
    (``pair_k7``, that tree's ``fakewords_score.cu``) classic and dot at
    B = 256 on the index's ``scored`` and ``tf``.  First it says which
    kernel instances both trees build, and whether their SASS is identical,
    for K1-K5, K7, and K6 and K8 (``cosine_score.cu``, ``lsh_match.cu``)."""
    from repro_torch.configs import ann_word2vec
    from repro_torch.core import blockmax, bruteforce, fakewords, lexical_lsh
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import BruteForceConfig, LexicalLshConfig
    from repro_torch.kernels.fused_topk.kernel import (
        fused_topk,
        fused_topk_gathered,
        fused_topk_gathered_quantized,
        fused_topk_quantized,
    )

    pdir = os.path.join(os.path.abspath(parent), "src", "repro_torch", "kernels")
    dense_dir = os.path.join(ROOT, "build", "pair-dense")
    with ThreadPoolExecutor() as pool:  # the parent's nvcc beside this tree's
        parent_build = pool.submit(_tree_kernels, pdir, os.path.join(ROOT, "build", "pair"))
        parent_k7 = pool.submit(_score_matmul_kernel, pdir,
                                os.path.join(dense_dir, "fakewords_score"))
        parent_k6 = pool.submit(_cosine_kernel, pdir, os.path.join(dense_dir, "cosine_score"))
        parent_k8 = pool.submit(_k8_kernel, pdir, os.path.join(dense_dir, "lsh_match"))
        build_kernels(["fused_topk", "fused_topk_quantized", "fakewords_score", "cosine_score",
                       "lsh_match"])
        old, old_k7, old_k6 = parent_build.result(), parent_k7.result(), parent_k6.result()
        old_k8 = parent_k8.result()
    for name in ("fused_topk", "fused_topk_quantized"):  # instances in both trees
        sass_pairing(name, os.path.join(ROOT, "build", "pair", f"lib{name}.so"))
    for name in ("fakewords_score", "cosine_score", "lsh_match"):
        sass_pairing(name, os.path.join(dense_dir, name, f"lib{name}.so"))
    cell = ann_word2vec.ARCH.cell("ann_search")
    config = ann_word2vec.ARCH.make_model(cell)
    x, qx = make_inputs(dev, cell.get("n_docs"), cell.batch)
    depth, k = cell.get("depth"), cell.get("k")
    qn = bruteforce.l2_normalize(qx)

    def pair(name, new, parent_fn, args, d, exact=False):
        compare(f"{name}: this tree vs the parent", new(*args, d), parent_fn(*args, d + 1),
                exact=exact)
        times = [cuda_ms(lambda: (parent_fn if i in (0, 3) else new)(*args, d)) for i in range(4)]
        print(f"pairing {name} on {card}: parent {times[0]:.3f} ms, this tree {times[1]:.3f} ms, "
              f"this tree {times[2]:.3f} ms, parent {times[3]:.3f} ms")

    idx = AnnIndex.build(x, config, device=dev)
    q_tf = fakewords.encode_queries(qn, config, normalized=True)
    qv = fakewords.classic_query(idx.index, q_tf)
    for name, q, docs, d in (("K1 classic bf16 B=256", qv, idx.index.scored, depth),
                             ("K1 classic bf16 B=1", qv[:1], idx.index.scored, depth),
                             ("K1 f32 B=256", qn, idx.index.vectors, k),
                             ("K1 f32 B=8", qn[:8], idx.index.vectors, k),
                             ("K1 f32 B=1", qn[:1], idx.index.vectors, k)):
        pair(name, fused_topk, old["fused_topk"], (q, docs), d)
    q_dot = fakewords.dot_query(idx.index, q_tf, dtype=torch.int8)
    for bb in (256, 8, 1):  # integer scores: bit for bit
        pair(f"K1 dot int8 B={bb}", fused_topk, old["fused_topk"], (q_dot[:bb], idx.index.tf),
             depth, exact=True)
    pair_k7(card, old_k7, {f"classic bf16 B={qv.shape[0]}": (qv, idx.index.scored),
                           f"dot int8 B={q_dot.shape[0]}": (q_dot, idx.index.tf)})
    pair_k6(card, old_k6, qn, x)
    # K3 (blockmax stage 2) at 10% of the blocks, rows in bound order:
    # classic at B = 256, 8 and 1, with each tree's pass 1 and pass 2 apart,
    # and dot (int8, bit for bit) at B = 8 and 1.
    n = x.shape[0]
    keep = int(KEEP_FRACTIONS[0] * -(-n // BLOCK))

    def k3(fn):
        return lambda q, store, rows, d: fn(q, store, rows, d, n)

    bm = blockmax.build_blockmax(idx.index, BLOCK)
    rows = blockmax.kept_rows(bm, q_tf, keep)
    q_k3 = q_tf.to(torch.bfloat16)
    for bb in (256, 8, 1):
        args = (q_k3[:bb], idx.index.scored, rows[:bb])
        pair(f"K3 classic bf16 n_keep={keep} B={bb}", k3(fused_topk_gathered),
             k3(old["fused_topk_gathered"]), args, depth)
        for label, fn in (("parent", old["fused_topk_gathered"]),
                          ("this tree", fused_topk_gathered)):
            print(f"pairing K3 classic bf16 n_keep={keep} B={bb}, passes ({label}, torch.profiler) "
                  f"on {card}: " + split_line(kernel_split(lambda: fn(*args, depth, n),
                                                            runs=3 if bb > 8 else 5)))
    bm_dot = blockmax.build_blockmax(idx.index, BLOCK, mode="dot")
    q_k3 = blockmax._stage2_operands(idx.index, bm_dot, q_tf[:8])[0].contiguous()
    rows = blockmax.kept_rows(bm_dot, q_tf[:8], keep)
    for bb in (8, 1):
        pair(f"K3 dot int8 n_keep={keep} B={bb}", k3(fused_topk_gathered),
             k3(old["fused_topk_gathered"]), (q_k3[:bb], idx.index.tf, rows[:bb]), depth,
             exact=True)
    del idx, qv, q_dot, bm, bm_dot, rows, q_k3
    torch.cuda.empty_cache()
    # K2: K1's lsh mode over the lexical-LSH signatures (b = 300, h = 1), bit for bit.
    lcfg = LexicalLshConfig(buckets=300, hashes=1)
    lidx = AnnIndex.build(x, lcfg, keep_vectors=False, device=dev)
    sig_q = lexical_lsh.encode(qn, lcfg)
    for bb in (256, 8, 1):
        pair(f"K1 lsh B={bb}", lambda q, sig, d: fused_topk(q, sig, d, mode="lsh"),
             old["fused_topk"], (sig_q[:bb], lidx.index.sig), depth, exact=True)
    pair_k8(card, old_k8, sig_q, lidx.index.sig)
    del lidx, sig_q
    torch.cuda.empty_cache()

    def k4_new(q, pq, d):
        return fused_topk_quantized(q, pq.q, pq.scale, d, pq.bits, pq.group)

    for pp in ("int8", "int4"):
        qidx = AnnIndex.build(x, config, primary_postings=pp, postings_group=GROUP,
                              rerank_store="none", device=dev)
        qv = fakewords.classic_query(qidx.index, q_tf)
        for bb in (256, 8, 1):
            pair(f"K4 {pp} bf16 query B={bb}", k4_new, old["fused_topk_quantized"],
                 (qv[:bb], qidx.index.pq), depth)
        # K5: blockmax stage 2 over the index, 10% of the blocks (int4 at
        # B = 256, 8 and 1; int8 at B = 8)
        rows = blockmax.kept_rows(blockmax.build_blockmax(qidx.index, BLOCK), q_tf, keep)
        q_k5 = q_tf.to(torch.bfloat16)
        for bb in ((256, 8, 1) if pp == "int4" else (8,)):
            pair(f"K5 {pp} bf16 query n_keep={keep} B={bb}",
                 lambda q, pq, rws, d: fused_topk_gathered_quantized(
                     q, pq.q, pq.scale, rws, d, n, pq.bits, pq.group),
                 lambda q, pq, rws, d: old["fused_topk_gathered_quantized"](q, pq, rws, d, n),
                 (q_k5[:bb], qidx.index.pq, rows[:bb]), depth)
        del qidx, qv, rows, q_k5
        torch.cuda.empty_cache()
    bidx = AnnIndex.build(x, BruteForceConfig(), primary_postings="int8", rerank_store="none",
                          device=dev)
    # and an integer query over the same rows with unit scales: exact sums
    gen = torch.Generator(device=dev).manual_seed(8)
    q_int = torch.randint(-20, 21, qn.shape, generator=gen, device=dev).float()
    unit = dataclasses.replace(bidx.index.pq, scale=torch.ones_like(bidx.index.pq.scale))
    for bb in (256, 8, 1):
        pair(f"K4 int8 f32 query B={bb}", k4_new, old["fused_topk_quantized"],
             (qn[:bb], bidx.index.pq), depth)
        pair(f"K4 int8 f32 integer query, unit scales B={bb}", k4_new,
             old["fused_topk_quantized"], (q_int[:bb], unit), depth, exact=True)
    del bidx, unit
    torch.cuda.empty_cache()
    bidx = AnnIndex.build(x, BruteForceConfig(), primary_postings="int4", postings_group=GROUP,
                          rerank_store="none", device=dev)
    pq4 = bidx.index.pq
    pow2 = dataclasses.replace(pq4, scale=pow2_scales(*pq4.scale.shape, dev))
    for bb in (256, 8, 1):
        pair(f"K4 int4 f32 query B={bb}", k4_new, old["fused_topk_quantized"], (qn[:bb], pq4),
             depth)
        pair(f"K4 int4 f32 integer query, power-of-two group scales B={bb}", k4_new,
             old["fused_topk_quantized"], (q_int[:bb], pow2), depth, exact=True)


def make_inputs(dev, n: int, b: int):
    """The ann-word2vec corpus (n x 300) and B queries, on ``dev``."""
    from repro_torch.data.embeddings import WORD2VEC_LIKE, make_corpus, make_queries

    t0 = time.perf_counter()
    corpus = make_corpus(dataclasses.replace(WORD2VEC_LIKE, n_vectors=n))
    queries, _ = make_queries(corpus, b, seed=1)
    print(f"corpus {corpus.shape} {corpus.dtype} made on the host in "
          f"{time.perf_counter() - t0:.1f} s (seed {WORD2VEC_LIKE.seed})")
    return torch.from_numpy(corpus).to(dev), torch.from_numpy(queries).to(dev)


def drive(dev, card: str, x, qx, depth: int, k: int, config):
    """Every fp32-postings main path over the corpus ``x`` (n docs) with the
    B queries ``qx`` on ``dev``; returns the per-kernel JSON entries and the
    exact top-k ids, both indexes and the classic block bounds (for
    :func:`drive_filtered`)."""
    from repro_torch.core import blockmax, bruteforce, eval as ev, fakewords, lexical_lsh
    from repro_torch.core import pipeline as pl
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import BruteForceConfig, LexicalLshConfig
    from repro_torch.kernels.fused_topk import ops, ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk, fused_topk_gathered

    n, b = x.shape[0], qx.shape[0]

    # ---- main path 1: classic fake words, dense -------------------------
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = AnnIndex.build(x, config, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s100, i100 = idx.search(qx, k=depth, depth=depth, rerank=False)
    rr_s, rr_i = idx.search(qx, k=k, depth=depth, rerank=True)
    torch.cuda.synchronize()
    search_launches = fused_topk.launches
    qn = bruteforce.l2_normalize(qx)
    gt_s, gt_i = bruteforce.exact_topk(idx.index.vectors, qn, k, normalized=True)
    torch.cuda.synchronize()
    gt_launches = fused_topk.launches - search_launches
    print(f"main path: build {build_s:.2f} s (first call), index {idx.nbytes() / 1e9:.2f} GB "
          f"on the card; fused_topk launches: search {search_launches}, "
          f"ground truth {gt_launches}")
    if search_launches <= 0 or gt_launches <= 0:
        raise AssertionError("the main path did not run through the fused_topk kernel")
    for name, (s, i, w) in {"match": (s100, i100, depth), "rerank": (rr_s, rr_i, k),
                            "truth": (gt_s, gt_i, k)}.items():
        _checked(name, s, i, b, w, n)
    r10_10 = float(ev.recall_at(gt_i, i100[:, :k]))
    r10_100 = float(ev.recall_at(gt_i, i100))
    r_rr = float(ev.recall_at(gt_i, rr_i))
    print(f"recall: R@(10,10) {r10_10:.4f}  R@(10,100) {r10_100:.4f}  "
          f"reranked R@10 {r_rr:.4f}")
    if abs(r_rr - r10_100) > 0.002:
        raise AssertionError("exact rerank of 100 candidates lost true top-10 ids")

    # The main-path calls against the plain version, 32 queries.
    q_tf = fakewords.encode_queries(qn, config, normalized=True)
    qv = fakewords.classic_query(idx.index, q_tf)
    scored, vectors = idx.index.scored, idx.index.vectors
    err_classic = compare("classic match, 32 queries", (s100[:32], i100[:32]),
                          ref.fused_topk_ref(qv[:32], scored, depth + 1), exact=False)
    err_f32 = compare("f32 ground truth, 32 queries", (gt_s[:32], gt_i[:32]),
                      ref.fused_topk_ref(qn[:32], vectors, k + 1), exact=False)
    print(f"main-path kernel calls vs plain: classic max_abs_err {err_classic:.3g}, "
          f"f32 max_abs_err {err_f32:.3g}")

    # ---- main path 1b: dot scoring over the same index (K1 int8) ----------
    dot_idx = AnnIndex(config=dataclasses.replace(config, scoring="dot"), index=idx.index)
    _reset_launches()
    dot_s, dot_i = dot_idx.search(qx, k=depth, depth=depth)
    torch.cuda.synchronize()
    dot_launches = _only("the dot search", "fused_topk")
    _checked("dot match", dot_s, dot_i, b, depth, n)
    q_dot = fakewords.dot_query(idx.index, q_tf, dtype=torch.int8)
    tf = idx.index.tf
    err_dot = compare("dot match, 32 queries", (dot_s[:32], dot_i[:32]),
                      ref.fused_topk_ref(q_dot[:32], tf, depth), exact=True)
    print(f"dot search (int8 tf, K1 int8): R@(10,100) {float(ev.recall_at(gt_i, dot_i)):.4f}; "
          f"fused_topk launches {dot_launches}; vs plain on 32 queries max_abs_err {err_dot:.3g}")

    # ---- main path 1c: brute force over fp32 postings (K1 f32) -------------
    # The exact cosine as a user searches it: its ids at B = 256, 8 and 1
    # must be the ground truth's (the same kernel over the same unit rows).
    bidx = AnnIndex.build(x, BruteForceConfig(), device=dev)
    line = []
    for bb in (b, 8, 1):
        _reset_launches()
        bf_s, bf_i = bidx.search(qx[:bb], k=k, depth=k)
        torch.cuda.synchronize()
        bf_launches = _only(f"brute force over fp32 postings, B={bb}", "fused_topk")
        _checked(f"brute force fp32 B={bb}", bf_s, bf_i, bb, k, n)
        if not torch.equal(bf_i, gt_i[:bb]):
            raise AssertionError(f"brute force over fp32 postings, B={bb}: "
                                 f"{int((bf_i != gt_i[:bb]).sum())} ids differ from the truth")
        line.append(f"B={bb} {cuda_ms(lambda: bidx.search(qx[:bb], k=k, depth=k)):.3f} ms "
                    f"({bf_launches} launch)")
    print(f"brute force, fp32 postings ({bidx.nbytes() / 1e9:.2f} GB), k = depth = {k}: ids equal "
          f"the ground truth's at B = {b}, 8 and 1; search (median of {RUNS}, CUDA events) on "
          f"{card}: {'; '.join(line)}")
    del bidx
    torch.cuda.empty_cache()

    # ---- main path 2: blockmax classic ----------------------------------
    n_blocks = -(-n // BLOCK)
    keeps = [int(f * n_blocks) for f in KEEP_FRACTIONS]
    t0 = time.perf_counter()
    bm = blockmax.build_blockmax(idx.index, BLOCK)
    torch.cuda.synchronize()
    print(f"blockmax classic bounds: {n_blocks} blocks of {BLOCK} rows, "
          f"built in {time.perf_counter() - t0:.2f} s (first call)")
    pruned, k3_launches, k3_err = {}, {}, 0.0
    for n_keep in keeps:
        pidx = AnnIndex(config=config, index=idx.index, blockmax_keep=n_keep,
                        blockmax_block_size=BLOCK, bm=bm)
        _reset_launches()
        s, i = pidx.search(qx, k=depth, depth=depth)
        ps, pi = pidx.search(qx, k=k, depth=depth, rerank=True)
        torch.cuda.synchronize()
        k3_launches[n_keep] = fused_topk_gathered.launches
        if fused_topk_gathered.launches <= 0 or fused_topk.launches != 0:
            raise AssertionError(f"blockmax n_keep={n_keep} did not run through K3 alone: "
                                 f"gathered {fused_topk_gathered.launches}, "
                                 f"dense {fused_topk.launches}")
        _checked(f"blockmax n_keep={n_keep}", s, i, b, depth, n)
        _checked(f"blockmax n_keep={n_keep} rerank", ps, pi, b, k, n)
        # The B = 256 call's own K3 launch plan, against the plain version on
        # its first 8 queries (a query's result does not depend on B).
        rows_main = blockmax.kept_rows(bm, q_tf, n_keep)[:8]
        q8v = q_tf[:8].to(torch.bfloat16)
        err_main = compare(
            f"blockmax classic B={b} n_keep={n_keep}, first 8 queries", (s[:8], i[:8]),
            ref.gathered_topk_ref(q8v, ref.gather_rows(scored, rows_main, n), rows_main,
                                  depth + 1, n), exact=False)
        k3_err = max(k3_err, err_main)
        pruned[n_keep] = pidx
        print(f"blockmax classic n_keep={n_keep} ({n_keep * BLOCK} rows a query): "
              f"R@(10,10) {float(ev.recall_at(gt_i, i[:, :k])):.4f}  "
              f"R@(10,100) {float(ev.recall_at(gt_i, i)):.4f}  "
              f"reranked R@10 {float(ev.recall_at(gt_i, pi)):.4f}; "
              f"fused_topk_gathered launches {fused_topk_gathered.launches}; "
              f"K3 vs plain on the first 8 queries max_abs_err {err_main:.3g}")

    # ---- main path 3: lexical LSH (b = 300, h = 1) on K2 ----------------
    lcfg = LexicalLshConfig(buckets=300, hashes=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lidx = AnnIndex.build(x, lcfg, keep_vectors=False, device=dev)
    torch.cuda.synchronize()
    lsh_build_s = time.perf_counter() - t0
    _reset_launches()
    ls, li = lidx.search(qx, k=depth, depth=depth)
    torch.cuda.synchronize()
    lsh_launches = fused_topk.launches
    if lsh_launches <= 0 or fused_topk_gathered.launches != 0:
        raise AssertionError("the LSH search did not run through K1's lsh mode")
    _checked("lsh match", ls, li, b, depth, n)
    sig_q = lexical_lsh.encode(qn, lcfg)
    err_lsh = compare("lsh match, 32 queries", (ls[:32], li[:32]),
                      ref.fused_topk_ref(sig_q[:32], lidx.index.sig, depth + 1, mode="lsh"),
                      exact=True)
    print(f"lexical LSH {lcfg}: build {lsh_build_s:.2f} s (first call), index "
          f"{lidx.nbytes() / 1e9:.2f} GB; R@(10,10) {float(ev.recall_at(gt_i, li[:, :k])):.4f}  "
          f"R@(10,100) {float(ev.recall_at(gt_i, li)):.4f}; fused_topk (lsh) launches "
          f"{lsh_launches}; vs plain on 32 queries max_abs_err {err_lsh:.3g}")

    # ---- every block kept, 8 queries: blockmax equals the dense search ---
    q8 = qx[:8]
    every = AnnIndex(config=config, index=idx.index, blockmax_keep=n_blocks,
                     blockmax_block_size=BLOCK, bm=bm)
    compare("blockmax classic, every block, 8 queries", every.search(q8, k=depth, depth=depth),
            idx.search(q8, k=depth + 1, depth=depth + 1), exact=False)
    bm_dot = blockmax.build_blockmax(idx.index, BLOCK, mode="dot")
    compare("blockmax dot, every block, 8 queries",
            pl.BlockMaxMatcher(n_blocks, bm_dot)(idx.index, q_tf[:8], depth),
            ops.dot_topk(idx.index, q_tf[:8], depth), exact=True)
    every_lsh = AnnIndex(config=lcfg, index=lidx.index, blockmax_keep=n_blocks,
                         blockmax_block_size=BLOCK)
    compare("blockmax lsh, every block, 8 queries", every_lsh.search(q8, k=depth, depth=depth),
            lidx.search(q8, k=depth, depth=depth), exact=True)
    print("blockmax at every block kept equals the dense search: classic (near-tie rule), "
          "dot and lsh (exact)")

    # ---- K3 at the main path's shape (B = 8, 10% of the blocks) ----------
    keep = keeps[0]
    qv8 = q_tf[:8].to(torch.bfloat16)
    rows8 = blockmax.kept_rows(bm, q_tf[:8], keep)
    err_k3 = compare(f"fused_topk_gathered classic, B=8, n_keep={keep}",
                     fused_topk_gathered(qv8, scored, rows8, depth, n),
                     ref.gathered_topk_ref(qv8, ref.gather_rows(scored, rows8, n), rows8,
                                           depth + 1, n),
                     exact=False)
    k3_err = max(k3_err, err_k3)
    print(f"main-path K3 call vs plain: max_abs_err {err_k3:.3g}")

    # ---- times ----------------------------------------------------------
    def rebuild():
        AnnIndex.build(x, config, device=dev)

    t_build = cuda_ms(rebuild, warmup=1)
    t_search = cuda_ms(lambda: idx.search(qx, k=k, depth=depth))
    t_search_rr = cuda_ms(lambda: idx.search(qx, k=k, depth=depth, rerank=True))
    t_search_1 = cuda_ms(lambda: idx.search(qx[:1], k=k, depth=depth))
    t_search_1_rr = cuda_ms(lambda: idx.search(qx[:1], k=k, depth=depth, rerank=True))
    t_dot = cuda_ms(lambda: dot_idx.search(qx, k=k, depth=depth))
    t_dot_1 = cuda_ms(lambda: dot_idx.search(qx[:1], k=k, depth=depth))
    print(f"times (median of {RUNS}, CUDA events) on {card}: build {t_build:.1f} ms; "
          f"search B={b} {t_search:.2f} ms, with rerank {t_search_rr:.2f} ms; "
          f"B=1 {t_search_1:.2f} ms, with rerank {t_search_1_rr:.2f} ms; "
          f"dot search B={b} {t_dot:.3f} ms, B=1 {t_dot_1:.3f} ms")
    for n_keep, pidx in pruned.items():
        line = []
        for bb in (1, 8):
            plain = cuda_ms(lambda: pidx.search(qx[:bb], k=k, depth=depth))
            rr = cuda_ms(lambda: pidx.search(qx[:bb], k=k, depth=depth, rerank=True))
            stage1 = cuda_ms(lambda: blockmax.kept_rows(bm, q_tf[:bb], n_keep))
            line.append(f"B={bb} {plain:.3f} ms, with rerank {rr:.3f} ms, "
                        f"stage 1 alone {stage1:.3f} ms")
        t_256 = cuda_ms(lambda: pidx.search(qx, k=k, depth=depth), runs=3, warmup=1)
        print(f"blockmax classic n_keep={n_keep} search: {'; '.join(line)}; "
              f"B={b} {t_256:.2f} ms (median of 3)")
    profile_search(idx, qx, k, depth, card)
    for bb in (1, 8, b):  # K3's pass 1 and pass 2 within the blockmax search
        profile_search(pruned[keeps[0]], qx[:bb], k, depth, card,
                       label=f"blockmax classic n_keep={keeps[0]}")
    t_lsh = cuda_ms(lambda: lidx.search(qx, k=k, depth=depth))
    t_lsh_1 = cuda_ms(lambda: lidx.search(qx[:1], k=k, depth=depth))
    print(f"lexical LSH search: B={b} {t_lsh:.2f} ms; B=1 {t_lsh_1:.3f} ms")

    def int8_library(qb):
        """torch.topk(_int_mm(q, tf.T).float()); _int_mm takes more than 16
        rows, so a smaller B runs on the query zero-padded to 32 rows."""
        if qb.shape[0] > 16:
            return lambda: torch.topk(torch._int_mm(qb, tf.T).float(), depth)
        q_pad = torch.zeros((32, qb.shape[1]), dtype=qb.dtype, device=dev)
        q_pad[:qb.shape[0]] = qb
        return lambda: torch.topk(torch._int_mm(q_pad, tf.T)[:qb.shape[0]].float(), depth)

    kernels = []
    f32_lib = f"torch.topk(matmul) with allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    for name, qop, docs, d, kind, launches, err, library, lib_label in (
            ("fused_topk", qv, scored, depth, "bf16", search_launches, err_classic,
             lambda qb: lambda: torch.topk(torch.matmul(qb, scored.T), depth),
             "torch.topk(matmul)"),
            ("fused_topk/f32-exact", qn, vectors, k, "f32", gt_launches, err_f32,
             lambda qb: lambda: torch.topk(torch.matmul(qb, vectors.T), k), f32_lib),
            ("fused_topk/int8", q_dot, tf, depth, "int8", dot_launches, err_dot, int8_library,
             "torch.topk(torch._int_mm(q, tf.T).float()), B <= 16 on the query zero-padded to "
             "32 rows")):
        # K1 f32 runs split TF32, three tf32 products per f32 one: its row's
        # bound is theirs, and the f32 FMAs of the plain product (the bound of
        # the CUDA-core design it replaced) stand beside it.
        bkind, passes = ("tf32", 3) if kind == "f32" else (kind, 1)
        at = {}  # B -> (kernel, plain, library, bound, bound_by) at the first B queries
        for bb in (b, 8, 1):
            qb = qop[:bb]
            at[bb] = (cuda_ms(lambda: fused_topk(qb, docs, d)),
                      cuda_ms(lambda: ref.fused_topk_ref(qb, docs, d)),
                      cuda_ms(library(qb)), *bound_ms(qb, docs, n, d, bkind, passes))
        fma = ("; f32-FMA bound " + ", ".join(
            f"B={bb} {bound_ms(qop[:bb], docs, n, d, 'f32')[0]:.3f} ms" for bb in at)
            if kind == "f32" else "")
        print(f"{name} ({kind}, N={n}, T={qop.shape[1]}, depth={d}): "
              + "; ".join(f"B={bb} kernel {v[0]:.3f} ms, bound {v[3]:.3f} ms ({v[4]}, {bkind}), "
                          f"plain {v[1]:.3f} ms, library {v[2]:.3f} ms" for bb, v in at.items())
              + f"{fma} (library: {lib_label})")
        ms, plain_ms, lib_ms, bound, bound_by = at[b]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
            "replaces": "src/repro/kernels/fused_topk/kernel.py:288",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        })

    # K2: K1's lsh mode at the LSH path's shape.  No single PyTorch call
    # computes collision counts, so it has no library yardstick.
    sig = lidx.index.sig
    ms = cuda_ms(lambda: fused_topk(sig_q, sig, depth, mode="lsh"))
    small = {bb: (cuda_ms(lambda: fused_topk(sig_q[:bb], sig, depth, mode="lsh")),
                  *bound_ms(sig_q[:bb], sig, n, depth, "int32")) for bb in (8, 1)}
    plain_ms = cuda_ms(lambda: ref.fused_topk_ref(sig_q, sig, depth, mode="lsh"),
                       runs=3, warmup=1)
    bound, bound_by = bound_ms(sig_q, sig, n, depth, "int32")
    print(f"fused_topk/lsh (uint32, B={b}, N={n}, S={sig.shape[1]}, depth={depth}): "
          f"kernel {ms:.3f} ms, bound {bound:.3f} ms ({bound_by}); "
          + "; ".join(f"B={bb} kernel {v[0]:.3f} ms, bound {v[1]:.3f} ms ({v[2]})"
                      for bb, v in small.items())
          + f"; plain {plain_ms:.3f} ms (median of 3); library: none")
    kernels.append({
        "name": "fused_topk/lsh", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
        "replaces": "src/repro/kernels/fused_topk/kernel.py:288",
        "launches": lsh_launches, "max_abs_err": err_lsh, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
    })

    # K3 alone at B = 1, 8 and 256, 10% of the blocks, classic (and dot at
    # B = 1 and 8), with pass 1 and pass 2 apart (torch.profiler).
    k3 = {}
    rows_256 = blockmax.kept_rows(bm, q_tf, keep)
    q256 = q_tf.to(torch.bfloat16)
    for bb in (1, 8, b):
        qb, rb = q256[:bb], rows_256[:bb]
        wide = bb > 8  # no plain version or library call: they gather 92 GB at B = 256
        ms = cuda_ms(lambda: fused_topk_gathered(qb, scored, rb, depth, n),
                     **({"runs": 3, "warmup": 1} if wide else {}))
        plain_ms = None if wide else cuda_ms(lambda: ref.gathered_topk_ref(
            qb, ref.gather_rows(scored, rb, n), rb, depth, n))
        lib_ms = None if wide else cuda_ms(lambda: torch.topk(
            torch.einsum("bt,brt->br", qb, scored[rb.long()]), depth))
        bound, bound_by, distinct = gathered_bound_ms(qb, scored, rb, n, depth, "bf16")
        k3[bb] = (ms, plain_ms, lib_ms, bound, bound_by)
        split = split_line(kernel_split(lambda: fused_topk_gathered(qb, scored, rb, depth, n),
                                        runs=3 if wide else 5))
        print(f"fused_topk_gathered (bf16, B={bb}, R={rb.shape[1]}, T={qb.shape[1]}, "
              f"depth={depth}, {distinct} distinct rows): kernel {ms:.3f} ms"
              f"{' (median of 3)' if wide else ''}, bound {bound:.3f} ms ({bound_by}); "
              + ("plain and torch.topk(einsum(q, store[row_ids])): none, they would gather "
                 f"{bb * rb.shape[1] * qb.shape[1] * 2 / 1e9:.0f} GB" if wide else
                 f"plain {plain_ms:.3f} ms; torch.topk(einsum(q, store[row_ids])) {lib_ms:.3f} ms")
              + f"; passes (torch.profiler): {split}")
    del rows_256, q256
    q_dot_k3, _, _ = blockmax._stage2_operands(idx.index, bm_dot, q_tf[:8])
    rows_dot = blockmax.kept_rows(bm_dot, q_tf[:8], keep)
    for bb in (1, 8):
        qb, rb = q_dot_k3[:bb].contiguous(), rows_dot[:bb]
        ms = cuda_ms(lambda: fused_topk_gathered(qb, tf, rb, depth, n))
        plain_ms = cuda_ms(lambda: ref.gathered_topk_ref(qb, ref.gather_rows(tf, rb, n), rb,
                                                         depth, n))
        lib_ms = cuda_ms(lambda: torch.topk(
            torch.einsum("bt,brt->br", qb.float(), tf[rb.long()].float()), depth))
        bound, bound_by, distinct = gathered_bound_ms(qb, tf, rb, n, depth, "int8")
        split = split_line(kernel_split(lambda: fused_topk_gathered(qb, tf, rb, depth, n)))
        print(f"fused_topk_gathered/int8 (dot, B={bb}, R={rb.shape[1]}, T={qb.shape[1]}, "
              f"depth={depth}, {distinct} distinct rows): kernel {ms:.3f} ms, bound {bound:.3f} "
              f"ms ({bound_by}); plain {plain_ms:.3f} ms; torch.topk(einsum(q.float(), "
              f"tf[row_ids].float())) {lib_ms:.3f} ms; passes (torch.profiler): {split}")
    ms, plain_ms, lib_ms, bound, bound_by = k3[8]
    kernels.append({
        "name": "fused_topk_gathered", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
        "replaces": "src/repro/kernels/fused_topk/kernel.py:433",
        "launches": k3_launches[keep], "max_abs_err": k3_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
    })
    return kernels, gt_i, idx, lidx, bm


def _traced(fn, runs: int) -> list:
    """(start, end, name) of every CUDA kernel of ``runs`` back-to-back
    calls of ``fn`` in a torch.profiler trace, sorted by start.  One call
    before them, inside the trace but outside the measured span, takes the
    first kernels after the trace starts, which the trace may drop (it kept
    4 of 5 pass-1 kernels of the brute-force search whose pass 1 comes
    first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "measured calls"  # on the device's timeline too, as an annotation
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    t0 = min(e.time_range.start for e in events if e.name == mark)
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CUDA and e.name != mark
                  and e.time_range.start >= t0 and e.time_range.end > e.time_range.start)


def kernel_split(fn, runs: int = 5) -> dict:
    """{kernel instance: device ms per call of ``fn``} from a torch.profiler
    trace of ``runs`` calls (``_traced``); {} where the trace holds no
    device time.  Splits a fused top-k call into its pass 1 and pass 2."""
    per = {}
    for a, b, name in _traced(fn, runs):
        key = _instance(name) if "fused_topk" in name or "flash_attention" in name else name[:60]
        per[key] = per.get(key, 0.0) + (b - a) / 1e3 / runs
    return per


def split_line(per: dict) -> str:
    return ", ".join(f"{name} {ms:.4f} ms" for name, ms in per.items()) or "no device time traced"


def profile_search(idx, qx, k: int, depth: int, card: str, label: str = "classic",
                   runs: int = 5) -> None:
    """A torch.profiler trace of ``runs`` back-to-back searches of ``idx``
    (``label`` names them; ``_traced``): device time per CUDA kernel (pass
    1, merge, the encoder's kernels) and the device's idle share between
    the first kernel's start and the last one's end.  Where the trace holds
    no device time, the search is timed with CUDA events instead."""
    spans = _traced(lambda: idx.search(qx, k=k, depth=depth), runs)
    if not spans:
        print(f"profile: torch.profiler recorded no device time; CUDA events on {card}: {label} "
              f"search B={qx.shape[0]} {cuda_ms(lambda: idx.search(qx, k=k, depth=depth)):.3f} ms")
        return
    per, busy, end = {}, 0.0, spans[0][0]
    for a, b, name in spans:
        key = _instance(name) if "fused_topk" in name else name[:60]
        n, t = per.get(key, (0, 0.0))
        per[key] = (n + 1, t + (b - a) / 1e3)
        busy += max(0.0, b - max(a, end))  # the union of the device intervals
        end = max(end, b)
    window = (end - spans[0][0]) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][1])
    rest = sum(t for _, (_, t) in top[8:])
    print(f"profile (torch.profiler, {runs} {label} searches of B={qx.shape[0]}, k {k}, depth "
          f"{depth}) on {card}: device window {window:.3f} ms, busy {busy / 1e3:.3f} ms, idle "
          f"share {1 - busy / 1e3 / window:.4f}; per search: "
          + "; ".join(f"{name} {t / runs:.4f} ms ({n // runs} a search)" for name, (n, t) in top[:8])
          + f"; the other {max(0, len(top) - 8)} kernels {rest / runs:.4f} ms")


def timed(fn):
    """(median ms, runs) of ``fn`` with CUDA events: RUNS runs after a
    warm-up run, or 3 where the warm-up took more than a second."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    runs = RUNS if start.elapsed_time(end) <= 1000 else 3
    return cuda_ms(fn, runs=runs, warmup=0), runs


def dense_bound_ms(q, docs, extra_bytes: int, ops_per_pair: float, kind: str):
    """Bound of one dense (B, N) score call: the query, the store and
    ``extra_bytes`` read once, the 4-byte (B, N) output written once;
    ``ops_per_pair`` * T operations per (query, doc) pair."""
    b, t = q.shape
    n = docs.shape[0]
    nbytes = (q.numel() * q.element_size() + docs.numel() * docs.element_size() + extra_bytes
              + b * n * 4)
    return _bound(nbytes, ops_per_pair * b * n * t, kind)


def attention_bound_ms(q, k, v, kind: str, passes: int = 1):
    """Bound of one causal attention call: q, k, v read once, the output
    written once; ``passes`` x 4 * D operations (two products) per unmasked
    (query, key) pair, S (S + 1) / 2 of them per head ("tf32" with 3 passes
    for the f32 kernel's split TF32)."""
    b, hq, s, d = q.shape
    nbytes = 2 * q.numel() * q.element_size() + (k.numel() + v.numel()) * k.element_size()
    return _bound(nbytes, passes * 4.0 * b * hq * d * s * (s + 1) / 2, kind)


# One attention layer of each model at its cell's sequence, batch cut to 1:
# (name, Hq, Hkv, S, D) from src/repro/configs/{deepseek_coder_33b,
# phi3_mini_3_8b}.py and the prefill_32k / train_4k cells.
ATTENTION_LAYERS = (("deepseek-coder-33b prefill_32k", 56, 8, 32768, 128),
                    ("phi3-mini-3.8b train_4k", 32, 32, 4096, 96))
F32_LAYER = f"{ATTENTION_LAYERS[1][0]}, f32"  # phi3-mini's layer in f32


def drive_dense(dev, card: str, x, qx, gt_i, idx, lidx, depth: int, k: int, config) -> list:
    """The dense-score and attention entry points at full width, with the corpus
    ``x``, its fp32 fake-words index ``idx`` and lexical-LSH index ``lidx``
    on the card: ``fakewords_score.ops.classic_scores`` / ``dot_scores``
    (K7), ``cosine_score.ops.cosine_topk`` over the raw corpus (K6),
    ``lsh_match.ops.lsh_topk`` (K8), and ``flash_attention.ops.
    causal_attention`` (K9) for one attention layer of each model in
    ATTENTION_LAYERS, and in f32 for phi3-mini's.  Returns the kernels' JSON
    entries (K7 classic and dot, K6, K8, and K9 for each layer and for
    phi3-mini's in f32); also times ``cosine_topk`` whole and its
    ``common.stable_topk`` alone."""
    from repro_torch.core import bruteforce, eval as ev, fakewords, lexical_lsh
    from repro_torch.kernels.common import stable_topk
    from repro_torch.kernels.cosine_score import ops as cos_ops, ref as cos_ref
    from repro_torch.kernels.cosine_score.kernel import cosine_scores
    from repro_torch.kernels.fakewords_score import ops as fw_ops, ref as fw_ref
    from repro_torch.kernels.fakewords_score.kernel import score_matmul
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.fused_topk import ops as topk_ops
    from repro_torch.kernels.fused_topk.kernel import fused_topk
    from repro_torch.kernels.lsh_match import ops as lsh_ops, ref as lsh_ref
    from repro_torch.kernels.lsh_match.kernel import lsh_match_scores

    n, b = x.shape[0], qx.shape[0]
    qn = bruteforce.l2_normalize(qx)
    q_tf = fakewords.encode_queries(qn, config, normalized=True)
    sig_q = lexical_lsh.encode(qn, lidx.config)
    index = idx.index
    layers = _attention_layers(dev)
    # K9 in f32 (split TF32) at phi3-mini's layer (the same operands, widened)
    f32_layer = ATTENTION_LAYERS[1]
    layers_f32 = tuple(t.float() for t in layers[f32_layer[0]])
    # The fused top-k kernels' answers to the same queries, for the checks.
    k1_classic = topk_ops.classic_topk(index, q_tf, depth)
    k1_dot = topk_ops.dot_topk(index, q_tf, depth)
    k2_lsh = fused_topk(sig_q, lidx.index.sig, depth, mode="lsh")

    # ---- main path 7: the dense-score and attention entry points ----------
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    top_classic = stable_topk(fw_ops.classic_scores(index, q_tf), depth + 1)
    top_dot = stable_topk(fw_ops.dot_scores(index, q_tf), depth)
    top_cos = cos_ops.cosine_topk(qx, x, k)
    top_lsh = lsh_ops.lsh_topk(lidx.index, sig_q, depth)
    attn = {name: fa_ops.causal_attention(*qkv) for name, qkv in layers.items()}
    attn_f32 = fa_ops.causal_attention(*layers_f32)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = _launches()
    print(f"dense-score and attention entry points: {path_s:.2f} s (first calls); "
          f"launches {counts}")
    for fn in (score_matmul, cosine_scores, lsh_match_scores, flash_attention):
        if counts[fn.__name__] <= 0:
            raise AssertionError(f"the entry points never launched {fn.__name__}: {counts}")
    if any(counts[name] for name in ("fused_topk", "fused_topk_gathered", "fused_topk_quantized",
                                     "fused_topk_gathered_quantized")):
        raise AssertionError(f"the entry points ran a fused top-k kernel: {counts}")

    # What came out, against the fused top-k kernels and the plain versions.
    compare("classic_scores top-100 vs K1 classic search", k1_classic, top_classic, exact=False)
    compare("dot_scores top-100 vs K1 dot search", k1_dot, top_dot, exact=True)
    compare("lsh_topk vs K2", k2_lsh, top_lsh, exact=True)
    q_unit = qx / torch.clamp(torch.linalg.vector_norm(qx, dim=-1, keepdim=True), min=1e-12)
    inv = 1.0 / torch.clamp(torch.linalg.vector_norm(x, dim=-1), min=1e-12)
    compare("cosine_topk vs plain", top_cos,
            stable_topk(cos_ref.cosine_scores_ref(q_unit, x, inv), k + 1), exact=False)
    r_cos = float(ev.recall_at(gt_i, top_cos[1]))
    attn_err = {name: compare_dense(f"causal_attention {name}", attn[name],
                                    fa_ref.attention_ref(*layers[name]), exact=False,
                                    tol=ATTN_TOL[torch.bfloat16])
                for name in layers}
    attn_err[f"{f32_layer[0]}, f32"] = compare_dense(
        f"causal_attention {f32_layer[0]}, f32", attn_f32, fa_ref.attention_ref(*layers_f32),
        exact=False, tol=ATTN_TOL[torch.float32])
    print(f"entry-point outputs: classic / dot top-100 equal K1's (near-tie rule / exact), "
          f"lsh_topk equals K2, cosine_topk R@10 {r_cos:.4f} against the K1 ground truth; causal_attention "
          f"vs plain max_abs_err {attn_err}")
    if r_cos < 0.99:
        raise AssertionError(f"cosine_topk R@10 {r_cos:.4f}: not the exact cosine top-10")
    del top_classic, top_dot, top_cos, top_lsh, attn, attn_f32

    # ---- each kernel at its main-path shape: check and times ---------------
    kernels = []

    def entry(name, fn, plain, library, lib_label, bound, launches, exact, source, replaces,
              tol=TOL, note=""):
        got = fn()
        torch.cuda.synchronize()
        want = plain()
        err = compare_dense(name, got, want, exact=exact, tol=tol)
        del got, want
        ms, runs = timed(fn)
        plain_ms, plain_runs = timed(plain)
        lib_ms = timed(library)[0] if library is not None else None
        print(f"{name}: kernel {ms:.3f} ms (median of {runs}), bound {bound[0]:.3f} ms "
              f"({bound[1]}); plain {plain_ms:.3f} ms (median of {plain_runs}); "
              + (f"{lib_label} {lib_ms:.3f} ms" if library is not None else f"library: {lib_label}")
              + f"; vs plain max_abs_err {err:.3g}{note}")
        kernels.append({
            "name": name.split(" (")[0], "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
        })
        torch.cuda.empty_cache()

    fw_src = "src/repro_torch/kernels/fakewords_score/csrc/fakewords_score.cu"
    fw_rep = "src/repro/kernels/fakewords_score/kernel.py:48"
    qv = fakewords.classic_query(index, q_tf)
    scored = index.scored
    entry(f"score_matmul (classic, bf16, B={b}, N={n}, T={qv.shape[1]})",
          lambda: score_matmul(qv, scored), lambda: fw_ref.score_matmul_ref(qv, scored),
          lambda: torch.mm(qv, scored.T, out_dtype=torch.float32),
          "torch.mm(q, scored.T, out_dtype=f32)", dense_bound_ms(qv, scored, 0, 2.0, "bf16"),
          counts["score_matmul"], False, fw_src, fw_rep)
    q_dot = fakewords.dot_query(index, q_tf, dtype=torch.int8)
    tf = index.tf
    entry(f"score_matmul/dot (int8, B={b}, N={n}, T={q_dot.shape[1]})",
          lambda: score_matmul(q_dot, tf), lambda: fw_ref.score_matmul_ref(q_dot, tf),
          lambda: torch._int_mm(q_dot, tf.T), "torch._int_mm(q, tf.T) (int32 out)",
          dense_bound_ms(q_dot, tf, 0, 2.0, "int8"), counts["score_matmul"], True, fw_src, fw_rep)
    # K6 runs split TF32, three tf32 products per f32 one: its row's bound is
    # theirs, and the f32 FMAs of the plain product (the bound of the
    # CUDA-core design it replaced) stand beside it.
    fma = dense_bound_ms(q_unit, x, inv.numel() * 4, 2.0, "f32")
    entry(f"cosine_scores (f32, split TF32, B={b}, N={n}, T={x.shape[1]})",
          lambda: cosine_scores(q_unit, x, inv), lambda: cos_ref.cosine_scores_ref(q_unit, x, inv),
          lambda: torch.matmul(q_unit, x.T) * inv,
          "torch.matmul(q, x.T) * inv_norm (allow_tf32 False)",
          dense_bound_ms(q_unit, x, inv.numel() * 4, 6.0, "tf32"), counts["cosine_scores"], False,
          "src/repro_torch/kernels/cosine_score/csrc/cosine_score.cu",
          "src/repro/kernels/cosine_score/kernel.py:36",
          note=f"; f32-FMA bound {fma[0]:.3f} ms ({fma[1]})")
    # What cosine_topk spends besides K6: common.stable_topk, a full stable
    # sort of the (B, N) scores.
    scores = cosine_scores(q_unit, x, inv)
    sort_ms, sort_runs = timed(lambda: stable_topk(scores, k))
    del scores
    whole_ms, whole_runs = timed(lambda: cos_ops.cosine_topk(qx, x, k))
    print(f"cosine_topk (B={b}, N={n}, T={x.shape[1]}, k={k}) on {card}: whole {whole_ms:.3f} ms "
          f"(median of {whole_runs}); common.stable_topk of the (B, N) scores alone "
          f"{sort_ms:.3f} ms (median of {sort_runs}); K6 {kernels[-1]['ms']:.3f} ms")
    torch.cuda.empty_cache()
    sig = lidx.index.sig
    entry(f"lsh_match_scores (uint32, B={b}, N={n}, S={sig.shape[1]})",
          lambda: lsh_match_scores(sig_q, sig), lambda: lsh_ref.lsh_match_scores_ref(sig_q, sig),
          None, "none: no PyTorch call counts sentinel-aware collisions",
          dense_bound_ms(sig_q, sig, 0, 1.0, "int32"), counts["lsh_match_scores"], True,
          "src/repro_torch/kernels/lsh_match/csrc/lsh_match.cu",
          "src/repro/kernels/lsh_match/kernel.py:41")
    # K8 at B = 8 and 1 (the first queries), held to the plain version, and
    # its plan at each B; then what lsh_topk spends besides K8:
    # common.stable_topk, a full stable sort of the (B, N) counts.
    from repro_torch.kernels.lsh_match.kernel import plan as lsh_plan

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    line = []
    for bb in (b, 8, 1):
        qb = sig_q[:bb]
        if bb != b:
            compare_dense(f"lsh_match_scores B={bb}", lsh_match_scores(qb, sig),
                          lsh_ref.lsh_match_scores_ref(qb, sig), exact=True)
        bound = dense_bound_ms(qb, sig, 0, 1.0, "int32")
        line.append(f"B={bb} kernel {timed(lambda: lsh_match_scores(qb, sig))[0]:.3f} ms, bound "
                    f"{bound[0]:.3f} ms ({bound[1]}), plan (queries a block, splits, tiles a "
                    f"split, docs a tile, blocks a SM) {lsh_plan(bb, n, sig.shape[1], sm_count)}")
    print(f"lsh_match_scores (N={n}, S={sig.shape[1]}) on {card}: " + "; ".join(line))
    counts_f32 = lsh_match_scores(sig_q, sig).to(torch.float32)
    sort_ms, sort_runs = timed(lambda: stable_topk(counts_f32, depth))
    del counts_f32
    torch.cuda.empty_cache()
    whole_ms, whole_runs = timed(lambda: lsh_ops.lsh_topk(lidx.index, sig_q, depth))
    print(f"lsh_topk (B={b}, N={n}, S={sig.shape[1]}, k={depth}) on {card}: whole "
          f"{whole_ms:.3f} ms (median of {whole_runs}); common.stable_topk of the (B, N) "
          f"counts alone {sort_ms:.3f} ms (median of {sort_runs}); K8 {kernels[-1]['ms']:.3f} ms")
    torch.cuda.empty_cache()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa(q, kk, vv):  # the flash backend: it raises where it cannot run, never falls back
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(q, kk, vv, is_causal=True,
                                                                    enable_gqa=True)

    for i, (name, hq, hkv, s, d) in enumerate(ATTENTION_LAYERS):
        q, kk, vv = layers[name]
        entry(f"flash_attention{'' if i == 0 else '/' + name.split()[0]} ({name}, bf16, B=1, "
              f"Hq={hq}, Hkv={hkv}, S={s}, D={d})",
              lambda: flash_attention(q, kk, vv), lambda: fa_ref.attention_ref(q, kk, vv),
              lambda: sdpa(q, kk, vv),
              "scaled_dot_product_attention(is_causal=True, enable_gqa=True), flash backend",
              attention_bound_ms(q, kk, vv, "bf16"), counts["flash_attention"], False,
              "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:74", tol=ATTN_TOL[torch.bfloat16])

    def sdpa_efficient(q, kk, vv):  # f32: the memory-efficient backend alone, which raises
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):  # where it cannot run
            return torch.nn.functional.scaled_dot_product_attention(q, kk, vv, is_causal=True)

    # The f32 kernel runs split TF32, three tf32 products per f32 one: its
    # row's bound is theirs, and the f32 FMAs of the plain products (the
    # bound of the CUDA-core design it replaced) stand beside it.
    name, hq, hkv, s, d = f32_layer
    q, kk, vv = layers_f32
    fma = attention_bound_ms(q, kk, vv, "f32")
    entry(f"flash_attention/f32 ({name}, f32, split TF32, B=1, Hq={hq}, Hkv={hkv}, S={s}, D={d})",
          lambda: flash_attention(q, kk, vv), lambda: fa_ref.attention_ref(q, kk, vv),
          lambda: sdpa_efficient(q, kk, vv),
          "scaled_dot_product_attention(is_causal=True), backend that ran: "
          f"{SDPBackend.EFFICIENT_ATTENTION.name} (f32)",
          attention_bound_ms(q, kk, vv, "tf32", passes=3), counts["flash_attention"], False,
          "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
          "src/repro/kernels/flash_attention/kernel.py:74", tol=ATTN_TOL[torch.float32],
          note=f"; f32-FMA bound {fma[0]:.3f} ms ({fma[1]})")
    print(f"times on {card}")
    return kernels


KD_REDUCTIONS = ("pca", "ppa-pca-ppa")


def plain_l2_topk(points, qr, depth: int):
    """The k-d tree scan's search done plainly: -||q - d||^2 + ||q||^2 (the
    scan's score) of every reduced point, from the differences, sorted
    stably (ties to the lower id), 8 queries at a time."""
    out_s, out_i = [], []
    for q8 in qr.split(8):
        s = (q8 * q8).sum(-1, keepdim=True) - ((points[None] - q8[:, None]) ** 2).sum(-1)
        ss, ii = torch.sort(s, dim=-1, descending=True, stable=True)
        out_s.append(ss[:, :depth])
        out_i.append(ii[:, :depth].to(torch.int32))
    return torch.cat(out_s), torch.cat(out_i)


def drive_kdtree(dev, card: str, x, qx, gt_i, depth: int, k: int, fw_recall: float):
    """The k-d tree (paper §2, third method) over the corpus ``x`` on the
    card, for each reduction of KD_REDUCTIONS at dims 8: the fit alone, then
    ``AnnIndex.build`` and scan searches at B = 256, 8 and 1 (K1 f32 over the
    lifted points, T = 9), with and without rerank, their ids held to a
    plain reduced-space brute force under the near-tie rule; then the tree
    backend over the same points (built again by ``AnnIndex.build``, without
    a rerank store) at B = 8, its ids held to the scan's.  Prints fit, build
    and search times, ``nbytes()`` and recall beside fake words'
    (``fw_recall``, R@(10,100)).  Returns the K1 f32 lifted-scan JSON entry,
    and the "pca" tree index with its B = 8 result (for
    :func:`drive_persistence`)."""
    from repro_torch.core import bruteforce, eval as ev, kdtree, pca
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import KdTreeConfig
    from repro_torch.kernels.common import f32_matmul
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk

    n, b = x.shape[0], qx.shape[0]
    qn = bruteforce.l2_normalize(qx)
    scan_launches, scan_err, entry, kept = 0, 0.0, None, None
    for reduction in KD_REDUCTIONS:
        cfg = KdTreeConfig(dims=8, reduction=reduction)
        xn = bruteforce.l2_normalize(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pca.fit_reduction(xn, cfg.dims, reduction, cfg.ppa_remove)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        del xn
        t0 = time.perf_counter()
        kidx = AnnIndex.build(x, cfg, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0

        # ---- the main path: scan searches at B = 256, 8 and 1 -------------
        _reset_launches()
        res = {bb: (kidx.search(qx[:bb], k=depth, depth=depth),
                    kidx.search(qx[:bb], k=k, depth=depth, rerank=True)) for bb in (b, 8, 1)}
        torch.cuda.synchronize()
        launches = _only(f"k-d tree ({reduction}) scan searches", "fused_topk")
        scan_launches += launches
        qr = kdtree.reduce_queries(kidx.index, qn, normalized=True)
        for bb, ((s, i), (rs, ri)) in res.items():
            _checked(f"kd {reduction} B={bb}", s, i, bb, depth, n)
            _checked(f"kd {reduction} B={bb} rerank", rs, ri, bb, k, n)
            scan_err = max(scan_err, compare(
                f"k-d tree ({reduction}) scan B={bb} vs plain reduced-space brute force",
                (s, i), plain_l2_topk(kidx.index.reduced, qr[:bb], depth + 1), exact=False))
        i100, rr_i = res[b][0][1], res[b][1][1]
        times = {bb: (cuda_ms(lambda: kidx.search(qx[:bb], k=k, depth=depth)),
                      cuda_ms(lambda: kidx.search(qx[:bb], k=k, depth=depth, rerank=True)))
                 for bb in (b, 8, 1)}
        own = kidx.nbytes() - n * x.shape[1] * 4  # all but the rerank store
        print(f"k-d tree ({reduction}, dims 8, scan on K1 f32): fit {fit_s:.3f} s (first "
              f"call), build {build_s:.3f} s (fit, projection, lift), index "
              f"{kidx.nbytes() / 1e9:.3f} GB (reduced + lifted + model {own / 1e6:.1f} MB, "
              f"{own / n:.2f} B/doc); fused_topk launches "
              f"{launches} (one a search); ids equal the plain reduced-space brute force at "
              f"B = {b}, 8 and 1 (near-tie rule); R@(10,10) "
              f"{float(ev.recall_at(gt_i, i100[:, :k])):.4f}  R@(10,100) "
              f"{float(ev.recall_at(gt_i, i100)):.4f}  reranked R@10 "
              f"{float(ev.recall_at(gt_i, rr_i)):.4f} (fake words classic R@(10,100) "
              f"{fw_recall:.4f}); search (median of {RUNS}, CUDA events) on {card}: "
              + "; ".join(f"B={bb} {v[0]:.3f} ms, with rerank {v[1]:.3f} ms"
                          for bb, v in times.items()))

        if reduction == "pca":
            serve_prebuilt(card, "kd scan (pca)", kidx, qx, depth, k, "fused_topk")

        # ---- the tree backend over the same points at B = 8 ----------------
        tcfg = KdTreeConfig(dims=8, reduction=reduction, backend="tree")
        t0 = time.perf_counter()
        tidx = AnnIndex.build(x, tcfg, keep_vectors=False, device=dev)
        torch.cuda.synchronize()
        tree_build_s = time.perf_counter() - t0
        same = torch.equal(tidx.index.reduced, kidx.index.reduced)
        tqr = kdtree.reduce_queries(tidx.index, qn[:8], normalized=True)
        _reset_launches()
        ((ts, ti), tree_s), replays = _replayed(  # a replay runs the DFS's rounds
            lambda: _sync_s(lambda: tidx.search(qx[:8], k=depth, depth=depth)))
        rounds = 1 + replays * kdtree._ROUNDS_PER_CHECK  # the first runs before capture
        if any(_launches().values()):
            raise AssertionError(f"the tree search launched a kernel: {_launches()}")
        _checked(f"kd tree {reduction} B=8", ts, ti, 8, depth, n)
        scan8 = kdtree.scan_search(tidx.index, tqr, depth + 1)
        compare(f"k-d tree ({reduction}) tree B=8 vs the scan over its points",
                (ts + (tqr * tqr).sum(-1, keepdim=True), ti), scan8, exact=False)
        print(f"k-d tree ({reduction}) tree backend: build {tree_build_s:.2f} s (fit, the host "
              f"tree of {tidx.index.perm.shape[0]} leaves of {tidx.index.perm.shape[1]}, lift), "
              f"reduced points {'equal to' if same else 'NOT equal to'} the scan index's; "
              f"index {tidx.nbytes() / 1e6:.1f} MB; search B=8 depth {depth} "
              f"{tree_s * 1e3:.1f} ms (one run, host clock, plain torch in CUDA graphs of "
              f"{kdtree._ROUNDS_PER_CHECK} rounds: no kernel of ours launched; {rounds} lock-step "
              f"rounds, the last up to {kdtree._ROUNDS_PER_CHECK - 1} idle, "
              f"{tree_s * 1e3 / rounds:.3f} ms a round), ids equal the scan's (near-tie rule)")
        if reduction == "pca":
            kept = (tidx, (ts, ti))
            # K1 f32 at the scan's shape: the kernel, its plain version, the
            # library call, and the bound (three tf32 products a column of T).
            lifted = kidx.index.lifted
            qa = torch.cat([2.0 * qr, torch.ones_like(qr[:, :1])], dim=1).contiguous()
            err = compare("K1 f32 lifted scan B=256 vs plain", fused_topk(qa, lifted, depth),
                          ref.fused_topk_ref(qa, lifted, depth + 1), exact=False)
            at = {}
            for bb in (b, 8, 1):
                qb = qa[:bb]
                at[bb] = (cuda_ms(lambda: fused_topk(qb, lifted, depth)),
                          cuda_ms(lambda: ref.fused_topk_ref(qb, lifted, depth)),
                          cuda_ms(lambda: torch.topk(f32_matmul(qb, lifted.T), depth)),
                          *bound_ms(qb, lifted, n, depth, "tf32", 3))
            padded = _bound(0.0, 3 * 2.0 * b * n * 16, "tf32")[0]
            print(f"fused_topk/f32-lifted (f32, N={n}, T={qa.shape[1]}, depth={depth}): "
                  + "; ".join(f"B={bb} kernel {v[0]:.3f} ms, bound {v[3]:.3f} ms ({v[4]}, "
                              f"tf32), plain {v[1]:.3f} ms, library {v[2]:.3f} ms"
                              for bb, v in at.items())
                  + f"; at B={b} the tf32 products of 16 columns (two k-steps) would take "
                  f"{padded:.3f} ms (library: torch.topk(f32_matmul(qa, lifted.T), {depth}), "
                  f"allow_tf32 False); kernel vs plain max_abs_err {err:.3g}")
            ms, plain_ms, lib_ms, bound, bound_by = at[b]
            entry = {
                "name": "fused_topk/f32-lifted", "route": "cuda",
                "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
                "replaces": "src/repro/kernels/fused_topk/kernel.py:288",
                "launches": 0, "max_abs_err": max(err, 0.0), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            }
        else:
            del tidx
        del kidx, res
        torch.cuda.empty_cache()
    entry["launches"] = scan_launches
    entry["max_abs_err"] = max(entry["max_abs_err"], scan_err)
    return entry, kept


def drive_persistence(dev, card: str, x, qx, kd, config, depth: int, k: int, md) -> None:
    """``AnnIndex.save`` / ``load`` on the card: the full-N k-d tree index
    (``kd``: the index, tree backend, no rerank store, and its tree search at
    B = 8, which the loaded index must repeat; the scan over its points at
    B = 256 too) and a fake-words
    classic index of the first 100,000 rows with int8 postings, the int8
    rerank store and those rows' metadata from ``md`` (B = 256, with and
    without rerank, and filtered by a mask built from the index's own
    metadata, the loaded one's after load).  Search results after load must
    be bit-equal to those before.  Prints the save and load seconds and the
    saved bytes."""
    from repro_torch.core.index import AnnIndex

    root = os.path.join(ROOT, "build", "persist")
    shutil.rmtree(root, ignore_errors=True)
    fw = AnnIndex.build(x[:100_000], config, primary_postings="int8", rerank_store="int8",
                        metadata=dict(zip(md.field_names, md.values[:100_000].T)), device=dev)
    kd_idx, tree_8 = kd
    scan_cfg = dataclasses.replace(kd_idx.config, backend="scan")

    def kd_searches(idx):  # the tree at B = 8 is run once, on the loaded index
        scan = AnnIndex(config=scan_cfg, index=idx.index)
        tree = tree_8 if idx is kd_idx else idx.search(qx[:8], k=depth, depth=depth)
        return [tree, scan.search(qx, k=depth, depth=depth)]

    def fw_searches(idx):
        filt = idx.metadata.range_mask("year", 2005, 2007)  # the index's own (loaded) metadata
        return [idx.search(qx, k=depth, depth=depth),
                idx.search(qx, k=k, depth=depth, rerank=True),
                idx.search(qx, k=depth, depth=depth, filt=filt)]

    for name, idx, searches in (("kd-tree.ann", kd_idx, kd_searches),
                                ("fakewords-int8.ann", fw, fw_searches)):
        path = os.path.join(root, name)
        before = searches(idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = AnnIndex.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if loaded.config != idx.config or loaded.nbytes() != idx.nbytes():
            raise AssertionError(f"{name}: config or bytes differ after load")
        for (s0, i0), (s1, i1) in zip(before, searches(loaded)):
            if not (torch.equal(s0, s1) and torch.equal(i0, i1)):
                raise AssertionError(f"{name}: search after load is not bit-equal")
        disk = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        print(f"persistence {name} ({loaded.method}, {type(loaded.config).__name__}, "
              f"N={loaded.num_docs}, {idx.nbytes() / 1e6:.1f} MB on the card, {disk / 1e6:.1f} MB "
              f"on disk): save {save_s:.2f} s, load {load_s:.2f} s (host clock, {card}); "
              f"searches after load bit-equal ({len(before)} of them)")
        del loaded
    shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# The proximity graph ("hnsw"): the build on K1 f32, the traversal on K3
# f32, filters inside the traversal, segments, save / load.
# --------------------------------------------------------------------------

GRAPH_SEED = 41  # the integer-valued corpus's generator
GRAPH_ROWS = 100_000  # the bit-for-bit build and the save / load
GRAPH_SEG_ROWS = 400_000  # the segments' corpus: a merge is another O(N^2) build
GRAPH_SEG_ADDS = 4
GRAPH_WIDE = dict(ef=320, beam=16)  # the reference tests' filtered operating point


@contextlib.contextmanager
def _plain_graph_kernels():
    """``core/graph.py``'s K1 and K3 calls replaced by their plain versions
    (on the card: dense scores and a stable sort; the gathered rows)."""
    import types

    from repro_torch.core import graph
    from repro_torch.kernels.fused_topk import ref

    plain = types.SimpleNamespace(
        cosine_topk=lambda corpus, queries, depth: ref.fused_topk_ref(queries, corpus, depth),
        fused_topk_gathered=lambda q, store, row_ids, depth, n_docs: ref.gathered_topk_ref(
            q, ref.gather_rows(store, row_ids, n_docs), row_ids, depth, n_docs))
    kept, graph.fused = graph.fused, plain
    try:
        yield
    finally:
        graph.fused = kept


@contextlib.contextmanager
def _graph_stage_times(times: dict):
    """``graph.build_graph``'s stages timed into ``times`` (host seconds,
    the card synchronised on both sides of each)."""
    from repro_torch.core import graph

    kept = {name: getattr(graph, name)
            for name in ("_knn_pools", "_prune_all", "_reverse_edges", "_entry_points")}

    def staged(name, fn):
        def run(*args):
            out, seconds = _sync_s(lambda: fn(*args))
            times[name] = times.get(name, 0.0) + seconds
            return out
        return run

    for name, fn in kept.items():
        setattr(graph, name, staged(name, fn))
    try:
        yield
    finally:
        for name, fn in kept.items():
            setattr(graph, name, fn)


def _graph_int_parity(dev, card: str, cfg, b: int, depth: int) -> None:
    """The integer-valued graph bit for bit: ``graph.build_graph`` and
    ``search_graph`` over GRAPH_ROWS rows of small integers (not normalised)
    on K1 + K3 against the same calls with their plain versions on the card:
    adjacency, entry points, ids, scores and scored rows equal."""
    from repro_torch.core import graph

    gen = torch.Generator(device=dev).manual_seed(GRAPH_SEED)
    xi = torch.randint(-2, 3, (GRAPH_ROWS, 300), generator=gen, device=dev).float()
    xi[GRAPH_ROWS // 2:GRAPH_ROWS // 2 + 100] = xi[:100]  # duplicate rows: ties everywhere
    qi = torch.randint(-2, 3, (b, 300), generator=gen, device=dev).float()
    knobs = dict(depth=depth, ef=cfg.ef, beam=cfg.beam, iters=cfg.search_iters,
                 n_docs=GRAPH_ROWS)
    _reset_launches()
    (nb, entry), kernel_s = _sync_s(lambda: graph.build_graph(xi, cfg))
    got = graph._traverse(xi, nb, entry, qi, None, **knobs)  # op by op: one launch a block
    launches = _launches()
    with _plain_graph_kernels():
        (nb_p, entry_p), plain_s = _sync_s(lambda: graph.build_graph(xi, cfg))
        want = graph._traverse(xi, nb_p, entry_p, qi, None, **knobs)
    if not (torch.equal(nb, nb_p) and torch.equal(entry, entry_p)):
        n_bad = int((nb != nb_p).any(dim=1).sum())
        raise AssertionError(f"graph (integer rows): {n_bad} adjacency rows or the entry points "
                             "differ from the plain build")
    for name, g, w in zip(("scores", "ids", "scored"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"graph (integer rows): search {name} differ from the plain "
                                 "traversal")
    print(f"graph bit for bit (integer-valued rows in [-2, 2], {GRAPH_ROWS} x 300, 100 "
          f"duplicated; GraphConfig(), B={b}, depth {depth}): adjacency, entry points "
          f"{entry.tolist()}, ids, scores and scored rows of K1 + K3 "
          f"(launches {launches['fused_topk']} / {launches['fused_topk_gathered']}) equal the "
          f"plain versions' on the card; build {kernel_s:.2f} s against {plain_s:.2f} s plain "
          f"(host clock, {card})")


def _traversal_pools() -> str:
    """``graph.TRAVERSAL_CACHE``'s entries, each with its shape and the
    device memory its capture reserved (the graph's private pool), and the
    card's reserved and allocated memory."""
    from repro_torch.core import graph

    cache = graph.TRAVERSAL_CACHE
    parts = []
    for full_key, entry in cache._entries.items():
        knobs = dict(full_key[1][1:])
        q_aval, filt_aval = full_key[3]
        mask = "no mask" if filt_aval is None else f"mask {tuple(filt_aval[0])}"
        parts.append(f"B={q_aval[0][0]} depth {knobs['depth']} ef {knobs['ef']} beam "
                     f"{knobs['beam']} ({mask}) {getattr(entry, 'pool_bytes', 0) / 1e6:.1f} MB")
    return (f"{len(parts)} entries, pools {cache.stats()['pool_bytes'] / 1e9:.3f} GB in all ["
            + "; ".join(parts) + f"]; the card: reserved {torch.cuda.memory_reserved() / 1e9:.2f} "
            f"GB, allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")


def _graph_recall_reading(x, qx, gt_i, ids, nb, k: int) -> None:
    """What R@10 at full N is made of.  A query is a corpus row, so its own
    id leads its exact list: the queries whose traversal reached their own
    row, R@10 among them and among the rest, and the share of each query
    row's exact nearest others (ranks 2..k) held in its own adjacency
    row."""
    qid = gt_i[:, 0].long()
    own = (x[qid] == qx).all(dim=1)
    per_q = (gt_i[:, :, None] == ids[:, None, :k]).any(dim=2).float().mean(dim=1)
    reached = (ids == gt_i[:, :1]).any(dim=1)
    in_adj = (gt_i[:, 1:, None] == nb[qid][:, None, :]).any(dim=2).float().mean()

    def mean(mask):
        return f"{float(per_q[mask].mean()):.4f}" if bool(mask.any()) else "none"

    print(f"graph recall reading (B={qx.shape[0]}): the query's own row leads its exact list "
          f"for {int(own.sum())}; the traversal reached its own row for {int(reached.sum())} "
          f"queries, R@{k} {mean(reached)} among them and {mean(~reached)} among the other "
          f"{int((~reached).sum())}; {float(in_adj):.4f} of each query row's exact ranks 2..{k} "
          f"are in its adjacency row")


def _graph_k3_row(card: str, gi, qn, n: int, cfg, launches: int) -> dict:
    """K3 f32 at a traversal's shape: the (B, R = beam x total_degree)
    block of a middle iteration at B = 256, recorded from an eager search;
    the kernel, its plain version, the library call and the bound at B =
    256, 8 and 1 (the first rows of the block).  Returns its JSON entry."""
    import types

    from repro_torch.core import graph
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk_gathered

    blocks = []

    def recording(q, store, row_ids, depth, n_docs):
        blocks.append(row_ids.clone())
        return fused_topk_gathered(q, store, row_ids, depth, n_docs)

    kept, graph.fused = graph.fused, types.SimpleNamespace(
        cosine_topk=graph.fused.cosine_topk, fused_topk_gathered=recording)
    try:
        graph._traverse(gi.vectors, gi.neighbors, gi.entry, qn, None, depth=cfg.ef, ef=cfg.ef,
                        beam=cfg.beam, iters=cfg.search_iters, n_docs=n)
    finally:
        graph.fused = kept
    rows = blocks[len(blocks) // 2]
    r = rows.shape[1]
    vec = gi.vectors
    err = compare(f"K3 f32 graph block B={rows.shape[0]} R={r} vs plain",
                  fused_topk_gathered(qn, vec, rows, r, n),
                  ref.gathered_topk_ref(qn, ref.gather_rows(vec, rows, n), rows, r, n),
                  exact=False)
    at = {}
    for bb in (qn.shape[0], 8, 1):
        qb, rb = qn[:bb], rows[:bb]
        at[bb] = (cuda_ms(lambda: fused_topk_gathered(qb, vec, rb, r, n)),
                  cuda_ms(lambda: ref.gathered_topk_ref(qb, ref.gather_rows(vec, rb, n), rb, r,
                                                        n), runs=3),
                  cuda_ms(lambda: torch.topk(torch.einsum(
                      "bd,bmd->bm", qb, vec[rb.clamp(0, n - 1).long()]), r), runs=3),
                  *gathered_bound_ms(qb, vec, rb, n, r, "f32"))
    valid = int(((rows >= 0) & (rows < n)).sum())
    print(f"fused_topk_gathered/f32-graph (a middle iteration's block, R = beam x total_degree "
          f"= {r}, depth {r}, T=300, {valid} of {rows.numel()} slots valid at B={qn.shape[0]}): "
          + "; ".join(f"B={bb} kernel {v[0]:.4f} ms, bound {v[3]:.4f} ms ({v[4]}, f32, "
                      f"{v[5]} distinct rows), plain {v[1]:.4f} ms, library {v[2]:.4f} ms"
                      for bb, v in at.items())
          + f" (median of {RUNS} / 3 / 3, CUDA events, {card}; library: torch.topk(torch.einsum("
          f"'bd,bmd->bm', q, vectors[row_ids]), {r}), allow_tf32 False); kernel vs plain "
          f"max_abs_err {err:.3g}")
    ms, plain_ms, lib_ms, bound, bound_by, _ = at[qn.shape[0]]
    return {"name": "fused_topk_gathered/f32-graph", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
            "replaces": "src/repro/kernels/fused_topk/kernel.py:433", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms}


def _graph_k1_row(card: str, vec, n: int, depth: int, launches: int) -> dict:
    """K1 f32 at the shape the build's pools launch it: ``graph._POOL_ROWS``
    rows against all N at ``depth`` (= ef_construction + 1).  The launch's
    first 256 rows are held to the plain version on those rows (each row's
    list is its own; the plain version of the whole launch would hold
    (8,192, N) scores, 98 GB), and the plain version and the library call
    are timed over the launch's rows in 256-row slices.  Returns its JSON
    entry, every number at that launch's shape."""
    from repro_torch.core import graph
    from repro_torch.kernels.common import f32_matmul
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk

    rows = vec[:graph._POOL_ROWS]
    s, i = fused_topk(rows, vec, depth)
    err = compare(f"K1 f32 pools B={rows.shape[0]} depth {depth} (its first 256 rows) vs plain",
                  (s[:256], i[:256]), ref.fused_topk_ref(rows[:256], vec, depth + 1), exact=False)
    del s, i
    slices = rows.split(256)

    def plain():  # each slice's lists dropped at once: they are views of its sorted scores
        for q in slices:
            ref.fused_topk_ref(q, vec, depth)

    def library():
        for q in slices:
            torch.topk(f32_matmul(q, vec.T), depth)

    ms = cuda_ms(lambda: fused_topk(rows, vec, depth), runs=3, warmup=1)
    plain_ms = cuda_ms(plain, runs=3, warmup=1)
    lib_ms = cuda_ms(library, runs=3, warmup=1)
    bound, bound_by = bound_ms(rows, vec, n, depth, "tf32", 3)
    print(f"fused_topk/f32-graph-pools (a build launch: B={rows.shape[0]}, N={n}, "
          f"T={vec.shape[1]}, depth {depth}): kernel {ms:.3f} ms, bound {bound:.3f} ms "
          f"({bound_by}, split TF32's three tf32 products), plain {plain_ms:.3f} ms and library "
          f"{lib_ms:.3f} ms over its rows in {len(slices)} slices of 256 (library: "
          f"torch.topk(f32_matmul(q, vectors.T), {depth}), allow_tf32 False; median of 3, CUDA "
          f"events, {card}); its first 256 rows vs plain max_abs_err {err:.3g}")
    return {"name": "fused_topk/f32-graph-pools", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
            "replaces": "src/repro/kernels/fused_topk/kernel.py:288", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms}


def _graph_segments(dev, card: str, x, qx, depth: int, k: int) -> None:
    """Graph segments: ``IndexWriter(GraphConfig(ef=192, beam=8))`` over the
    first GRAPH_SEG_ROWS rows in GRAPH_SEG_ADDS flushed adds, 1% deleted,
    against a monolithic build of the live rows.  The per-segment loop (a
    traversal a segment, liveDocs inside it) emits no deleted id and loses
    no more than 0.01 of the monolithic R@10 (the reference's gate, one
    way: each segment's own traversal visits more of its rows than one
    traversal of the whole, so the loop may find more); after
    ``force_merge(1)`` the one segment is the monolithic build, adjacency
    and searches bit for bit."""
    import numpy as np

    from repro_torch.core import bruteforce, eval as ev, graph
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import GraphConfig
    from repro_torch.kernels.fused_topk import ops

    cfg = GraphConfig(ef=192, beam=8)
    xs = x[:GRAPH_SEG_ROWS]
    dead = np.random.default_rng(SEG_SEED).choice(GRAPH_SEG_ROWS, GRAPH_SEG_ROWS // 100,
                                                  replace=False)
    w, reader, flush_s, (delete_s, refresh_s) = _seg_writer(dev, cfg, xs, GRAPH_SEG_ADDS, dead)
    live = torch.ones(GRAPH_SEG_ROWS, dtype=torch.bool, device=dev)
    live[torch.from_numpy(dead).to(dev)] = False
    gmap = torch.from_numpy(reader.live_global_ids()).to(dev)
    mono, mono_s = _sync_s(lambda: AnnIndex.build(xs[live], cfg, device=dev))
    _, truth = ops.cosine_topk(mono.index.vectors, bruteforce.l2_normalize(qx), k)
    mono_res = mono.search(qx, k=k, depth=depth)
    r_mono = float(ev.recall_at(truth, mono_res[1]))
    (_, seg_i), loop_s = _sync_s(lambda: reader.search(qx, k=k, depth=depth))
    if reader._packed_err is None or bool(torch.isin(seg_i, torch.from_numpy(dead).to(dev)).any()):
        raise AssertionError("graph segments: a packed search, or a deleted id emitted")
    r_seg = float(ev.recall_at(_mapped(gmap, truth), seg_i))
    if r_seg < r_mono - 0.01:
        raise AssertionError(f"graph segmented R@10 {r_seg:.4f} is more than 0.01 below the "
                             f"monolithic {r_mono:.4f}")
    qn = bruteforce.l2_normalize(qx)

    def scored(gi):  # rows a query scored in one traversal of ``gi`` (filt does not change it)
        return graph.search_graph(gi.vectors, gi.neighbors, gi.entry, qn, depth, ef=cfg.ef,
                                  beam=cfg.beam, iters=cfg.search_iters, n_docs=gi.num_docs,
                                  with_stats=True)[2].float()

    per_seg = [scored(seg.ann.index) for seg in reader.segments]
    seg_scored = sum(per_seg)
    mono_scored = scored(mono.index)
    loop_ms = cuda_ms(lambda: reader.search(qx[:8], k=k, depth=depth))
    merged, merge_s = _sync_s(lambda: (w.force_merge(1), w.refresh())[1])
    merged_res = merged.search(qx, k=k, depth=depth)
    if not (torch.equal(merged.segments[0].ann.index.neighbors, mono.index.neighbors)
            and all(torch.equal(a, b) for a, b in zip(merged_res, mono_res))):
        raise AssertionError("graph force_merge(1): not the monolithic build bit for bit")
    print(f"graph segments (GraphConfig(ef=192, beam=8), {GRAPH_SEG_ROWS} rows in "
          f"{GRAPH_SEG_ADDS} flushed adds, {len(dead)} deleted): R@10 (depth {depth}) loop "
          f"{r_seg:.4f} against the monolithic build of the live rows {r_mono:.4f} (gate: "
          f"at most 0.01 below); rows a query scored: the loop {float(seg_scored.mean()):.1f} "
          f"over {len(reader.segments)} segments (in each "
          + ", ".join(f"{float(t.mean()):.1f}" for t in per_seg)
          + f"), the monolithic build {float(mono_scored.mean()):.1f}; after force_merge(1) "
          f"the monolithic build bit for bit "
          f"(adjacency, ids, scores); no deleted id emitted; packed path refused: "
          f"{reader._packed_err!r}; adds+flushes {flush_s:.1f} s, delete {delete_s:.3f} s, "
          f"refresh {refresh_s:.3f} s, monolithic build {mono_s:.1f} s, force_merge(1) + refresh "
          f"{merge_s:.1f} s, first loop search (B={qx.shape[0]}) {loop_s:.2f} s (host clock); "
          f"loop search B=8 {loop_ms:.3f} ms (median of {RUNS}, CUDA events, {card})")


def _graph_save_load(dev, card: str, x, qx, depth: int, k: int) -> None:
    """``AnnIndex.save`` / ``load`` of a GRAPH_ROWS-row graph index on the
    card: searches after load bit-equal to those before.  Also the index's
    R@10 with rows of its own as queries, as at full N."""
    from repro_torch.core import bruteforce, eval as ev
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import GraphConfig
    from repro_torch.kernels.fused_topk import ops

    path = os.path.join(ROOT, "build", "persist-graph", "graph.ann")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    idx = AnnIndex.build(x[:GRAPH_ROWS], GraphConfig(), device=dev)

    def searches(i):
        return [i.search(qx, k=depth, depth=depth), i.search(qx, k=k, depth=depth, rerank=True),
                i.search(qx[:1], k=k, depth=k)]

    before = searches(idx)
    pick = torch.randperm(GRAPH_ROWS, generator=torch.Generator().manual_seed(GRAPH_SEED))
    own_q = x[pick[:qx.shape[0]].to(x.device)]
    _, truth = ops.cosine_topk(idx.index.vectors, bruteforce.l2_normalize(own_q), k)
    r_own = float(ev.recall_at(truth, idx.search(own_q, k=k, depth=depth)[1]))
    _, save_s = _sync_s(lambda: idx.save(path))
    loaded, load_s = _sync_s(lambda: AnnIndex.load(path, device=dev))
    if loaded.config != idx.config or loaded.nbytes() != idx.nbytes():
        raise AssertionError("graph save / load: config or bytes differ")
    for (s0, i0), (s1, i1) in zip(before, searches(loaded)):
        if not (torch.equal(s0, s1) and torch.equal(i0, i1)):
            raise AssertionError("graph save / load: a search after load is not bit-equal")
    disk = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    print(f"persistence graph.ann (hnsw, N={GRAPH_ROWS}, {idx.nbytes() / 1e6:.1f} MB on the "
          f"card, {disk / 1e6:.1f} MB on disk): save {save_s:.2f} s, load {load_s:.2f} s (host "
          f"clock, {card}); {len(before)} searches after load bit-equal; R@{k} (depth {depth}) "
          f"with {own_q.shape[0]} of its rows as queries {r_own:.4f}")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)


def drive_graph(dev, card: str, x, qx, gt_i, depth: int, k: int, masks: dict) -> list:
    """The proximity graph ("hnsw") over the corpus ``x`` on the card:

      * ``AnnIndex.build(x, GraphConfig())`` at full N, each stage timed:
        the pools (K1 f32 launches counted), the prune, the reverse edges,
        the entry points; the index's bytes;
      * searches at B = 256, 8 and 1, depth ``depth`` and ``k``, with and
        without rerank, R@10 and R@(10,100) against ``gt_i``, the scored
        rows, K3's launches a search; the traversal captured against eager
        in turns; the ids of the same traversal with K3's plain version on
        the same adjacency (queries that differ counted); what R@10 is made
        of (``_graph_recall_reading``); the traversal cache's entries, each
        with its pool, and the card's memory before and after the searches
        (``_traversal_pools``);
      * the integer-valued graph bit for bit (``_graph_int_parity``);
      * filtered search at ``GraphConfig(ef=320, beam=16)`` with the ~10%
        and ~1% masks: no masked id, recall against the filtered exact top-k;
      * K3 f32 at a traversal's block and K1 f32 at a pools launch;
      * segments (``_graph_segments``) and save / load
        (``_graph_save_load``).

    Returns the JSON entries of K3 f32 (graph) and K1 f32 (pools)."""
    from repro_torch.core import bruteforce, eval as ev, graph
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import GraphConfig
    from repro_torch.kernels.fused_topk import ops

    t_phase = time.perf_counter()
    n, b = x.shape[0], qx.shape[0]
    cfg = GraphConfig()
    iters = cfg.search_iters
    graph.TRAVERSAL_CACHE.clear()

    # ---- the build at full N -------------------------------------------------
    stages = {}
    _reset_launches()
    with _graph_stage_times(stages):
        gidx, build_s = _sync_s(lambda: AnnIndex.build(x, cfg, device=dev))
    pool_launches = _only("graph build", "fused_topk")
    gi = gidx.index
    nb = gi.neighbors
    if (nb.shape != (n, cfg.total_degree) or nb.dtype != torch.int32
            or not bool(((nb >= -1) & (nb < n)).all())
            or bool((nb == torch.arange(n, device=dev, dtype=torch.int32)[:, None]).any())):
        raise AssertionError("graph build: bad adjacency (shape, range or a self-loop)")
    print(f"graph build (GraphConfig(): degree {cfg.degree} + reverse {cfg.reverse_degree}, "
          f"ef_construction {cfg.ef_construction}, alpha {cfg.alpha}; N={n}, T={x.shape[1]}): "
          f"{build_s:.1f} s (host clock, {card}): pools {stages['_knn_pools']:.1f} s "
          f"({pool_launches} K1 f32 launches of {graph._POOL_ROWS} rows at depth "
          f"{cfg.ef_construction + 1}), prune {stages['_prune_all']:.1f} s "
          f"({-(-n // graph._PRUNE_BLOCK)} blocks x {cfg.degree} steps), reverse edges "
          f"{stages['_reverse_edges']:.2f} s, entry points {stages['_entry_points']:.3f} s "
          f"({gi.entry.tolist()}); index {gidx.nbytes() / 1e9:.3f} GB (vectors "
          f"{gi.vectors.numel() * 4 / 1e9:.3f} GB, neighbors {nb.numel() * 4 / 1e9:.3f} GB); "
          f"{float((nb < 0).sum(dim=1).float().mean()):.2f} empty slots a node, "
          f"{int((nb < 0).all(dim=1).sum())} nodes without an edge")
    print("graph traversal cache before the searches: " + _traversal_pools())

    # ---- the main path: searches at B = 256, 8 and 1 ---------------------------
    _reset_launches()
    res = {bb: (gidx.search(qx[:bb], k=depth, depth=depth),
                gidx.search(qx[:bb], k=k, depth=depth, rerank=True),
                gidx.search(qx[:bb], k=k, depth=k)) for bb in (b, 8, 1)}
    torch.cuda.synchronize()
    k3_launches = _only("graph searches", "fused_topk_gathered")
    for bb, ((s, i), (rs, ri), (ks, ki)) in res.items():
        _checked(f"graph B={bb}", s, i, bb, depth, n)
        _checked(f"graph B={bb} rerank", rs, ri, bb, k, n)
        _checked(f"graph B={bb} depth {k}", ks, ki, bb, k, n)
    print("graph traversal cache after the main path's searches: " + _traversal_pools())
    (s, i), (_, ri), (_, ki) = res[b]
    qn = bruteforce.l2_normalize(qx)
    knobs = dict(ef=cfg.ef, beam=cfg.beam, iters=iters, n_docs=n)
    _reset_launches()
    eager = graph._traverse(gi.vectors, nb, gi.entry, qn, None, depth=depth, **knobs)
    torch.cuda.synchronize()
    per_search = _only("graph eager search", "fused_topk_gathered")
    if per_search != 1 + iters:
        raise AssertionError(f"graph: {per_search} K3 launches a search, not 1 + {iters}")
    if not (torch.equal(eager[0], s) and torch.equal(eager[1], i)):
        raise AssertionError("graph: the captured search differs from the eager one")
    scored = eager[2]
    bound = cfg.entries + iters * cfg.beam * cfg.total_degree
    if int(scored.max()) > bound:
        raise AssertionError(f"graph: a query scored {int(scored.max())} rows, over {bound}")
    with _plain_graph_kernels():
        plain = graph._traverse(gi.vectors, nb, gi.entry, qn, None, depth=depth, **knobs)
    differ = (plain[1] != i).any(dim=1)
    same_err = float((plain[0] - s)[~differ].abs().max()) if bool((~differ).any()) else 0.0
    print(f"graph search (GraphConfig(): ef {cfg.ef}, beam {cfg.beam}, {iters} iterations, "
          f"B={b}): R@10 {float(ev.recall_at(gt_i, i[:, :k])):.4f}, R@(10,100) "
          f"{float(ev.recall_at(gt_i, i)):.4f}, reranked R@10 {float(ev.recall_at(gt_i, ri)):.4f}, "
          f"depth {k} R@10 {float(ev.recall_at(gt_i, ki)):.4f}; scored rows a query: max "
          f"{int(scored.max())}, mean {float(scored.float().mean()):.1f} (at most {bound}); K3 "
          f"launches a search {per_search} (1 + {iters}), in the main path's searches "
          f"{k3_launches} (a first search of a shape runs once before its capture and once "
          f"into it; replays launch without counting); with K3's plain version on the same "
          f"adjacency (B={b}): {int(differ.sum())} queries' ids differ (R@10 "
          f"{float(ev.recall_at(gt_i, plain[1][:, :k])):.4f}), the others' scores within "
          f"{same_err:.3g}")
    _graph_recall_reading(x, qx, gt_i, i, nb, k)

    times = {}
    for bb in (b, 8, 1):
        qb = qn[:bb]
        graphed = lambda: graph.search_graph(gi.vectors, nb, gi.entry, qb, depth, **knobs)
        op_by_op = lambda: graph._traverse(gi.vectors, nb, gi.entry, qb, None, depth=depth,
                                           **knobs)
        times[bb] = [cuda_ms(graphed), cuda_ms(op_by_op), cuda_ms(op_by_op), cuda_ms(graphed),
                     cuda_ms(lambda: gidx.search(qx[:bb], k=k, depth=depth, rerank=True)),
                     cuda_ms(lambda: gidx.search(qx[:bb], k=k, depth=k))]
    print(f"graph search times (median of {RUNS}, CUDA events, {card}), depth {depth}, the "
          "traversal captured / eager / eager / captured in turns, then the facade with "
          f"rerank and at depth {k}: "
          + "; ".join(f"B={bb} {v[0]:.3f} / {v[1]:.3f} / {v[2]:.3f} / {v[3]:.3f} ms, rerank "
                      f"{v[4]:.3f} ms, depth {k} {v[5]:.3f} ms" for bb, v in times.items())
          + f"; traversal cache {graph.TRAVERSAL_CACHE.stats()}")
    print("graph traversal cache after the timings: " + _traversal_pools())

    # ---- filtered search at the reference's wide operating point ---------------
    wide_cfg = GraphConfig(**GRAPH_WIDE)
    wide = AnnIndex(config=wide_cfg, index=gi)
    wide_r = float(ev.recall_at(gt_i, wide.search(qx, k=k, depth=k)[1]))
    lines = [f"unfiltered R@10 {wide_r:.4f}, B={b} "
             f"{cuda_ms(lambda: wide.search(qx, k=k, depth=k)):.3f} ms"]
    for key in ("10%", "1%"):
        m = masks[key]
        fs, fi = wide.search(qx, k=k, depth=k, filt=m)
        _kept(f"graph filtered {key}", fi, m, n)
        _, ft = ops.cosine_topk(gi.vectors, qn, k, filt=m)
        f_ms = cuda_ms(lambda: wide.search(qx, k=k, depth=k, filt=m))
        f8_ms = cuda_ms(lambda: wide.search(qx[:8], k=k, depth=k, filt=m))
        lines.append(f"{key} ({int(m.sum())} kept): R@10 {float(ev.recall_at(ft, fi)):.4f}, "
                     f"{int((fi < 0).sum())} empty slots, B={b} {f_ms:.3f} ms, B=8 {f8_ms:.3f} ms")
    print(f"graph filtered (GraphConfig(ef=320, beam=16): {wide_cfg.search_iters} iterations of "
          f"{wide_cfg.beam * cfg.total_degree}-row K3 blocks; B={b}, k {k}, recall against the "
          f"filtered exact top-k on K1 f32; no masked id emitted): " + "; ".join(lines)
          + f" (median of {RUNS}, CUDA events, {card})")
    print("graph traversal cache after the filtered searches: " + _traversal_pools())
    del wide

    entries = [_graph_k3_row(card, gi, qn, n, cfg, k3_launches),
               _graph_k1_row(card, gi.vectors, n, cfg.ef_construction + 1, pool_launches)]
    serve_prebuilt(card, "hnsw", gidx, qx, depth, k, "fused_topk_gathered")
    del gidx, gi, nb, res, eager, plain
    graph.TRAVERSAL_CACHE.clear()
    torch.cuda.empty_cache()
    _graph_int_parity(dev, card, cfg, b, depth)
    _graph_segments(dev, card, x, qx, depth, k)
    _graph_save_load(dev, card, x, qx, depth, k)
    graph.TRAVERSAL_CACHE.clear()
    torch.cuda.empty_cache()
    print(f"graph phase: {time.perf_counter() - t_phase:.1f} s (host clock, {card})")
    return entries


def drive_quantized(dev, card: str, x, qx, gt_i, depth: int, k: int, config, masks: dict):
    """The quantized read path over the corpus ``x`` with the queries ``qx``
    (ground truth ``gt_i``), then its filtered searches with ``masks``
    (:func:`drive_filtered_quantized`); returns the K4 and K5 JSON entries
    and the seconds the filtered searches took."""
    from repro_torch.core import blockmax, bruteforce, eval as ev, fakewords
    from repro_torch.core import memory_budget as mb
    from repro_torch.core import pipeline as pl
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import BruteForceConfig
    from repro_torch.kernels.common import dequant_int4
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import (
        fused_topk_gathered_quantized,
        fused_topk_quantized,
    )

    n, dim = x.shape
    b = qx.shape[0]
    qn = bruteforce.l2_normalize(qx)
    q_tf = fakewords.encode_queries(qn, config, normalized=True)

    def recalls(i_match, i_rr):
        return (float(ev.recall_at(gt_i, i_match[:, :k])), float(ev.recall_at(gt_i, i_match)),
                float(ev.recall_at(gt_i, i_rr)))

    # ---- the yardstick: fp32 postings reranked from the same int8 store ----
    fidx = AnnIndex.build(x, config, rerank_store="int8", device=dev)
    f_i = fidx.search(qx, k=depth, depth=depth)[1]
    f_rr = fidx.search(qx, k=k, depth=depth, rerank=True)[1]
    r_f = recalls(f_i, f_rr)
    print(f"fp32 postings + int8 rerank store: index {fidx.nbytes() / 1e9:.2f} GB; "
          f"R@(10,10) {r_f[0]:.4f}  R@(10,100) {r_f[1]:.4f}  reranked R@10 {r_f[2]:.4f}")
    del fidx, f_i, f_rr
    torch.cuda.empty_cache()

    # ---- main path 4: classic with int8 / int4 postings (K4) ----------------
    quant = {}
    for pp in ("int8", "int4"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qidx = AnnIndex.build(x, config, primary_postings=pp, postings_group=GROUP,
                              rerank_store="int8", device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _reset_launches()
        s100, i100 = qidx.search(qx, k=depth, depth=depth)
        rr_s, rr_i = qidx.search(qx, k=k, depth=depth, rerank=True)
        torch.cuda.synchronize()
        launches = _only(f"the {pp} classic search", "fused_topk_quantized")
        _checked(f"{pp} match", s100, i100, b, depth, n)
        _checked(f"{pp} rerank", rr_s, rr_i, b, k, n)
        pq = qidx.index.pq
        per_doc = (mb.postings_bytes_per_doc(config, dim, pp, GROUP)
                   + mb.rerank_bytes_per_doc(dim, "int8"))
        r = recalls(i100, rr_i)
        # The B = 256 call against the plain version on its first 8 queries.
        qv = fakewords.classic_query(qidx.index, q_tf)
        err = compare(f"classic {pp} match, first 8 queries", (s100[:8], i100[:8]),
                      ref.quantized_topk_ref(qv[:8], pq.q, pq.scale, depth + 1, pq.bits,
                                             pq.group), exact=False)
        print(f"quantized classic, {pp} postings (group {pq.group}) + int8 rerank store: build "
              f"{build_s:.2f} s (first call); index {qidx.nbytes() / 1e9:.3f} GB, planner "
              f"{per_doc} B/doc x N = {per_doc * n / 1e9:.3f} GB; R@(10,10) {r[0]:.4f}  "
              f"R@(10,100) {r[1]:.4f}  reranked R@10 {r[2]:.4f} (fp32 postings {r_f[2]:.4f}); "
              f"fused_topk_quantized launches {launches}; K4 vs plain on 8 queries "
              f"max_abs_err {err:.3g}")
        if r_f[2] - r[2] > RECALL_SLACK:
            raise AssertionError(f"{pp} postings: reranked R@10 {r[2]:.4f} is more than "
                                 f"{RECALL_SLACK} below fp32 postings' {r_f[2]:.4f}")
        quant[pp] = (qidx, qv, launches, err)

    # ---- main path 5: blockmax on the int4 index (K5) -----------------------
    n_blocks = -(-n // BLOCK)
    keep = int(KEEP_FRACTIONS[0] * n_blocks)
    q4 = quant["int4"][0]
    pq4 = q4.index.pq
    bm4 = blockmax.build_blockmax(q4.index, BLOCK)
    pidx = AnnIndex(config=config, index=q4.index, blockmax_keep=keep, blockmax_block_size=BLOCK,
                    bm=bm4)
    _reset_launches()
    ps, pi = pidx.search(qx, k=depth, depth=depth)
    prs, pri = pidx.search(qx, k=k, depth=depth, rerank=True)
    torch.cuda.synchronize()
    k5_launches = _only("blockmax on the int4 index", "fused_topk_gathered_quantized")
    _checked(f"blockmax int4 n_keep={keep}", ps, pi, b, depth, n)
    _checked(f"blockmax int4 n_keep={keep} rerank", prs, pri, b, k, n)
    rows8 = blockmax.kept_rows(bm4, q_tf[:8], keep)
    qv8 = q_tf[:8].to(torch.bfloat16)
    k5_err = compare(f"blockmax classic int4 B={b} n_keep={keep}, first 8 queries",
                     (ps[:8], pi[:8]),
                     ref.quantized_gathered_topk_ref(qv8, pq4.q, pq4.scale, rows8, depth + 1, n,
                                                     4, GROUP), exact=False)
    r = recalls(pi, pri)
    print(f"blockmax classic int4 n_keep={keep}: R@(10,10) {r[0]:.4f}  R@(10,100) {r[1]:.4f}  "
          f"reranked R@10 {r[2]:.4f}; fused_topk_gathered_quantized launches {k5_launches}; "
          f"K5 vs plain on 8 queries max_abs_err {k5_err:.3g}")

    # ---- every block kept, 8 queries: blockmax equals the dense search -----
    q8 = qx[:8]
    for pp, (qidx, *_) in quant.items():
        every = AnnIndex(config=config, index=qidx.index, blockmax_keep=n_blocks,
                         blockmax_block_size=BLOCK)
        compare(f"blockmax classic {pp}, every block, 8 queries",
                every.search(q8, k=depth, depth=depth),
                qidx.search(q8, k=depth + 1, depth=depth + 1), exact=False)
        del every
    dot = dataclasses.replace(config, scoring="dot")
    for pp in ("int8", "int4"):
        didx = AnnIndex.build(x, dot, primary_postings=pp, postings_group=GROUP,
                              rerank_store="none", device=dev)
        bm = blockmax.build_blockmax(didx.index, BLOCK)
        compare(f"blockmax dot {pp}, every block, 8 queries",
                pl.BlockMaxMatcher(n_blocks, bm)(didx.index, q_tf[:8], depth),
                didx.pipeline.matcher(didx.index, q_tf[:8], depth + 1),
                exact=didx.index.pq is None)
        del didx, bm
    print("quantized blockmax at every block kept equals the dense quantized search: classic "
          "and dot x int8 and int4 (dot int8, the int8 tf through K3, exact; the rest under "
          "the near-tie rule)")

    # ---- main path 6: brute force with int8 / int4 postings (K4, f32 query) -
    brute = {}
    for pp in ("int8", "int4"):
        bidx = AnnIndex.build(x, BruteForceConfig(), primary_postings=pp, postings_group=GROUP,
                              rerank_store="int8", device=dev)
        _reset_launches()
        bs, bi = bidx.search(qx, k=depth, depth=depth)
        brs, bri = bidx.search(qx, k=k, depth=depth, rerank=True)
        torch.cuda.synchronize()
        bf_launches = _only(f"brute force over {pp} postings", "fused_topk_quantized")
        _checked(f"brute force {pp} match", bs, bi, b, depth, n)
        bpq = bidx.index.pq
        bf_err = compare(f"brute force {pp} match, first 8 queries", (bs[:8], bi[:8]),
                         ref.quantized_topk_ref(qn[:8], bpq.q, bpq.scale, depth + 1, bpq.bits,
                                                bpq.group), exact=False)
        r = recalls(bi, bri)
        print(f"brute force, {pp} postings + int8 rerank store: index "
              f"{bidx.nbytes() / 1e9:.3f} GB (postings {bpq.nbytes() / 1e9:.3f} GB); "
              f"R@(10,10) {r[0]:.4f}  R@(10,100) {r[1]:.4f}  reranked R@10 {r[2]:.4f}; "
              f"fused_topk_quantized (f32 query) launches {bf_launches}; vs plain on 8 "
              f"queries max_abs_err {bf_err:.3g}")
        brute[pp] = (bidx, bpq, bf_launches, bf_err)

    # ---- times ---------------------------------------------------------------
    profile_search(quant["int8"][0], qx, k, depth, card, label="int8 quantized classic")
    profile_search(brute["int4"][0], qx, k, depth, card, label="int4 brute-force")
    for pp, (qidx, *_) in quant.items():
        line = []
        for bb in (b, 8, 1):
            qb = qx[:bb]
            plain = cuda_ms(lambda: qidx.search(qb, k=k, depth=depth))
            rr = cuda_ms(lambda: qidx.search(qb, k=k, depth=depth, rerank=True))
            cand = qidx.search(qb, k=depth, depth=depth)[1]
            alone = cuda_ms(lambda: qidx.pipeline.reranker(qidx.index, qn[:bb], cand, k))
            line.append(f"B={bb} {plain:.3f} ms, with rerank {rr:.3f} ms, int8 rerank alone "
                        f"{alone:.3f} ms")
        print(f"quantized classic {pp} search (median of {RUNS}, CUDA events) on {card}: "
              f"{'; '.join(line)}")
    for pp, (bidx, *_) in brute.items():
        line = [f"B={bb} {cuda_ms(lambda: bidx.search(qx[:bb], k=k, depth=depth)):.3f} ms"
                for bb in (b, 8, 1)]
        print(f"brute force {pp} search (median of {RUNS}, CUDA events) on {card}: "
              f"{'; '.join(line)}")
    line = []
    for bb in (1, 8):
        line.append(f"B={bb} {cuda_ms(lambda: pidx.search(qx[:bb], k=k, depth=depth)):.3f} ms")
    t_256 = cuda_ms(lambda: pidx.search(qx, k=k, depth=depth), runs=3, warmup=1)
    print(f"blockmax classic int4 n_keep={keep} search: {'; '.join(line)}; "
          f"B={b} {t_256:.2f} ms (median of 3)")

    kernels = []
    t = q_tf.shape[1]
    f32_lib = f"f32 torch.matmul with allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    for name, qidx_pq, qop, kind, launches, err, lib_label in (
            ("fused_topk_quantized", quant["int8"][0].index.pq, quant["int8"][1], "bf16",
             quant["int8"][2], quant["int8"][3], "torch.topk(matmul(q, pq.q.to(bf16).T) * scale)"),
            ("fused_topk_quantized/int4", pq4, quant["int4"][1], "bf16", quant["int4"][2],
             quant["int4"][3], "torch.topk(matmul(q, dequant_int4(store).T)), whole-store dequant"),
            ("fused_topk_quantized/f32-int8", brute["int8"][1], qn, "tf32", *brute["int8"][2:],
             f"torch.topk(matmul(q, pq.q.float().T) * scale), {f32_lib}"),
            ("fused_topk_quantized/f32-int4", brute["int4"][1], qn, "tf32", *brute["int4"][2:],
             f"torch.topk(matmul(q, dequant_int4(store).T)), whole-store dequant, {f32_lib}")):
        pq, tq = qidx_pq, qop.shape[1]

        def library(qo, pq=pq, tq=tq):
            if pq.bits == 8:
                return torch.topk(torch.matmul(qo, pq.q.to(qo.dtype).T) * pq.scale.T, depth)
            return torch.topk(torch.matmul(
                qo, dequant_int4(pq.q, pq.scale, pq.group, qo.dtype)[:, :tq].T), depth)

        at = {}  # B -> (kernel, plain, library, bound, bound_by) at the first B queries
        for bb in (b, 8, 1):
            qb = qop[:bb]
            at[bb] = (cuda_ms(lambda: fused_topk_quantized(qb, pq.q, pq.scale, depth, pq.bits,
                                                            pq.group)),
                      cuda_ms(lambda: ref.quantized_topk_ref(qb, pq.q, pq.scale, depth, pq.bits,
                                                             pq.group), runs=3, warmup=1),
                      cuda_ms(lambda: library(qb), runs=3, warmup=1),
                      *quantized_bound_ms(qb, pq.q, pq.scale, n, depth, kind,
                                          passes=2 if kind == "tf32" else 1))
        # The split-TF32 rows' bound is their two tf32 passes; the f32 FMAs
        # of the plain product bound the CUDA-core designs they replaced.
        fma = ("; f32-FMA bound " + ", ".join(
            f"B={bb} {quantized_bound_ms(qop[:bb], pq.q, pq.scale, n, depth, 'f32')[0]:.3f} ms"
            for bb in at) if kind == "tf32" else "")
        print(f"{name} ({'f32' if kind == 'tf32' else kind} query, int{pq.bits}, N={n}, T={tq}, "
              f"depth={depth}): "
              + "; ".join(f"B={bb} kernel {v[0]:.3f} ms, bound {v[3]:.3f} ms ({v[4]}, {kind}), "
                          f"plain {v[1]:.3f} ms, library {v[2]:.3f} ms" for bb, v in at.items())
              + f"{fma} (plain and library: median of 3; library: {lib_label})")
        ms, plain_ms, lib_ms, bound, bound_by = at[b]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk_quantized.cu",
            "replaces": "src/repro/kernels/fused_topk/kernel.py:632",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        })

    # K5 alone at B = 1 and B = 8 on the int4 index, 10% of the blocks.
    rows8 = blockmax.kept_rows(bm4, q_tf[:8], keep)
    k5 = {}
    for bb in (1, 8):
        qb, rb = qv8[:bb], rows8[:bb]
        ms = cuda_ms(lambda: fused_topk_gathered_quantized(qb, pq4.q, pq4.scale, rb, depth, n, 4,
                                                           GROUP))
        plain_ms = cuda_ms(lambda: ref.quantized_gathered_topk_ref(qb, pq4.q, pq4.scale, rb, depth,
                                                                   n, 4, GROUP))
        lib_ms = cuda_ms(lambda: torch.topk(torch.einsum("bt,brt->br", qb, dequant_int4(
            pq4.q[rb.long()], pq4.scale[rb.long()], GROUP, qb.dtype)[..., :t]), depth))
        bound, bound_by, distinct = gathered_quantized_bound_ms(qb, pq4.q, pq4.scale, rb, n, depth,
                                                                "bf16")
        k5[bb] = (ms, plain_ms, lib_ms, bound, bound_by)
        print(f"fused_topk_gathered_quantized (bf16 query, int4 g{GROUP}, B={bb}, "
              f"R={rb.shape[1]}, T={t}, depth={depth}, {distinct} distinct rows): kernel "
              f"{ms:.3f} ms, bound {bound:.3f} ms ({bound_by}), no-reuse floor "
              f"{no_reuse_ms(qb, pq4.q, pq4.scale, rb):.3f} ms; plain {plain_ms:.3f} ms; "
              f"torch.topk(einsum(q, dequant_int4(store[row_ids]))) {lib_ms:.3f} ms")
    # K5 alone at the B = 256 blockmax search's shape (no plain version: its
    # gathered rows would take 23 GB packed, and more dequantized).
    rows_256 = blockmax.kept_rows(bm4, q_tf, keep)
    q256 = q_tf.to(torch.bfloat16)
    ms_256 = cuda_ms(lambda: fused_topk_gathered_quantized(q256, pq4.q, pq4.scale, rows_256, depth,
                                                           n, 4, GROUP), runs=3, warmup=1)
    bound, bound_by, distinct = gathered_quantized_bound_ms(q256, pq4.q, pq4.scale, rows_256, n,
                                                            depth, "bf16")
    print(f"fused_topk_gathered_quantized (B={b}, R={rows_256.shape[1]}, {distinct} distinct "
          f"rows): kernel {ms_256:.3f} ms (median of 3), bound {bound:.3f} ms ({bound_by}), "
          f"no-reuse floor {no_reuse_ms(q256, pq4.q, pq4.scale, rows_256):.3f} ms")
    ms, plain_ms, lib_ms, bound, bound_by = k5[8]
    kernels.append({
        "name": "fused_topk_gathered_quantized", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk_quantized.cu",
        "replaces": "src/repro/kernels/fused_topk/kernel.py:765",
        "launches": k5_launches, "max_abs_err": k5_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
    })
    t0 = time.perf_counter()
    drive_filtered_quantized(card, qx, quant, brute, bm4, masks, depth, k, config)
    return kernels, time.perf_counter() - t0


# --------------------------------------------------------------------------
# Filtered search: DocMetadata masks through every encoding at full N.
# --------------------------------------------------------------------------

FILTER_SEED = 31  # the metadata's generator on the card
FILTER_KEYS = ("1%", "10%", "50%", "50 docs")


def make_filters(dev, n: int, card: str):
    """Per-doc metadata of the corpus on the card (``cat`` uniform on [0,
    100), ``year`` on [2000, 2020), a seeded generator) and its masks: the
    shared keep bitmaps at ~1% (cat = 7), ~10% (year in [2005, 2007)) and
    ~50% (year in [2000, 2010)), and one of exactly 50 docs.  Prints each
    mask's kept count and the time to build it from the metadata."""
    from repro_torch.core.types import DocMetadata

    g = torch.Generator(device=dev).manual_seed(FILTER_SEED)
    md = DocMetadata.from_fields({
        "cat": torch.randint(0, 100, (n,), generator=g, device=dev),
        "year": torch.randint(2000, 2020, (n,), generator=g, device=dev)})
    predicates = {"1%": ("cat = 7", lambda: md.eq_mask("cat", 7)),
                  "10%": ("year in [2005, 2007)", lambda: md.range_mask("year", 2005, 2007)),
                  "50%": ("year in [2000, 2010)", lambda: md.range_mask("year", 2000, 2010))}
    masks = {key: fn() for key, (_, fn) in predicates.items()}
    fifty = torch.zeros(n, dtype=torch.bool, device=dev)
    fifty[torch.randperm(n, generator=g, device=dev)[:50]] = True
    masks["50 docs"] = fifty
    print(f"filter metadata: {md.field_names} x {n} int32 ({md.nbytes() / 1e6:.1f} MB on the "
          f"card); masks (kept docs; time to build from the metadata, median of {RUNS}, CUDA "
          f"events, {card}): "
          + "; ".join(f"{key} {text}: {int(masks[key].sum())} kept, {cuda_ms(fn):.4f} ms"
                      for key, (text, fn) in predicates.items())
          + f"; 50 docs: {int(fifty.sum())} kept")
    return md, masks


def _kept(name: str, ids, mask, n: int) -> None:
    """Raises unless every id is -1 or a doc the (N,) or (B, N) mask keeps."""
    keep = mask if mask.dim() == 2 else mask[None, :].expand(ids.shape[0], -1)
    bits = torch.gather(keep, 1, ids.clamp(0, n - 1).long())
    if not bool(((ids == -1) | ((ids >= 0) & (ids < n) & bits)).all()):
        raise AssertionError(f"{name}: an id that the mask drops, or out of range")


def check_filtered(label: str, idx, plain, masks: dict, qx, depth: int, exact: bool,
                   b256: bool) -> float:
    """``idx``'s filtered search against its plain version with the same
    mask, on the card: at B = 8 with every mask and, where ``b256``, at B =
    256 with the 10% mask (``plain(B, mask, depth)``: the plain version on
    the same query operand); every id kept; an all-ones mask gives the
    unfiltered search bit for bit.  Returns the largest score difference."""
    n = idx.num_docs
    cases = [(8, key) for key in masks] + ([(qx.shape[0], "10%")] if b256 else [])
    err = 0.0
    for bb, key in cases:
        m = masks[key]
        got = idx.search(qx[:bb], k=depth, depth=depth, filt=m)
        _kept(f"filtered {label} {key} B={bb}", got[1], m, n)
        err = max(err, compare(f"filtered {label}, {key} mask, B={bb}", got,
                               plain(bb, m, depth if exact else depth + 1), exact))
    ones = torch.ones(n, dtype=torch.bool, device=qx.device)
    s0, i0 = idx.search(qx[:8], k=depth, depth=depth)
    s1, i1 = idx.search(qx[:8], k=depth, depth=depth, filt=ones)
    if not (torch.equal(s0, s1) and torch.equal(i0, i1)):
        raise AssertionError(f"filtered {label}: an all-ones mask is not the unfiltered search")
    return err


def drive_filtered(dev, card: str, x, qx, gt_i, idx, lidx, bm, md, masks: dict, depth: int,
                   k: int, config) -> int:
    """Filtered search over the fp32 indexes the earlier phases built (no
    index is built again): fake words classic (K1 bf16) and dot (K1 int8)
    over ``idx``, brute force over its unit rows (K1 f32), lexical LSH over
    ``lidx`` (K2), and blockmax over ``bm`` (K3), each held to its plain
    version with the same mask; the all-zeros mask, exact filtered brute
    force, per-query masks, ``FilterMask``; then times, filtered recall and
    one RRF fusion of classic and LSH."""
    from repro_torch.core import blockmax, bruteforce, eval as ev, fakewords, lexical_lsh
    from repro_torch.core import pipeline as pl
    from repro_torch.core import plan
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import BruteForceConfig, FlatIndex
    from repro_torch.kernels.common import f32_matmul, stable_topk
    from repro_torch.kernels.fused_topk import ops, ref

    n, b = x.shape[0], qx.shape[0]
    qn = bruteforce.l2_normalize(qx)
    q_tf = fakewords.encode_queries(qn, config, normalized=True)
    qv = fakewords.classic_query(idx.index, q_tf)
    q_dot = fakewords.dot_query(idx.index, q_tf, dtype=torch.int8)
    sig_q = lexical_lsh.encode(qn, lidx.config)
    dot = AnnIndex(config=dataclasses.replace(config, scoring="dot"), index=idx.index)
    brute = AnnIndex(config=BruteForceConfig(), index=FlatIndex(vectors=idx.index.vectors))
    scored, tf, sig, vectors = idx.index.scored, idx.index.tf, lidx.index.sig, idx.index.vectors
    encodings = (  # label, index, kernel, plain version, exact, B = 256 too
        ("classic (K1 bf16)", idx, "fused_topk",
         lambda bb, m, d: ref.fused_topk_ref(qv[:bb], scored, d, filt=m), False, True),
        ("dot (K1 int8)", dot, "fused_topk",
         lambda bb, m, d: ref.fused_topk_ref(q_dot[:bb], tf, d, filt=m), True, True),
        ("lexical LSH (K2)", lidx, "fused_topk",
         lambda bb, m, d: ref.fused_topk_ref(sig_q[:bb], sig, d, mode="lsh", filt=m), True,
         False),
        ("brute force fp32 (K1 f32)", brute, "fused_topk",
         lambda bb, m, d: ref.fused_topk_ref(qn[:bb], vectors, d, filt=m), False, True))
    for label, index, kernel, plain, exact, b256 in encodings:
        _reset_launches()
        err = check_filtered(label, index, plain, masks, qx, depth, exact, b256)
        launches = _only(f"filtered {label}", kernel)
        print(f"filtered {label}: held to the plain version with the same mask at B = 8 "
              f"({', '.join(masks)}){' and at B = ' + str(b) + ' (10%)' if b256 else ''}, "
              f"{'bit for bit' if exact else 'near-tie rule'}, max_abs_err {err:.3g}; every id "
              f"kept; all-ones = unfiltered bit for bit; {kernel} launches {launches}")

    # ---- all-zeros, with and without rerank; exact filtered brute force ----
    zeros = torch.zeros(n, dtype=torch.bool, device=dev)
    for rerank in (False, True):
        s, i = idx.search(qx[:8], k=k, depth=depth, rerank=rerank, filt=zeros)
        if not (bool((i == -1).all()) and bool((s == -torch.inf).all())):
            raise AssertionError(f"all-zeros mask (rerank={rerank}): not all (-inf, -1)")
    for key, m in masks.items():
        kept = m.nonzero()[:, 0].to(torch.int32)
        es, pos = stable_topk(f32_matmul(qn[:8], vectors[kept.long()].T), k + 1)
        want = (es, torch.where(es == -torch.inf, -1, kept[pos.long()]))
        compare(f"filtered brute force {key}, B=8, vs the exact top-{k} of the kept rows",
                brute.search(qx[:8], k=k, depth=k, filt=m), want, exact=False)
    print(f"all-zeros mask: only (-inf, -1), no NaN, with and without rerank; filtered brute "
          f"force at B = 8 equals an exact f32 top-{k} over the kept rows alone (near-tie rule), "
          f"every mask")

    # ---- per-query (B, N) masks: row r equals query r alone with its mask ----
    md_rows = [masks["1%"], masks["10%"], masks["50%"]] + [
        torch.roll(masks["10%"], 1000 * (r + 1)) for r in range(5)]
    per8 = torch.stack(md_rows)
    for label, index, exact in (("classic", idx, False), ("dot", dot, True),
                                ("lexical LSH", lidx, True)):
        _reset_launches()
        got = index.search(qx[:8], k=depth, depth=depth, filt=per8)
        _kept(f"per-query {label}", got[1], per8, n)
        for r in range(8):
            w = depth if exact else depth + 1
            compare(f"per-query mask {label}, row {r}", (got[0][r:r + 1], got[1][r:r + 1]),
                    index.search(qx[r:r + 1], k=w, depth=w, filt=md_rows[r]), exact)
        _only(f"per-query {label}", "fused_topk")
    print("per-query masks (8, N) at B = 8: each row equals its query searched alone with its "
          "own (N,) mask: classic (near-tie rule), dot and LSH (bit for bit)")

    # ---- blockmax: every block kept, and n_keep 1171 with the 10% mask (K3) ----
    n_blocks = bm.num_blocks
    every = AnnIndex(config=config, index=idx.index, blockmax_keep=n_blocks,
                     blockmax_block_size=BLOCK, bm=bm)
    keep = int(KEEP_FRACTIONS[0] * n_blocks)
    pruned = AnnIndex(config=config, index=idx.index, blockmax_keep=keep,
                      blockmax_block_size=BLOCK, bm=bm)
    for key, m in masks.items():
        got = every.search(qx[:8], k=depth, depth=depth, filt=m)
        _kept(f"blockmax every block {key}", got[1], m, n)
        want = idx.search(qx[:8], k=depth + 1, depth=depth + 1, filt=m)
        compare(f"filtered blockmax classic, every block, {key} mask, B=8", got, want, False)
    m10 = masks["10%"]
    _reset_launches()
    got = pruned.search(qx[:8], k=depth, depth=depth, filt=m10)
    k3_launches = _only("filtered blockmax", "fused_topk_gathered")
    rows8 = blockmax.kept_rows(bm, q_tf[:8], keep)
    err_k3 = compare(
        f"filtered blockmax classic n_keep={keep}, 10% mask, B=8", got,
        ref.gathered_topk_ref(q_tf[:8].to(torch.bfloat16), ref.gather_rows(scored, rows8, n),
                              rows8, depth + 1, n, filt=ops.gather_filt(m10, rows8, n)), False)
    print(f"filtered blockmax classic (K3): every block kept equals the dense filtered search "
          f"at B = 8 with every mask (near-tie rule); n_keep={keep} with the 10% mask held to "
          f"the plain gathered version with gather_filt's mask, max_abs_err {err_k3:.3g}; "
          f"fused_topk_gathered launches {k3_launches}")

    # ---- FilterMask: native (in the kernel) against depth inflation ----
    extra = 1024
    fm = pl.FilterMask(inner=idx.pipeline.matcher, extra=extra)
    m50 = masks["50%"]
    native = fm(idx.index, q_tf[:8], depth, m50, native=True)
    inflated = fm(idx.index, q_tf[:8], depth + 1, m50, native=False)
    compare("FilterMask native vs inflated, 50% mask, B=8", native, inflated, False)
    _, inner_i = idx.pipeline.matcher(idx.index, q_tf[:8], depth + extra)
    full_rows = int((pl.lookup_filt_bits(m50, inner_i).sum(1) >= depth).sum())
    print(f"FilterMask (classic, 50% mask, B = 8): native=True equals native=False with extra "
          f"{extra} (near-tie rule); {full_rows} of 8 rows hold at least {depth} kept docs in "
          f"the inflated list of {depth + extra}")
    if full_rows != 8:
        raise AssertionError("the inflated list lacks depth kept docs in some row")

    # ---- times, filtered recall, and one RRF fusion ----
    line = []
    for bb in (b, 8, 1):
        parts = [f"unfiltered {cuda_ms(lambda: idx.search(qx[:bb], k=k, depth=depth)):.3f}"]
        for key in FILTER_KEYS[:3]:
            m = masks[key]
            t = cuda_ms(lambda: idx.search(qx[:bb], k=k, depth=depth, filt=m))
            parts.append(f"{key} {t:.3f}")
        line.append(f"B={bb} " + ", ".join(parts) + " ms")
    # (B, N): query r keeps the years [2000 + r % 18, 2002 + r % 18), ~10% each
    year = md.values[:, 1]
    lo = 2000 + torch.arange(b, device=dev, dtype=torch.int32)[:, None] % 18
    per_query = (year[None, :] >= lo) & (year[None, :] < lo + 2)
    _reset_launches()
    got = idx.search(qx, k=depth, depth=depth, filt=per_query)
    _only("the per-query-mask search", "fused_topk")
    _kept("per-query mask B=256", got[1], per_query, n)
    compare(f"per-query mask classic B={b}, first 8 queries", (got[0][:8], got[1][:8]),
            ref.fused_topk_ref(qv[:8], scored, depth + 1, filt=per_query[:8]), False)
    t_shared = cuda_ms(lambda: idx.search(qx, k=k, depth=depth, filt=m10))
    t_per = cuda_ms(lambda: idx.search(qx, k=k, depth=depth, filt=per_query))
    splits = {label: split_line(kernel_split(lambda: idx.search(qx, k=k, depth=depth, filt=f),
                                             runs=3))
              for label, f in (("unfiltered", None), ("10%", m10), ("per-query", per_query))}
    del per_query, got
    bm_line = []
    for bb in (1, 8):
        t0 = cuda_ms(lambda: pruned.search(qx[:bb], k=k, depth=depth))
        t1 = cuda_ms(lambda: pruned.search(qx[:bb], k=k, depth=depth, filt=m10))
        bm_line.append(f"B={bb} {t1:.3f} ms (unfiltered {t0:.3f})")
    print(f"filtered classic search (median of {RUNS}, CUDA events) on {card}: "
          + "; ".join(line) + f"; B={b} with a per-query (B, N) mask of ~10% a row "
          f"({b * n / 1e6:.0f} MB of bool) {t_per:.3f} ms against the shared 10% mask's "
          f"{t_shared:.3f} ms; blockmax classic n_keep={keep} with the 10% mask: "
          + "; ".join(bm_line))
    print(f"filtered classic search B={b}, device time per search by kernel (torch.profiler, "
          f"3 searches): " + "; ".join(f"{label}: {line}" for label, line in splits.items()))
    recall = []
    for key in FILTER_KEYS[:3]:
        m = masks[key]
        truth = brute.search(qx, k=k, depth=k, filt=m)[1]
        got = idx.search(qx, k=depth, depth=depth, filt=m)[1]
        recall.append(f"{key} R@(10,10) {float(ev.recall_at(truth, got[:, :k], m)):.4f} "
                      f"R@(10,100) {float(ev.recall_at(truth, got, m)):.4f}")
    print(f"filtered recall of classic against the filtered exact top-{k} (eval.recall_at with "
          f"filter_mask, B = {b}): " + "; ".join(recall))

    plans = (plan.QueryPlan(search=lambda q: idx.search(q, k=depth, depth=depth),
                            label="classic"),
             plan.QueryPlan(search=lambda q: lidx.search(q, k=depth, depth=depth),
                            label="lexical LSH"))
    stage = plan.FusionStage(plans=plans, k=k)
    fused_s, fused_i = stage.run(qx)
    _checked("RRF fusion", fused_s, fused_i, b, k, n)
    r_each = [float(ev.recall_at(gt_i, p.run(qx)[1][:, :k])) for p in plans]
    print(f"RRF FusionStage (classic + lexical LSH, each top-{depth}, k {k}) at B = {b}: "
          f"{cuda_ms(lambda: stage.run(qx)):.3f} ms (median of {RUNS}, CUDA events, {card}); "
          f"R@10 {float(ev.recall_at(gt_i, fused_i)):.4f} (classic {r_each[0]:.4f}, lexical "
          f"LSH {r_each[1]:.4f})")
    return k3_launches


def drive_filtered_kd(card: str, qx, kd, masks: dict, depth: int) -> None:
    """Filtered k-d tree search over the "pca" index of :func:`drive_kdtree`
    (``kd``: the tree index and its unfiltered B = 8 result): the scan (K1
    f32 at T = 9) held to its plain version with the same mask, and the
    tree's post-filter at B = 8 (10% mask) equal to ``mask_and_topk`` of
    its own unfiltered result, bit for bit."""
    from repro_torch.core import bruteforce, kdtree
    from repro_torch.core import pipeline as pl
    from repro_torch.core.index import AnnIndex
    from repro_torch.kernels.fused_topk import ref

    tidx, (ts, ti) = kd
    n = tidx.num_docs
    scan = AnnIndex(config=dataclasses.replace(tidx.config, backend="scan"), index=tidx.index)
    qr = kdtree.reduce_queries(tidx.index, bruteforce.l2_normalize(qx), normalized=True)
    lifted = tidx.index.lifted
    qa = torch.cat([2.0 * qr, torch.ones_like(qr[:, :1])], dim=1).contiguous()
    _reset_launches()
    err = check_filtered("k-d tree pca scan (K1 f32, T = 9)", scan,
                         lambda bb, m, d: ref.fused_topk_ref(qa[:bb], lifted, d, filt=m), masks,
                         qx, depth, False, True)
    launches = _only("filtered k-d tree scan", "fused_topk")
    m = masks["10%"]
    t0 = time.perf_counter()
    got = tidx.search(qx[:8], k=depth, depth=depth, filt=m)
    torch.cuda.synchronize()
    tree_s = time.perf_counter() - t0
    keep = (ti >= 0) & pl.lookup_filt_bits(m, ti)
    want = pl.mask_and_topk(ts, ti, keep, depth, n)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("filtered k-d tree: not mask_and_topk of its unfiltered result")
    _kept("filtered k-d tree", got[1], m, n)
    print(f"filtered k-d tree (pca): the scan held to its plain version with the same mask at "
          f"B = 8 (every mask) and {qx.shape[0]} (10%), near-tie rule, max_abs_err {err:.3g}, "
          f"fused_topk launches {launches}; the tree at B = 8 with the 10% mask equals "
          f"mask_and_topk of its unfiltered result, bit for bit, and keeps "
          f"{(got[1] >= 0).sum(1).tolist()} of {depth} docs a query (a post-filter); "
          f"{tree_s:.2f} s (one run, host clock, {card})")


def drive_filtered_quantized(card: str, qx, quant: dict, brute: dict, bm4, masks: dict,
                             depth: int, k: int, config) -> None:
    """Filtered search over the quantized indexes of :func:`drive_quantized`
    (no index is built again): classic over int8 and int4 postings (K4 bf16
    query) and brute force over int8 (K4 f32 query), each held to its plain
    version with the same mask; the all-zeros mask with the int8 rerank
    store; blockmax on the int4 index (K5) at every block against the dense
    filtered search, and at n_keep 1171 with the 10% mask against the plain
    version with ``gather_filt``'s mask; K5's time with and without it."""
    from repro_torch.core import blockmax, bruteforce, fakewords
    from repro_torch.core.index import AnnIndex
    from repro_torch.kernels.fused_topk import ops, ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk_gathered_quantized

    qn = bruteforce.l2_normalize(qx)
    q_tf = fakewords.encode_queries(qn, config, normalized=True)
    bidx, bpq = brute["int8"][:2]
    n = bidx.num_docs
    cases = [(f"classic {pp} postings (K4 bf16 query)", quant[pp][0], quant[pp][0].index.pq,
              quant[pp][1]) for pp in ("int8", "int4")]
    cases.append(("brute force int8 postings (K4 f32 query)", bidx, bpq, qn))
    for label, qidx, pq, qop in cases:
        _reset_launches()
        err = check_filtered(
            label, qidx, lambda bb, m, d, pq=pq, qop=qop: ref.quantized_topk_ref(
                qop[:bb], pq.q, pq.scale, d, pq.bits, pq.group, filt=m),
            masks, qx, depth, False, True)
        launches = _only(f"filtered {label}", "fused_topk_quantized")
        print(f"filtered {label}: held to the plain version with the same mask at B = 8 (every "
              f"mask) and {qx.shape[0]} (10%), near-tie rule, max_abs_err {err:.3g}; every id "
              f"kept; all-ones = unfiltered bit for bit; fused_topk_quantized launches "
              f"{launches}")
    zeros = torch.zeros(n, dtype=torch.bool, device=qx.device)
    for rerank in (False, True):
        s, i = quant["int8"][0].search(qx[:8], k=k, depth=depth, rerank=rerank, filt=zeros)
        if not (bool((i == -1).all()) and bool((s == -torch.inf).all())):
            raise AssertionError(f"int8 all-zeros mask (rerank={rerank}): not all (-inf, -1)")

    q4 = quant["int4"][0]
    pq4 = q4.index.pq
    n_blocks = bm4.num_blocks
    every = AnnIndex(config=config, index=q4.index, blockmax_keep=n_blocks,
                     blockmax_block_size=BLOCK, bm=bm4)
    for key, m in masks.items():
        got = every.search(qx[:8], k=depth, depth=depth, filt=m)
        _kept(f"int4 blockmax every block {key}", got[1], m, n)
        compare(f"filtered blockmax int4, every block, {key} mask, B=8", got,
                q4.search(qx[:8], k=depth + 1, depth=depth + 1, filt=m), False)
    keep = int(KEEP_FRACTIONS[0] * n_blocks)
    pidx = AnnIndex(config=config, index=q4.index, blockmax_keep=keep, blockmax_block_size=BLOCK,
                    bm=bm4)
    m10 = masks["10%"]
    _reset_launches()
    got = pidx.search(qx[:8], k=depth, depth=depth, filt=m10)
    k5_launches = _only("filtered int4 blockmax", "fused_topk_gathered_quantized")
    rows8 = blockmax.kept_rows(bm4, q_tf[:8], keep)
    qv8 = q_tf[:8].to(torch.bfloat16)
    f8 = ops.gather_filt(m10, rows8, n)
    err = compare(f"filtered blockmax int4 n_keep={keep}, 10% mask, B=8", got,
                  ref.quantized_gathered_topk_ref(qv8, pq4.q, pq4.scale, rows8, depth + 1, n, 4,
                                                  GROUP, filt=f8), False)
    line = []
    for bb in (1, 8):
        qb, rb, fb = qv8[:bb], rows8[:bb], f8[:bb]
        t0 = cuda_ms(lambda: fused_topk_gathered_quantized(qb, pq4.q, pq4.scale, rb, depth, n, 4,
                                                           GROUP))
        t1 = cuda_ms(lambda: fused_topk_gathered_quantized(qb, pq4.q, pq4.scale, rb, depth, n, 4,
                                                           GROUP, filt=fb))
        s0 = cuda_ms(lambda: pidx.search(qx[:bb], k=k, depth=depth))
        s1 = cuda_ms(lambda: pidx.search(qx[:bb], k=k, depth=depth, filt=m10))
        line.append(f"B={bb} K5 {t1:.3f} ms with the mask, {t0:.3f} without; the search "
                    f"{s1:.3f} / {s0:.3f} ms")
    print(f"filtered blockmax int4 (K5): every block kept equals the dense filtered search at "
          f"B = 8 with every mask (near-tie rule); n_keep={keep} with the 10% mask held to the "
          f"plain version with gather_filt's mask, max_abs_err {err:.3g}, "
          f"fused_topk_gathered_quantized launches {k5_launches}; times (median of {RUNS}, "
          f"CUDA events, {card}): " + "; ".join(line))



SEG_SEED = 23  # the deletes' generator of the segments phase
SEG_ADDS = 16  # flushed adds of the full-N classic index: 187,488 rows each
NRT_CYCLES, NRT_ROWS = 10, 1024
NRT_CLASSIC_CYCLES = 6  # each a full repack and two new graphs (B = 8, and 256 with rerank)
COMMIT_ROWS = 100_000  # savez_compressed runs at ~10 MB/s: a full-N commit would take ~15 min


def _sync_s(fn):
    """(fn(), host seconds with the card synchronised on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _replayed(fn):
    """(fn(), the CUDA graph replays it made)."""
    replays, replay = [0], torch.cuda.CUDAGraph.replay

    def counted(graph):
        replays[0] += 1
        return replay(graph)

    torch.cuda.CUDAGraph.replay = counted
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph.replay = replay
    return out, replays[0]


def _mapped(gmap, ids):
    """Monolithic live-corpus ids -> the segmented reader's global ids."""
    return torch.where(ids >= 0, gmap[ids.clamp_min(0).long()], -1).to(torch.int32)


def _seg_parity(label, reader, mono, qx, bs, depth: int, k: int, exact: bool) -> float:
    """``reader``'s packed search equals its loop bit for bit, and both
    equal ``mono`` (a monolithic build of its live rows; ids through
    ``live_global_ids``) bit for bit, or under the near-tie rule where
    ``exact`` is False, at each B of ``bs``, with and without rerank.
    Returns the largest score difference against ``mono``."""
    gmap = torch.from_numpy(reader.live_global_ids()).to(qx.device)
    err = 0.0
    for bb in bs:
        for rerank in (False, True):
            kk = k if rerank else depth
            got = reader.search(qx[:bb], k=kk, depth=depth, rerank=rerank, packed=True)
            loop = reader.search(qx[:bb], k=kk, depth=depth, rerank=rerank, packed=False)
            compare(f"{label} packed vs loop B={bb} rerank={rerank}", got, loop, exact=True)
            extra = 0 if exact else 1  # the near-tie rule reads one rank more
            ms, mi = mono.search(qx[:bb], k=kk + extra, depth=depth + (extra and not rerank),
                                 rerank=rerank)
            err = max(err, compare(f"{label} segmented vs monolithic B={bb} rerank={rerank}",
                                   got, (ms, _mapped(gmap, mi)), exact))
    return err


def _seg_writer(dev, cfg, x, adds: int, dead, md=None, **knobs):
    """An IndexWriter (no merge policy) with ``x`` flushed in ``adds``
    equal adds (with ``md``'s rows where given), ``dead`` deleted and a
    refreshed reader; returns (writer, reader, flush s, (delete s, refresh
    s))."""
    from repro_torch.core.segments import IndexWriter
    from repro_torch.core.types import DocMetadata

    w = IndexWriter(cfg, merge_policy=knobs.pop("merge_policy", None), device=dev, **knobs)
    per = x.shape[0] // adds

    def flush_all():
        for a in range(adds):
            rows = slice(a * per, (a + 1) * per)
            w.add(x[rows], metadata=None if md is None else DocMetadata(
                values=md.values[rows], field_names=md.field_names))
            w.flush()

    _, flush_s = _sync_s(flush_all)
    t0 = time.perf_counter()
    if dead is not None and w.delete(dead) != len(dead):
        raise AssertionError("delete did not flip every id")
    delete_s = time.perf_counter() - t0
    reader, refresh_s = _sync_s(w.refresh)
    return w, reader, flush_s, (delete_s, refresh_s)


def drive_segments(dev, card: str, x, qx, depth: int, k: int, config, md) -> int:
    """The segmented mutable index and the packed single launch
    (``repro_torch.core.segments`` / ``packed``) on the ann-word2vec corpus
    ``x`` with the queries ``qx``, every check against the packed path, the
    per-segment loop and a monolithic ``AnnIndex.build`` of the live rows:

      * classic fp32 at full N: 16 flushed adds with ``md``'s rows, 1% of
        the ids deleted, searches at B = 256, 8 and 1 with and without
        rerank (packed == loop == monolithic, bit for bit); the ~10% year
        predicate through ``global_metadata()`` at B = 8; ``force_merge(1)``;
        the same 16 adds under the default ``TieredMergePolicy`` (2
        segments); loop and packed times at 1, 4 and 16 segments;
      * dot (int8 postings, int8 rerank), classic int4, LSH, the kd scan and
        brute force at full N in 4 segments, B = 8;
      * packed blockmax over the classic fp32 and int4 packs (K3, K5);
      * NRT cycles: LSH appends in place replaying one CUDA graph, classic
        repacking and capturing anew;
      * commit and load of two generations at 100,000 rows.

    Resets the device's peak memory statistic to read the phase's own peak;
    returns the peak of the run before the phase.
    """
    from repro_torch.core import packed as packed_mod
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import (
        BruteForceConfig, DocMetadata, FakeWordsConfig, KdTreeConfig, LexicalLshConfig)
    import numpy as np

    from repro_torch.core.segments import IndexWriter, SegmentedAnnIndex, TieredMergePolicy

    t_phase = time.perf_counter()
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cache = packed_mod.EXEC_CACHE
    cache.clear()
    n, b = x.shape[0], qx.shape[0]
    rng = np.random.default_rng(SEG_SEED)
    dead = rng.choice(n, size=n // 100, replace=False)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    live[torch.from_numpy(dead).to(dev)] = False

    # ---- classic fp32, 16 segments at full N --------------------------------
    w, reader, flush_s, (delete_s, refresh_s) = _seg_writer(dev, config, x, SEG_ADDS, dead,
                                                              md)
    _, views_s = _sync_s(reader._ensure_views)
    pk, pack_s = _sync_s(reader.packed_segments)
    mono = AnnIndex.build(x[live], config, metadata=DocMetadata(
        values=md.values[live], field_names=md.field_names), device=dev)
    _seg_parity("classic 16 segments", reader, mono, qx, (b, 8, 1), depth, k, exact=True)
    pred = reader.global_metadata().range_mask("year", 2005, 2007)
    gmap = torch.from_numpy(reader.live_global_ids()).to(dev)
    ms, mi = mono.search(qx[:8], k=depth, depth=depth,
                         filt=mono.metadata.range_mask("year", 2005, 2007))
    for packed in (True, False):
        got = reader.search(qx[:8], k=depth, depth=depth, filter_mask=pred, packed=packed)
        _kept(f"segmented filtered packed={packed}", got[1], pred & live, n)
        compare(f"segmented filtered (year 10%) packed={packed} vs monolithic", got,
                (ms, _mapped(gmap, mi)), exact=True)
    default = reader.search(qx[:8], k=k, depth=depth)  # packed=None: the packed path if it can
    compare("segmented packed=None vs packed=True", default,
            reader.search(qx[:8], k=k, depth=depth, packed=True), exact=True)
    took = "packed" if reader._packed is not None else f"loop ({reader._packed_err})"
    # the capture against the steady search; launches a search, replays
    cache.clear()
    _, first_s = _sync_s(lambda: reader.search(qx[:8], k=k, depth=depth, rerank=True,
                                               packed=True))
    steady = cuda_ms(lambda: reader.search(qx[:8], k=k, depth=depth, rerank=True, packed=True))
    reader.search(qx[:8], k=k, depth=depth, packed=True)  # captures the entry counted below
    _reset_launches()
    _, loop_replays = _replayed(lambda: reader.search(qx[:8], k=k, depth=depth, packed=False))
    loop_launches = _launches()
    _reset_launches()
    _, packed_replays = _replayed(lambda: reader.search(qx[:8], k=k, depth=depth, packed=True))
    if any(_launches().values()) or packed_replays != 1 or loop_replays:
        raise AssertionError(f"packed search: eager launches {_launches()}, replays "
                             f"{packed_replays}; loop replays {loop_replays}")
    captured = next(reversed(cache._entries.values())).captured
    if loop_launches["fused_topk"] != SEG_ADDS or captured != {"fused_topk": 1}:
        raise AssertionError(f"loop launches {loop_launches}, graph holds {captured}")
    print(f"segments classic fp32: {SEG_ADDS} adds of {n // SEG_ADDS} rows flushed in "
          f"{flush_s:.2f} s, {len(dead)} deletes in {delete_s:.3f} s, refresh "
          f"{refresh_s * 1e3:.1f} ms (host clock), stat views "
          f"{views_s * 1e3:.1f} ms, pack {pack_s * 1e3:.1f} ms (bucket {pk.bucket}); packed == "
          f"loop == monolithic bit for bit at B = {b}, 8, 1 with and without rerank, and with "
          f"the year predicate ({int(pred.sum())} kept) at B = 8; a search: the loop "
          f"{loop_launches['fused_topk']} fused_topk launches, the packed path 1 graph replay "
          f"holding {captured}; the first packed B = 8 rerank search (captures) "
          f"{first_s * 1e3:.1f} ms host clock, steady {steady:.3f} ms (CUDA events); "
          f"packed=None took the {took} path; {card}")
    seg_times = {SEG_ADDS: _seg_times(reader, mono, qx, k, depth)}
    print(f"segments classic fp32, 16 segments: the packed search's CUDA graph against the "
          f"same search eager (median of {RUNS} each, in turns, CUDA events, k {k}, depth "
          f"{depth}, {card}): "
          + _graph_vs_eager(reader, qx, (b, 8, 1), k, depth, rerank=False)
          + "; with rerank " + _graph_vs_eager(reader, qx, (8, 1), k, depth, rerank=True))
    print(_seg_blockmax("classic fp32", reader, qx, depth, card))
    del reader, pk
    w._reader = None
    cache.clear()
    (_, merge_s) = _sync_s(lambda: w.force_merge(1))
    one = w.refresh()
    if one.num_segments != 1 or one.del_count:
        raise AssertionError("force_merge(1) left more than one segment or a delete")
    _seg_parity("classic force_merge(1)", one, mono, qx, (b, 8), depth, k, exact=True)
    seg_times[1] = _seg_times(one, mono, qx, k, depth)
    del w, one, mono
    cache.clear()
    torch.cuda.empty_cache()
    w4, r4, _, _ = _seg_writer(dev, config, x, 4, None)
    mono_all = AnnIndex.build(x, config, device=dev)
    _seg_parity("classic 4 segments", r4, mono_all, qx, (8,), depth, k, exact=True)
    seg_times[4] = _seg_times(r4, mono_all, qx, k, depth)
    del w4, r4
    cache.clear()
    torch.cuda.empty_cache()
    print(f"segments classic fp32 search times (median of {RUNS}, CUDA events, k {k}, depth "
          f"{depth}, {card}); force_merge(1) {merge_s:.2f} s host clock: "
          + "; ".join(f"{m} segments: " + ", ".join(
              f"B={bb} loop {lp:.3f} / packed {pkd:.3f} / monolithic {mn:.3f} ms"
              for bb, (lp, pkd, mn) in t.items()) for m, t in sorted(seg_times.items())))

    # ---- the default TieredMergePolicy over the same 16 adds ------------------
    wt, rt, tier_s, _ = _seg_writer(dev, config, x, SEG_ADDS, None,
                                    merge_policy=TieredMergePolicy())
    if rt.num_segments != 2:
        raise AssertionError(f"tiered merging left {rt.num_segments} segments, not 2")
    _seg_parity("classic tiered (2 segments)", rt, mono_all, qx, (8,), depth, k, exact=True)
    print(f"segments tiered: {SEG_ADDS} adds under the default TieredMergePolicy settle at "
          f"{rt.num_segments} segments ({[s.num_docs for s in rt.segments]}) in {tier_s:.2f} s "
          f"host clock (merges included); equal to the monolithic build bit for bit")
    del wt, rt, mono_all
    cache.clear()
    torch.cuda.empty_cache()

    # ---- the other encodings, 4 segments each ----------------------------------
    others = (("dot int8 postings + int8 rerank", FakeWordsConfig(quantization=50,
               scoring="dot"), {"primary_postings": "int8", "rerank_store": "int8"}, True),
              ("classic int4", config, {"primary_postings": "int4"}, True),
              ("lexical LSH", LexicalLshConfig(buckets=300, hashes=1), {}, True),
              ("kd scan pca", KdTreeConfig(dims=8), {}, False),
              ("brute force fp32", BruteForceConfig(), {}, False))
    int4_bm = ""
    for label, cfg, knobs, exact in others:
        w, r, _, _ = _seg_writer(dev, cfg, x, 4, dead, **dict(knobs))
        mono = AnnIndex.build(x[live], cfg, device=dev, **knobs)
        _reset_launches()
        err = _seg_parity(label, r, mono, qx, (8,), depth, k, exact)
        used = {name: v for name, v in _launches().items() if v}
        note = ""
        if isinstance(cfg, KdTreeConfig):
            views, _ = r._ensure_views()
            got = torch.cat([v.reduced for v in views])[live]
            note = (f"; the stat views' reduced rows bit-equal to the monolithic "
                    f"build's: {torch.equal(got, mono.index.reduced)} (max diff "
                    f"{float((got - mono.index.reduced).abs().max()):.3g})")
        print(f"segments {label}: 4 segments at full N, 1% deleted; packed == loop bit for bit; "
              f"against the monolithic build {'bit for bit' if exact else 'near-tie rule'}, "
              f"max diff {err:.3g}{note}; launches of the checks {used}")
        if label == "classic int4":
            int4_bm = _seg_blockmax("classic int4", r, qx, depth, card)
        del w, r, mono
        cache.clear()
        torch.cuda.empty_cache()
    print(int4_bm)

    # ---- NRT cycles -------------------------------------------------------------
    nrt_lines = []
    for label, cfg, cycles in (("LSH", LexicalLshConfig(buckets=300, hashes=1), NRT_CYCLES),
                               ("classic", config, NRT_CLASSIC_CYCLES)):
        cache.clear()
        base = n - NRT_CYCLES * NRT_ROWS
        w = IndexWriter(cfg, merge_policy=None, device=dev)
        w.add(x[:base])
        r = w.refresh()
        r.search(qx[:8], k=k, depth=depth, packed=True)
        after_first = cache.compiles
        times, held = [], []
        for c in range(cycles):
            rows = x[base + c * NRT_ROWS: base + (c + 1) * NRT_ROWS]
            _, add_s = _sync_s(lambda: (w.add(rows), w.flush()))
            r, refresh_s = _sync_s(w.refresh)
            pkc = None  # the previous cycle's pack goes with its reader
            pkc, append_s = _sync_s(r.packed_segments)
            (got, replays) = _replayed(lambda: r.search(qx[:8], k=k, depth=depth, packed=True))
            compare(f"NRT {label} cycle {c + 1} packed vs loop", got,
                    r.search(qx[:8], k=k, depth=depth, packed=False), exact=True)
            times.append((add_s, refresh_s, append_s, pkc.appends))
            if label == "classic":
                # and at B = 256 with rerank: the largest graph pool of the phase
                r.search(qx, k=k, depth=depth, rerank=True, packed=True)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()  # what stays reserved is held by tensors and graphs
                held.append((cache.stats()["entries"], torch.cuda.memory_reserved(),
                             torch.cuda.memory_allocated()))
                if held[-1][0] != 2:
                    raise AssertionError(f"NRT classic cycle {c + 1}: {cache.stats()}: the "
                                         "dead packs' graphs were not dropped")
        if label == "LSH" and (cache.compiles != after_first or cache.hits < 8
                               or pkc.appends != cycles):
            raise AssertionError(f"NRT LSH: {cache.stats()}, appends {pkc.appends}")
        if label == "classic" and cache.compiles != after_first + 2 * cycles:
            raise AssertionError(f"NRT classic did not capture anew each cycle: {cache.stats()}")
        nrt_lines.append(
            f"{label} ({cycles} cycles of {NRT_ROWS} rows on {base} rows): cache "
            f"{cache.stats()}, in-place appends {pkc.appends}, last search replays {replays}; "
            "a cycle's add+flush / refresh / pack (append) ms: " + ", ".join(
                f"{a * 1e3:.1f} / {f * 1e3:.1f} / {p * 1e3:.1f}" for a, f, p, _ in times)
            + ("" if not held else "; after each cycle (B = 8 and B = 256 rerank searched) "
               "cache entries / device memory reserved after empty_cache / allocated: "
               + ", ".join(f"{e} / {m / 1e9:.3f} / {a / 1e9:.3f} GB" for e, m, a in held)))
        del w, r, pkc
        cache.clear()
        torch.cuda.empty_cache()
    print("segments NRT cycles (host clock, synchronised; each cycle's packed search equals "
          f"the loop bit for bit; {card}): " + "; ".join(nrt_lines))

    # ---- commit and load, cut to 100,000 rows ---------------------------------------
    root = os.path.join(ROOT, "build", "segments")
    shutil.rmtree(root, ignore_errors=True)
    xc = x[:COMMIT_ROWS]
    w = IndexWriter(config, path=root, merge_policy=None, rerank_store="int8",
                    primary_postings="int8", device=dev)
    for a in range(4):
        w.add(xc[a * COMMIT_ROWS // 4:(a + 1) * COMMIT_ROWS // 4])
        w.flush()
    snaps, commit_s = {}, []
    for gen in (1, 2):
        w.delete(rng.choice(COMMIT_ROWS, size=COMMIT_ROWS // 100, replace=False))
        r = w.refresh()
        snaps[gen] = [r.search(qx, k=depth, depth=depth, packed=p) for p in (True, False)]
        snaps[gen].append(r.search(qx, k=k, depth=depth, rerank=True))
        (g, sec) = _sync_s(w.commit)
        if g != gen:
            raise AssertionError(f"commit wrote generation {g}, not {gen}")
        commit_s.append(sec)
    small = _graph_vs_eager(r, qx, (qx.shape[0], 8, 1), k, depth, rerank=True)
    load_s = []
    for gen in (1, 2):
        (r, sec) = _sync_s(lambda: SegmentedAnnIndex.load(root, generation=gen, device=dev))
        load_s.append(sec)
        got = [r.search(qx, k=depth, depth=depth, packed=p) for p in (True, False)]
        got.append(r.search(qx, k=k, depth=depth, rerank=True))
        for want, have in zip(snaps[gen], got):
            compare(f"commit generation {gen} after load", have, want, exact=True)
    disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    shutil.rmtree(root, ignore_errors=True)
    print(f"segments commit / load (classic, int8 postings + int8 rerank, {COMMIT_ROWS} rows, "
          f"{w.num_segments} segments with source sidecars, {disk / 1e6:.1f} MB on disk): "
          f"commit gen 1 {commit_s[0]:.2f} s, gen 2 {commit_s[1]:.2f} s; load gen 1 "
          f"{load_s[0]:.2f} s, gen 2 {load_s[1]:.2f} s (host clock, {card}); searches after "
          "load bit-equal to the writer's snapshots at both generations; the packed rerank "
          f"search's CUDA graph against the same search eager (median of {RUNS} each, in "
          f"turns, CUDA events): {small}")
    del w, r
    cache.clear()
    print(f"segments phase: {time.perf_counter() - t_phase:.1f} s, the phase's peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB (the run's before it "
          f"{peak_before / 1e9:.1f} GB; {card})")
    return peak_before


@contextlib.contextmanager
def _eager_packed():
    """The packed search without its CUDA graph: a cache of its own whose
    entries are the plain callables (as on the CPU route), for timing."""
    from repro_torch.core import packed as packed_mod

    from repro_torch.core import executables

    saved = packed_mod.EXEC_CACHE, executables._GraphEntry
    packed_mod.EXEC_CACHE = executables.ExecutableCache()
    executables._GraphEntry = lambda fn, resident, fed: (lambda res, fd: fn(*res, *fd))
    try:
        yield
    finally:
        packed_mod.EXEC_CACHE, executables._GraphEntry = saved


def _graph_vs_eager(reader, qx, bs, k: int, depth: int, rerank: bool) -> str:
    """The packed search's graph replay against the same search run eagerly,
    at each B of ``bs`` in turns (graph, eager, eager, graph), CUDA events:
    each run starts on an idle card, so the host's launches count."""
    def search(bb):
        return reader.search(qx[:bb], k=k, depth=depth, rerank=rerank, packed=True)

    out = []
    for bb in bs:
        got = search(bb)
        with _eager_packed():
            compare(f"packed eager vs graph B={bb}", search(bb), got, exact=True)
        times = {"graph": [], "eager": []}
        for mode in ("graph", "eager", "eager", "graph"):
            with _eager_packed() if mode == "eager" else contextlib.nullcontext():
                times[mode].append(cuda_ms(lambda: search(bb)))
        out.append(f"B={bb} graph " + " / ".join(f"{t:.3f}" for t in times["graph"])
                   + " eager " + " / ".join(f"{t:.3f}" for t in times["eager"]) + " ms")
    return ", ".join(out)


def _seg_times(reader, mono, qx, k: int, depth: int) -> dict:
    """{B: (loop ms, packed ms, monolithic ms)} at B = 256, 8 and 1, in one
    stretch."""
    return {bb: (cuda_ms(lambda: reader.search(qx[:bb], k=k, depth=depth, packed=False)),
                 cuda_ms(lambda: reader.search(qx[:bb], k=k, depth=depth, packed=True)),
                 cuda_ms(lambda: mono.search(qx[:bb], k=k, depth=depth)))
            for bb in (qx.shape[0], 8, 1)}


def _seg_blockmax(label: str, reader, qx, depth: int, card: str) -> str:
    """Packed blockmax over ``reader``'s pack: at every block kept equal to
    the packed dense search (near-tie rule) at B = 8; the times at
    n_keep 1,171 at B = 8 and 1."""
    pk = reader.packed_segments()
    every = pk.bucket // BLOCK
    got = reader.search(qx[:8], k=depth, depth=depth, blockmax_keep=every)
    err = compare(f"packed blockmax {label}, every block", got,
                  reader.search(qx[:8], k=depth + 1, depth=depth + 1), exact=False)
    keep = 1171
    times = {bb: cuda_ms(lambda: reader.search(qx[:bb], k=10, depth=depth, blockmax_keep=keep))
             for bb in (8, 1)}
    return (f"segments packed blockmax {label}: every block ({every}) equals the packed dense "
            f"search (near-tie rule, max diff {err:.3g}); n_keep {keep}: "
            + ", ".join(f"B={bb} {t:.3f} ms" for bb, t in times.items())
            + f" (median of {RUNS}, CUDA events, {card})")


# --------------------------------------------------------------------------
# Serving (``repro_torch.serve.ann_service``, ``repro_torch.launch.serve``)
# --------------------------------------------------------------------------

SERVE_QUERIES = 2048  # the replayed stream, drawn as the launcher draws it (make_queries)
SERVE_BATCHES = (1, 8, 64, 256)  # max_batch of the sync service; 64 is the launcher's
SERVE_POOL = 256  # the open loop's Zipfian pool (the launcher's --query-pool)
SERVE_ZIPF = 1.1
SERVE_SECONDS = 10.0  # each open-loop rate, search only
NRT_SECONDS = 5.0  # each NRT open loop (LSH, classic) at 1,000 QPS
NRT_EVERY = 200  # requests between two mutations (the launcher's --mutate-every)
CACHE_HITS = 20


class _SnapshotTaggedCache(dict):
    """A service's result cache that remembers the snapshot object each
    entry was stored under (a weak reference) and counts the hits served
    while another snapshot is bound (stale).  The service's key carries the
    epoch, so this catches a snapshot that changed under an unchanged
    epoch."""

    def __init__(self, svc):
        super().__init__()
        self.svc, self.snaps, self.hits, self.stale = svc, {}, 0, 0

    def __setitem__(self, key, value):
        self.snaps[key] = weakref.ref(self.svc.ann)
        super().__setitem__(key, value)

    def __getitem__(self, key):
        self.hits += 1
        self.stale += self.snaps[key]() is not self.svc.ann
        return super().__getitem__(key)

    def move_to_end(self, key):  # the service's LRU calls: keep insertion order
        value = super().pop(key)
        super().__setitem__(key, value)

    def popitem(self, last=True):
        key = next(iter(self)) if not last else next(reversed(self))
        self.snaps.pop(key, None)
        return key, super().pop(key)


def _service_only(fn):
    """(fn(), launches, graph replays): the kernel wrappers' counts set to 0
    just before ``fn`` and read just after it, and the CUDA graph replays
    it made.  ``fn`` holds the service's own calls and nothing else: every
    reference search runs outside it."""
    _reset_launches()
    out, replays = _replayed(fn)
    return out, _launches(), replays


def _served(path: str, kernel: str, counts: dict, replays: int = 0) -> int:
    """Raises unless ``kernel`` alone ran in a service window: launched
    there (a capture of the service's own counts), or, with ``replays``
    allowed, replayed in a graph an earlier service call captured."""
    others = {k: v for k, v in counts.items() if k != kernel and v}
    if others or counts[kernel] + replays <= 0:
        raise AssertionError(f"{path}: the service did not run through {kernel} alone: "
                             f"{counts}, {replays} graph replays")
    return counts[kernel]


def _host_p(times_s) -> tuple:
    """(p50, p99) in ms of host-clock samples."""
    import numpy as np

    ms = np.asarray(times_s, np.float64) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def _facade_wall(fn, runs: int) -> tuple:
    """(p50, p99) ms of ``fn`` on the host clock, the card synchronised
    before and after each call (what a caller of the facade waits)."""
    fn()
    times = []
    for _ in range(runs):
        times.append(_sync_s(fn)[1])
    return _host_p(times)


def _np_pair(pair):
    import numpy as np

    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in pair)


def _capture_during_add(dev, svc, w, rows, victims, q) -> str:
    """Force the async worker's first packed search (a CUDA-graph capture)
    to stand mid-capture, held in the kernel wrapper, while this thread runs
    ``w.add(rows)`` (a pageable copy to the card), ``w.delete(victims)`` and
    device work of its own.  Raises unless all of it goes through: this
    thread's stream is not capturing, the rows reach the card intact (a
    recorded copy would not have run), the capture completes, the replayed
    graph gives the worker's result bit for bit and the per-segment loop's
    under the near-tie rule, and after ``refresh`` the rows are found."""
    import threading

    import numpy as np

    from repro_torch.core import packed as packed_mod
    from repro_torch.kernels.fused_topk import ops
    from repro_torch.serve.ann_service import AnnService

    capturing, added = threading.Event(), threading.Event()
    real = ops.fused_topk

    def held_mid_capture(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing() and not capturing.is_set():
            capturing.set()
            if not added.wait(300):
                raise AssertionError("capture during add: the add never finished")
        return real(*args, **kwargs)

    cache = packed_mod.EXEC_CACHE
    compiles = cache.compiles
    ops.fused_topk = held_mid_capture
    _reset_launches()  # the service's own window: up to the replay below
    try:
        svc.start_async()
        fut = svc.search_async(q)
        if not capturing.wait(300):
            raise AssertionError("capture during add: the worker's search did not capture")
        other_capturing = torch.cuda.is_current_stream_capturing()
        t0 = time.perf_counter()
        ids = w.add(rows)
        newly = w.delete(victims)
        on_card = w._buf[-1].cpu().numpy()
        total = float(torch.as_tensor(rows, device=dev).double().sum())
        add_ms = (time.perf_counter() - t0) * 1e3
        added.set()
        got = fut.result(timeout=300)
        svc.stop_async()
    finally:
        ops.fused_topk = real
        added.set()
    if other_capturing or not np.array_equal(on_card, rows) or newly != len(victims) or abs(
            total - float(rows.astype(np.float64).sum())) > 1e-6 * max(1.0, abs(total)):
        raise AssertionError(f"capture during add: the other thread's work went wrong "
                             f"(capturing {other_capturing}, newly deleted {newly})")
    if cache.compiles != compiles + 1:
        raise AssertionError(f"capture during add: {cache.compiles - compiles} captures")
    uncached = AnnService(svc.ann, dataclasses.replace(svc.scfg, cache_size=0))
    again, replays = _replayed(lambda: uncached.search_batch(q))  # the captured graph
    launches = _served("capture during add", "fused_topk", _launches())
    if replays != 1:
        raise AssertionError(f"capture during add: {replays} graph replays, want 1")
    if not (np.array_equal(again[0], got[0]) and np.array_equal(again[1], got[1])):
        raise AssertionError("capture during add: the replay differs from the captured run")
    loop = svc.ann.search(q, k=svc.scfg.k, depth=svc.scfg.depth, rerank=svc.scfg.rerank,
                          packed=False)
    err = compare("capture during add: the captured search vs the loop", _np_pair(got), loop,
                  exact=False)
    svc.refresh()
    _, found = svc.search_batch(rows[:8])
    if not np.array_equal(found[:, 0], ids[:8]):
        raise AssertionError("capture during add: the added rows are not found after refresh")
    return (f"capture during add: the worker held mid-capture while this thread added "
            f"{rows.shape[0]} rows (pageable copy) and deleted {newly} in {add_ms:.1f} ms; this "
            f"thread's stream not capturing; rows on the card intact; 1 capture (fused_topk "
            f"launches {launches} in the service's window), its replay (a service without a "
            f"result cache) bit-equal, the loop "
            f"within {err:.3g}; the rows found after refresh")


def _serve_sync(idx, qs, qs_dev, gt, depth: int, k: int, card: str) -> dict:
    """The sync service over the monolithic ``idx`` at each max_batch of
    SERVE_BATCHES, against ``AnnIndex.search`` on the same rows in one
    batch: match only bit for bit, reranked under the near-tie rule (bit
    equality printed); per-batch p50 / p99 beside the facade's at the same
    B.  The kernel launches are counted around the service's own calls
    alone.  Returns ({max_batch: per-batch p50 ms with rerank}, the
    service's fused_topk launches)."""
    import numpy as np

    from repro_torch.core import eval as ev
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    p50s, lines, launched = {}, [], 0
    for rerank in (False, True):
        want = idx.search(qs_dev, k=k, depth=depth, rerank=rerank)
        for mb in SERVE_BATCHES:
            svc = AnnService(idx, AnnServiceConfig(k=k, depth=depth, rerank=rerank, max_batch=mb,
                                                   latency_window=SERVE_QUERIES))
            got, counts, _ = _service_only(lambda: svc.search_batch(qs))
            launched += _served(f"serve sync max_batch={mb}", "fused_topk", counts)
            bits = all(np.array_equal(g, w.cpu().numpy()) for g, w in zip(got, want))
            err = compare(f"service classic max_batch={mb} rerank={rerank} vs AnnIndex.search "
                          f"(B={len(qs)})", _np_pair(got), want, exact=not rerank)
            if not rerank:
                continue
            st = svc.stats()
            qb = qs_dev[:mb]
            f50, f99 = _facade_wall(lambda: idx.search(qb, k=k, depth=depth, rerank=True),
                                    min(len(qs) // mb, 64))
            ev_ms = cuda_ms(lambda: idx.search(qb, k=k, depth=depth, rerank=True))
            p50s[mb] = st["lat_p50_ms"]
            lines.append(
                f"max_batch {mb}: {st['batches']} batches, R@10 "
                f"{float(ev.recall_at(gt, torch.from_numpy(got[1]))):.4f}, scores "
                f"{'bit-equal' if bits else f'within {err:.3g}'}; service p50 / p99 "
                f"{st['lat_p50_ms']:.3f} / {st['lat_p99_ms']:.3f} ms a batch, facade "
                f"{f50:.3f} / {f99:.3f} ms (host clock, synchronised; CUDA events "
                f"{ev_ms:.3f}): the service's own cost {st['lat_p50_ms'] - f50:.3f} ms")
    print(f"serve sync (AnnService over the classic fp32 index with the exact rerank, "
          f"{len(qs)} queries drawn as the launcher draws them; match only bit-equal to "
          f"AnnIndex.search on the same rows in one batch at every max_batch, reranked under "
          f"the near-tie rule; fused_topk launches {launched} in the service's calls; "
          f"{card}): " + "; ".join(lines))
    return p50s, launched


def _serve_cache(idx, qs, depth: int, k: int, card: str, miss_p50: float) -> None:
    import numpy as np

    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    svc = AnnService(idx, AnnServiceConfig(k=k, depth=depth, rerank=True, max_batch=64,
                                           cache_size=64))
    first, counts, _ = _service_only(lambda: svc.search_batch(qs[:64]))
    miss_launches = _served("serve cache, the miss", "fused_topk", counts)
    svc.reset_latency()

    def hits():
        for _ in range(CACHE_HITS):
            out = svc.search_batch(qs[:64])
        return out

    again, counts, replays = _service_only(hits)
    if any(counts.values()) or replays:
        raise AssertionError(f"serve cache: a hit ran a kernel: {counts}, {replays} replays")
    if (svc.cache_hits, svc.cache_misses) != (CACHE_HITS, 1) or not all(
            np.array_equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"serve cache: hits {svc.cache_hits}, misses {svc.cache_misses}")
    st = svc.stats()
    print(f"serve cache (cache_size 64, max_batch 64, {CACHE_HITS} repeats of one batch): hits "
          f"{svc.cache_hits} (no kernel launched), misses {svc.cache_misses} (fused_topk "
          f"launches {miss_launches}), results bit-equal; a hit p50 / p99 "
          f"{st['lat_p50_ms']:.3f} / {st['lat_p99_ms']:.3f} ms (encode on the card, key bytes "
          f"copied to the host, SHA-1) against a miss p50 {miss_p50:.3f} ms (host clock, {card})")


class _NoopService:
    """A stand-in for the started async service whose ``search_async``
    takes the query as the service does (a host copy) and returns a
    resolved future: the open loop against it measures the submitting
    thread alone."""

    def search_async(self, query, filter=None):
        import numpy as np
        from concurrent.futures import Future

        np.asarray(query).copy()
        fut = Future()
        fut.set_result(None)
        return fut


def _serve_async(idx, pool_q, depth: int, k: int, card: str, p50_64: float) -> None:
    """The async micro-batcher over ``idx``, search only, open loop as the
    launcher runs it, at 1,000 QPS and near the rate the sync service's
    batch of 64 implies; every future's result held to the sync service's
    row for its query (near-tie rule).  The kernel launches are counted
    around each open loop alone.  Where the submitting thread's time goes:
    the seconds it spent inside accepted and inside shed ``search_async``
    calls, and the same loop against a no-op ``search_async``."""
    import queue as queue_mod

    import numpy as np

    from repro_torch.launch import serve as launch
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    scfg = AnnServiceConfig(k=k, depth=depth, rerank=True, max_batch=64, max_wait_s=0.002,
                            queue_depth=256, latency_window=1 << 17)
    svc = AnnService(idx, scfg)
    table = svc.search_batch(pool_q)
    rng = np.random.default_rng(13)
    sample = launch.zipf_sampler(rng, len(pool_q), SERVE_ZIPF)
    svc.reset_latency()
    seq = launch.sequential_qps(svc, pool_q, sample(512))
    implied = 0.9 * 64 / (p50_64 / 1e3)
    lines = []
    for rate in (1000.0, float(round(implied, -2))):
        drawn, sent_idx = [], []
        took = {"sent": 0.0, "shed": 0.0, "shed_max": 0.0}

        def recorded(m):
            r = sample(m)
            drawn.extend(int(v) for v in r)
            return r

        submit = svc.search_async

        def tracked(q, filter=None):
            t0 = time.perf_counter()
            try:
                f = submit(q, filter)
            except queue_mod.Full:
                dt = time.perf_counter() - t0
                took["shed"] += dt
                took["shed_max"] = max(took["shed_max"], dt)
                raise
            took["sent"] += time.perf_counter() - t0
            sent_idx.append(drawn[-1])
            return f

        svc.search_async = tracked
        svc.reset_latency()
        launches0, rejected0 = svc.async_launches, svc.rejected

        def run():
            svc.start_async()
            out = launch.open_loop(svc, pool_q, recorded, rate, SERVE_SECONDS)
            svc.stop_async()
            return out

        (futs, sent, shed, elapsed, lag), counts, replays = _service_only(run)
        fused = _served(f"serve async at {rate:.0f} QPS", "fused_topk", counts)
        del svc.search_async
        got = [f.result() for f in futs]
        rows = np.asarray(sent_idx)
        compare(f"serve async at {rate:.0f} QPS vs the sync service",
                _np_pair((np.concatenate([g[0] for g in got]),
                          np.concatenate([g[1] for g in got]))),
                _np_pair((table[0][rows], table[1][rows])), exact=False)
        st = svc.stats()
        launches = svc.async_launches - launches0
        if shed != svc.rejected - rejected0 or sent != len(futs):
            raise AssertionError("serve async: shed / sent counts disagree")
        _, _, _, alone_s, alone_lag = launch.open_loop(_NoopService(), pool_q, sample, rate,
                                                       min(SERVE_SECONDS, 3.0))
        lines.append(f"offered {rate:.0f} QPS: sent {sent}, shed {shed}, the submitting "
                     f"thread at most {lag * 1e3:.1f} ms behind its schedule, sustained "
                     f"{len(futs) / elapsed:.1f} QPS, request p50 / p99 {st['req_p50_ms']:.3f} / "
                     f"{st['req_p99_ms']:.3f} ms, {launches} launches, "
                     f"{len(futs) / max(1, launches):.1f} queries a launch, batch p50 "
                     f"{st['lat_p50_ms']:.3f} ms, fused_topk launches {fused}; the submitting "
                     f"thread spent {took['sent']:.3f} s inside {sent} accepted search_async "
                     f"calls and {took['shed']:.3f} s inside {shed} shed ones (the longest "
                     f"{took['shed_max'] * 1e3:.3f} ms); the same loop against a no-op "
                     f"search_async: {min(SERVE_SECONDS, 3.0) * rate / alone_s:.1f} arrivals/s, "
                     f"at most {alone_lag * 1e3:.1f} ms behind")
    print(f"serve async (search only; AnnService max_batch 64, max_wait_s 2 ms, queue_depth 256; "
          f"open loop of {SERVE_SECONDS:.0f} s, Zipf s = {SERVE_ZIPF} over {len(pool_q)} "
          f"queries; every result equal to the sync service's row (near-tie rule); sequential "
          f"one query a launch {seq:.1f} QPS; the batch of 64 implies {implied:.0f} QPS; "
          f"host clock; {card}): " + "; ".join(lines))


def _serve_nrt(dev, card: str, label: str, cfg, x, pool_q, depth: int, k: int) -> None:
    """NRT serving as the launcher's open loop runs it: a full-N writer with
    90% of the rows in its first add, at 1,000 QPS for NRT_SECONDS with a
    32-row add, 4 deletes and ``refresh()`` every NRT_EVERY requests; after
    each refresh the added rows are searched (found at rank 1) and a fixed
    batch twice: the second a cache hit, held bit for bit to a service with
    no cache bound to the same snapshot.  Stale hits (an entry served while
    another snapshot object is bound) must be zero; captures, replays and
    refresh times printed.  The kernel launches and graph replays are
    counted around the service's own calls alone (the open loop and its
    mutations).  Starts with the forced capture-during-add case."""
    import numpy as np

    from repro_torch.core import packed as packed_mod
    from repro_torch.core.segments import IndexWriter
    from repro_torch.launch import serve as launch
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    cache = packed_mod.EXEC_CACHE
    cache.clear()
    n = x.shape[0]
    n0 = int(n * 0.9)
    tail = x[n0:].cpu().numpy()
    w = IndexWriter(cfg, device=dev)
    w.add(x[:n0])
    scfg = AnnServiceConfig(k=k, depth=depth, rerank=True, max_batch=64, max_wait_s=0.002,
                            queue_depth=256, cache_size=64, latency_window=1 << 17)
    svc, first_s = _sync_s(lambda: AnnService(writer=w, service=scfg))
    tagged = _SnapshotTaggedCache(svc)
    svc._cache = tagged
    rng = np.random.default_rng(13)
    forced = _capture_during_add(dev, svc, w, tail[:32], rng.choice(n0, 4, replace=False),
                                 pool_q[:3])
    plain = AnnService(svc.ann, dataclasses.replace(scfg, cache_size=0))
    ptr = [32]
    refresh_ms, visible_ms = [], []
    stats0 = dict(cache.stats())

    def mutate():
        w.delete(rng.choice(n0 + ptr[0], size=4, replace=False))  # rows added before
        new = tail[ptr[0]:ptr[0] + 32]
        w.add(new)
        ptr[0] += 32
        _, took = _sync_s(svc.refresh)
        (_, got), first = _sync_s(lambda: svc.search_batch(new[:8]))  # packs, may capture
        # the newest live rows, in global ids (a merge may have remapped add's ids)
        if not np.array_equal(got[:, 0], svc.ann.live_global_ids()[-32:][:8]):
            raise AssertionError(f"NRT {label}: added rows not visible after refresh")
        refresh_ms.append(took * 1e3)
        visible_ms.append((took + first) * 1e3)
        svc.search_batch(pool_q[:64])
        hits0 = svc.cache_hits
        hit = svc.search_batch(pool_q[:64])  # same snapshot: a hit
        plain.set_index(svc.ann)
        fresh = plain.search_batch(pool_q[:64])
        if svc.cache_hits != hits0 + 1 or not all(
                np.array_equal(a, b) for a, b in zip(hit, fresh)):
            raise AssertionError(f"NRT {label}: after refresh {len(refresh_ms)} the cached "
                                 f"batch differs from an uncached search of the same snapshot")

    sample = launch.zipf_sampler(rng, len(pool_q), SERVE_ZIPF)
    svc.reset_latency()

    def run():
        svc.start_async()
        out = launch.open_loop(svc, pool_q, sample, 1000.0, NRT_SECONDS, NRT_EVERY, mutate)
        svc.stop_async()
        return out

    (futs, sent, shed, elapsed, lag), launches, replays = _service_only(run)
    fused = _served(f"NRT {label}", "fused_topk", launches, replays)
    for f in futs:
        s, i = f.result()
        if s.shape != (1, k) or not np.isfinite(s).all() or not ((i >= 0).all()):
            raise AssertionError(f"NRT {label}: a bad result row")
    st = svc.stats()
    hit = svc.search_batch(pool_q[:64])
    plain.set_index(svc.ann)
    fresh = plain.search_batch(pool_q[:64])
    if not all(np.array_equal(a, b) for a, b in zip(hit, fresh)):
        raise AssertionError(f"NRT {label}: a cached result differs from a fresh search")
    loop = svc.ann.search(pool_q[:64], k=k, depth=depth, rerank=True, packed=False)
    compare(f"NRT {label}: the served snapshot vs the loop", _np_pair(fresh), loop, exact=False)
    if tagged.stale or tagged.hits < len(refresh_ms):
        raise AssertionError(f"NRT {label}: {tagged.stale} stale hits of {tagged.hits}")
    cs = cache.stats()
    pk = svc.ann.packed_segments()
    r50, r99 = _host_p(np.asarray(refresh_ms) / 1e3)
    v50, v99 = _host_p(np.asarray(visible_ms) / 1e3)
    print(f"serve NRT {label} ({n0} rows in the first add, its build {first_s:.1f} s; 1,000 QPS "
          f"for {NRT_SECONDS:.0f} s, every {NRT_EVERY} requests 32 rows added, 4 deleted, "
          f"refresh; {card}): {forced}; then {len(refresh_ms)} refresh cycles (host clock, "
          f"synchronised): refresh (flush + snapshot) p50 / p99 / max {r50:.1f} / {r99:.1f} / "
          f"{max(refresh_ms):.1f} ms, to visibility (the refresh and the first search, which "
          f"packs and may capture) {v50:.1f} / {v99:.1f} / {max(visible_ms):.1f} ms; added rows "
          f"found at rank 1 after every refresh; "
          f"captures {cs['compiles'] - stats0['compiles']} against replays "
          f"{cs['hits'] - stats0['hits']} in the loop ({cs}; in-place appends "
          f"{pk.appends if pk is not None else 0}, {svc.ann.num_segments} segments); cache "
          f"hits {tagged.hits}, stale hits {tagged.stale} (an entry tagged with another "
          f"snapshot object than the bound one); after every refresh the cached batch equals "
          f"an uncached search of the same snapshot bit for bit, and at the end the loop by "
          f"the near-tie rule; sent {sent}, shed {shed} (the "
          f"submitting thread at most {lag * 1e3:.1f} ms behind its schedule), sustained "
          f"{len(futs) / elapsed:.1f} QPS, request p50 / p99 {st['req_p50_ms']:.3f} / "
          f"{st['req_p99_ms']:.3f} ms; in the service's calls of the loop fused_topk "
          f"launches {fused} outside graph replays and {replays} graph replays ({launches})")
    tagged.svc = None  # the cache and the service refer to each other
    del svc, plain, w, tagged
    cache.clear()
    gc.collect()
    torch.cuda.empty_cache()


def capture_mode_trial(dev, mode: str) -> dict:
    """One CUDA-graph capture in ``capture_error_mode=mode``, held open on
    this thread while another thread copies 20,000 pageable host rows of
    300 to the card (what ``IndexWriter.add`` does) and allocates a fresh
    1 GiB; returns what each side saw: the other thread's stream capturing
    or not, its error or whether its rows arrived, the capture's error or
    whether its replay is right.  Run it in a process of its own: a failed
    global-mode capture can leave the process's CUDA state unusable."""
    import threading

    import numpy as np

    x = torch.randn(4096, 256, device=dev)
    torch.cuda.synchronize()
    started, done = threading.Event(), threading.Event()
    res = {"mode": mode}

    def other():
        started.wait(60)
        try:
            res["other_capturing"] = torch.cuda.is_current_stream_capturing()
            rows = np.random.default_rng(0).standard_normal((20000, 300)).astype(np.float32)
            t = torch.as_tensor(rows, device=dev)
            big = torch.ones((1 << 28,), device=dev)
            res["other_ok"] = bool(np.array_equal(t[:5].cpu().numpy(), rows[:5])) and float(
                big.sum().item()) == float(1 << 28)
        except RuntimeError as e:  # recorded: the finding
            res["other_error"] = str(e).splitlines()[0]
        done.set()

    worker = threading.Thread(target=other)
    worker.start()
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
    try:
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            y = (x @ x.T).sum(1)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.cuda.graph(graph, stream=side, capture_error_mode=mode):
            y = (x @ x.T).sum(1)
            started.set()
            done.wait(60)
            y = y * 2
        graph.replay()
        torch.cuda.synchronize()
        res["capture_ok"] = bool(torch.allclose(y, (x @ x.T).sum(1) * 2))
    except RuntimeError as e:
        res["capture_error"] = str(e).splitlines()[0]
    started.set()
    worker.join(120)
    return res


def drive_serve(dev, card: str, x, idx, config, depth: int, k: int) -> None:
    """The serving layer at full N over the classic fp32 index ``idx`` (the
    ann-word2vec cell's, exact rerank): the sync service at max_batch 1, 8,
    64 and 256 against ``AnnIndex.search`` with per-batch times beside the
    facade's, the cache-hit time, the async micro-batcher's open loop at two
    offered rates (search only), then NRT serving over full-N writers for
    LSH (an in-place append a refresh) and classic (a repack and a capture
    a refresh), each starting with a capture forced to run during an add."""
    import numpy as np

    from repro_torch.core import bruteforce
    from repro_torch.core.types import LexicalLshConfig

    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    n = x.shape[0]
    picks = np.random.default_rng(1).choice(n, size=SERVE_QUERIES, replace=False)
    qs_dev = x[torch.from_numpy(picks).to(dev)]
    qs = qs_dev.cpu().numpy()
    _, gt = bruteforce.exact_topk(idx.index.vectors, bruteforce.l2_normalize(qs_dev), k,
                                  normalized=True)
    gt = gt.cpu()
    p50s, _ = _serve_sync(idx, qs, qs_dev, gt, depth, k, card)
    _serve_cache(idx, qs, depth, k, card, p50s[64])
    pool_q = qs[:SERVE_POOL]
    _serve_async(idx, pool_q, depth, k, card, p50s[64])
    for label, cfg in (("lsh", LexicalLshConfig(buckets=300, hashes=1)), ("classic", config)):
        _serve_nrt(dev, card, label, cfg, x, pool_q, depth, k)
    del qs_dev, gt
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    if left > 2e9:  # a writer or an index left alive holds 3.6 GB or more
        raise AssertionError(f"serve phase: {left / 1e9:.3f} GB still allocated after it")
    print(f"serve phase: {time.perf_counter() - t_phase:.1f} s (host clock, {card}); device "
          f"memory allocated after it {left / 1e6:.1f} MB above before it")


def serve_prebuilt(card: str, label: str, ann, qx, depth: int, k: int, kernel: str) -> None:
    """A few batches of an index an earlier phase built (the kd scan, the
    graph) through the sync and the async service: ids and scores equal
    the facade's on the same rows (near-tie rule), and ``kernel`` carried
    the searches.  The facade's reference runs first and its traversal
    graphs are dropped, so the launches counted around the service's own
    calls are its captures (and its other launches), and its graph
    replays are counted beside them."""
    import numpy as np

    from repro_torch.core import graph
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    t0 = time.perf_counter()
    q = qx[:64]
    q_np = q.cpu().numpy()
    want = ann.search(q, k=k, depth=depth, rerank=True)
    graph.TRAVERSAL_CACHE.clear()
    svcs = {mb: AnnService(ann, AnnServiceConfig(k=k, depth=depth, rerank=True, max_batch=mb,
                                                 max_wait_s=0.002)) for mb in (64, 8)}

    def served():
        out = {}
        for mb, svc in svcs.items():
            svc.search_batch(q_np)  # a shape's first search captures (the graph)
            svc.reset_latency()  # the batch p50 below is of the searches after it
            got = svc.search_batch(q_np)
            svc.start_async()
            res = [f.result(timeout=300) for f in [svc.search_async(row) for row in q_np]]
            svc.stop_async()
            out[mb] = got, res
        return out

    out, counts, replays = _service_only(served)
    launches = _served(f"serve {label}", kernel, counts)
    lines = []
    for mb, (got, res) in out.items():
        err = compare(f"serve {label} max_batch={mb} vs AnnIndex.search", _np_pair(got), want,
                      exact=False)
        aerr = compare(f"serve {label} async max_batch={mb} vs AnnIndex.search", _np_pair(
            (np.concatenate([r[0] for r in res]), np.concatenate([r[1] for r in res]))), want,
            exact=False)
        st = svcs[mb].stats()
        lines.append(f"max_batch {mb}: sync within {err:.3g}, async within {aerr:.3g} "
                     f"({st['async_launches']} launches for {len(q_np)} requests), batch p50 "
                     f"{st['lat_p50_ms']:.3f} ms")
    print(f"serve {label} ({len(q_np)} queries through the sync and the async service, ids "
          f"equal to AnnIndex.search by the near-tie rule; in the service's calls {kernel} "
          f"launches {launches} outside graph replays and {replays} graph replays; "
          f"{time.perf_counter() - t0:.1f} s, {card}): " + "; ".join(lines))


# --------------------------------------------------------------------------
# The sharded build and search (core/distributed.py): a single-process mesh
# --------------------------------------------------------------------------

SHARDS = 4  # 4 x cuda:0 on one card: 749,952 rows a shard at full N
SHARD_BATCHES = (1, 8, 256)
SHARD_GRAPH_ROWS = 100_000  # the full-N graph build takes 134.6 s (PERF.md §5)
SHARD_SEGMENTS = 4
SHARD_QPS, SHARD_SECONDS = 1000.0, 5.0
KD_SHARD_TOL = 1e-4  # the reference test's atol on sign-aligned reduced rows


def _leaf_tensors(name: str, leaf):
    if isinstance(leaf, torch.Tensor):
        return [(name, leaf)]
    return [(f"{name}.{f.name}", getattr(leaf, f.name)) for f in dataclasses.fields(leaf)
            if isinstance(getattr(leaf, f.name), torch.Tensor)]


def _shards_equal_mono(label: str, sharded, mono) -> list:
    """Raises unless every leaf of every shard equals its rows of the
    monolithic index's (doc leaves) or the whole leaf (replicated), bit for
    bit, without gathering.  Returns the leaf names held."""
    from repro_torch.core import distributed

    held = []
    split = distributed.shard_index(sharded.mesh, mono, sharded.axes)  # views of mono's rows
    for leaf in distributed.index_pspec(mono):
        for s, (shard, want) in enumerate(zip(sharded.shards, split.shards)):
            for (name, g), (_, w) in zip(_leaf_tensors(leaf, getattr(shard, leaf)),
                                         _leaf_tensors(leaf, getattr(want, leaf))):
                if not torch.equal(g, w):
                    raise AssertionError(f"sharded {label}: shard {s}'s {name} differs from "
                                         "the monolithic build's")
                if s == 0:
                    held.append(name)
    return held


def _sharded_window(kernel: str, fn, expected: int):
    """(fn(), launches): the wrappers' counts set to 0 just before ``fn``
    and read just after; raises unless ``kernel`` alone launched, and
    ``expected`` times."""
    _reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = _launches()
    if counts[kernel] != expected or any(v for key, v in counts.items() if key != kernel):
        raise AssertionError(f"sharded search did not launch {kernel} {expected} times alone: "
                             f"{counts}")
    return out, counts[kernel]


def _sharded_search_line(label: str, mono, sh, qx, k: int, depth: int, kernel: str,
                         exact: bool, card: str) -> str:
    """Match only at B = 1, 8, 256: the sharded search against the
    monolithic one (``exact``: bit for bit, else the near-tie rule), its
    launches counted, and both times (CUDA events)."""
    parts = []
    for bb in SHARD_BATCHES:
        q = qx[:bb]
        want = mono.search(q, k=k, depth=depth)
        got, launches = _sharded_window(kernel, lambda: sh.search(q, k=k, depth=depth), SHARDS)
        _checked(f"sharded {label} B={bb}", *got, q.shape[0], k, mono.num_docs)
        err = compare(f"sharded {label} match only B={bb} vs monolithic", got, want, exact)
        bits = torch.equal(got[0].cpu(), want[0].cpu()) and torch.equal(got[1].cpu(),
                                                                        want[1].cpu())
        t_mono = cuda_ms(lambda: mono.search(q, k=k, depth=depth))
        t_sh = cuda_ms(lambda: sh.search(q, k=k, depth=depth))
        parts.append(f"B={bb}: {'bit-equal' if bits else f'within {err:.3g}'}, {launches} "
                     f"{kernel} launches, {t_sh:.3f} ms sharded / {t_mono:.3f} monolithic")
    return f"sharded {label} ({SHARDS} shards; {card}): " + "; ".join(parts)


def _plain_merge(sh, q, k: int, depth: int):
    """The sharded reranked search done by hand: each shard's own facade
    search (its match and exact rerank over its rows), ids moved to global
    ones, and one stable descending sort of the concatenation."""
    from repro_torch.core.index import AnnIndex

    parts_s, parts_i = [], []
    for s, shard in enumerate(sh.index.shards):
        ss, ii = AnnIndex(config=sh.config, index=shard).search(q, k=k, depth=depth, rerank=True)
        parts_s.append(ss.to(q.device))
        parts_i.append(torch.where(ii >= 0, ii + s * sh.index.n_local, -1).to(q.device))
    all_s, all_i = torch.cat(parts_s, 1), torch.cat(parts_i, 1)
    order = torch.sort(all_s, dim=1, descending=True, stable=True).indices[:, :k]
    return all_s.gather(1, order), all_i.gather(1, order)


def _sharded_classic(dev, card: str, mesh, x, qx, gt_i, depth: int, k: int, config,
                     masks: dict) -> None:
    """The classic fp32 index with the exact store, built both ways: leaves,
    match only, the rerank against a plain merge and its recall, blockmax
    at 10% of each shard's blocks, filtered at 1% and 10%, and the sync and
    async service over the mesh."""
    import numpy as np

    from repro_torch.core import blockmax, bruteforce, distributed
    from repro_torch.core import eval as ev
    from repro_torch.core import pipeline as pl
    from repro_torch.core.index import AnnIndex
    from repro_torch.kernels.fused_topk import ref

    axes = ("data",)
    mono, build_mono = _sync_s(lambda: AnnIndex.build(x, config, device=dev))
    sh, build_sh = _sync_s(lambda: AnnIndex.build(x, config, mesh=mesh, shard_axes=axes))
    held = _shards_equal_mono("classic", sh.index, mono.index)
    print(f"sharded build classic fp32 + exact store: {SHARDS} shards x {sh.index.n_local} rows "
          f"in {build_sh:.2f} s, monolithic {build_mono:.2f} s (host clock, synchronised; "
          f"{card}); leaves bit-equal shard by shard: {', '.join(held)}; index "
          f"{sh.nbytes() / 1e9:.2f} GB (monolithic {mono.nbytes() / 1e9:.2f})")
    print(_sharded_search_line("classic", mono, sh, qx, k, depth, "fused_topk", True, card))
    # Where the fan-out's time goes at B = 256: the shards' kernels one
    # after another on the stream, and the merge.
    profile_search(sh, qx, k, depth, card, label=f"sharded classic ({SHARDS} shards)")
    profile_search(mono, qx, k, depth, card, label="monolithic classic")

    # The rerank: S x depth candidates, each shard's own rows.
    lines = []
    for bb in SHARD_BATCHES:
        q = qx[:bb]
        got, launches = _sharded_window(
            "fused_topk", lambda: sh.search(q, k=k, depth=depth, rerank=True), SHARDS)
        err = compare(f"sharded classic rerank B={bb} vs the plain merge", got,
                      _plain_merge(sh, q, k, depth), exact=False)
        t_mono = cuda_ms(lambda: mono.search(q, k=k, depth=depth, rerank=True))
        t_sh = cuda_ms(lambda: sh.search(q, k=k, depth=depth, rerank=True))
        lines.append(f"B={bb}: within {err:.3g} of the plain merge, {t_sh:.3f} ms sharded / "
                     f"{t_mono:.3f} monolithic")
    r_sh = float(ev.recall_at(gt_i, sh.search(qx, k=k, depth=depth, rerank=True)[1]))
    r_mono = float(ev.recall_at(gt_i, mono.search(qx, k=k, depth=depth, rerank=True)[1]))
    if r_sh < r_mono:
        raise AssertionError(f"sharded rerank R@10 {r_sh} below the monolithic {r_mono}")
    print(f"sharded classic rerank ({SHARDS} x {depth} candidates against {depth}; {card}): "
          f"R@10 {r_sh:.4f} sharded, {r_mono:.4f} monolithic; " + "; ".join(lines))

    # Blockmax: each shard keeps 10% of its own blocks.
    n_blocks_local = -(-sh.index.n_local // BLOCK)
    keep = int(KEEP_FRACTIONS[0] * n_blocks_local)
    bm_sh, bm_s = _sync_s(lambda: distributed.build_blockmax_sharded(mesh, sh.index, axes,
                                                                      BLOCK))
    mono_keep = int(KEEP_FRACTIONS[0] * (-(-mono.num_docs // BLOCK)))
    mono_bm = AnnIndex(config=config, index=mono.index, blockmax_keep=mono_keep,
                       blockmax_block_size=BLOCK)
    sh_bm = AnnIndex(config=config, index=sh.index, blockmax_keep=keep,
                     blockmax_block_size=BLOCK, bm=bm_sh)
    qn = bruteforce.l2_normalize(qx)
    q_tf = sh.encode_queries(qx)
    lines = []
    for bb in SHARD_BATCHES:
        q = qx[:bb]
        (s, i), launches = _sharded_window("fused_topk_gathered",
                                           lambda: sh_bm.search(q, k=depth, depth=depth),
                                           SHARDS)
        _checked(f"sharded blockmax B={bb}", s, i, q.shape[0], depth, mono.num_docs)
        t_sh = cuda_ms(lambda: sh_bm.search(q, k=depth, depth=depth))
        t_mono = cuda_ms(lambda: mono_bm.search(q, k=depth, depth=depth))
        lines.append(f"B={bb}: {launches} K3 launches, {t_sh:.3f} ms sharded / {t_mono:.3f} "
                     f"monolithic (n_keep {mono_keep})")
    s, i = sh_bm.search(qx, k=depth, depth=depth)
    r_bm = float(ev.recall_at(gt_i, i))
    r_mono_bm = float(ev.recall_at(gt_i, mono_bm.search(qx, k=depth, depth=depth)[1]))
    # Shard 0's K3 call against the plain version, first 8 queries.
    shard0, bm0 = sh.index.shards[0], bm_sh.shards[0]
    rows = blockmax.kept_rows(bm0, q_tf[:8], keep)
    got0 = pl.BlockMaxMatcher(keep, bm0)(shard0, q_tf[:8], depth)
    err0 = compare("sharded blockmax shard 0 K3, first 8 queries", got0,
                   ref.gathered_topk_ref(q_tf[:8].to(torch.bfloat16),
                                         ref.gather_rows(shard0.scored, rows, shard0.num_docs),
                                         rows, depth + 1, shard0.num_docs), exact=False)
    print(f"sharded blockmax classic (n_keep {keep} of each shard's {n_blocks_local} blocks, "
          f"{SHARDS} x {keep * BLOCK} rows a query; bounds built in {bm_s:.2f} s; {card}): "
          f"R@(10,100) {r_bm:.4f} sharded, {r_mono_bm:.4f} monolithic at n_keep {mono_keep}; "
          f"shard 0's K3 vs plain max_abs_err {err0:.3g}; " + "; ".join(lines))
    del mono_bm, sh_bm, bm_sh

    # Filtered, match only: the (N,) bitmap split with the rows.
    lines = []
    for key in ("1%", "10%"):
        mask = masks[key]
        for bb in (SHARD_BATCHES[-1], 8):
            q = qx[:bb]
            want = mono.search(q, k=k, depth=depth, filt=mask)
            got, launches = _sharded_window(
                "fused_topk", lambda: sh.search(q, k=k, depth=depth, filt=mask), SHARDS)
            compare(f"sharded filtered {key} B={bb} vs monolithic", got, want, exact=True)
            _kept(f"sharded filtered {key}", got[1], mask, mono.num_docs)
            lines.append(f"{key} B={bb}: bit-equal, {launches} launches, "
                         f"{cuda_ms(lambda: sh.search(q, k=k, depth=depth, filt=mask)):.3f} ms "
                         f"sharded / "
                         f"{cuda_ms(lambda: mono.search(q, k=k, depth=depth, filt=mask)):.3f} "
                         "monolithic")
    print(f"sharded filtered classic (match only; {card}): " + "; ".join(lines))
    del mono
    torch.cuda.empty_cache()
    _sharded_serving(card, mesh, sh, qx, qn, depth, k)


def _sharded_serving(card: str, mesh, sh, qx, qn, depth: int, k: int) -> None:
    """AnnService(mesh=) over the sharded classic index: sync at max_batch
    64 against make_sharded_search on the same rows (bit for bit), then
    the async micro-batcher in an open loop at SHARD_QPS for
    SHARD_SECONDS."""
    import numpy as np

    from repro_torch.core import distributed
    from repro_torch.launch import serve as launch
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    qs = qx.cpu().numpy()
    svc = AnnService(sh, AnnServiceConfig(k=k, depth=depth, rerank=True, max_batch=64,
                                          max_wait_s=0.002, queue_depth=256,
                                          latency_window=1 << 16), mesh=mesh)
    fn = distributed.make_sharded_search(mesh, sh.config, ("data",), k=k, depth=depth,
                                         rerank=True)
    got, counts, _ = _service_only(lambda: svc.search_batch(qs))
    sync_launches = _served("sharded serve sync", "fused_topk", counts)
    for i in range(0, len(qs), 64):
        want = fn(sh.index, sh.encode_queries(qx[i:i + 64]), qn[i:i + 64])
        compare(f"sharded service rows {i}..{i + 63} vs make_sharded_search",
                _np_pair((got[0][i:i + 64], got[1][i:i + 64])), want, exact=True)
    st = svc.stats()
    rng = np.random.default_rng(13)
    sample = launch.zipf_sampler(rng, len(qs), SERVE_ZIPF)
    svc.reset_latency()

    def run():
        svc.start_async()
        out = launch.open_loop(svc, qs, sample, SHARD_QPS, SHARD_SECONDS)
        svc.stop_async()
        return out

    (futs, sent, shed, elapsed, lag), counts, _ = _service_only(run)
    async_launches = _served("sharded serve async", "fused_topk", counts)
    if not all(f.done() and f.exception() is None for f in futs) or sent != len(futs):
        raise AssertionError("sharded serve async: a request did not resolve")
    ast = svc.stats()
    print(f"sharded serve (AnnService(mesh=), classic fp32 + exact rerank, {SHARDS} shards; "
          f"{card}): sync max_batch 64 over {len(qs)} queries bit-equal to make_sharded_search "
          f"on the same rows, batch p50 / p99 {st['lat_p50_ms']:.3f} / {st['lat_p99_ms']:.3f} "
          f"ms (host clock), {sync_launches} fused_topk launches; async at {SHARD_QPS:.0f} QPS "
          f"for {SHARD_SECONDS:.0f} s: sent {sent}, shed {shed}, every future resolved, "
          f"sustained {len(futs) / elapsed:.1f} QPS, request p50 / p99 {ast['req_p50_ms']:.3f} "
          f"/ {ast['req_p99_ms']:.3f} ms, {ast['async_launches']} launches "
          f"({len(futs) / max(1, ast['async_launches']):.1f} queries a launch), "
          f"{async_launches} fused_topk launches, the submitter at most {lag * 1e3:.1f} ms "
          "behind")


def _sharded_kd(dev, card: str, mesh, x, qx, gt_i, depth: int, k: int) -> None:
    """The kd scan "pca" built both ways: the reduced rows sign-aligned
    within KD_SHARD_TOL (the fit sums its moments over the shards), the
    other leaves bit for bit; the sharded search over the monolithic
    build's rows split equals the monolithic search bit for bit (f32 at T
    = 9); R@(10,100) of each build."""
    import numpy as np

    from repro_torch.core import distributed
    from repro_torch.core import eval as ev
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import KdTreeConfig

    cfg = KdTreeConfig(dims=8, backend="scan")
    mono, build_mono = _sync_s(lambda: AnnIndex.build(x, cfg, rerank_store="none", device=dev))
    sh, build_sh = _sync_s(lambda: AnnIndex.build(x, cfg, rerank_store="none", mesh=mesh))
    split = AnnIndex(config=cfg, index=distributed.shard_index(mesh, mono.index, ("data",)))
    worst = 0.0
    for mine, want in zip(sh.index.shards, split.index.shards):
        a, b = want.reduced, mine.reduced
        sign = torch.sign((a * b).sum(0))
        sign[sign == 0] = 1.0
        worst = max(worst, float((a - b * sign).abs().max()))
    if not worst <= KD_SHARD_TOL:
        raise AssertionError(f"sharded kd reduced rows differ by {worst} > {KD_SHARD_TOL}")
    parts = []
    for bb in SHARD_BATCHES:
        q = qx[:bb]
        got, launches = _sharded_window("fused_topk", lambda: split.search(q, k=k, depth=depth),
                                        SHARDS)
        err = compare(f"sharded kd scan B={bb} vs monolithic", got,
                      mono.search(q, k=k, depth=depth), exact=False)
        parts.append(f"B={bb}: within {err:.3g}, {launches} launches, "
                     f"{cuda_ms(lambda: split.search(q, k=k, depth=depth)):.3f} ms sharded / "
                     f"{cuda_ms(lambda: mono.search(q, k=k, depth=depth)):.3f} monolithic")
    r_sh = float(ev.recall_at(gt_i, sh.search(qx, k=depth, depth=depth)[1]))
    r_mono = float(ev.recall_at(gt_i, mono.search(qx, k=depth, depth=depth)[1]))
    print(f"sharded kd scan pca: build {build_sh:.2f} s, monolithic {build_mono:.2f} s; reduced "
          f"rows sign-aligned within {worst:.3g} (rule {KD_SHARD_TOL}); R@(10,100) {r_sh:.4f} "
          f"sharded build, {r_mono:.4f} monolithic; the monolithic rows split: "
          + "; ".join(parts) + f" ({card})")


def _sharded_packed(dev, card: str, mesh, x, qx, depth: int, k: int, config) -> None:
    """make_packed_segmented_search over a SHARD_SEGMENTS-segment writer of
    the corpus.  Match only: bit-equal to the reader's loop (the merge of
    each segment's top-depth) and to its packed single launch.  With rerank
    (``test_packed.py:286``): overlap >= 0.95 with the loop, and the ids
    both return with close scores (the shards' S x depth candidates are
    not the segments', so an id one path finds and the other misses shifts
    the ranks behind it); one K1 launch a shard."""
    from repro_torch.core import bruteforce, distributed
    from repro_torch.core import eval as ev
    from repro_torch.core.segments import IndexWriter

    n = x.shape[0]
    w = IndexWriter(config, merge_policy=None, device=dev)
    for part in x.chunk(SHARD_SEGMENTS):
        w.add(part)
        w.flush()
    reader = w.refresh()
    (fn, idx_sh, filt_sh), pack_s = _sync_s(lambda: distributed.make_packed_segmented_search(
        mesh, reader, ("data",), k=k, depth=depth, rerank=True))
    qn = bruteforce.l2_normalize(qx)
    q_rep = reader.encode_queries(qx)
    match_fn, _, _ = distributed.make_packed_segmented_search(mesh, reader, ("data",), k=k,
                                                              depth=depth)
    got = match_fn(idx_sh, q_rep, None, filt_sh)
    compare("sharded packed match only vs the loop", got,
            reader.search(qx, k=k, depth=depth, packed=False), exact=True)
    compare("sharded packed match only vs the packed launch", got,
            reader.search(qx, k=k, depth=depth, packed=True), exact=True)
    (s_sh, i_sh), launches = _sharded_window("fused_topk",
                                             lambda: fn(idx_sh, q_rep, qn, filt_sh), SHARDS)
    s_1, i_1 = reader.search(qx, k=k, depth=depth, rerank=True, packed=False)
    ov = float(ev.overlap(i_1, i_sh))
    both = (i_sh[:, :, None] == i_1[:, None, :]) & (i_sh[:, :, None] >= 0)
    s_loop = torch.where(both, s_1[:, None, :], 0.0).sum(2)  # the loop's score of each id
    common = both.any(2)
    close = torch.allclose(s_sh[common], s_loop[common], rtol=1e-4, atol=1e-5)
    if ov < 0.95 or not close:
        raise AssertionError(f"sharded packed: overlap {ov} with the loop, the common ids' "
                             f"scores close {close}")
    t_sh = cuda_ms(lambda: fn(idx_sh, q_rep, qn, filt_sh))
    t_loop = cuda_ms(lambda: reader.search(qx, k=k, depth=depth, rerank=True, packed=False))
    print(f"sharded packed segments ({SHARD_SEGMENTS} segments of {n // SHARD_SEGMENTS} rows, "
          f"bucket {idx_sh.num_docs}, {SHARDS} shards; pack + split {pack_s:.2f} s): match "
          f"only bit-equal to the loop and the packed launch; with rerank overlap {ov:.4f} with "
          f"the loop, the {int(common.sum())} common ids' scores within rtol 1e-4; {launches} "
          "fused_topk "
          f"launches; B={qx.shape[0]} with rerank {t_sh:.3f} ms sharded / {t_loop:.3f} the "
          f"loop ({card})")


def _sharded_graph(dev, card: str, mesh, x) -> None:
    """build_sharded with GraphConfig() over SHARD_GRAPH_ROWS rows: the ring
    build's adjacency and entry points equal build_graph's on the same
    rows."""
    from repro_torch.core import bruteforce, distributed, graph
    from repro_torch.core.types import GraphConfig

    rows = x[:SHARD_GRAPH_ROWS]
    cfg = GraphConfig()
    (nb, entry), mono_s = _sync_s(lambda: graph.build_graph(bruteforce.l2_normalize(rows), cfg))
    _reset_launches()
    sh, sh_s = _sync_s(lambda: distributed.build_sharded(mesh, rows, cfg, ("data",)))
    launches = _launches()["fused_topk"]
    n_local = sh.n_local
    for s, shard in enumerate(sh.shards):
        if not torch.equal(shard.neighbors, nb[s * n_local:(s + 1) * n_local]):
            raise AssertionError(f"sharded graph: shard {s}'s adjacency differs from build_graph's")
        if not torch.equal(shard.entry, entry):
            raise AssertionError(f"sharded graph: shard {s}'s entry points differ")
    print(f"sharded graph build ({SHARD_GRAPH_ROWS} rows, {SHARDS} shards, ring of {SHARDS} "
          f"pool steps on K1 f32, {launches} fused_topk launches): adjacency and entry points "
          f"equal build_graph's; {sh_s:.2f} s sharded, {mono_s:.2f} s build_graph (host "
          f"clock, synchronised; {card})")


def _sharded_quantized(dev, card: str, mesh, x, qx, depth: int, k: int, config) -> None:
    """dot, LSH (b = 300, h = 1) and classic over int8 / int4 postings with
    the int8 rerank store, built both ways: leaves bit for bit, match only
    bit for bit at B = 1, 8, 256, times beside the monolithic ones."""
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import LexicalLshConfig

    dot = dataclasses.replace(config, scoring="dot")
    for label, cfg, knobs, kernel, exact in (
            ("dot", dot, dict(rerank_store="none"), "fused_topk", True),
            ("lsh (300, 1)", LexicalLshConfig(buckets=300, hashes=1), dict(rerank_store="none"),
             "fused_topk", True),
            ("classic int8 + int8 store", config,
             dict(primary_postings="int8", rerank_store="int8"), "fused_topk_quantized", True),
            ("classic int4 + int8 store", config,
             dict(primary_postings="int4", rerank_store="int8"), "fused_topk_quantized", True)):
        mono, build_mono = _sync_s(lambda: AnnIndex.build(x, cfg, device=dev, **knobs))
        sh, build_sh = _sync_s(lambda: AnnIndex.build(x, cfg, mesh=mesh, **knobs))
        held = _shards_equal_mono(label, sh.index, mono.index)
        print(f"sharded build {label}: {build_sh:.2f} s, monolithic {build_mono:.2f} s; leaves "
              f"bit-equal shard by shard: {', '.join(held)} ({card})")
        print(_sharded_search_line(label, mono, sh, qx, k, depth, kernel, exact, card))
        del mono, sh
        torch.cuda.empty_cache()


def drive_sharded(dev, card: str, x, qx, gt_i, depth: int, k: int, config, masks: dict) -> None:
    """The sharded build and search at full N over a mesh of SHARDS shards
    from ``make_mesh(device="cuda")`` (round robin over the visible cards:
    4 x cuda:0 on one card): classic, dot, LSH, int8 / int4 postings and
    the kd scan built both ways and held leaf by leaf; match-only search
    equal to the monolithic one; the rerank against a plain merge and
    recall; blockmax, filtered, packed segments; the ring graph build at
    SHARD_GRAPH_ROWS; AnnService(mesh=); ``launch.serve --shards``.
    Frees what it builds."""
    from repro_torch.core import distributed
    from repro_torch.launch import serve as launch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh = distributed.make_mesh((SHARDS,), ("data",), device=dev.type)
    cards = sorted({str(d) for d in mesh.devices})
    print(f"sharded mesh: {SHARDS} shards over {', '.join(cards)} "
          f"({x.shape[0] // SHARDS} rows a shard; {card})")
    _sharded_classic(dev, card, mesh, x, qx, gt_i, depth, k, config, masks)
    gc.collect()
    torch.cuda.empty_cache()
    _sharded_quantized(dev, card, mesh, x, qx, depth, k, config)
    _sharded_kd(dev, card, mesh, x, qx, gt_i, depth, k)
    gc.collect()
    torch.cuda.empty_cache()
    _sharded_packed(dev, card, mesh, x, qx, depth, k, config)
    gc.collect()
    torch.cuda.empty_cache()
    _sharded_graph(dev, card, mesh, x)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    out = launch.main(["--shards", str(SHARDS), "--n-docs", str(x.shape[0]), "--device",
                       dev.type])
    print(f"launch.serve --shards {SHARDS} --n-docs {x.shape[0]}: R@10 {out['recall@k']}, batch "
          f"p50 / p99 {out['p50_ms_per_batch']} / {out['p99_ms_per_batch']} ms, index "
          f"{out['index_mb']} MB ({time.perf_counter() - t0:.1f} s with its corpus; {card})")
    if not out["recall@k"] > 0.9:
        raise AssertionError(f"launch.serve --shards: R@10 {out['recall@k']}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    if left > 2e9:
        raise AssertionError(f"sharded phase: {left / 1e9:.3f} GB still allocated after it")
    print(f"sharded phase: {time.perf_counter() - t_phase:.1f} s (host clock, {card}); peak "
          f"device memory {peak / 1e9:.1f} GB before the launcher; allocated after it "
          f"{left / 1e6:.1f} MB above before it")


LM_SEED = 36  # the LM phase's weights and prompts
LM_SLOTS = 8
LM_MAX_LEN = 4096
LM_REQUESTS = 16
LM_PROMPTS = (512, 3072)  # prompt lengths spread evenly over this range
LM_NEW = 32  # max_new_tokens of every request
LM_EOS = 0  # the Zipf ranks of data/lm.py start at 1: no prompt holds token 0
LM_CUT = (2, 256)  # hold (b): layers and sequence of the full-width cut
LM_CHECKED = 8  # hold (c) covers at least this many tokens of every request
LM_TOL = 2e-2  # bf16 logits, relative to their scale (tests/test_torch_transformer.py)


def _lm_prefill_qkv(params, cfg, tokens):
    """Layer 0's rotated q, k and its v for ``tokens`` (1, S), in K9's
    (B, H, S, D) layout: the operands the model's first prefill layer gives
    K9 (``transformer.attention``'s arithmetic)."""
    from repro_torch.models import transformer as tfm

    _, layer = next(tfm.iter_layers(params, cfg))
    h = tfm.rms_norm(tfm._embed(params, tokens, cfg), layer["ln1"], cfg.norm_eps)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    return [t.transpose(1, 2).contiguous() for t in tfm.qkv(h, layer, cfg, positions)]


def _lm_logits_gap(a, b) -> tuple:
    """(largest |a - b| over the largest |b|, error norm over b's norm)."""
    a, b = a.float().cpu(), b.float().cpu()
    return (float((a - b).abs().max() / b.abs().max()),
            float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)))


def drive_lm(dev, card: str, cfg=None) -> list:
    """The LM served through ``DecodeEngine`` at phi3-mini-3.8b's full width
    and depth (32 layers; ``cfg`` overrides for a rehearsal), weights drawn
    from LM_SEED by ``init_params`` on the card: LM_REQUESTS prompts from
    ``data/lm.py`` with lengths spread over LM_PROMPTS, through LM_SLOTS slots
    of LM_MAX_LEN, LM_NEW tokens each.  Holds (a) K9 on layer 0's own q, k, v
    (the longest prompt) against its plain version, (b) a LM_CUT cut of the
    model, same weights, card against the CPU route, (c) every request's
    tokens against a greedy recompute by ``prefill`` on the card, (d) 32 K9
    launches a prefill and no other kernel on the engine's run, (e) every
    request retired and every slot reused.  Prints the memory, the prefill
    and decode times, tokens a second and K9 against SDPA at the longest
    prefill.  Returns K9's kernels-line entry; frees what it builds."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.configs import phi3_mini_3_8b
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or phi3_mini_3_8b.make_model()
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, gen, device=dev)
    leaves = []
    tfm.tree_map(lambda _, v: leaves.append(v), params)
    n_params = sum(v.numel() for v in leaves)
    param_gb = sum(v.numel() * v.element_size() for v in leaves) / 1e9
    if n_params != cfg.param_count()[0]:
        raise AssertionError(f"{n_params} parameters, param_count {cfg.param_count()[0]}")
    torch.cuda.synchronize()
    print(f"LM {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params:,} "
          f"parameters, {param_gb:.2f} GB in {str(cfg.param_dtype)[6:]} (init_params on the card "
          f"{time.perf_counter() - t0:.1f} s; {card})")
    lengths = np.linspace(*LM_PROMPTS, LM_REQUESTS).round().astype(int)
    data = lm_data.LmDataConfig(vocab=cfg.vocab, seq_len=int(lengths.max()),
                                global_batch=LM_REQUESTS, seed=LM_SEED)
    toks = lm_data.batch_at(data, 0)["tokens"].numpy()
    prompts = [toks[i, :n] for i, n in enumerate(lengths)]
    if any((p == LM_EOS).any() for p in prompts):
        raise AssertionError("a prompt holds the eos token")

    # (a) K9 on the model's own q, k, v at layer 0 of the longest prompt
    longest = torch.from_numpy(prompts[-1].astype(np.int64))[None].to(dev)
    q, k, v = _lm_prefill_qkv(params, cfg, longest)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = fa_ref.attention_ref(q, k, v)
    err_a = compare_dense(f"LM layer 0 attention S={q.shape[2]}", got, want, exact=False,
                          tol=ATTN_TOL[q.dtype])
    print(f"  ok  (a) K9 on layer 0's own q, k, v (B=1, Hq={q.shape[1]}, Hkv={k.shape[1]}, "
          f"S={q.shape[2]}, D={q.shape[3]}, {str(q.dtype)[6:]}) against its plain version: "
          f"max_abs_err {err_a:.3g} (row rule {ATTN_TOL[q.dtype]})")
    del got, want

    # (b) a cut of the model at full width: the card against the CPU route
    n_cut, s_cut = LM_CUT
    cut_cfg = dc.replace(cfg, n_layers=n_cut)
    cut = {key: ({w: t[:n_cut] for w, t in val.items()} if isinstance(val, dict) else val)
           for key, val in params.items()}
    cut_toks = longest[:, :s_cut]
    _, on_card = tfm.prefill(cut, cut_toks, cut_cfg)
    cut_cpu = tfm.tree_map(lambda _, t: t.cpu(), cut)
    t0 = time.perf_counter()
    _, on_cpu = tfm.prefill(cut_cpu, cut_toks.cpu(), cut_cfg)
    cpu_s = time.perf_counter() - t0
    del cut, cut_cpu
    err_b, norm_b = _lm_logits_gap(on_card, on_cpu)
    print(f"  ok  (b) {n_cut} layers of {cfg.name} at S={s_cut}, last-position logits on the "
          f"card against the CPU route ({cpu_s:.1f} s): largest error {err_b:.4g} of the largest "
          f"logit ({float(on_cpu.abs().max()):.4g}), error norm {norm_b:.4g} of the norm "
          f"(tolerance {LM_TOL} / {2 * LM_TOL})")
    if not (norm_b <= LM_TOL and err_b <= 2 * LM_TOL):
        raise AssertionError(f"(b): the cut's logits differ by {err_b:.4g} / {norm_b:.4g}")
    # Hold (c)'s near-tie: the bf16 tolerance (b) holds the card to.  Two bf16
    # computations of the same logits (the engine's decode and a prefill, on
    # one route) differ by a step or two of the largest logit (~0.5% of it);
    # (b)'s measured error is no bound on that (it is 0 on one route).
    near_tie = LM_TOL

    # the main path: the engine serves every request
    class TimedEngine(DecodeEngine):
        """Times each prefill and decode step with CUDA events, and counts
        the K9 launches of each prefill."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.prefills, self.decodes = [], []

        def _prefill(self, prompt, slot):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            before = flash_attention.launches
            start.record()
            tok = super()._prefill(prompt, slot)
            end.record()
            self.prefills.append((len(prompt), slot, start, end,
                                  flash_attention.launches - before))
            return tok

        def _decode(self, tokens, active):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = super()._decode(tokens, active)
            end.record()
            self.decodes.append((int(active.sum()), start, end))
            return out

    engine = TimedEngine(params, cfg, EngineConfig(batch_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                                                   eos_id=LM_EOS), device=dev)
    cache_gb = sum(engine.cache[key].numel() * engine.cache[key].element_size()
                   for key in ("k", "v")) / 1e9
    reqs = [Request(uid=i, prompt=p, max_new_tokens=LM_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _launches()
    # (d) K9 carried every prefill layer, and nothing else launched
    per_prefill = [p[4] for p in engine.prefills]
    if (counts["flash_attention"] != cfg.n_layers * len(reqs)
            or any(n != cfg.n_layers for n in per_prefill)
            or any(n for name, n in counts.items() if name != "flash_attention")):
        raise AssertionError(f"(d): launches {counts}, a prefill's K9 launches {per_prefill}")
    # (e) every request retired through the slots, each slot reused
    slots = collections.Counter(p[1] for p in engine.prefills)
    if (sorted(r.uid for r in done) != list(range(len(reqs))) or not all(r.done for r in reqs)
            or len(slots) != LM_SLOTS or min(slots.values()) < 2):
        raise AssertionError(f"(e): retired {sorted(r.uid for r in done)}, slots {dict(slots)}")
    n_out = sum(len(r.out_tokens) for r in reqs)
    print(f"  ok  (d) {counts['flash_attention']} K9 launches on the engine's run, "
          f"{cfg.n_layers} a prefill, no other kernel; (e) {len(done)} requests retired "
          f"through {LM_SLOTS} slots (requests a slot {sorted(slots.values())}), "
          f"{engine.steps} steps")
    prefill_ms = [(p[0], p[2].elapsed_time(p[3])) for p in engine.prefills]
    full = [s.elapsed_time(e) for a, s, e in engine.decodes if a == LM_SLOTS]
    print(f"LM engine on {card}: parameters {param_gb:.2f} GB, cache {cache_gb:.2f} GB "
          f"({LM_SLOTS} x {LM_MAX_LEN} positions); prefill ms at each prompt length: "
          + ", ".join(f"{n}: {ms:.2f}" for n, ms in prefill_ms)
          + f"; decode ms a step at {LM_SLOTS} active slots: median {statistics.median(full):.2f} "
          f"(min {min(full):.2f}, max {max(full):.2f}, {len(full)} steps); {n_out} tokens out in "
          f"{run_s:.2f} s: {n_out / run_s:.1f} tokens/s ({sum(lengths) + n_out} tokens through "
          f"the model: {(sum(lengths) + n_out) / run_s:.1f}/s)")
    # where a decode step's time goes: a trace of 2 steps at LM_SLOTS active
    ones = torch.ones(LM_SLOTS, dtype=torch.int64, device=dev)
    spans = _traced(lambda: engine._decode(ones, ones.bool()), 2)
    if spans:
        per = collections.Counter()
        for a, b, name in spans:
            per[name[:70]] += (b - a) / 1e3 / 2
        busy, wall = sum(per.values()), (spans[-1][1] - spans[0][0]) / 1e3 / 2
        print(f"LM decode step trace ({LM_SLOTS} active, 2 steps; {card}): {len(spans) // 2} "
              f"kernels a step, device busy {busy:.2f} of {wall:.2f} ms (idle "
              f"{1 - busy / wall:.1%}); most time: "
              + "; ".join(f"{name} {ms:.2f} ms" for name, ms in per.most_common(8)))
    else:
        print("LM decode step trace: torch.profiler recorded no device time")
    engine.cache = None
    del engine
    torch.cuda.empty_cache()

    # K9 at the engine's longest prefill beside SDPA (is_causal=True)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                    enable_gqa=True)

    ms, runs = timed(lambda: flash_attention(q, k, v))
    plain_ms, plain_runs = timed(lambda: fa_ref.attention_ref(q, k, v))
    lib_ms = timed(sdpa)[0]
    bound = attention_bound_ms(q, k, v, "bf16")
    print(f"flash_attention/phi3-mini-engine (the engine's prefill, B=1, Hq={q.shape[1]}, "
          f"Hkv={k.shape[1]}, S={q.shape[2]}, D={q.shape[3]}, bf16) on {card}: kernel {ms:.3f} ms "
          f"(median of {runs}), bound {bound[0]:.3f} ms ({bound[1]}); plain {plain_ms:.3f} ms "
          f"(median of {plain_runs}); scaled_dot_product_attention(is_causal=True), flash "
          f"backend {lib_ms:.3f} ms; launches on the engine's run {counts['flash_attention']}")
    entry = {"name": "flash_attention/phi3-mini-engine", "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:74",
             "launches": counts["flash_attention"], "max_abs_err": err_a, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": lib_ms}
    # (c) each request's tokens against a greedy recompute by prefill on the
    # card, on the engine's own prefix (the anchor's check up to the first
    # step where they part; past it the engine's token must be a near-tie of
    # the recompute's top).
    t0 = time.perf_counter()
    exact, parted = 0, []
    for r in reqs:
        n_check = min(len(r.out_tokens), LM_NEW)
        if n_check < min(LM_CHECKED, r.max_new_tokens):
            raise AssertionError(f"(c): request {r.uid} has {len(r.out_tokens)} tokens")
        seq = torch.from_numpy(np.concatenate([r.prompt, r.out_tokens]).astype(np.int64)).to(dev)
        for j in range(n_check):
            lg = tfm.prefill(params, seq[None, :len(r.prompt) + j], cfg)[1][0].float()
            top = int(torch.argmax(lg))
            if top == r.out_tokens[j]:
                exact += 1
                continue
            parted.append((r.uid, j, float((lg[top] - lg[r.out_tokens[j]]) / lg.abs().max())))
    gaps = sorted(g for _, _, g in parted)
    print(f"  (c) {exact + len(parted)} tokens of {len(reqs)} requests against a greedy "
          f"recompute by prefill on the card: {exact} equal, {len(parted)} parted (each must be a "
          f"near-tie within {near_tie:.4g} of the scale, (b)'s tolerance): gaps "
          f"{[round(g, 5) for g in gaps]} at (request, token) {[(u, j) for u, j, _ in parted]} "
          f"({time.perf_counter() - t0:.1f} s)")
    if gaps and gaps[-1] > near_tie:
        raise AssertionError(f"(c): {sum(g > near_tie for g in gaps)} tokens part from the "
                             f"recompute by more than {near_tie:.4g} of the scale")

    peak = torch.cuda.max_memory_allocated()
    del q, k, v, params, leaves, reqs, done
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    if left > 1e9:
        raise AssertionError(f"LM phase: {left / 1e9:.3f} GB still allocated after it")
    print(f"LM phase: {time.perf_counter() - t_phase:.1f} s (host clock, {card}); peak device "
          f"memory {peak / 1e9:.1f} GB (with the {held / 1e9:.1f} GB held before it)")
    return [entry]



TRAIN_SEED = 37  # the training phase's weights and batches
TRAIN_CUT = (2, 1, 256)  # hold (b): layers, batch and sequence of the full-width step
TRAIN_LAYERS = 8  # (c): 1.10e9 parameters, 17.6 GB of f32 state; 32 layers would take 61.1 GB
# (c): steps, checkpoint period, crash step.  10 steps, not a multiple of 6: run
# A saves at step 6 and at its end, run B at step 6 before its crash and at its
# end (the crash and resume took 113-133 s at 24 steps, and each 13.2 GB save
# costs 10-17 s of host copy and disk write)
TRAIN_STEPS, TRAIN_EVERY, TRAIN_KILL = 10, 6, 8
# (c)'s driver flags: AdamW on a cosine schedule (lr 3e-4, warm-up 4), a global
# batch of 8 x 1,024 tokens in 2 microbatches of 4.
TRAIN_FLAGS = ["--steps", str(TRAIN_STEPS), "--global-batch", "8", "--seq-len", "1024",
               "--microbatches", "2", "--lr", "3e-4", "--warmup", "4", "--ckpt-every",
               str(TRAIN_EVERY), "--log-every", "1", "--seed", str(TRAIN_SEED)]
# (b)'s tolerance: every leaf's gradient on the card against the CPU route,
# relative to the leaf's scale (error norm within it, no element past twice
# it of the largest): twice the spread of the reference's own einsum and
# blockwise bf16 gradients (1.4% of a leaf's norm, 2% of its largest element;
# tests/test_torch_lm_grad.py, whose bf16 tolerance this is).
LM_GRAD_TOL = 4e-2
RESTART_TOL = 1e-4  # the last loss of the resumed run (tests/test_train.py:91's bound)


class _StepTimes:
    """A Watchdog clock that also keeps each step's host seconds."""

    def __init__(self):
        from repro_torch.train.train_loop import Watchdog

        self.dts = []
        self.watchdog = Watchdog()
        stop = self.watchdog.stop
        self.watchdog.stop = lambda step, log=print: self.dts.append(stop(step, log)) or self.dts[-1]


def _gap(a, b) -> tuple:
    """(error norm over b's norm, largest |a - b| over the largest |b|)."""
    a, b = a.float().cpu(), b.float().cpu()
    return (float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)),
            float((a - b).abs().max() / b.abs().max()))


def _train_step_grads(params, cfg, batch, dev):
    """(loss, {leaf name: gradient}) of ``loss_fn`` on ``batch``, on ``dev``."""
    from repro_torch.models import transformer as tfm

    leaves = []
    tfm.tree_map(lambda n, v: leaves.append((n, v.requires_grad_())), params)
    loss = tfm.loss_fn(params, batch["tokens"].to(dev), batch["labels"].to(dev), cfg)
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    return float(loss), {n: g for (n, _), g in zip(leaves, grads)}


def _train_trace(cfg, dev, card: str) -> dict:
    """One training step of the driver's kind (``build_train_step``, AdamW,
    2 microbatches of 4 x 1,024) on fresh parameters, after two untraced
    ones, in a torch.profiler trace: K9's forward and backward device time
    and launches a step, the device's busy and idle share, the costliest
    kernels."""
    from repro_torch.data import lm as lm_data
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import build_train_step, make_train_state

    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    opt = opt_mod.adamw(lr=opt_mod.cosine_schedule(3e-4, 4, TRAIN_STEPS))
    state = make_train_state(tfm.init_params(cfg, gen, device=dev), opt)
    step = build_train_step(lambda p, b: tfm.loss_fn(p, b["tokens"], b["labels"], cfg), opt, 2)
    data = lm_data.LmDataConfig(vocab=cfg.vocab, seq_len=1024, global_batch=8, seed=TRAIN_SEED)
    batches = [{k: x.to(dev) for k, x in lm_data.batch_at(data, i).items()} for i in range(2)]
    holder = [state]

    def one():
        holder[0], m = step(holder[0], batches[0])
        float(m["loss"])

    one()
    spans = _traced(one, 1)
    del holder, state
    if not spans:
        print("training step trace: torch.profiler recorded no device time")
        return {}
    per = collections.Counter()
    count = collections.Counter()
    for a, b, name in spans:
        key = _instance(name) if "flash_attention" in name else name[:70]
        per[key] += (b - a) / 1e3
        count[key] += 1
    busy, wall = sum(per.values()), (spans[-1][1] - spans[0][0]) / 1e3
    fwd = {k: v for k, v in per.items() if k.startswith("flash_attention_bf16")}
    bwd = {k: v for k, v in per.items() if k.startswith("flash_attention_bwd")}
    print(f"training step trace ({cfg.name}, {cfg.n_layers} layers, 2 x 4 x 1,024 tokens; {card}): "
          f"{len(spans)} kernels, device busy {busy:.1f} of {wall:.1f} ms (idle "
          f"{1 - busy / wall:.1%}); K9 forward with lse {sum(fwd.values()):.2f} ms in "
          f"{sum(count[k] for k in fwd)} launches, K9 backward {sum(bwd.values()):.2f} ms in "
          f"{sum(count[k] for k in bwd)} kernels ({', '.join(f'{k} {v:.2f}' for k, v in bwd.items())})"
          "; most time: " + "; ".join(f"{name} {ms:.1f} ms ({count[name]})"
                                      for name, ms in per.most_common(10)))
    return {"fwd_ms": sum(fwd.values()), "bwd_ms": sum(bwd.values()), "busy_ms": busy,
            "wall_ms": wall}


def k9_entries(r: dict, path: str, counts: dict) -> list:
    """The kernels-line entries of K9's forward with lse and of its backward
    on ``path``: ``attention_bwd_row``'s row ``r`` at the path's shape and
    the path's launch ``counts``."""
    source = "src/repro_torch/kernels/flash_attention/csrc/"
    return [
        {"name": f"flash_attention_fwd/{path}", "route": "cuda",
         "source": source + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:74",
         "launches": counts["flash_attention_fwd"], "max_abs_err": r["fwd_err"],
         "ms": r["fwd_ms"],
         "plain_ms": r["fwd_plain_ms"], "bound_ms": r["fwd_bound"][0],
         "bound_by": r["fwd_bound"][1], "library_ms": r["fwd_library_ms"]},
        {"name": f"flash_attention_bwd/{path}", "route": "cuda",
         "source": source + "flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:74 (its gradient; the TPU "
                     "kernel has no backward)",
         "launches": counts["flash_attention_bwd"], "max_abs_err": r["err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"]}]


def drive_train(dev, card: str, attn_rows: dict, cfg=None, layers: int = TRAIN_LAYERS) -> list:
    """Training of phi3-mini-3.8b at full width (``cfg`` overrides for a
    rehearsal), weights drawn from TRAIN_SEED by ``init_params``.  (b) One
    step's loss and gradients of TRAIN_CUT (2 layers, B 1, S 256) on the card
    against the CPU route from the same parameters and batch (LM_GRAD_TOL a
    leaf, the global norm too), with K9's forward (with lse) and backward
    launched on every layer.  (c) ``launch.train.train`` on ``layers`` layers
    (TRAIN_FLAGS): run A, TRAIN_STEPS steps with a checkpoint every
    TRAIN_EVERY; run B crashed after step TRAIN_KILL (SystemExit 42) and
    resumed, which must say "resumed from step TRAIN_EVERY" and end within
    RESTART_TOL of A's last loss; every loss finite, A's last below its
    first.  The counts of K9's launches are set to 0 before run A and read
    after it: the forward with lse runs twice a layer a microbatch (the
    checkpointed layer's recompute), the backward once.  Prints step times,
    tokens a second, peak memory, the checkpoints' save and restore
    seconds, a traced step (``_train_trace``).  ``attn_rows`` are
    ``check_attention_bwd``'s timings; returns the kernels-line entries of
    K9's forward with lse and of its backward."""
    import dataclasses as dc
    import tempfile

    from repro_torch.configs import phi3_mini_3_8b
    from repro_torch.data import lm as lm_data
    from repro_torch.launch import train as train_driver
    from repro_torch.models import transformer as tfm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or phi3_mini_3_8b.make_model()

    # (b) one step at full width, 2 layers: the card against the CPU route
    n_cut, b_cut, s_cut = TRAIN_CUT
    cut_cfg = dc.replace(cfg, n_layers=n_cut)
    params = tfm.init_params(cut_cfg, torch.Generator(device=dev).manual_seed(TRAIN_SEED),
                             device=dev)
    params_cpu = tfm.tree_map(lambda _, x: x.detach().cpu(), params)
    batch = lm_data.batch_at(lm_data.LmDataConfig(vocab=cfg.vocab, seq_len=s_cut,
                                                  global_batch=b_cut, seed=TRAIN_SEED), 0)
    _reset_launches()
    loss_card, g_card = _train_step_grads(params, cut_cfg, batch, dev)
    torch.cuda.synchronize()
    counts = _launches()
    if (counts["flash_attention_fwd"] != 2 * n_cut or counts["flash_attention_bwd"] != n_cut
            or any(n for name, n in counts.items()
                   if name not in ("flash_attention_fwd", "flash_attention_bwd"))):
        raise AssertionError(f"(b): launches {counts}, want {2 * n_cut} forward with lse (the "
                             f"checkpointed layers' recompute) and {n_cut} backward")
    t0 = time.perf_counter()
    loss_cpu, g_cpu = _train_step_grads(params_cpu, cut_cfg, batch, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    norm_card = float(opt_mod.global_norm(g_card))
    norm_cpu = float(opt_mod.global_norm(g_cpu))
    gaps = {n: _gap(g_card[n], g_cpu[n]) for n in g_cpu}
    worst = max(gaps, key=lambda n: gaps[n][0])
    print(f"  (b) one training step of {cfg.name} at full width, {n_cut} layers, B={b_cut}, "
          f"S={s_cut}, the card against the CPU route ({cpu_s:.1f} s): loss {loss_card:.6f} / "
          f"{loss_cpu:.6f}, global grad norm {norm_card:.6g} / {norm_cpu:.6g}; worst leaf {worst}: "
          f"error norm {gaps[worst][0]:.4g} of its norm, largest error "
          f"{max(g[1] for g in gaps.values()):.4g} of its largest (tolerance {LM_GRAD_TOL} / "
          f"{2 * LM_GRAD_TOL}); K9 launches {counts['flash_attention_fwd']} forward with lse, "
          f"{counts['flash_attention_bwd']} backward")
    if not (abs(loss_card - loss_cpu) <= LM_GRAD_TOL * abs(loss_cpu)
            and abs(norm_card - norm_cpu) <= LM_GRAD_TOL * norm_cpu
            and all(a <= LM_GRAD_TOL and m <= 2 * LM_GRAD_TOL for a, m in gaps.values())):
        raise AssertionError(f"(b): the card's step differs from the CPU route's: {gaps}")
    del params, params_cpu, g_card, g_cpu
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the driver on `layers` layers at full width: run A, then B crashed and resumed
    big = dc.replace(cfg, n_layers=layers)
    n_params = big.param_count()[0]
    root = tempfile.mkdtemp(prefix="train-ckpt-")
    print(f"  (c) {big.name} at full width, {layers} of {cfg.n_layers} layers: {n_params:,} "
          f"parameters, {n_params * 16 / 1e9:.1f} GB of f32 parameters, gradients and AdamW "
          f"moments; checkpoints of {n_params * 12 / 1e9:.1f} GB into {root} "
          f"({shutil.disk_usage(root).free / 1e9:.0f} GB free)")
    io_s = collections.defaultdict(list)
    saved = {name: getattr(ckpt, name) for name in ("save_async", "save", "restore", "_write")}

    def timed_io(name):
        def fn(*a, **kw):
            t0 = time.perf_counter()
            out = saved[name](*a, **kw)
            io_s[name].append(time.perf_counter() - t0)
            return out
        return fn

    for name in saved:
        setattr(ckpt, name, timed_io(name))

    def run(ckpt_dir, *extra):
        args = train_driver.parser().parse_args(
            [*TRAIN_FLAGS, "--ckpt-dir", ckpt_dir, "--device", dev.type, *extra])
        times = _StepTimes()
        out = io.StringIO()
        code = 0
        with contextlib.redirect_stdout(out):
            try:
                summary = train_driver.train(big, args, times.watchdog)
            except SystemExit as crash:
                code, summary = crash.code, None
        text = out.getvalue()
        losses = [float(line.split("loss ")[1].split()[0]) for line in text.splitlines()
                  if line.startswith("[train] step ")]
        return code, summary, text, times.dts, losses

    try:
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        code_a, sum_a, text_a, dts_a, losses_a = run(os.path.join(root, "a"))
        run_a_s = time.perf_counter() - t0
        counts = _launches()
        peak = torch.cuda.max_memory_allocated()
        shutil.rmtree(os.path.join(root, "a"))
        t0 = time.perf_counter()
        code_b1, _, text_b1, _, losses_b1 = run(os.path.join(root, "b"), "--kill-at",
                                                str(TRAIN_KILL))
        code_b2, sum_b, text_b2, _, losses_b2 = run(os.path.join(root, "b"))
        run_b_s = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(ckpt, name, fn)
        shutil.rmtree(root, ignore_errors=True)
    per_step = {k: counts[k] / TRAIN_STEPS for k in ("flash_attention_fwd", "flash_attention_bwd")}
    want = {"flash_attention_fwd": 2 * 2 * layers, "flash_attention_bwd": 2 * layers}
    if per_step != want or any(n for name, n in counts.items() if name not in want):
        raise AssertionError(f"(c): launches {counts} over {TRAIN_STEPS} steps, want {want} a step")
    if code_a != 0 or code_b1 != 42 or code_b2 != 0:
        raise AssertionError(f"(c): exit codes A {code_a}, B {code_b1} then {code_b2}:\n"
                             f"{text_a[-800:]}\n{text_b1[-800:]}\n{text_b2[-800:]}")
    if f"resumed from step {TRAIN_EVERY}" not in text_b2:
        raise AssertionError(f"(c): run B did not resume from step {TRAIN_EVERY}:\n{text_b2[:800]}")
    finite = all(math.isfinite(x) for x in losses_a + losses_b1 + losses_b2)
    gap = abs(sum_a["last_loss"] - sum_b["last_loss"])
    step_ms = 1e3 * statistics.median(dts_a[2:])
    tokens = 8 * 1024
    print(f"  (c) run A: {TRAIN_STEPS} steps, losses {[round(x, 4) for x in losses_a]}; run B: "
          f"crashed after step {TRAIN_KILL} (exit {code_b1}), resumed from step {TRAIN_EVERY}, "
          f"losses {[round(x, 4) for x in losses_b2]}; last loss A {sum_a['last_loss']:.6f}, B "
          f"{sum_b['last_loss']:.6f} (|A - B| {gap:.3g}, bound {RESTART_TOL}); every loss finite "
          f"{finite}")
    if not (finite and gap <= RESTART_TOL and sum_a["last_loss"] < sum_a["first_loss"]):
        raise AssertionError(f"(c): finite {finite}, |A - B| {gap}, first {sum_a['first_loss']} "
                             f"last {sum_a['last_loss']}")
    print(f"training on {card} ({big.name}, {layers} layers, AdamW, 2 x 4 x 1,024 tokens a step): "
          f"step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS - 1}, host clock; min "
          f"{1e3 * min(dts_a[2:]):.1f}, max {1e3 * max(dts_a[2:]):.1f}; step 0 "
          f"{1e3 * dts_a[0]:.1f}), {tokens / step_ms * 1e3:.0f} tokens/s; K9 launches a step "
          f"{per_step['flash_attention_fwd']:.0f} forward with lse, "
          f"{per_step['flash_attention_bwd']:.0f} backward; peak device memory {peak / 1e9:.1f} "
          f"GB (with {held / 1e9:.1f} GB held before the phase); run A {run_a_s:.1f} s, run B "
          f"(crash and resume) {run_b_s:.1f} s; checkpoints: host copy "
          f"{[round(x, 2) for x in io_s['save_async']]} s, disk write "
          f"{[round(x, 2) for x in io_s['_write']]} s, synchronous save "
          f"{[round(x, 2) for x in io_s['save']]} s, restore "
          f"{[round(x, 2) for x in io_s['restore']]} s (host clock)")
    trace = _train_trace(big, dev, card)

    entries = k9_entries(attn_rows[ATTN_BWD_CASES[0][0]], "phi3-mini-train", counts)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    if left > 1e9:
        raise AssertionError(f"training phase: {left / 1e9:.3f} GB still allocated after it")
    print(f"training phase: {time.perf_counter() - t_phase:.1f} s (host clock, {card}); K9 a "
          f"step in the trace: forward {trace.get('fwd_ms', float('nan')):.2f} ms, backward "
          f"{trace.get('bwd_ms', float('nan')):.2f} ms")
    return entries


# --------------------------------------------------------------------------
# C3: f32_matmul under the caller's TF32 settings
# --------------------------------------------------------------------------

F32_RULE = 2.0**-20  # of sum |a| |b|: 16 f32 ulps of it; a TF32 product misses it by far
F32_THREAD_CALLS = 50


def _f32_rule(a, b, c) -> bool:
    """``c`` within F32_RULE of sum |a| |b| of each element from the float64
    product of f32 ``a`` and ``b``."""
    want = a.double() @ b.double()
    return bool(((c.double() - want).abs() <= F32_RULE * (a.double().abs() @ b.double().abs()))
                .all())


def check_f32_matmul(dev, card: str) -> None:
    """``common.f32_matmul`` keeps TF32 out of its product whatever the
    caller set: (1) with ``fp32_precision = "tf32"`` (where torch has it),
    which makes a read of ``allow_tf32`` raise; (2) with ``allow_tf32 =
    True``, in two threads at once, F32_THREAD_CALLS products each.  Each
    product is held to f32's rule (``_f32_rule``) and a plain product under
    the same setting must miss it; the caller's setting must read the same
    after.  The settings are restored as they were."""
    from repro_torch.kernels.common import f32_matmul

    matmul = torch.backends.cuda.matmul
    gen = torch.Generator(device=dev).manual_seed(41)
    a, b = (torch.randn(shape, generator=gen, device=dev) for shape in ((256, 1024), (1024, 256)))
    pairs = [tuple(torch.randn(shape, generator=gen, device=dev)
                   for shape in ((128, 1024), (1024, 128))) for _ in range(2)]
    prev = matmul.allow_tf32  # main set it through this flag
    lines = []
    try:
        if hasattr(matmul, "fp32_precision"):
            matmul.fp32_precision = "tf32"
            plain, kept = _f32_rule(a, b, a @ b), _f32_rule(a, b, f32_matmul(a, b))
            after = matmul.fp32_precision
            if plain or not kept or after != "tf32":
                raise AssertionError(f"C3, fp32_precision 'tf32': plain product within f32's rule "
                                     f"{plain}, f32_matmul within it {kept}, setting after {after}")
            lines.append("fp32_precision 'tf32': f32_matmul within f32's rule, a plain product "
                         "outside it, the setting 'tf32' after")
        else:
            lines.append(f"torch {torch.__version__} has no fp32_precision: that case not run")
        matmul.allow_tf32 = True
        results = [[] for _ in pairs]

        def work(i):
            x, y = pairs[i]
            for _ in range(F32_THREAD_CALLS):
                results[i].append(_f32_rule(x, y, f32_matmul(x, y)))

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(pairs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        plain = _f32_rule(*pairs[0], pairs[0][0] @ pairs[0][1])
        if (any(t.is_alive() for t in threads) or plain or matmul.allow_tf32 is not True
                or [sum(r) for r in results] != [F32_THREAD_CALLS] * len(pairs)):
            raise AssertionError(f"C3, allow_tf32 True in two threads: products within f32's "
                                 f"rule {[sum(r) for r in results]} of {F32_THREAD_CALLS} each, "
                                 f"plain within it {plain}, flag after {matmul.allow_tf32}")
        lines.append(f"allow_tf32 True, two threads x {F32_THREAD_CALLS} products: every one "
                     "within f32's rule, a plain product outside it, the flag True after")
    finally:
        matmul.allow_tf32 = prev
    print(f"C3 (f32_matmul's precision switch) on {card}, torch {torch.__version__}: "
          + "; ".join(lines) + f" (rule: {F32_RULE:.3g} of sum |a| |b| from the float64 product)")


# --------------------------------------------------------------------------
# Sharded training: data parallel (psum and compressed_psum) and GPipe
# --------------------------------------------------------------------------

SHARD_TRAIN_SEED = 41  # the sharded phase's weights, batches and cotangents
DP_SHARDS, DP_LAYERS, DP_BATCH, DP_SEQ = 4, 4, 8, 1024  # (a): 4 x cuda:0, 2 x 1,024 a shard
PP_STAGES, PP_LAYERS, PP_MICRO, PP_SEQ = 4, 8, 4, 1024  # (b): two layers a stage, M 4 of 1 x 1,024
DP_LOSS_RTOL = 2e-4  # tests/test_distributed.py:191's
# compressed_psum's holds: the mean within half a grid step plus f32 rounding
# (the exact mean's sum and the dequantization: a few hundred ulps of the
# step's 127), the feedback identity within 16 ulps of its terms' magnitude
CP_GRID_SLACK = 2.0**-14
CP_FEEDBACK_ULPS = 2.0**-20


def _named_leaves(params) -> list:
    from repro_torch.models import transformer as tfm

    leaves = []
    tfm.tree_map(lambda n, v: leaves.append((n, v)), params)
    return leaves


def _sync_s(fn):
    """(fn(), host seconds to its end on the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _hold_compressed(names, g1, r1, out1, g2, r2, out2, n: int) -> tuple:
    """compressed_psum's holds leaf by leaf (the first call from a zero
    residual, so its g32 is the gradient): (1) the first mean within half a
    grid step of the exact mean; (2) the first residual within half a grid
    step of 0 and bit-equal to g - q scale rounded once to f32, with q =
    clip(round(g / scale), -127, 127) written out here from the definition
    (not through ``compression``'s own functions); (3) over both
    calls, n (out1 + out2) + sum_s r2 equal to sum_s (g1 + g2) within
    CP_FEEDBACK_ULPS of the terms' magnitude.  Returns (the largest first
    error in grid steps, the largest feedback gap in ulps of the
    magnitude)."""
    from repro_torch.core import distributed

    worst_step, worst_fb = 0.0, 0.0
    for name in names:
        gs = [g[name].float() for g in g1]
        scale = torch.clamp_min(distributed.pmax([x.abs().max() for x in gs]), 1e-12) / 127.0
        exact = distributed.psum(gs) / n
        err = float((out1[0][name] - exact).abs().max())
        if err > float(scale) * (0.5 + CP_GRID_SLACK):
            raise AssertionError(f"compressed_psum {name}: mean off by {err:.4g}, past half the "
                                 f"grid step {float(scale):.4g}")
        worst_step = max(worst_step, err / float(scale))
        for s, x in enumerate(gs):
            q = torch.clamp(torch.round(x / scale), -127, 127).double()
            want = (x.double() - q * scale.double()).float()
            half = float(r1[s][name].abs().max()) / float(scale)
            if not torch.equal(r1[s][name], want) or half > 0.5 + CP_GRID_SLACK:
                raise AssertionError(f"compressed_psum {name}: shard {s}'s residual is not "
                                     f"g32 - q scale (largest |r| {half:.4g} grid steps)")
            del q, want
        del exact, gs
        lhs = n * (out1[0][name].double() + out2[0][name].double())
        mag = n * (out1[0][name].double().abs() + out2[0][name].double().abs())
        rhs = torch.zeros_like(lhs)
        for s in range(n):
            lhs += r2[s][name].double()
            rhs += g1[s][name].double() + g2[s][name].double()
            mag += (r2[s][name].double().abs() + r1[s][name].double().abs()
                    + g1[s][name].double().abs() + g2[s][name].double().abs())
        gap = float(((lhs - rhs).abs() / mag.clamp_min(1e-30)).max())
        if gap > CP_FEEDBACK_ULPS:
            raise AssertionError(f"compressed_psum {name}: error feedback off by {gap:.3g} of the "
                                 f"terms' magnitude (bound {CP_FEEDBACK_ULPS:.3g})")
        worst_fb = max(worst_fb, gap)
        del lhs, rhs, mag
    return worst_step, worst_fb


def _data_parallel(dev, card: str, cfg) -> list:
    """(a) of ``drive_sharded_train``; returns its K9 kernels-line entries."""
    import dataclasses as dc

    from repro_torch.core import distributed
    from repro_torch.data import lm as lm_data
    from repro_torch.models import transformer as tfm
    from repro_torch.train import compression

    dcfg = dc.replace(cfg, n_layers=DP_LAYERS)
    params = tfm.init_params(dcfg, torch.Generator(device=dev).manual_seed(SHARD_TRAIN_SEED),
                             device=dev)
    leaves = [(n, v.requires_grad_()) for n, v in _named_leaves(params)]
    names = [n for n, _ in leaves]
    batch = lm_data.batch_at(lm_data.LmDataConfig(vocab=cfg.vocab, seq_len=DP_SEQ,
                                                  global_batch=DP_BATCH, seed=SHARD_TRAIN_SEED), 0)
    mesh = distributed.make_mesh((DP_SHARDS,), ("data",), device=dev)
    toks, labels = (distributed.shard_rows(mesh, batch[k], ("data",)) for k in ("tokens", "labels"))

    def shard_grads(t, y):
        loss = tfm.loss_fn(params, t, y, dcfg)
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, [v for _, v in leaves])))

    _reset_launches()
    shards = [_sync_s(lambda: shard_grads(t, y)) for t, y in zip(toks, labels)]
    counts = _launches()
    want = {"flash_attention_fwd": 2 * DP_LAYERS * DP_SHARDS,
            "flash_attention_bwd": DP_LAYERS * DP_SHARDS}
    if any(counts[k] != want.get(k, 0) for k in counts):
        raise AssertionError(f"(a): launches {counts}, want {want} (the checkpointed layers' "
                             "recompute: two forwards with lse a layer a shard)")
    losses = [loss for (loss, _), _ in shards]
    g1 = [g for (_, g), _ in shards]
    grad_ms = [1e3 * dt for _, dt in shards]
    del shards
    mean, psum_s = _sync_s(lambda: {n: distributed.psum([g[n] for g in g1]) / DP_SHARDS
                                    for n in names})
    (loss_all, g_all), whole_s = _sync_s(lambda: shard_grads(batch["tokens"].to(dev),
                                                             batch["labels"].to(dev)))
    loss_dp = float(distributed.psum(losses) / DP_SHARDS)
    gaps = {n: _gap(mean[n], g_all[n]) for n in names}
    worst = max(gaps, key=lambda n: gaps[n][0])
    if not (abs(loss_dp - float(loss_all)) <= DP_LOSS_RTOL * abs(float(loss_all))
            and all(a <= LM_GRAD_TOL and m <= 2 * LM_GRAD_TOL for a, m in gaps.values())):
        raise AssertionError(f"(a): loss {loss_dp} against the whole batch's {float(loss_all)}, "
                             f"gradient gaps {gaps}")
    del mean, g_all

    zero = [compression.init_residual(g) for g in g1]
    (out1, r1), cp1_s = _sync_s(lambda: compression.compressed_psum(g1, zero, mesh, "data"))
    del zero
    g2 = [g1[(s + 1) % DP_SHARDS] for s in range(DP_SHARDS)]  # other gradients, no new memory
    (out2, r2), cp2_s = _sync_s(lambda: compression.compressed_psum(g2, r1, mesh, "data"))
    step, fb = _hold_compressed(names, g1, r1, out1, g2, r2, out2, DP_SHARDS)
    n_params = sum(v.numel() for _, v in leaves)
    wire_f32, wire_int8 = (compression.wire_bytes(params, c) for c in (False, True))
    print(f"  (a) data parallel, {dcfg.name} at full width, {DP_LAYERS} layers ({n_params:,} "
          f"parameters), {DP_BATCH} x {DP_SEQ} tokens over {DP_SHARDS} shards on one card "
          f"(make_mesh(({DP_SHARDS},), ('data',)): the shards run one after another): mean of the "
          f"shards' losses {loss_dp:.6f}, the whole batch's {float(loss_all):.6f} (rtol "
          f"{DP_LOSS_RTOL}); psum / {DP_SHARDS} of the shards' gradients against the whole batch's: "
          f"worst leaf {worst} error norm {gaps[worst][0]:.4g} of its norm, largest error "
          f"{max(g[1] for g in gaps.values()):.4g} of its largest (tolerance {LM_GRAD_TOL} / "
          f"{2 * LM_GRAD_TOL}); compressed_psum: first mean within {step:.4f} grid steps of the "
          f"exact mean (bound 0.5), residuals g32 - q scale bit for bit (q written out from its "
          f"definition) and within half a grid step, error feedback over two reductions"
          f" within {fb:.3g} of the terms' magnitude (bound {CP_FEEDBACK_ULPS:.3g}); "
          f"K9 launches {counts['flash_attention_fwd']} forward with lse, "
          f"{counts['flash_attention_bwd']} backward")
    print(f"  (a) on {card}, host clock: each shard's loss and gradients "
          f"{[round(x, 1) for x in grad_ms]} ms, the whole batch's {1e3 * whole_s:.1f} ms; psum / "
          f"{DP_SHARDS} {1e3 * psum_s:.1f} ms, compressed_psum {1e3 * cp1_s:.1f} ms (from a zero "
          f"residual), {1e3 * cp2_s:.1f} ms (with feedback); wire_bytes a hop: f32 {wire_f32:,}, "
          f"compressed {wire_int8:,} (the reference's count, 1 byte a parameter; the payload is "
          f"summed as int32, {4 * n_params:,} bytes)")
    del g1, g2, out1, out2, r1, r2, params, leaves
    gen = torch.Generator(device=dev).manual_seed(SHARD_TRAIN_SEED)
    b = DP_BATCH // DP_SHARDS
    q, k, v = _qkv(torch.bfloat16, b, cfg.n_heads, cfg.n_kv_heads, DP_SEQ, cfg.dh, gen, dev)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    row = attention_bwd_row(q, k, v, dout, f"data-parallel shard ({_layer_label(q, k)})", card)
    return k9_entries(row, "phi3-mini-data-parallel", counts)


def _gpipe(dev, card: str, cfg) -> list:
    """(b) of ``drive_sharded_train``; returns its K9 kernels-line entries."""
    import dataclasses as dc

    from repro_torch.core import distributed
    from repro_torch.data import lm as lm_data
    from repro_torch.models import transformer as tfm
    from repro_torch.train import pipeline

    pcfg = dc.replace(cfg, n_layers=PP_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SHARD_TRAIN_SEED)
    params = tfm.init_params(pcfg, gen, device=dev)
    tokens = lm_data.batch_at(lm_data.LmDataConfig(
        vocab=cfg.vocab, seq_len=PP_SEQ, global_batch=PP_MICRO, seed=SHARD_TRAIN_SEED), 1)[
        "tokens"].to(dev).reshape(PP_MICRO, 1, PP_SEQ)
    with torch.no_grad():
        x = tfm._embed(params, tokens, pcfg)  # (M, 1, S, d) in bf16
    layers = params["layers"]
    del params
    leaves = [(n, v.requires_grad_()) for n, v in _named_leaves(layers)]
    x.requires_grad_()
    wrt = [v for _, v in leaves] + [x]
    dout = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
    positions = torch.arange(PP_SEQ, device=dev).expand(1, PP_SEQ)
    mesh = distributed.make_mesh((PP_STAGES,), ("pipe",), device=dev)
    gpipe = pipeline.build_gpipe_fn(
        mesh, lambda h, layer: tfm._dense_layer(h, layer, pcfg, positions), PP_STAGES)

    def pipelined():
        out = gpipe(layers, x)
        return out.detach(), torch.autograd.grad(out, wrt, dout)

    def sequential():  # the same layers, one microbatch at a time, in order
        out = torch.stack([tfm._run_layers({"layers": layers}, x[j], pcfg)
                           for j in range(PP_MICRO)])
        return out.detach(), torch.autograd.grad(out, wrt, dout)

    _reset_launches()
    (out, grads), _ = _sync_s(pipelined)
    counts = _launches()
    want = {"flash_attention_fwd": 2 * PP_LAYERS * PP_MICRO,
            "flash_attention_bwd": PP_LAYERS * PP_MICRO}
    if any(counts[k] != want.get(k, 0) for k in counts):
        raise AssertionError(f"(b): launches {counts}, want {want} (inactive ticks skipped: each "
                             "stage's layers M times forward, again in the recompute, M times "
                             "backward)")
    seq_out, seq_grads = sequential()
    same = torch.equal(out, seq_out)
    gaps = {n: _gap(g, w) for n, g, w in zip([n for n, _ in leaves] + ["input"], grads,
                                               seq_grads)}
    worst = max(gaps, key=lambda n: gaps[n][0])
    if not same or not all(a <= LM_GRAD_TOL and m <= 2 * LM_GRAD_TOL for a, m in gaps.values()):
        raise AssertionError(f"(b): output bit-equal to the sequential run's {same}, gradient "
                             f"gaps {gaps}")
    del grads, seq_grads, out, seq_out
    times = {}
    for name, fn in 2 * (("sequential", sequential), ("gpipe", pipelined), ("gpipe", pipelined),
                         ("sequential", sequential)):
        times.setdefault(name, []).append(1e3 * _sync_s(fn)[1])
    med = {name: statistics.median(t) for name, t in times.items()}
    print(f"  (b) GPipe, {pcfg.name} at full width, {PP_LAYERS} layers over {PP_STAGES} stages "
          f"(make_mesh(({PP_STAGES},), ('pipe',)), two layers a stage), M = {PP_MICRO} "
          f"microbatches of 1 x {PP_SEQ} embedded tokens: output bit-equal to the layers run one "
          f"microbatch at a time ({same}); gradients of the layers and the input against that "
          f"run's: worst {worst} error norm {gaps[worst][0]:.4g} of its norm, largest error "
          f"{max(g[1] for g in gaps.values()):.4g} of its largest (tolerance {LM_GRAD_TOL} / "
          f"{2 * LM_GRAD_TOL}); K9 launches {counts['flash_attention_fwd']} forward with lse, "
          f"{counts['flash_attention_bwd']} backward (inactive ticks skipped)")
    print(f"  (b) on {card}, host clock, forward and backward in turns (both run once "
          f"before): GPipe {[round(t, 1) for t in times['gpipe']]} ms (median "
          f"{med['gpipe']:.1f}), sequential {[round(t, 1) for t in times['sequential']]} ms "
          f"(median {med['sequential']:.1f}); bubble_fraction({PP_STAGES}, "
          f"{PP_MICRO}) = {pipeline.bubble_fraction(PP_STAGES, PP_MICRO):.4f}; on one card the "
          "stages run one after another, so no speed-up is expected")
    del layers, leaves, x, wrt
    q, k, v = _qkv(torch.bfloat16, 1, cfg.n_heads, cfg.n_kv_heads, PP_SEQ, cfg.dh, gen, dev)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    row = attention_bwd_row(q, k, v, dout, f"GPipe microbatch ({_layer_label(q, k)})", card)
    return k9_entries(row, "phi3-mini-gpipe", counts)


def drive_sharded_train(dev, card: str, cfg=None) -> list:
    """Sharded training of phi3-mini-3.8b at full width (``cfg`` overrides
    for a rehearsal), weights drawn from SHARD_TRAIN_SEED by
    ``init_params``, batches from ``data/lm.py``.  (a) Data parallel on
    ``make_mesh((DP_SHARDS,), ("data",))``: ``shard_rows`` splits DP_BATCH
    x DP_SEQ tokens, each shard's loss and gradients come from ``loss_fn``
    (DP_LAYERS layers); the mean of the losses against the whole batch's
    (DP_LOSS_RTOL), ``psum`` / S of the gradients against the whole
    batch's (LM_GRAD_TOL a leaf), and ``compressed_psum`` twice, with error
    feedback (``_hold_compressed``).  (b) GPipe on ``make_mesh((PP_STAGES,),
    ("pipe",))``: PP_LAYERS layers, PP_MICRO microbatches of 1 x PP_SEQ
    embedded tokens; the output bit-equal to the layers run one microbatch
    at a time, the gradients of the layers and the input within
    LM_GRAD_TOL.  K9's launches are counted on each path.  Returns the
    kernels-line entries of K9's forward with lse and backward at each
    path's shapes."""
    from repro_torch.configs import phi3_mini_3_8b

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or phi3_mini_3_8b.make_model()
    entries = _data_parallel(dev, card, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    entries += _gpipe(dev, card, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    left = torch.cuda.memory_allocated() - held
    if left > 1e9:
        raise AssertionError(f"sharded training phase: {left / 1e9:.3f} GB still allocated after it")
    print(f"sharded training phase: {time.perf_counter() - t_phase:.1f} s (host clock, {card}); "
          f"peak device memory {peak / 1e9:.1f} GB (with {held / 1e9:.1f} GB held before it)")
    return entries


# --------------------------------------------------------------------------
# The kNN-LM example
# --------------------------------------------------------------------------

KNN_DEPTH = 64  # the example's match depth (examples/knn_lm_torch.py)


def drive_knn_lm(dev, card: str, argv=("--device", "cuda")) -> list:
    """``examples/knn_lm_torch.py``'s ``main`` (the reference's 200 steps
    of the micro LM, the datastore of 8,192 hidden states, the fake-words
    search at depth 64 with rerank, the NLL at three lambdas): every NLL
    finite, lambda 0 the LM's own cross-entropy (1e-5), K9 (forward with
    lse, backward, the plain forward) and K1 launched on its run.  Then K9
    at the micro LM's training shape and K1 classic at the datastore's
    (the index and queries of the run's search) against their plain
    versions and timed.  Returns their kernels-line entries."""
    import importlib.util

    from repro_torch.core import fakewords
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk
    from repro_torch.launch.train import micro_lm_config

    t_phase = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "knn_lm_torch", os.path.join(ROOT, "examples", "knn_lm_torch.py"))
    knn = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(knn)
    _reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = knn.main(list(argv))
    torch.cuda.synchronize()
    counts = _launches()
    run_s = time.perf_counter() - t_phase
    print("\n".join("  | " + line for line in out.getvalue().splitlines()))
    nlls = res["nll"]
    ran = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention", "fused_topk")
    if (not all(math.isfinite(x) for x in nlls.values())
            or abs(nlls[0.0] - res["lm_nll"]) > 1e-5 * res["lm_nll"]
            or any(counts[k] <= 0 for k in ran) or any(counts[k] for k in counts if k not in ran)):
        raise AssertionError(f"kNN-LM: NLLs {nlls}, the LM's own {res['lm_nll']}, launches "
                             f"{counts}")
    index, q_tf = res["index"], res["q_tf"]
    qv = fakewords.classic_query(index, q_tf)
    docs, n = index.scored, index.scored.shape[0]
    err = compare("kNN-LM K1 classic vs plain", fused_topk(qv, docs, KNN_DEPTH),
                  ref.fused_topk_ref(qv, docs, KNN_DEPTH + 1), exact=False)
    ms = cuda_ms(lambda: fused_topk(qv, docs, KNN_DEPTH))
    plain_ms = cuda_ms(lambda: ref.fused_topk_ref(qv, docs, KNN_DEPTH))
    lib_ms = cuda_ms(lambda: torch.topk(torch.matmul(qv, docs.T), KNN_DEPTH))
    bound, bound_by = bound_ms(qv, docs, n, KNN_DEPTH, "bf16")
    print(f"fused_topk/knn-lm (bf16, B={qv.shape[0]}, N={n}, T={qv.shape[1]}, depth={KNN_DEPTH}): "
          f"kernel {ms:.4f} ms, bound {bound:.4f} ms ({bound_by}, bf16), plain {plain_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms (torch.topk(matmul)); max_abs_err {err:.3g}; launches on "
          f"the example's run {counts['fused_topk']}; {card}")
    cfg = micro_lm_config()
    gen = torch.Generator(device=dev).manual_seed(SHARD_TRAIN_SEED)
    q, k, v = _qkv(torch.bfloat16, 8, cfg.n_heads, cfg.n_kv_heads, 64, cfg.dh, gen, dev)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    row = attention_bwd_row(q, k, v, dout, f"kNN-LM micro LM step ({_layer_label(q, k)})", card)
    entries = k9_entries(row, "knn-lm-micro-train", counts)
    entries.append({
        "name": "fused_topk/knn-lm", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
        "replaces": "src/repro/kernels/fused_topk/kernel.py:288",
        "launches": counts["fused_topk"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms})
    print(f"kNN-LM phase: {time.perf_counter() - t_phase:.1f} s (host clock, {card}; the "
          f"example's run {run_s:.1f} s); NLL at lambda "
          + ", ".join(f"{lam}: {x:.4f}" for lam, x in nlls.items())
          + f" (the LM's own {res['lm_nll']:.4f}); launches on the run: K9 forward with lse "
          f"{counts['flash_attention_fwd']}, backward {counts['flash_attention_bwd']}, plain "
          f"forward {counts['flash_attention']}, K1 {counts['fused_topk']}")
    return entries


GNN_SEED = 38  # the GraphSAGE phase's weights, seeds and molecule batches
GNN_STEPS = 3  # AdamW steps of each GraphSAGE cell
GNN_HOLD_SEEDS = 128  # minibatch_lg's hold: the first seeds of the card's batch
GNN_HOLD_SLICE = 1_024  # full_graph_sm's second hold: edges a gather-scatter slice
# The card against the CPU route (logits and every leaf's gradient, relative
# to their scale: error norm within it, no element past twice it of the
# largest): the two routes scatter-add and multiply in another order in f32.
MODEL_TOL = 1e-4


def _tree_cpu(params):
    from repro_torch.models.params import tree_map

    return tree_map(lambda _, v: v.detach().cpu(), params)


def _loss_grads(loss_fn, params):
    """(loss, {leaf name: gradient}) of ``loss_fn(params)`` on detached
    leaves; a leaf the loss does not use has a zero gradient, as in JAX."""
    from repro_torch.models.params import tree_map

    fresh = {}

    def leaf(name, v):
        fresh[name] = v.detach().requires_grad_()
        return fresh[name]

    loss = loss_fn(tree_map(leaf, params))
    grads = torch.autograd.grad(loss, list(fresh.values()), allow_unused=True)
    return float(loss.detach()), {n: torch.zeros_like(v) if g is None else g
                                  for (n, v), g in zip(fresh.items(), grads)}


def _hold_model(label: str, card: tuple, cpu: tuple, rows=None) -> str:
    """Hold (logits, loss, grads) of the card against the CPU route's within
    MODEL_TOL; ``rows`` maps the name of a table leaf to the rows of the
    card's gradient the CPU route's (a sub-table) stands for.  Returns the
    printed summary."""
    (lc, loss_c, gc_), (lp, loss_p, gp) = card, cpu
    worst = {"logits": _gap(lc, lp)}
    for n, g in gp.items():
        got = gc_[n] if rows is None or n not in rows else gc_[n][rows[n]]
        # a leaf the loss does not use: zero on both sides
        worst[f"grad {n}"] = (_gap(got, g) if bool(g.any())
                              else (float(got.abs().max()), float(got.abs().max())))
    bad = {n: v for n, v in worst.items() if v[0] > MODEL_TOL or v[1] > 2 * MODEL_TOL}
    if bad or abs(loss_c - loss_p) > MODEL_TOL * abs(loss_p):
        raise AssertionError(f"{label}: the card differs from the CPU route: loss {loss_c} / "
                             f"{loss_p}; {bad}")
    top = max(worst, key=lambda n: worst[n][0])
    return (f"{label}: loss {loss_c:.6f} / {loss_p:.6f} (card / CPU route); worst {top}: error "
            f"norm {worst[top][0]:.3g} of its norm, largest error "
            f"{max(v[1] for v in worst.values()):.3g} of its largest (tolerance {MODEL_TOL} / "
            f"{2 * MODEL_TOL})")


def _train_steps(loss_fn, params, batches, n_microbatches: int = 1, trace: str = "",
                 lr: float = 1e-2):
    """AdamW (``lr``) steps of ``build_train_step`` over ``batches`` (a
    callable batch is drawn at its step); returns (losses, host seconds a
    step: each ends in a synchronize, and with ``trace`` the line of one
    more step of the first batch in a trace, else "")."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import build_train_step, make_train_state

    opt = opt_mod.adamw(lr=lr)
    holder = [make_train_state(params, opt)]
    step = build_train_step(loss_fn, opt, n_microbatches)
    losses, dts = [], []

    def one(batch):
        holder[0], m = step(holder[0], batch() if callable(batch) else batch)
        return float(m["loss"])

    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(one(batch))
        dts.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training losses {losses}")
    line = _trace_line(trace, lambda: one(batches[0])) if trace else ""
    del holder
    return losses, dts, line


def _trace_line(label: str, fn) -> str:
    """One call of ``fn`` in a torch.profiler trace: kernels, device busy
    and idle share, the costliest kernels."""
    spans = _traced(fn, 1)
    if not spans:
        return f"{label} trace: torch.profiler recorded no device time"
    per, count = collections.Counter(), collections.Counter()
    for a, b, name in spans:
        per[name[:60]] += (b - a) / 1e3
        count[name[:60]] += 1
    busy, wall = sum(per.values()), (spans[-1][1] - spans[0][0]) / 1e3
    return (f"{label} trace: {len(spans)} kernels, device busy {busy:.2f} of {wall:.2f} "
            f"ms (idle {1 - busy / wall:.1%}); most time: "
            + "; ".join(f"{n} {ms:.2f} ms ({count[n]})" for n, ms in per.most_common(5)))


def _ms_list(dts) -> str:
    return "[" + ", ".join(f"{1e3 * x:.1f}" for x in dts) + "] ms"


def drive_gnn(dev, card: str, cells=None) -> float:
    """GraphSAGE 2 x 128 (``configs/graphsage_reddit.py``) at each cell's
    published graph (``cells`` overrides for a rehearsal), weights drawn from
    GNN_SEED by ``init_params`` on the card, graphs by ``make_graph`` (numpy
    on the host, then moved; its host time printed):
    full_graph_sm (Cora sizes) and molecule (128 graphs of 30 nodes):
    ``forward_full`` / ``forward_batched`` timed and GNN_STEPS AdamW steps,
    each held to the CPU route at full size (logits, loss, every gradient;
    Cora's a second time with the card's gather-scatter over edge slices of
    GNN_HOLD_SLICE, forward and backward, as ogbn-products' runs over
    ``gnn._EDGE_SLICE``);
    minibatch_lg (Reddit sizes, B 1,024, fanouts 15-10): the sampler on the
    card (ids in range, -1 only at isolated nodes, the first seeds' samples
    in their CSR rows), GNN_STEPS steps of sampling plus ``loss_sampled``,
    the first GNN_HOLD_SEEDS seeds' forward and gradients held to the CPU
    route; ogb_products: ``embeddings_full`` (unit rows) and full-graph
    training steps, with the peak device memory (the gather-scatter over
    edge slices, ``gnn._EDGE_SLICE``: the whole (E, d) message block would
    take 24.7 GB at d 100, 31.7 GB at d 128).  Returns the phase's peak
    device memory."""
    from repro_torch.configs import graphsage_reddit
    from repro_torch.data import graph as gdata
    from repro_torch.models import gnn

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    peak = 0
    for cell in cells or graphsage_reddit.CELLS:
        torch.cuda.reset_peak_memory_stats()
        cfg = graphsage_reddit.make_model(cell)
        gen = torch.Generator(device=dev).manual_seed(GNN_SEED)
        params = gnn.init_params(cfg, gen, device=dev)
        label = f"graphsage {cell.name}"
        if cell.kind == "molecule":
            mb = gdata.make_molecule_batch(gen, cell.batch, cell.get("n_nodes"),
                                           cell.get("n_edges"), cell.get("d_feat"),
                                           cell.get("n_classes"))
            x = (mb["feats"], mb["src"], mb["dst"])
            y = (mb["labels"],)
            what = f"{cell.batch} graphs of {cell.get('n_nodes')} nodes, {cell.get('n_edges')} edges"
            fwd, loss = gnn.forward_batched, gnn.loss_batched
        else:
            t0 = time.perf_counter()
            g = gdata.make_graph(gdata.GraphConfig(
                n_nodes=cell.get("n_nodes"), n_edges=cell.get("n_edges"),
                d_feat=cell.get("d_feat"), n_classes=cell.get("n_classes")), device=dev)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            what = (f"{g.n_nodes:,} nodes, {g.n_edges:,} edges, d {cell.get('d_feat')}; "
                    f"make_graph {host_s:.1f} s (host numpy, then to the card): indices "
                    f"{g.indices.numel() * 4 / 1e6:.0f} MB, features "
                    f"{g.feats.numel() * 4 / 1e6:.0f} MB on the card")
        if cell.kind == "full_graph":
            src, dst = g.edge_list()
            x = (g.feats, src, dst)
            y = (g.labels, torch.ones(g.n_nodes, dtype=torch.float32, device=dev))
            fwd, loss = gnn.forward_full, gnn.loss_full
        if cell.kind in ("full_graph", "molecule"):
            with torch.no_grad():
                out = (gnn.embeddings_full(params, *x, cfg) if cell.name == "ogb_products"
                       else fwd(params, *x, cfg))
                ms, runs = timed(lambda: (gnn.embeddings_full if cell.name == "ogb_products"
                                          else fwd)(params, *x, cfg))
            rows = out.shape[0]
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{label}: non-finite forward")
            if cell.name == "ogb_products":
                norms = torch.linalg.vector_norm(out, dim=-1)
                if float((norms - 1).abs().max()) > 1e-4:
                    raise AssertionError(f"{label}: embeddings not unit rows")
                fwd_what = f"embeddings_full {tuple(out.shape)} unit rows"
                trace = _trace_line(f"{label} embeddings_full ({card})",
                                    lambda: gnn.embeddings_full(params, *x, cfg))
            else:
                fwd_what = f"forward {tuple(out.shape)}"
                trace = ""
            del out
            hold = ""
            if cell.name != "ogb_products":  # the CPU route at full size
                pc, xc, yc = _tree_cpu(params), [t.cpu() for t in x], [t.cpu() for t in y]

                def card_side():
                    with torch.no_grad():
                        lg = fwd(params, *x, cfg)
                    return (lg, *_loss_grads(lambda p: loss(p, *x, *y, cfg), params))

                with torch.no_grad():
                    lg_cpu = fwd(pc, *xc, cfg)
                cpu_side = (lg_cpu, *_loss_grads(lambda p: loss(p, *xc, *yc, cfg), pc))
                hold = _hold_model(f"  {label} held", card_side(), cpu_side)
                if cell.kind == "full_graph":  # the card's aggregate over many edge slices
                    whole = gnn._EDGE_SLICE
                    gnn._EDGE_SLICE = GNN_HOLD_SLICE
                    try:
                        sliced = card_side()
                    finally:
                        gnn._EDGE_SLICE = whole
                    hold += "\n" + _hold_model(
                        f"  {label} held, the card's gather-scatter over "
                        f"{-(-x[1].shape[0] // GNN_HOLD_SLICE)} edge slices of {GNN_HOLD_SLICE:,} "
                        f"forward and backward (the CPU route's in one)", sliced, cpu_side)
            losses, dts, _ = _train_steps(lambda p, _: loss(p, *x, *y, cfg), params,
                                          [{}] * (2 if cell.name == "ogb_products" else GNN_STEPS))
            print(f"{label} ({what}) on {card}: {fwd_what} {ms:.3f} ms (median of {runs}, CUDA "
                  f"events; {rows / ms * 1e3:,.0f} rows/s); AdamW steps {_ms_list(dts)} (host "
                  f"clock), losses {[round(v, 4) for v in losses]}; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (with "
                  f"{held / 1e9:.1f} GB held before the phase)")
            for line in (hold, trace):
                if line:
                    print(line)
        else:  # minibatch: the sampler on the card, sampled training
            fanouts = tuple(cell.get("fanouts"))
            b = cell.batch

            def sample():
                seeds = gdata.batch_seeds(gen, g.n_nodes, b)
                n1, n2 = gdata.sample_two_hop(gen, g.indptr, g.indices, seeds, fanouts)
                return seeds, n1, n2

            seeds, n1, n2 = sample()
            deg = (g.indptr[1:] - g.indptr[:-1])[seeds.long()]
            for blk in (n1, n2):
                if not bool(((blk >= -1) & (blk < g.n_nodes)).all()):
                    raise AssertionError(f"{label}: sampled ids out of range")
            if not torch.equal((n1 < 0).any(-1), deg == 0):
                raise AssertionError(f"{label}: -1 samples at nodes with neighbours")
            ip = g.indptr.cpu().numpy()
            for i in range(16):  # the first seeds' samples lie in their CSR rows
                s_i = int(seeds[i])
                row = set(g.indices[ip[s_i]:ip[s_i + 1]].cpu().tolist())
                if any(v >= 0 and v not in row for v in n1[i].tolist()):
                    raise AssertionError(f"{label}: a sample outside seed {s_i}'s row")
            sample_ms = cuda_ms(sample, runs=5, warmup=1)
            gather_mb = n2.numel() * cfg.d_in * 4 / 1e6
            c = GNN_HOLD_SEEDS
            sub = (seeds[:c], n1[:c], n2[:c])
            feats_cpu, pc = g.feats.cpu(), _tree_cpu(params)
            with torch.no_grad():
                lg_card = gnn.forward_sampled(params, g.feats, *sub, cfg)
                lg_cpu = gnn.forward_sampled(pc, feats_cpu, *(t.cpu() for t in sub), cfg)
            lab = g.labels[seeds[:c].long()]
            hold = _hold_model(
                f"  {label} held ({c} seeds of the card's batch)",
                (lg_card, *_loss_grads(lambda p: gnn.loss_sampled(p, g.feats, *sub, lab, cfg),
                                       params)),
                (lg_cpu, *_loss_grads(lambda p: gnn.loss_sampled(
                    p, feats_cpu, *(t.cpu() for t in sub), lab.cpu(), cfg), pc)))
            del feats_cpu, pc

            def batch():
                s_, a_, b_ = sample()
                return {"seeds": s_, "n1": a_, "n2": b_, "labels": g.labels[s_.long()]}

            losses, dts, _ = _train_steps(
                lambda p, bt: gnn.loss_sampled(p, g.feats, bt["seeds"], bt["n1"], bt["n2"],
                                               bt["labels"], cfg), params, [batch] * GNN_STEPS)
            print(f"{label} ({what}; B {b}, fanouts {fanouts}) on {card}: sampling "
                  f"{sample_ms:.3f} ms (median of 5, CUDA events), hop-2 gather "
                  f"{gather_mb:.0f} MB; AdamW steps of sampling plus loss_sampled "
                  f"{_ms_list(dts)} (host clock), losses {[round(v, 4) for v in losses]}; peak "
                  f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            print(hold)
        peak = max(peak, torch.cuda.max_memory_allocated())
        del params
        if cell.kind != "minibatch":
            del x, y
        if cell.kind != "molecule":
            del g
        gc.collect()
        torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    if left > 1e9:
        raise AssertionError(f"GraphSAGE phase: {left / 1e9:.3f} GB still allocated after it")
    print(f"GraphSAGE phase: {time.perf_counter() - t_phase:.1f} s (host clock, {card}); peak "
          f"device memory {peak / 1e9:.2f} GB")
    return peak



REC_SEED = 39  # the recsys phase's weights and batches
REC_ARCHS = ("fm", "deepfm", "xdeepfm", "dlrm-rm2")  # DLRM last: its training needs ~69 GB
REC_TRAIN = {"fm": (3, 1), "xdeepfm": (2, 8), "dlrm-rm2": (3, 1)}  # steps, microbatches
REC_LR = 1e-3  # AdamW's learning rate at train_batch (1e-2 sends DLRM's loss up)
RETRIEVAL_USERS = 64  # user vectors searched through the fake-words index
RETRIEVAL_DEPTH, RETRIEVAL_K = 100, 10


def _sub_table_route(params, cfg, sparse):
    """The CPU route of a full-size tower on the rows a batch reads: the
    table leaves cut to those rows (in id order) on the CPU, every other
    leaf copied, and a config whose one field holds them (every offset 0),
    so ``forward`` on the remapped ids reads the same rows.  Returns
    (cpu params, cpu config, remapped ids, the rows on the card)."""
    import dataclasses as dc

    from repro_torch.models import recsys as rec

    gidx = cfg.table.globalize(sparse)
    rows, local = torch.unique(gidx, return_inverse=True)
    pc = {k: (v[rows].detach().cpu() if k in ("table", "linear") else _tree_cpu(v)
              if isinstance(v, dict) else v.detach().cpu()) for k, v in params.items()}
    one = rec.TableSpec((0,) * (cfg.n_fields - 1) + (rows.numel(),), cfg.dim)
    return pc, dc.replace(cfg, table=one), local.to(torch.int32).cpu(), rows


def drive_recsys(dev, card: str, tables=None) -> tuple:
    """The four recsys towers at their published tables (``tables`` cuts
    them for a rehearsal), weights drawn from REC_SEED by ``init_params``
    on the card, batches from ``data/recsys.py``: ``forward`` at serve_p99
    (B 512) and serve_bulk (B 262,144; xDeepFM's CIN in
    ``recsys._CIN_ROWS``-row slices) timed; the serve_p99 batch's logits, loss and gradients held to
    the CPU route on the rows it reads (``_sub_table_route``); REC_TRAIN
    AdamW steps at train_batch (B 65,536; xDeepFM in microbatches, the
    reference's mechanism); each tower's peak device memory.  Then
    retrieval_cand on DLRM: ``user_tower`` of RETRIEVAL_USERS users,
    ``retrieval_topk`` over rows [0, 10^6) of its field 0 (B 1, the cell,
    and B 64), those rows indexed by ``FakeWordsConfig(quantization=50)``
    and searched at depth 100 with rerank (K1 classic), the ground truth by
    ``bruteforce.exact_topk`` (K1 f32); the match, the rerank, the truth and
    ``retrieval_topk`` held to the CPU route on the same index and vectors
    (near-tie rule), each kernel call to its plain version; R@(10,100) and
    the reranked R@10.  Returns (the kernels-line entries of K1 classic and
    K1 f32 at this cell, the phase's peak device memory)."""
    import dataclasses as dc

    from repro_torch import configs
    from repro_torch.data import recsys as rec_data
    from repro_torch.models import recsys as rec

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    batches = {}  # (table, cell) -> batch: FM, DeepFM and xDeepFM share one table

    def batch_of(cfg, cell, step=0):
        key = (cfg.table, cfg.n_dense, cell.name, step)
        if key not in batches:
            t0 = time.perf_counter()
            batches[key] = rec_data.batch_at(rec_data.RecsysDataConfig(
                table=cfg.table, batch=cell.batch, n_dense=cfg.n_dense, seed=REC_SEED), step,
                device=dev)
            batches[key]["host_s"] = time.perf_counter() - t0
        return batches[key]

    entries, peak = [], 0
    for arch_id in REC_ARCHS:
        spec = configs.get(arch_id)
        cfg = spec.make_model(None)
        if tables:
            cfg = dc.replace(cfg, table=rec.TableSpec(rec.criteo_row_counts(
                cfg.n_fields, tables), cfg.dim))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = rec.init_params(cfg, torch.Generator(device=dev).manual_seed(REC_SEED),
                                 device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        label = f"recsys {arch_id}"
        serve = {}
        for cell_name in ("serve_p99", "serve_bulk"):
            cell = spec.cell(cell_name)
            bt = batch_of(cfg, cell)
            with torch.no_grad():
                out = rec.forward(params, cfg, bt["sparse"], bt.get("dense"))
                if out.shape != (cell.batch,) or not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"{label} {cell_name}: bad logits {tuple(out.shape)}")
                ms, runs = timed(lambda: rec.forward(params, cfg, bt["sparse"], bt.get("dense")))
            serve[cell_name] = (ms, runs, bt["host_s"])
            del out
        # the serve_p99 batch against the CPU route on the rows it reads
        bt = batch_of(cfg, spec.cell("serve_p99"))
        sp, de, lab = bt["sparse"], bt.get("dense"), bt["label"]
        pc, cfg_c, local, rows = _sub_table_route(params, cfg, sp)
        de_c = de.cpu() if de is not None else None
        with torch.no_grad():
            lg_card = rec.forward(params, cfg, sp, de)
            lg_cpu = rec.forward(pc, cfg_c, local, de_c)
        card_side = (lg_card, *_loss_grads(lambda p: rec.bce_loss(p, cfg, sp, lab, de), params))
        cpu_side = (lg_cpu, *_loss_grads(lambda p: rec.bce_loss(p, cfg_c, local, lab.cpu(), de_c),
                                         pc))
        hold = _hold_model(f"  {label} held (serve_p99 batch; the CPU route on its "
                           f"{rows.numel():,} rows)", card_side, cpu_side,
                           {k: rows for k in ("table", "linear")})
        del card_side, cpu_side, pc, lg_card, lg_cpu
        gc.collect()
        n_bytes = cfg.param_count() * cfg.param_dtype.itemsize
        print(f"{label} on {card}: table {cfg.table.total_rows:,} x {cfg.dim} (field 0 "
              f"{cfg.table.row_counts[0]:,} rows), {cfg.param_count():,} parameters, "
              f"{n_bytes / 1e9:.2f} GB, init_params {init_s:.2f} s; forward "
              + "; ".join(f"{c} B={spec.cell(c).batch:,} {v[0]:.3f} ms (median of {v[1]}, CUDA "
                          f"events; {spec.cell(c).batch / v[0] * 1e3:,.0f} rows/s; batch_at "
                          f"{v[2]:.2f} s host)" for c, v in serve.items())
              + (f"; the CIN in {rec._CIN_ROWS:,}-row slices" if cfg.model == "xdeepfm" else ""))
        print(hold)
        if arch_id == "dlrm-rm2":
            entries = _retrieval_phase(dev, card, spec, cfg, params, batch_of)
        if arch_id in REC_TRAIN:
            steps, micro = REC_TRAIN[arch_id]
            cell = spec.cell("train_batch")
            train_batches = [{k: v for k, v in batch_of(cfg, cell, i).items() if k != "host_s"}
                             for i in range(steps)]
            losses, dts, trace = _train_steps(
                lambda p, b: rec.bce_loss(p, cfg, b["sparse"], b["label"], b.get("dense")),
                params, train_batches, micro,
                f"{label} train step ({card})" if arch_id == "dlrm-rm2" else "", lr=REC_LR)
            print(f"  {label} train_batch (B {cell.batch:,}"
                  f"{f', {micro} microbatches' if micro > 1 else ''}, AdamW lr {REC_LR}, dense table "
                  f"gradient): steps {_ms_list(dts)} (host clock), losses "
                  f"{[round(v, 5) for v in losses]}")
            if trace:
                print("  " + trace)
        peak = max(peak, torch.cuda.max_memory_allocated())
        print(f"  {label}: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
              f"(with {held / 1e9:.1f} GB held before the phase)")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    batches.clear()
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    if left > 1e9:
        raise AssertionError(f"recsys phase: {left / 1e9:.3f} GB still allocated after it")
    print(f"recsys phase: {time.perf_counter() - t_phase:.1f} s (host clock, {card}); peak "
          f"device memory {peak / 1e9:.2f} GB")
    return entries, peak


def _retrieval_phase(dev, card: str, spec, cfg, params, batch_of) -> list:
    """retrieval_cand on DLRM's field 0 (``drive_recsys``)."""
    import dataclasses as dc

    from repro_torch.core import bruteforce, fakewords
    from repro_torch.core import eval as ev
    from repro_torch.core import pipeline as pl
    from repro_torch.core.types import FakeWordsConfig
    from repro_torch.data import recsys as rec_data
    from repro_torch.kernels.common import f32_matmul
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk
    from repro_torch.models import recsys as rec

    cell = spec.cell("retrieval_cand")
    n = min(cell.get("n_candidates"), cfg.table.row_counts[0])
    items = params["table"][:n].detach()  # field 0's rows [0, n): the candidates
    ub = rec_data.batch_at(rec_data.RecsysDataConfig(
        table=cfg.table, batch=RETRIEVAL_USERS, n_dense=cfg.n_dense, seed=REC_SEED), 10_000,
        device=dev)
    with torch.no_grad():
        users = rec.user_tower(params, cfg, ub["sparse"], ub.get("dense"))
    depth, k = RETRIEVAL_DEPTH, RETRIEVAL_K
    items_c, users_c = items.cpu(), users.cpu()

    # retrieval_topk (plain: f32 product + stable_topk) at the cell's B = 1 and at 64
    top_s, top_i = rec.retrieval_topk(users, items, depth)
    want = rec.retrieval_topk(users_c, items_c, depth + 1)
    err_rt = compare("retrieval_topk, card vs CPU route", (top_s, top_i), want, exact=False)
    rt_ms = {bb: timed(lambda: rec.retrieval_topk(users[:bb], items, depth))[0]
             for bb in (cell.batch, RETRIEVAL_USERS)}

    # the fake-words index over the candidates: the main path
    fw = FakeWordsConfig(quantization=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = fakewords.build(items, fw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qn = bruteforce.l2_normalize(users)
    q_tf = fakewords.encode_queries(users, fw)
    _reset_launches()
    s100, i100 = fakewords.search(idx, q_tf, qn, k=depth, depth=depth)
    rr_s, rr_i = fakewords.search(idx, q_tf, qn, k=k, depth=depth, rerank=True)
    torch.cuda.synchronize()
    classic_launches = _only("the retrieval fake-words search", "fused_topk")
    _reset_launches()
    gt_s, gt_i = bruteforce.exact_topk(items, users, k)
    torch.cuda.synchronize()
    f32_launches = _only("the retrieval ground truth", "fused_topk")
    b = users.shape[0]
    for name, (sc, ids, w) in {"match": (s100, i100, depth), "rerank": (rr_s, rr_i, k),
                               "truth": (gt_s, gt_i, k)}.items():
        _checked(f"retrieval {name}", sc, ids, b, w, n)
    r10_100 = float(ev.recall_at(gt_i, i100))
    r_rr = float(ev.recall_at(gt_i, rr_i))

    # each kernel call against its plain version on the card
    qv = fakewords.classic_query(idx, q_tf)
    cn = bruteforce.l2_normalize(items)
    err_classic = compare("retrieval classic match vs plain", (s100, i100),
                          ref.fused_topk_ref(qv, idx.scored, depth + 1), exact=False)
    err_f32 = compare("retrieval f32 truth vs plain", (gt_s, gt_i),
                      ref.fused_topk_ref(qn, cn, k + 1), exact=False)
    # the CPU route on the same index and vectors
    idx_c = dc.replace(idx, **{f.name: getattr(idx, f.name).cpu() for f in dc.fields(idx)
                               if isinstance(getattr(idx, f.name), torch.Tensor)})
    qn_c, q_tf_c = qn.cpu(), q_tf.cpu()
    t0 = time.perf_counter()
    compare("retrieval match, card vs CPU route", (s100, i100),
            fakewords.search(idx_c, q_tf_c, qn_c, k=depth + 1, depth=depth + 1), exact=False)
    compare("retrieval rerank of the card's candidates, card vs CPU route", (rr_s, rr_i),
            pl.default_reranker(idx_c)(idx_c, qn_c, i100.cpu(), k + 1), exact=False)
    compare("retrieval truth, card vs CPU route", (gt_s, gt_i),
            bruteforce.exact_topk(items_c, users_c, k + 1), exact=False)
    cpu_rr = fakewords.search(idx_c, q_tf_c, qn_c, k=k, depth=depth, rerank=True)[1]
    route_overlap = float(ev.overlap(cpu_rr, rr_i.cpu()))
    cpu_s = time.perf_counter() - t0
    if route_overlap < 0.99:
        raise AssertionError(f"retrieval: the CPU route's reranked ids overlap the card's by "
                             f"{route_overlap}")
    search_ms = timed(lambda: fakewords.search(idx, q_tf, qn, k=k, depth=depth, rerank=True))[0]
    gt_ms = timed(lambda: bruteforce.exact_topk(items, users, k))[0]
    print(f"recsys retrieval_cand (dlrm-rm2 field 0 rows [0, {n:,}), dim {cfg.dim}; "
          f"{RETRIEVAL_USERS} users from user_tower) on {card}: retrieval_topk "
          f"B={cell.batch} {rt_ms[cell.batch]:.3f} ms, B={RETRIEVAL_USERS} "
          f"{rt_ms[RETRIEVAL_USERS]:.3f} ms (f32 product + stable sort; vs CPU max_abs_err "
          f"{err_rt:.3g}); fake words Q=50: build {build_s:.2f} s (first call), index "
          f"{idx.nbytes() / 1e6:.0f} MB; search depth {depth} + rerank {search_ms:.3f} ms, "
          f"exact_topk {gt_ms:.3f} ms (CUDA events); R@(10,100) {r10_100:.4f}, reranked R@10 "
          f"{r_rr:.4f}; fused_topk launches: search {classic_launches}, truth {f32_launches}; "
          f"held to the plain versions (classic {err_classic:.3g}, f32 {err_f32:.3g}) and to the "
          f"CPU route on the same index (match, rerank, truth; reranked overlap "
          f"{route_overlap:.4f}; {cpu_s:.1f} s)")

    entries = []
    f32_lib = f"torch.topk(matmul) with allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    for name, q, docs, d, kind, launches, err, lib in (
            ("fused_topk/retrieval_cand", qv, idx.scored, depth, "bf16", classic_launches,
             err_classic, lambda: torch.topk(torch.matmul(qv, idx.scored.T), depth)),
            ("fused_topk/f32-retrieval_cand", qn, cn, k, "f32", f32_launches, err_f32,
             lambda: torch.topk(f32_matmul(qn, cn.T), k))):
        bkind, passes = ("tf32", 3) if kind == "f32" else (kind, 1)
        ms = cuda_ms(lambda: fused_topk(q, docs, d))
        plain_ms = cuda_ms(lambda: ref.fused_topk_ref(q, docs, d))
        lib_ms = cuda_ms(lib)
        bound, bound_by = bound_ms(q, docs, n, d, bkind, passes)
        print(f"{name} ({kind}, B={q.shape[0]}, N={n}, T={q.shape[1]}, depth={d}): kernel "
              f"{ms:.3f} ms, bound {bound:.3f} ms ({bound_by}, {bkind}), plain {plain_ms:.3f} ms, "
              f"library {lib_ms:.3f} ms ({'torch.topk(matmul)' if kind == 'bf16' else f32_lib}); "
              f"launches on the main path {launches}; {card}")
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
            "replaces": "src/repro/kernels/fused_topk/kernel.py:288",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms})
    del idx, idx_c, cn, items_c
    return entries


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
