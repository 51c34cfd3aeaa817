#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--docs N] [--seed S] [--skip rerank,encoders,executor,dataflow,temporal,generate,moe,speculative,vision,lora,train,parallel,sharded,rag,hybrid,persistence,cluster,vector_store]

Phases, each on a line of its own; any failure exits non-zero:

1. card: name and power limit (nvidia-smi), torch and CUDA versions, the
   TF32 flags (set off explicitly), whether ``ml_dtypes`` imports (a bf16
   UDF result enters a column as its ``bfloat16`` array);
2. build: every CUDA kernel of the port, from the sources in this checkout;
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16, at the reference shapes, the main path's and the kernel's edge
   shapes, plus the masking and independence pins; device-only times of
   kernel, plain version and the PyTorch library call at every main-path
   shape (CUDA graphs of many launches, inputs rotated past the L2 cache),
   and the wrapper's host time per call;
4. main path at full all-MiniLM-L6-v2 width (seeded random weights):
   encode a synthetic corpus (65,536 texts by default) in length-sorted
   batches, time one arrival-order pass over a part of it, fill a cosine
   ``BruteForceKnnIndex`` with it, answer one untimed warm-up and 128 timed
   ``search_many`` batches of 64 re-encoded corpus texts at k=10, and check
   the answers; the kernels' launch counts are zeroed just before and read
   just after, every attention shape the run gave the kernel is held
   against the plain version, and the launches are counted per shape;
5. rerank: the retrieve-then-rerank step of the RAG path at full width:
   16,384 chunks of 50-500 words embedded by all-MiniLM-L6-v2 into a
   cosine ``BruteForceKnnIndex``, then one untimed warm-up and 8 timed
   batches of 64 queries (6-20 word perturbed spans of chunks): top-32
   retrieval, the 2,048 (query, chunk) pairs scored by the
   ms-marco-MiniLM-L-6-v2 ``CrossEncoder`` as ``CrossEncoderReranker``
   sends them (``score`` on micro-batches of 256 pairs in arrival order,
   each padded to its longest pair), the 5 best kept; pairs/s and latency split into retrieve and
   rerank; the first batch's scores held to the plain attention path
   within 0.05·(max|ref|+1) and its top-5 sets to the plain path's but
   at near-ties;
6. encoders: 32,768 texts of the main corpus through BGE-base (hd 64,
   its embeddings held to the plain attention path at cosine > 0.999),
   then through all-MiniLM-L6-v2 in bf16 and in W8A8 (min cosine > 0.99,
   top-10 neighbour overlap > 0.85 over 256 queries), emb/s of each;
   phases 5 and 6 count launches per shape like phase 4, and every new
   shape is held to the plain version (in slices of the batch where its
   f32 scores would pass 1 GiB) and timed; phases 4-6 run on the shared
   default executor with its fault rail on, and each fails on any fallback
   batch, classified failure, quarantine or breaker not closed (its
   ``step: executor`` line also gives the run's padding-waste fraction);
7. executor: all-MiniLM-L6-v2 at full width through the port's
   ``DeviceExecutor``, launches counted like phase 4: ``overlap`` (32
   batches of 512 corpus texts tokenized then run by ``run_batch``,
   against ``submit`` with the next batch tokenized while the dispatch
   thread runs the current one: emb/s of each, their ratio, the device's
   idle share from CUDA events around every forward, and the two loops'
   embeddings held together at cosine > 0.999), ``batcher`` (4,096 texts,
   one coroutine each, through ``AsyncMicroBatcher`` at max batch 256 and
   flush delay 0.002 s over ``SentenceEncoder.encode``: emb/s, the batch
   sizes formed, every row held to a direct ``encode``), ``faults`` on the
   card (a real CUDA OOM ratcheting a 512-row batch to cap 64 with the
   unfaulted outputs and the allocated bytes back where they were; an
   injected transient retried once with bitwise-equal rows; a breaker
   tripped onto an explicit CPU MiniLM fallback, held to the card's rows,
   and closed again by the half-open probe with launches resuming; an
   injected hang failed at a 10 s dispatch deadline with the next submit
   served on the card by the fresh dispatch thread, its ms reported),
   ``overhead`` (host µs per dispatch with the rail on and off,
   interleaved, on a trivial callable and a (512, 64) MiniLM dispatch,
   the rail alone with the device call stubbed, and its share
   against the reference's 2% pin, reported and not gated; the trip and
   open-breaker fallback latency) and ``accounting`` (the (512, 64) key's
   counted FLOPs against the analytic count, the achieved TFLOP/s and
   utilization over dispatch seconds, ``device.hbm.bytes_in_use`` against
   ``torch.cuda.memory_allocated``);
7b. dataflow: the Table API and the dataflow core (host engine H1) at
   full all-MiniLM-L6-v2 width, through ``pw.run`` on the shared default
   executor with the rail on: 16,384 synthetic texts keyed by ``doc_id``
   with 64 source ids, staged by ``pw.debug.table_from_rows`` in 8 epochs
   of 2,048 at times 2-16, a ninth retracting 1,024 docs and replacing
   the text of 1,024; an async ``pw.udf`` embeds each row through
   ``AsyncMicroBatcher`` (max batch 256) over ``SentenceEncoder.encode``,
   a ``pw.apply`` scores it against a unit query, a join with the
   64-row sources table and ``groupby(source).reduce(count, sum)``; rows/s,
   host ms per epoch and outside the UDF node, the forwards' device ms and
   the idle share, the batch sizes; the final rows held to a direct
   ``encode`` of the live texts (cosine > 0.999, retracted docs absent,
   replaced texts embedded), counts to a recount and sums within 1e-3,
   no ``ERROR``, the native core loaded, launches counted like phase 4;
7c. temporal: the temporal slice (``pw.temporal``'s windows, behaviors and
   time joins) as a live windowed topic monitor at full BAAI/bge-base-en-v1.5
   width (seeded weights, ``SentenceTransformerEmbedder``, an async UDF
   through ``AsyncMicroBatcher`` at 256): 16,384 texts of 6-60 words at
   int event times over one day, 16 topics drawn Zipf-distributed, fed by
   ``pw.io.python.read`` in event-time order in 64 commits (2% held back
   2-6 commits), each commit sent once the run has taken the one before
   into an epoch; 512 alerts in the commits of their times and 256
   questions in 4 commits of their own.  Sliding windows of an hour every
   10 minutes per topic under ``common_behavior(delay=300, cutoff=600)``
   (count, vector sum, first and last time), hourly tumbling windows under
   ``exactly_once_behavior()``, sessions of max gap 900, each alert's
   events within 300 s by ``interval_join`` (pairs, best dot product),
   each question answered by ``asof_now_join`` against its topic's latest
   sliding window (``argmax_rows``) with the cosine to its centroid.
   Events/s, commit-to-window latency, epochs, host ms per epoch by node
   class, rows dropped by the cutoff, peak buffered rows, columnar bails,
   the forwards' device ms and idle share, batch sizes, launches by shape;
   gated on 256 events re-embedded on the plain attention path (cosine
   > 0.999), the final sliding, hourly and session windows equal to a
   plain Python replay of the epochs the run had (counts, times and
   dropped rows exactly, vector sums within 1e-4 relative), the hourly
   stream equal to the replay's epoch by epoch, the interval join's pairs
   exactly and best dot within 1e-4, every answer the replay's latest
   window at its epoch (score within 1e-4) and never revised, the sliding
   windows assigned by the columnar branches, and the rail still;
8. generate: decoder generation at full mistral-7b-instruct width (seeded
   random bf16 weights): a burst of 16 requests (prompts of 64-896 token
   ids, 128 new tokens, 12 greedy and 4 at temperature 0.7 / top-p 0.9)
   through ``GenerationScheduler`` at the repo's defaults, with tokens/s,
   TTFT and latency; every greedy row held to the dense
   ``DecoderLM.generate_ids`` (parting only at a near-tie), the paged
   path's teacher-forced logits held to the dense path's over 128 steps,
   every sampled token held to its top-p support; then device (CUDA
   graphs) and host ms of a decode tick and a prefill chunk at 8 slots,
   paged attention beside its bound and SDPA, and each op of the decode
   step;
9. moe: mixtral-8x7b-instruct at full width (32 layers, 8 experts, top-2,
   expert FFN 14336) with seeded int8 weights (≈ 46.8 GB) on one card: a
   burst of 8 requests (64-512 prompt ids, 64 new tokens, 6 greedy and 2
   at temperature 0.7 / top-p 0.9) through ``GenerationScheduler`` with
   phase 7's checks against the dense path, the teacher-forced logits
   compared at the steps whose own token took the same experts in both
   paths (top-2 routing parts at near-tied router probabilities when the
   two paths round differently; those steps are counted, beside the dense
   path run against itself row by row); layer 0's ``moe_ffn`` on 64
   random tokens against an f32 per-token loop over each token's own
   top-2 experts (the same experts, relative error < 2e-2), the int8
   ``_mm`` at ``wq`` likewise; decode tick and prefill chunk device/host
   ms beside their bounds, and each op of the MoE FFN at the decode shape
   beside a bf16 product at the ``wq`` shape;
10. speculative: mistral-7b-instruct in bf16 with its int8 draft:
   ``generate_ids_speculative(n_draft=8)`` and greedy ``generate_ids`` on
   the same 8 prompts (64-512 ids, 64 new tokens), rows equal but at
   near-ties; tokens accepted per round, acceptance rate, tokens/s of
   both, and the device ms of the int8 draft's decode step against the
   bf16 one at B=8;
11. vision: siglip-base-patch16-224 at full width (a 12-layer ViT, H 768,
   12 heads, 196 patches of 16×16; the bge-base-en-v1.5 text tower;
   seeded random bf16 weights) through ``MultimodalEncoder``: 2,048 seeded
   uint8 224×224 images at ``max_batch`` 256 and 2,048 texts of the main
   corpus after one untimed batch of each, images/s and texts/s; a batch
   split into host conversion, padding and H2D ms against the forward's
   device ms (CUDA graphs), the device's idle share, and the text tower's
   per-call cast of its f32 kernels; 256 320×320 images through the host
   resize; 64 images and 64 texts held to an f32 run of the same functions
   and weights (min cosine > 0.999), row 2 of a batch of 5 to that image
   alone (> 0.999), ``score`` to ``pairwise_logits`` of its embeddings
   (1e-3); an ``op`` line with the plain vision attention at (256, 196,
   768, 12) beside SDPA and the encoder kernel on the same q, k, v (the
   kernel held to the plain attention at 0.05), outside the counted run;
   then siglip-so400m-patch14-384 (27 layers, H 1152, hd 72, 729
   patches) timed on 512 images beside its FLOP bound;
12. lora: mistral-7b-instruct in bf16 with LoRA adapters of rank 8 on
   ``wq`` and ``wv`` (``b`` seeded at std 0.02): a burst of 8 requests
   (64-512 prompt ids, 64 new tokens, 6 greedy and 2 sampled) through
   ``GenerationScheduler`` over the adapted tree and over the base tree,
   twice each in turns (adapted, base, base, adapted), tokens/s, TTFT and
   latency of each run; the adapted answers held to the
   dense path of the merged tree by phase 7's checks, the adapted greedy
   rows differing from the base rows, zero-init adapters giving the base
   tree's greedy tokens on 4 prompts; device and host ms of a decode tick
   at 8 slots over the base, the adapted and a timing-only rank-16
   adapter on all seven targets, beside the bytes bound;
13. train: training on the card, seeded random weights.  ``contrastive``:
   all-MiniLM-L6-v2 then BAAI/bge-base-en-v1.5 (f32 trees, bf16 compute),
   20 Adam steps of symmetric InfoNCE at temperature 0.05 on 256 fresh
   (query, passage) pairs at seq 128 (a passage is a main-corpus text, its
   query a 6-20 word span of it drawn as phase 5 draws queries); the
   losses finite and the last 5 below the first 5, step 1 in bf16 held to
   f32 compute (|Δloss| ≤ 1e-2·|loss|, gradient cosine > 0.99); pairs/s,
   step ms (host, CUDA events), peak memory.  ``lm_full``:
   mistral-7b-instruct at full width and depth in bf16 with remat and
   fused Adam (bf16 moments), 6 steps on one batch of 4 × 512 ids (lengths
   256-512): finite, falling; remat on against off at 2 layers of full
   width (gradient cosine > 0.9999); tokens/s, step ms, peak memory,
   TFLOP/s at 8·N·tokens.  ``lora``: the same model at full depth with
   rank-8 adapters on wq/wv and remat, 10 steps on one batch of 8 × 512:
   every base leaf's checksum unchanged, every b moved, the loss falling,
   Adam's moments 2 × the adapter bytes; the state saved after step 5,
   restored into a fresh state and run 5 steps (losses within 1e-3
   relative of the run's); then 4 greedy prompts served by the trained
   tree, held to the merged tree's dense path by phase 8's checks.
   ``moe``: the MoE layer at mixtral-8x7b width (8 experts, top-2,
   capacity factor 2.0, bf16), 10 Adam steps of the denoising regression
   on 4,096 fresh tokens each: falling, aux finite; step ms and the share
   of assignments dropped at capacity.

14. parallel: the multi-device layer (``parallel/``,
   ``models/long_context.py``) as a world of one in this process, its
   group made by ``make_mesh`` over NCCL.  ``index``: 2,097,152 seeded unit
   rows × 384 stored in bf16 (1.61 GB) in a ``ShardedDeviceIndex``, a mesh
   ``DeviceIndexCache`` through ``topk_search_cached`` and the
   single-device cache, one untimed then 128 timed batches of 64 queries
   at k=10, each with 8 planted corpus rows, the three paths in turns:
   planted rows first, ids equal to the single-device answers but at
   near-ties, scores within 1e-2 of f32, p50/p99 ms beside the bytes
   bound.  ``ring``: ``ring_encoder_attention`` at
   ``tests/test_ring_attention.py``'s shapes in bf16 with a masked tail of
   10%, against the plain attention (0.05) and at (1, 2048, 384, 12) the
   f32 truth (0.06), the masked-key pin (1e-3), device ms beside SDPA.
   ``long_context``: ``LongContextSentenceEncoder`` (all-MiniLM-L6-v2,
   seeded) on 4,096 main-corpus texts and 64 texts of 1,000-3,000 words
   (cut at 512 ids at world 1) against ``SentenceEncoder`` on the same
   weights (cosine > 0.99), padding invariance (0.02), emb/s of both and
   the ms of one (64, 512) forward of each.
15. sharded: tensor-, data-, expert- and pipeline-parallel
   (``models/decoder.py``'s TP layout, ``parallel/train.py``,
   ``moe.py``, ``pipeline.py``, ``checkpoint.py``, ``dryrun.py``) as a
   world of one in this process over NCCL, every gate held to the
   unsharded or single-device form on the same seeded weights.
   ``tp_serve``: mistral-7b-instruct at full width and depth in bf16
   placed by ``tp_param_specs``: ``prefill`` of 8 prompts of 64-896 ids
   and 31 ``decode_step`` calls, the logits teacher-forced on the
   unsharded greedy tokens within the near-tie tol of each step and the
   sharded greedy tokens within tol of the unsharded max (``[generate]``'s
   gates), ms per prefill and per decode step of both (CUDA events) and
   of the placed leaves re-checked on every call, host µs per view.
   ``tp_moe``: the MoE decoder at mixtral-8x7b-instruct width, depth cut
   to 2 layers, its experts over ``model``, 4 prompts of 64-512 ids and
   16 steps, the same gates.  ``train``: the contrastive step (MiniLM, 256
   pairs × 128, ``make_mesh(1)``), the causal-LM step (mistral-7b width, 8
   layers, 4 × 512, remat) and the EP MoE step (one mixtral-width layer,
   4,096 tokens, ``make_ep_mesh(1)``), each against its single-device form
   on the same tree and batches: step-0 loss within 1e-3 relative,
   gradient cosine > 0.999 and relative L2 < 0.045, 5 steps falling, step ms (host, CUDA events)
   and the sharded/device ratio.  ``pp``: ``make_pp_train_step`` at
   mistral-7b width, 8 layers, one stage, ``n_micro`` 4, 8 × 512 ids, 6
   steps, step 0 held to the causal-LM step's.  ``checkpoint``: a
   mesh-placed LoRA state saved through ``torch.distributed.checkpoint``
   after step 3 and resumed, the resumed losses bit-equal.  ``dryrun``:
   ``dryrun_multichip(1)`` on the card.
15b. rag: BASELINE.md's Adaptive RAG template served over ``pw.io.http``
   (the REST surface and the answering half of the LLM xpack):
   ``AdaptiveRAGQuestionAnswerer(JaxChat("mistral-7b-instruct",
   max_new_tokens=64, max_cache=4096))`` (seeded bf16 weights, through the
   continuous-batching scheduler; 2 starting documents, factor 2, 4
   iterations) over a ``DocumentStore`` of 2,048 files of 100-1,000 words
   read by ``pw.io.fs.read(mode="static")`` (``ParseUtf8``,
   ``TokenCountSplitter()``, MiniLM through ``SentenceTransformerEmbedder``
   at 256, a cosine ``BruteForceKnn``), behind ``build_server`` and
   ``run_server(threaded=True, with_cache=False)``, with admission set to
   16 in flight and 8 queued.  A standard-library client, 16 threads:
   16 /v1/retrieve questions at k=10 with one /v1/statistics and one
   /v2/list_documents; the 16 questions (8-32 words) to /v1/pw_ai_answer
   with 2 /v1/pw_ai_summary text lists; malformed JSON (400), an unknown
   route (404), a 1 ms ``X-Pathway-Deadline-Ms`` (504); a burst of 40
   summaries (429 with ``Retry-After`` past the budget); then a Table
   program on the same store retrieves the 16 documents of each question
   and scores the 256 pairs with ``CrossEncoderReranker``
   (ms-marco-MiniLM-L-6-v2) and ``rerank_topk_filter(k=5)``; the client
   closes the server, which ends the run.  Latency by route, TTFT and
   tokens/s, admission queue wait, the median of each request-trace span,
   host ms per epoch, the forwards' and decoder calls' device ms and idle
   share, launches by shape; gated on every status, /v1/retrieve against a
   direct ``encode`` + f32 ``torch.topk`` (as phase 16), every answer the
   decoded scheduler tokens of a first-round prompt that is the
   template's literal text over its two best documents, those tokens the
   dense greedy row but at near-ties, no prompt cut to the cache, the
   rerank scores within 0.05·(max|ref|+1) of a direct ``score`` and the
   kept sets theirs but at ties, the socket closed, and the rail still.
15c. hybrid: BASELINE.md's fourth configuration, the index slice
   (``stdlib/indexing``'s BM25, HNSW and hybrid index):
   ``DocumentStore(docs, HybridIndexFactory([UsearchKnnFactory(
   SentenceTransformerEmbedder("all-MiniLM-L6-v2")), TantivyBM25Factory()]))``
   (reciprocal rank fusion at k 60; HNSW M 16, efC 128, ef 64, on the
   host in the native core), ``ParseUtf8`` and ``TokenCountSplitter()``
   over 1,024 files of 100-1,000 words drawn Zipf-distributed (exponent
   1.0) over the 20,000-word vocabulary, fed by ``pw.io.python.read`` in
   one commit; 128 questions of 8-32 words (spans of chunks, a quarter of
   the words swapped) in 4 commits of 32 through ``retrieve_query`` at
   k 16, the 2,048 (question, document) pairs reranked by
   ``CrossEncoderReranker`` (ms-marco-MiniLM-L-6-v2) and
   ``rerank_topk_filter(k=5)``; then one commit deletes 64 files and
   rewrites 64 while the questions stand, and the engine re-answers them
   one search at a time.  Ingest chunks/s, retrieve latency from commit
   to answer, host ms per search in HNSW, BM25 and the fusion, searches
   run and answers revised after the change with the time to the last,
   rerank pairs/s, the forwards' device ms and idle share, launches by
   shape; gated on the stored embeddings against the plain attention path
   (cosine > 0.999), HNSW recall@48 ≥ 0.9 against the exact f32 top-48 of
   its stored vectors with scores within 1e-4, BM25 equal to a plain
   numpy BM25 but at exact ties (1e-9 relative), every fused list the RRF
   of its inner lists, before and after the change; the final answers
   their last search and free of removed chunks; the rerank within
   0.05·(max|ref|+1) of the plain path, the kept 5 its top 5 but at
   near-ties; ``NativeHnswIndex`` serving and the rail still.

15d. persistence: one worker's storage path (``pw.persistence``, input
   and operator snapshots, the UDF ``DiskCache``) at full
   all-MiniLM-L6-v2 width with seeded weights.  ``resume``, in this
   process: ``[dataflow]``'s program (an async ``pw.udf`` through
   ``AsyncMicroBatcher``, the select, join and groupby) over
   ``pw.io.jsonlines.read(mode="static", name="docs")`` of 8,192 texts
   in 8 files; run 1 reads 6 files to a clean finish on a fresh root, 2
   files are added and run 2 resumes on it, in ``PERSISTING`` (the UDF
   under ``DiskCache``) and in ``OPERATOR_PERSISTING``; one unbroken run
   over the 8 files without persistence is the reference.  Gated on run
   2's net sink state against the unbroken run's (keys, ids, names and
   counts exact, vectors at cosine > 0.999, scores and sums within 1e-2
   and 1e-3 relative) and on run 2 embedding exactly the 2,048 texts run 1
   did not, counted at the forwards: every replayed row a cache hit
   (input mode), ``replay_into`` 0 and the input taking only the new rows
   (operator mode); run 2's wall s against the unbroken run's, the bytes
   and generations under the root, ``CommitMetrics`` and the forwards.
   ``crash``, in two spawned children: ``VectorStoreServer(docs,
   embedder=<async pw.udf under DiskCache over the
   SentenceTransformerEmbedder batcher>, splitter=TokenCountSplitter())
   .run_server(..., with_cache=True, cache_backend=filesystem(root))``
   over ``pw.io.fs.read(mode="streaming", format="binary",
   with_metadata=True)``: the corpus (1,024 files of ``[vector_store]``'s
   generator) written in batches of 128, child 1 SIGKILLed once
   ``/v1/statistics`` shows 512 files, 64 files added, child 2 started on
   the same root; once it shows all 1,088 files, 64 ``/v1/retrieve``
   queries at k 10, then it closes.  Gated on the answers against a direct
   ``encode`` and f32 ``torch.topk`` (as phase 16), on child 2 embedding
   exactly the chunks that had no cache entry when it started (keys
   computed here by ``DiskCache._cache_key``) and the queries, and on both
   children launching the kernel (their launches and shapes come back in
   a JSON file each and join the kernel line); child 2's time to its first
   answer and to a full index, the cache hit share, the chunks each child
   embedded and the time from the kill to the answers;
15e. cluster: more than one worker (``engine/comm.py``'s TCP mesh,
   ``engine/supervisor.py``, ``engine/standby.py``) at full
   all-MiniLM-L6-v2 width with seeded weights: part A's program of
   ``[persistence]`` (the async embedder UDF through ``AsyncMicroBatcher``,
   the score, a join with the sources and the per-source groupby, into
   jsonlines sinks, one ``.part-N`` a worker) over 16,384 texts of its
   generator from a ``pw.io.python`` subject that commits every 256 (64
   epochs) and ends; the subject is read on worker 0 and the exchange
   scatters its rows.  Run A is one worker in this process; runs B-D are
   ``python -m pathway_tpu_torch spawn -n 2`` (fresh interpreters, started
   together, each loading MiniLM and then running on its go file, one run
   at a time): B unbroken; C ``--supervise --checkpoint-root`` with input
   snapshots and ``PATHWAY_FAULT_PLAN`` SIGKILLing worker 1 at its epoch
   24; D as C with ``--standbys 1``, worker 1 SIGKILLed from here once
   6,144 texts are embedded (an epoch spec would fire again in the
   promoted standby, whose epochs count from 0 and whose attempt stays 0).
   Rows/s of A and B, each worker's texts, forwards, device ms (CUDA
   events), idle share and peak memory; C's and D's seconds from the kill
   to the first output after it and to the end, the texts embedded after
   the restart, the generations under the root.  Gated on each run's net
   state against A's (keys, ids, names and counts exact, vectors at
   cosine > 0.999, scores and per-source sums within 1e-4, each sum its
   docs' scores), B's workers embedding exactly 16,384 texts, C's SIGKILL
   and group restart (a crash dump of worker 1, the last attempt ending
   clean), D's promotion with worker 0 one process throughout, a clean
   ``scrub`` of C's and D's roots, no worker running ``nvcc``, and every
   worker process launching the kernel once per layer of each forward,
   each shape it gave held to the plain attention;
16. vector_store: the connectors and the retrieval half of the LLM xpack,
   last (its streaming fs reader polls on after the run, as the JAX
   package's does): ``VectorStoreServer`` over
   ``SentenceTransformerEmbedder("all-MiniLM-L6-v2")`` (seeded weights,
   the shared default executor, batches of up to 256),
   ``TokenCountSplitter()``, ``ParseUtf8`` and a cosine ``BruteForceKnn``,
   fed by ``pw.io.fs.read(mode="streaming", format="binary",
   with_metadata=True)`` over 1,024 files of 100-1,000 words and queried
   through ``pw.io.python.read``, its answers, its chunk table and its
   statistics read by ``pw.io.subscribe``: once the corpus is indexed, 16
   batches of 64 queries at k=10 (8-32 word spans of live chunks with a
   quarter of the words swapped), each committed and answered before the
   next; 512 live changes (256 files added, 128 deleted, 128
   rewritten) in 8 bursts 0.25 s apart; once the statistics show 1,152
   files and every change has shown in the chunk table, 16 more batches;
   the answers' subscriber ends the run with an exception of the phase's
   own at the last query's first answer.  Ingest chunks/s and docs/s, host
   ms per epoch, the forwards' device ms and idle share, batch sizes, the
   padding share of the ids embedded, query latency, staleness of the
   changes, launches by shape; gated on the file count, no answer naming
   a change already seen, the answers against a direct ``encode`` of
   every chunk and query with f32 cosine scores and ``torch.topk`` (stage
   1's first answers on the initial corpus, every last answer on the
   final one; ids equal but at ties within 1e-2, scores within 1e-2), no
   ``ERROR``, the native core loaded and the rail still.

Phases 8-15 run one model at a time; the encoder kernel is on none of
their paths, and its launches there are counted and must be 0.
``--skip`` leaves out the named phases of 5-16, 7b, 7c, 15b-15e (all run by default), to
time one phase without the ones before it in the same process.  Then the total
seconds, one JSON line with every kernel's numbers, and last the line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  It imports nothing of JAX or of ``pathway_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import functools
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense
ATTN_TOL = 0.05  # the JAX package's own kernel-vs-XLA pin (bf16 probabilities)
PIN_TOL = 1e-3  # masked keys and other sequences must not move the output
SCORE_TOL = 1e-2  # bf16-stored index vs f32 scores of the same vectors
COS_MIN = 0.999


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls between
    two CUDA events: host enqueue time included, for work far longer than
    its launch (a whole forward)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(calls, reps: int = 40, replays: int = 5) -> float:
    """Device-only ms per call: ``reps`` calls, cycling through ``calls``
    (one per input copy), captured in one CUDA graph and replayed after a
    warm-up; the median of ``replays`` replays between CUDA events."""
    for call in calls:  # warm-up outside the capture: builds, loads, configures
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


def host_us(fn, calls: int = 200) -> float:
    """Host µs per call of ``fn`` (argument checks, allocation, launch),
    from the host clock around ``calls`` calls that do not wait for the
    device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


# ---------------------------------------------------------------------------
# Phase 3: encoder-attention kernel against its plain version.
# ---------------------------------------------------------------------------

REFERENCE_SHAPES = [  # tests/test_attention_kernel.py's shapes
    (4, 64, 384, 12),
    (2, 128, 768, 12),
    (8, 16, 384, 12),
    (1, 256, 1024, 16),
    (3, 64, 384, 12),
]
MAIN_SHAPE = (512, 64, 384, 12)  # all-MiniLM-L6-v2 at max_batch 512, seq bucket 64
EXTRA_SHAPES = [
    (512, 16, 384, 12),  # the main path's corpus batches at seq buckets 16 and 32
    (512, 32, 384, 12),
    (64, 16, 384, 12),  # its 64-query batches
    (64, 32, 384, 12),
    (64, 64, 384, 12),
    (16, 512, 384, 12),  # the largest seq bucket
    (2, 128, 1024, 8),  # hd=128, the widest head the kernel takes
]
EDGE_SHAPES = [  # the edges of the kernel's work plan
    (4, 1, 384, 12),  # S=1: one real row in a 16-row tile
    (8, 24, 384, 12),  # S not a multiple of 16: two sequences of 32 rows per item
    (3, 48, 256, 8),  # 48 rows per item, hd=32, two head groups
    (3, 100, 384, 12),  # S > 64 and not a multiple of 64: a short last key chunk
    (1, 64, 384, 12),  # B=1
    (1, 16, 384, 12),  # B=1 where an item packs four sequences
    (513, 16, 384, 12),  # B not a multiple of the sequences per item
    (5, 64, 96, 3),  # H not a multiple of 128: one 96-column group
    (8, 32, 768, 12),  # hd=64, packed
    (6, 16, 1024, 8),  # hd=128, packed
]
TIMED_SHAPES = [  # the main path's attention shapes (PERF.md section 5)
    (512, 16, 384, 12),
    (512, 32, 384, 12),
    (512, 64, 384, 12),
    (64, 64, 384, 12),
]
L2_BYTES = 50 * 2**20  # H100
PLAIN_SLICE_BYTES = 2**30  # the plain version's f32 scores per call, at most


def plain_rows(shape) -> int:
    """Sequences per call of the plain version at ``shape``: the whole batch
    where its f32 scores ``[B, heads, S, S]`` fit in ``PLAIN_SLICE_BYTES``,
    else the largest power of two of sequences that does (64 at S=512 with
    12 heads, where the whole (512, 512) batch would need 6.4 GB)."""
    B, S, _, heads = shape
    fit = max(1, PLAIN_SLICE_BYTES // (heads * S * S * 4))
    return B if fit >= B else 1 << (fit.bit_length() - 1)


def plain_attention(q, k, v, mask, heads):
    """The plain version over the batch in slices of ``plain_rows``."""
    from pathway_tpu_torch.ops.attention import encoder_attention_reference

    B, S, H = q.shape
    rows = plain_rows((B, S, H, heads))
    if rows >= B:
        return encoder_attention_reference(q, k, v, mask, heads)
    return torch.cat([
        encoder_attention_reference(q[i : i + rows], k[i : i + rows], v[i : i + rows], mask[i : i + rows], heads)
        for i in range(0, B, rows)
    ])


def fused_qkv(gen, B, S, H, device):
    """q, k, v as column views of one ``[B*S, 3H]`` tensor (row stride 3H),
    as the trunk's fused QKV projection leaves them."""
    qkv = torch.randn((B * S, 3 * H), generator=gen, device=device).to(torch.bfloat16)
    return tuple(qkv[:, i * H : (i + 1) * H].reshape(B, S, H) for i in range(3))


def padded_mask(B, S, device):
    mask = torch.zeros((B, S), device=device)
    mask[:, int(S * 0.8) :] = -1e9  # padded tail keys
    if B > 1:
        mask[-1, :] = -1e9  # an all-padding row, as the executor's batch padding makes
    return mask


def check_attention_shape(gen, shape, device) -> float:
    """Kernel against the plain version at ``shape`` = (B, S, H, heads), with
    q, k, v contiguous and as views of a fused QKV tensor, padded tail keys
    and an all-padding row; returns the larger max abs err of the two.  The
    plain version runs in slices of ``plain_rows(shape)`` sequences."""
    from pathway_tpu_torch.ops.attention import encoder_attention

    B, S, H, heads = shape
    worst = 0.0
    for layout in ("contiguous", "fused_qkv"):
        q, k, v = fused_qkv(gen, B, S, H, device)
        if layout == "contiguous":
            q, k, v = (t.contiguous() for t in (q, k, v))
        mask = padded_mask(B, S, device)
        out = encoder_attention(q, k, v, mask, heads)
        ref = plain_attention(q, k, v, mask, heads)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"attention {shape} {layout}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        log("kernels", shape=list(shape), layout=layout, max_abs_err=err, plain_rows=plain_rows(shape))
        if err >= ATTN_TOL:
            fail(f"attention {shape} {layout}: max abs err {err}")
        worst = max(worst, err)
    return worst


def time_attention_shape(gen, shape, device) -> dict:
    """Device-only ms of kernel, plain version and ``scaled_dot_product_attention``
    at ``shape``, on q, k, v as views of fused QKV tensors, with enough
    input copies in rotation to exceed the L2 cache; the bound from the
    shape; and the wrapper's host µs per call.  The plain version runs in
    slices of ``plain_rows(shape)`` sequences, one after the other."""
    from pathway_tpu_torch.ops.attention import encoder_attention

    B, S, H, heads = shape
    hd = H // heads
    operand_bytes = 4 * B * S * H * 2 + B * S * 4  # q, k, v read; ctx written; bias read
    copies = max(2, -(-2 * L2_BYTES // operand_bytes))
    inputs = [(*fused_qkv(gen, B, S, H, device), padded_mask(B, S, device)) for _ in range(copies)]
    sdpa_inputs = [
        (*(t.reshape(B, S, heads, hd).transpose(1, 2) for t in (q, k, v)),
         mask.to(torch.bfloat16)[:, None, None, :])
        for q, k, v, mask in inputs
    ]
    kernel = [lambda x=x: encoder_attention(*x, heads) for x in inputs]
    plain = [lambda x=x: plain_attention(*x, heads) for x in inputs]
    library = [
        lambda x=x: torch.nn.functional.scaled_dot_product_attention(x[0], x[1], x[2], attn_mask=x[3])
        for x in sdpa_inputs
    ]
    t_bytes = operand_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * B * S * S * H / BF16_FLOPS_PER_S * 1e3
    row = {
        "shape": list(shape),
        "ms": device_ms(kernel),
        "plain_ms": device_ms(plain),
        "library_ms": device_ms(library),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "input_copies": copies,
        "plain_rows": plain_rows(shape),
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    log("kernels", timed=list(shape), **{k: v for k, v in row.items() if k != "shape"})
    us = host_us(kernel[0])
    log("kernels", shape=list(shape), wrapper_host_us_per_call=us)
    row["host_us"] = us
    return row


def attention_phase(device) -> tuple[dict, dict, dict]:
    """The kernel line's entry for encoder attention, the max abs err at
    each shape checked, and the times at each main-path shape."""
    from pathway_tpu_torch.ops.attention import encoder_attention

    gen = torch.Generator(device=device).manual_seed(0)
    checked = {}
    for shape in REFERENCE_SHAPES + [MAIN_SHAPE] + EXTRA_SHAPES + EDGE_SHAPES:
        checked[shape] = check_attention_shape(gen, shape, device)
    worst = max(checked.values())

    # a masked key must not influence any query's context
    B, S, H, heads = 2, 64, 384, 12
    q, k, v = fused_qkv(gen, B, S, H, device)
    mask = torch.zeros((B, S), device=device)
    mask[:, 32:] = -1e9
    out1 = encoder_attention(q, k, v, mask, heads)
    k2, v2 = k.clone(), v.clone()
    k2[:, 32:, :] = 99.0
    v2[:, 32:, :] = -99.0
    out2 = encoder_attention(q, k2, v2, mask, heads)
    pin = (out1.float() - out2.float()).abs().max().item()
    log("kernels", pin="masked_keys", max_abs_diff=pin)
    if pin >= PIN_TOL:
        fail(f"masked keys moved the output by {pin}")

    # a sequence's output does not depend on the other sequences of the batch
    B, S, H, heads = 8, 16, 384, 12
    q, k, v = fused_qkv(gen, B, S, H, device)
    mask = torch.zeros((B, S), device=device)
    full = encoder_attention(q, k, v, mask, heads)
    solo = encoder_attention(q[:1], k[:1], v[:1], mask[:1], heads)
    pin = (full[0].float() - solo[0].float()).abs().max().item()
    log("kernels", pin="cross_sequence", max_abs_diff=pin)
    if pin >= PIN_TOL:
        fail(f"sequences leak into each other: {pin}")

    timed = {shape: time_attention_shape(gen, shape, device) for shape in TIMED_SHAPES}
    main = timed[MAIN_SHAPE]
    return {
        "name": "encoder_attention",
        "route": "cuda",
        "source": "pathway_tpu_torch/ops/csrc/encoder_attention.cu",
        "replaces": "pathway_tpu/ops/attention.py:259",
        "launches": None,  # filled from the main path's run
        "max_abs_err": worst,
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": list(MAIN_SHAPE),
    }, checked, timed


# ---------------------------------------------------------------------------
# Phase 4: the embed-and-retrieve main path.
# ---------------------------------------------------------------------------


def synthetic_corpus(n: int, seed: int, words_per_text: tuple[int, int] = (6, 60)):
    """``n`` texts of 6-60 words (or ``words_per_text``) over a 20,000-word
    synthetic vocabulary drawn from ``seed``: the texts, their lengths in
    words, each text's word ids and the vocabulary."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    word_lens = rng.integers(3, 10, size=20000)
    vocab = ["".join(rng.choice(letters, size=int(n_))) for n_ in word_lens]
    lengths = rng.integers(words_per_text[0], words_per_text[1] + 1, size=n)
    words = rng.integers(0, len(vocab), size=int(lengths.sum()))
    texts, ids, at = [], [], 0
    for length in lengths:
        ids.append(words[at : at + length])
        texts.append(" ".join(vocab[w] for w in ids[-1]))
        at += length
    return texts, lengths, ids, vocab


def record_launches(encoder, seen: dict):
    """Add ``encoder``'s attention launches per shape (B, S, H, heads) to
    ``seen``: one per layer of each forward its model runs."""
    cfg = encoder.config

    def hook(_module, args):
        shape = (*args[0].shape, cfg.hidden, cfg.heads)
        seen[shape] = seen.get(shape, 0) + cfg.layers

    return encoder.model.register_forward_pre_hook(hook)


def encode_sorted(enc, texts, order) -> tuple[np.ndarray, float]:
    """``enc.encode`` over ``texts`` in length-sorted batches of
    ``max_batch``: the embeddings in the texts' order, and the seconds."""
    embs = np.empty((len(texts), enc.dimensions), np.float32)
    t0 = time.perf_counter()
    for start in range(0, len(texts), enc.max_batch):
        ids = order[start : start + enc.max_batch]
        embs[ids] = enc.encode([texts[i] for i in ids])
    return embs, time.perf_counter() - t0


def main_path(device, docs: int, seed: int, checked: dict, model: str = "all-MiniLM-L6-v2",
              query_batches: int = 128, batch_queries: int = 64, k: int = 10,
              arrival_docs: int = 65536) -> dict:
    """Drive the main path; ``checked`` maps each attention shape that phase 3
    held against the plain version to its max abs err, and gains the shapes
    this run gave the kernel that phase 3 had not checked.  Returns the
    launches per kernel and, for attention, per shape."""
    import pathway_tpu_torch as pt
    from pathway_tpu_torch.models.encoder import fused_sentence_apply
    from pathway_tpu_torch.models.tokenizer import bucket_seq_len, pad_batch
    from pathway_tpu_torch.ops.attention import (
        encoder_attention,
        encoder_attention_reference,
    )

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    texts, lengths, _, _ = synthetic_corpus(docs, seed)
    log("main", step="corpus", docs=docs, seconds=time.perf_counter() - t0)

    # the encoder and the index run on the card by default; the keyword is
    # passed only where a CPU rehearsal asks for the host
    kw = {} if on_card else {"device": device}
    enc = pt.SentenceEncoder(model, seed=seed, **kw)
    index = pt.BruteForceKnnIndex(pt.DistanceMetric.COS, **kw)
    order = np.argsort(lengths, kind="stable")  # length-sorted batches: buckets 16/32/64
    arrival = min(arrival_docs, docs)
    query_batches = min(query_batches, docs // batch_queries - 1)
    rng = np.random.default_rng(seed + 1)
    picks = rng.choice(docs, size=(query_batches + 1, batch_queries), replace=False)
    cfg = enc.config
    seen: dict[tuple, int] = {}  # attention launches per shape
    record_launches(enc, seen)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # ---- the counted run: counts zeroed just before, read just after ----
    encoder_attention.launches = 0
    forwards_before = enc.forward_batches
    sync()
    embs, encode_s = encode_sorted(enc, texts, order)
    # a stream encodes texts as they arrive: nearly every batch pads to the
    # longest seq bucket
    t0 = time.perf_counter()
    arrival_embs = np.concatenate([
        enc.encode(texts[start : min(start + enc.max_batch, arrival)])
        for start in range(0, arrival, enc.max_batch)
    ])
    sync()
    arrival_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(docs):
        index.add(i, embs[i])
    index.search(embs[0], k)  # builds and uploads the device index
    sync()
    index_s = time.perf_counter() - t0
    latencies, answers, queries = [], [], []
    for n, batch in enumerate(picks):
        t0 = time.perf_counter()
        q = enc.encode([texts[i] for i in batch])
        res = index.search_many([(q[j], k, None) for j in range(len(batch))])
        if n:  # the first batch warms up and is not timed
            latencies.append((time.perf_counter() - t0) * 1e3)
        answers.append(res)
        queries.append(q)
    launches = {"encoder_attention": encoder_attention.launches}
    forwards = enc.forward_batches - forwards_before
    # ---- end of the counted run ----

    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    buckets = {}
    for n in lengths:
        b = bucket_seq_len(int(n) + 2)
        buckets[b] = buckets.get(b, 0) + 1
    log("main", step="encode", order="length-sorted", docs=docs, seconds=encode_s,
        emb_per_s=docs / encode_s, seq_buckets=buckets, forward_batches=forwards,
        peak_mem_gb=peak_gb)
    log("main", step="encode", order="arrival", docs=arrival, seconds=arrival_s,
        emb_per_s=arrival / arrival_s)
    log("main", step="index", rows=docs, seconds=index_s)
    log("main", step="query", batches=len(latencies), warmup_batches=1,
        queries_per_batch=batch_queries, k=k,
        latency_ms_p50=float(np.percentile(latencies, 50)),
        latency_ms_p99=float(np.percentile(latencies, 99)),
        latency_ms_max=float(np.max(latencies)))

    if not np.isfinite(embs).all() or embs.shape != (docs, cfg.hidden):
        fail(f"embeddings: shape {embs.shape} or non-finite values")
    # on the CPU (a rehearsal) the wrapper runs the plain version and counts nothing
    expected = cfg.layers * forwards if on_card else 0
    if launches["encoder_attention"] != expected:
        fail(f"attention launches {launches['encoder_attention']} != {expected} "
             f"({cfg.layers} layers x {forwards} forward batches)")
    by_shape = dict(seen) if on_card else {}
    if sum(by_shape.values()) != launches["encoder_attention"]:
        fail(f"attention launches per shape {by_shape} do not add up to "
             f"{launches['encoder_attention']}")
    # padding to another seq bucket must not move an embedding
    arrival_cos = float((arrival_embs * embs[:arrival]).sum(axis=1).min())
    if arrival_cos <= COS_MIN:
        fail(f"arrival-order vs length-sorted embeddings: min cosine {arrival_cos}")

    # answers against plain f32 scores of the same vectors, on the device
    corpus = torch.from_numpy(embs).to(device)
    corpus = corpus / corpus.norm(dim=1, keepdim=True).clamp_min(1e-12)
    worst_score, self_first = 0.0, 0
    for batch, q, res in zip(picks, queries, answers):
        if any(len(hits) != k for hits in res):
            fail(f"a query of batch {batch[:4]}... got fewer than {k} hits")
        qt = torch.from_numpy(q).to(device)
        qt = qt / qt.norm(dim=1, keepdim=True).clamp_min(1e-12)
        ids = torch.tensor([[h[0] for h in hits] for hits in res], device=device)
        got = torch.tensor([[h[1] for h in hits] for hits in res], device=device)
        plain = torch.einsum("qkd,qd->qk", corpus[ids], qt)
        worst_score = max(worst_score, (got - plain).abs().max().item())
        own = (corpus[torch.from_numpy(batch).to(device)] * qt).sum(dim=1)
        first = ids[:, 0] == torch.from_numpy(batch).to(device)
        ok = first | (own >= got[:, 0] - SCORE_TOL)
        self_first += int(ok.sum())
        if not bool(ok.all()):
            j = int((~ok).nonzero()[0])
            fail(f"query {batch[j]}: own document scores {own[j].item()}, top hit {res[j][0]}")
    if worst_score >= SCORE_TOL:
        fail(f"returned scores differ from plain f32 scores by {worst_score}")

    # every attention shape this run gave the kernel, against the plain version
    if on_card:
        gen = torch.Generator(device=device).manual_seed(seed)
        for shape in sorted(set(seen) - set(checked)):
            checked[shape] = check_attention_shape(gen, shape, device)
    log("main", step="shapes", attention_shapes=sorted(seen),
        launches={str(list(sh)): n for sh, n in sorted(by_shape.items())},
        max_abs_err={str(list(sh)): checked[sh] for sh in sorted(seen) if sh in checked})

    # the kernel path against the plain attention, on the same 64 texts
    sample = [texts[i] for i in picks[0]]
    id_lists = [enc.tokenizer.encode(t) for t in sample]
    ids, mask = pad_batch(id_lists, bucket_seq_len(max(len(x) for x in id_lists)))
    ids_t, mask_t = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    tree = enc.model.tree()
    with torch.inference_mode():
        fast = fused_sentence_apply(tree, ids_t, mask_t, enc.config, attention=encoder_attention)
        plain = fused_sentence_apply(tree, ids_t, mask_t, enc.config, attention=encoder_attention_reference)
    cos = torch.nn.functional.cosine_similarity(fast, plain, dim=1).min().item()
    log("main", step="check", max_score_err=worst_score, own_doc_first=self_first,
        attention_launches=launches, forward_batches=forwards, min_cos_kernel_vs_plain=cos)
    if cos <= COS_MIN:
        fail(f"kernel-path embeddings vs plain attention: min cosine {cos}")

    # where the encode time goes: the host tokenizer alone, and one forward
    # at the largest batch of the run, whose attention share the kernel
    # line's time gives
    sample = texts[: min(docs, 16384)]
    t0 = time.perf_counter()
    for text in sample:
        enc.tokenizer.encode(text)
    tokenize_s = time.perf_counter() - t0
    step = {"texts_per_s_tokenizer": len(sample) / tokenize_s}
    if on_card:
        ids_t = torch.randint(104, enc.config.vocab_size, (enc.max_batch, 64), device=device)
        mask_t = torch.ones_like(ids_t)
        with torch.inference_mode():
            step["forward_ms"] = time_ms(lambda: enc.model(ids_t, mask_t), iters=10)
        step["forward_shape"] = list(ids_t.shape)
    log("main", step="breakdown", **step)
    return {"launches": launches, "attention_launches": by_shape, "emb_per_s": docs / encode_s,
            "texts": texts, "lengths": lengths}


# ---------------------------------------------------------------------------
# Phase 5: retrieve then rerank; phase 6: BGE-base and the W8A8 embedder.
# ---------------------------------------------------------------------------

SKIPPABLE = ("rerank", "encoders", "executor", "dataflow", "temporal", "generate", "moe", "speculative", "vision", "lora",
             "train", "parallel", "sharded", "rag", "hybrid", "persistence", "cluster", "vector_store")
# the phases whose paths hold no encoder-attention call: their launches must be 0
NO_KERNEL_PHASES = ("generate", "moe", "speculative", "vision", "lora", "train", "parallel", "sharded")
RERANK_MODEL = "cross-encoder/ms-marco-MiniLM-L-6-v2"
RERANK_CHUNKS = 16384
CHUNK_WORDS = (50, 500)  # TokenCountSplitter's min/max tokens (xpacks/llm/splitters.py:74-75)
QUERY_WORDS = (6, 20)
QUERY_SWAP = 0.25  # share of a query's words swapped for random ones
RERANK_BATCHES = 8  # timed, after one untimed warm-up batch
RERANK_QUERIES = 64
RETRIEVE_K = 32
RERANK_KEEP = 5  # rerank_topk_filter's k (xpacks/llm/rerankers.py:137-149)
RERANK_MICRO_BATCH = 256  # CrossEncoderReranker's max_batch_size (xpacks/llm/rerankers.py:30)
BGE_MODEL = "BAAI/bge-base-en-v1.5"
ENCODER_TEXTS = 32768
W8A8_COS_MIN = 0.99  # the JAX package's W8A8 pin (tests/test_quantized_encoder.py:49)
OVERLAP_MIN = 0.85  # its neighbour-overlap pin (:68)
OVERLAP_QUERIES = 256
OVERLAP_K = 10


def score_tol(ref) -> float:
    """0.05·(max|ref|+1): the JAX package's cross-encoder pin
    (tests/test_attention_kernel.py:135)."""
    return 0.05 * (float(np.abs(ref).max()) + 1.0)


def micro_batches(n: int) -> list[range]:
    """The reference reranker's ``score`` calls over ``n`` pairs: its
    micro-batcher flushes every 256 submissions in arrival order
    (``AsyncMicroBatcher``, ``utils/batching.py``), and each call pads to
    its longest pair."""
    return [range(a, min(a + RERANK_MICRO_BATCH, n)) for a in range(0, n, RERANK_MICRO_BATCH)]


def rerank_batch(enc, index, ce, queries, chunks) -> dict:
    """One retrieve-then-rerank step: encode the queries, retrieve the top
    32 chunks of each, score the (query, chunk) pairs, keep the 5 best of
    each query (``rerank_topk_filter`` on numpy scores)."""
    t0 = time.perf_counter()
    q = enc.encode(queries)
    hits = index.search_many([(q[j], RETRIEVE_K, None) for j in range(len(queries))])
    t1 = time.perf_counter()
    if any(len(h) != RETRIEVE_K for h in hits):
        fail(f"a query retrieved fewer than {RETRIEVE_K} chunks")
    keys = np.array([[key for key, _ in h] for h in hits])  # [queries, 32]
    pairs = [(queries[j], chunks[key]) for j in range(len(queries)) for key in keys[j]]
    scores = np.concatenate([ce.score(pairs[mb.start : mb.stop]) for mb in micro_batches(len(pairs))])
    scores = scores.reshape(keys.shape)
    top = np.take_along_axis(keys, np.argsort(-scores, axis=1)[:, :RERANK_KEEP], axis=1)
    t2 = time.perf_counter()
    return {"keys": keys, "scores": scores, "top": top, "pairs": pairs,
            "retrieve_s": t1 - t0, "rerank_s": t2 - t1}


def rerank_queries(rng, batches: int, per_batch: int, lengths, chunk_words, vocab):
    """``batches`` lists of ``per_batch`` queries of 6-20 words, each a span
    of a random chunk with a quarter of its words swapped, and the chunk it
    came from."""
    out = []
    for _ in range(batches):
        texts, sources = [], []
        for _ in range(per_batch):
            c = int(rng.integers(len(lengths)))
            n = int(rng.integers(QUERY_WORDS[0], QUERY_WORDS[1] + 1))
            start = int(rng.integers(0, lengths[c] - n + 1))
            words = chunk_words[c][start : start + n].copy()
            swap = rng.random(n) < QUERY_SWAP
            words[swap] = rng.integers(0, len(vocab), size=int(swap.sum()))
            texts.append(" ".join(vocab[w] for w in words))
            sources.append(c)
        out.append((texts, np.array(sources)))
    return out


def percentiles(values) -> dict:
    return {"p50": float(np.percentile(values, 50)), "p99": float(np.percentile(values, 99)),
            "max": float(np.max(values))}


def rerank_phase(device, seed: int, checked: dict, n_chunks: int = RERANK_CHUNKS,
                 batches: int = RERANK_BATCHES, batch_queries: int = RERANK_QUERIES) -> dict:
    """The retrieve-then-rerank step of the RAG path at full width: embed a
    corpus of chunks into a cosine index with all-MiniLM-L6-v2, then per
    batch of 64 queries retrieve the top 32 chunks, score the 2,048 pairs
    with the ms-marco-MiniLM-L-6-v2 cross-encoder and keep the top 5.
    ``checked`` gains the attention shapes the run gave the kernel."""
    import pathway_tpu_torch as pt
    from pathway_tpu_torch.models.encoder import fused_cross_apply
    from pathway_tpu_torch.models.tokenizer import bucket_seq_len, pad_batch
    from pathway_tpu_torch.ops.attention import encoder_attention, encoder_attention_reference

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    chunks, lengths, chunk_words, vocab = synthetic_corpus(n_chunks, seed + 4, CHUNK_WORDS)
    query_batches = rerank_queries(np.random.default_rng(seed + 5), batches + 1, batch_queries,
                                   lengths, chunk_words, vocab)
    log("rerank", step="corpus", chunks=n_chunks, words_min=int(lengths.min()), words_max=int(lengths.max()),
        words_mean=float(lengths.mean()), batches=batches, warmup_batches=1, queries_per_batch=batch_queries,
        retrieve_k=RETRIEVE_K, keep=RERANK_KEEP, seconds=time.perf_counter() - t0)

    kw = {} if on_card else {"device": device}
    enc = pt.SentenceEncoder("all-MiniLM-L6-v2", seed=seed, **kw)
    ce = pt.CrossEncoder(RERANK_MODEL, seed=seed, **kw)
    index = pt.BruteForceKnnIndex(pt.DistanceMetric.COS, **kw)
    cfg = ce.config
    log("rerank", step="model", model=RERANK_MODEL, layers=cfg.layers, hidden=cfg.hidden, heads=cfg.heads,
        intermediate=cfg.intermediate, vocab_size=cfg.vocab_size, max_len=cfg.max_len,
        max_batch=ce.max_batch, n_params=ce.n_params(), pretrained=ce.pretrained, device=str(ce.device))
    seen: dict[tuple, int] = {}
    hooks = [record_launches(m, seen) for m in (enc, ce)]
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # ---- the counted run: counts zeroed just before, read just after ----
    encoder_attention.launches = 0
    forwards_before = enc.forward_batches + ce.forward_batches
    t0 = time.perf_counter()
    order = np.argsort(lengths, kind="stable")
    for start in range(0, n_chunks, enc.max_batch):
        ids = order[start : start + enc.max_batch]
        for i, vec in zip(ids, enc.encode([chunks[i] for i in ids])):
            index.add(int(i), vec)
    index.search(vec, 1)  # builds and uploads the device index (vec: the last chunk's)
    index_s = time.perf_counter() - t0
    steps = [rerank_batch(enc, index, ce, texts, chunks) for texts, _ in query_batches]
    launches = {"encoder_attention": encoder_attention.launches}
    forwards = enc.forward_batches + ce.forward_batches - forwards_before
    # ---- end of the counted run ----
    for h in hooks:
        h.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    timed = steps[1:]
    n_pairs = sum(len(st["pairs"]) for st in timed)
    rerank_s = sum(st["rerank_s"] for st in timed)
    retrieve_ms = [st["retrieve_s"] * 1e3 for st in timed]
    rerank_ms = [st["rerank_s"] * 1e3 for st in timed]
    batch_ms = [a + b for a, b in zip(retrieve_ms, rerank_ms)]
    in_32 = np.mean([np.mean([src in keys for src, keys in zip(sources, st["keys"])])
                     for (_, sources), st in zip(query_batches, steps)])
    in_5 = np.mean([np.mean([src in top for src, top in zip(sources, st["top"])])
                    for (_, sources), st in zip(query_batches, steps)])
    log("rerank", step="index", chunks=n_chunks, seconds=index_s, emb_per_s=n_chunks / index_s)
    log("rerank", step="batches", pairs=n_pairs, pairs_per_s=n_pairs / rerank_s,
        queries_per_s=len(timed) * batch_queries / (sum(batch_ms) / 1e3),
        batch_latency_ms=percentiles(batch_ms), retrieve_latency_ms=percentiles(retrieve_ms),
        rerank_latency_ms=percentiles(rerank_ms),
        source_chunk_in_top32=float(in_32), source_chunk_in_top5=float(in_5),
        forward_batches=forwards, peak_mem_gb=peak_gb)

    # where a timed batch's rerank time goes: the host tokenizer alone, then
    # the scoring of the tokenized pairs (padding, copies, forwards, scores
    # back); and the tokenizer alone on 2,048 corpus chunks
    st = steps[1]
    t0 = time.perf_counter()
    tokenized = [[ce.tokenizer.encode_pair(*st["pairs"][i]) for i in mb] for mb in micro_batches(len(st["pairs"]))]
    t1 = time.perf_counter()
    for id_lists in tokenized:
        ce._run_padded(id_lists)
    t2 = time.perf_counter()
    sample = chunks[:2048]
    t3 = time.perf_counter()
    for text in sample:
        enc.tokenizer.encode(text)
    t4 = time.perf_counter()
    seqs = [bucket_seq_len(max(len(x) for x in id_lists)) for id_lists in tokenized]
    log("rerank", step="breakdown", batch=1, rerank_ms=st["rerank_s"] * 1e3, tokenize_pairs_ms=(t1 - t0) * 1e3,
        score_tokenized_ms=(t2 - t1) * 1e3, micro_batches=len(tokenized), micro_batch_seq=seqs,
        pair_ids_mean=float(np.mean([len(x) for group in tokenized for x in group])),
        padded_ids_share=1.0 - sum(len(x) for group in tokenized for x in group)
        / sum(seq * len(group) for seq, group in zip(seqs, tokenized)),
        chunks_per_s_tokenizer=len(sample) / (t4 - t3))

    expected = sum(seen.values()) if on_card else 0
    by_shape = dict(seen) if on_card else {}
    if launches["encoder_attention"] != expected or (on_card and not expected):
        fail(f"rerank: attention launches {launches['encoder_attention']} != {expected} "
             f"(layers x forwards per shape {seen})")
    for st in steps:
        if not np.isfinite(st["scores"]).all() or st["scores"].shape != (batch_queries, RETRIEVE_K):
            fail(f"rerank: scores of shape {st['scores'].shape} or non-finite")

    # the first batch's kernel-path scores against the plain attention
    first = steps[0]
    tree = ce.model.tree()
    plain = np.empty(len(first["pairs"]), np.float32)
    with torch.inference_mode():
        for idx in micro_batches(len(first["pairs"])):
            id_lists = [ce.tokenizer.encode_pair(*first["pairs"][i]) for i in idx]
            ids, mask = pad_batch(id_lists, bucket_seq_len(max(len(x) for x in id_lists)))
            rows = plain_rows((len(idx), ids.shape[1], cfg.hidden, cfg.heads))
            for a in range(0, len(idx), rows):
                ids_t = torch.from_numpy(ids[a : a + rows]).to(device)
                mask_t = torch.from_numpy(mask[a : a + rows]).to(device)
                plain[np.array(idx[a : a + rows])] = fused_cross_apply(
                    tree, ids_t, mask_t, cfg, attention=encoder_attention_reference).cpu().numpy()
    plain = plain.reshape(first["scores"].shape)
    err, tol = float(np.abs(first["scores"] - plain).max()), score_tol(plain)
    same, ties, gaps = 0, 0, []
    for j in range(batch_queries):
        ref_top = first["keys"][j][np.argsort(-plain[j])[:RERANK_KEEP]]
        desc = np.sort(plain[j])[::-1]
        gap = float(desc[RERANK_KEEP - 1] - desc[RERANK_KEEP])  # the plain scores' 5th/6th gap
        gaps.append(gap)
        if set(ref_top) == set(first["top"][j]):
            same += 1
        elif gap < tol:
            ties += 1
        else:
            fail(f"rerank: query {j} kept {sorted(first['top'][j])}, the plain path "
                 f"{sorted(ref_top)}, with a 5th/6th gap {gap} >= {tol}")
    log("rerank", step="check", pairs=plain.size, max_abs_err=err, tol=tol,
        score_min=float(plain.min()), score_max=float(plain.max()), score_std=float(plain.std()),
        top5_identical=same, top5_parted_at_near_tie=ties, gap_5th_6th_median=float(np.median(gaps)),
        queries_with_gap_under_tol=int(np.sum(np.array(gaps) < tol)))
    if err >= tol:
        fail(f"rerank: kernel-path scores vs plain attention: max abs err {err} >= {tol}")

    # every attention shape this run gave the kernel, against the plain version
    if on_card:
        gen = torch.Generator(device=device).manual_seed(seed + 4)
        for shape in sorted(set(seen) - set(checked)):
            checked[shape] = check_attention_shape(gen, shape, device)
    log("rerank", step="shapes", launches={str(list(sh)): n for sh, n in sorted(by_shape.items())},
        max_abs_err={str(list(sh)): checked[sh] for sh in sorted(by_shape)})
    return {"launches": launches, "attention_launches": by_shape, "pairs_per_s": n_pairs / rerank_s,
            "batch_latency_ms": percentiles(batch_ms), "peak_mem_gb": peak_gb}


def top_neighbours(embs, rows, k: int, device):
    """The ``k`` nearest rows by cosine of each of ``rows``, itself left out."""
    e = torch.from_numpy(embs).to(device)
    e = e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
    rows_t = torch.from_numpy(rows).to(device)
    scores = e[rows_t] @ e.T
    scores[torch.arange(len(rows), device=device), rows_t] = -float("inf")
    return scores.topk(k, dim=1).indices.cpu().numpy()


def w8a8_matmuls(bf16, w8a8, device) -> None:
    """Device ms (CUDA graphs) of layer 0's four matmuls at the (512, 64)
    batch's 32,768 rows: the bf16 product, the whole W8A8 ``_qdot``, and
    its ``torch._int_mm`` alone."""
    from pathway_tpu_torch.models.encoder import _qdot

    gen = torch.Generator(device=device).manual_seed(9)
    plain, quant = bf16.model.tree()["layers"][0], w8a8.model.tree()["layers"][0]
    rows = bf16.max_batch * 64
    for name in ("qkv_k", "out_k", "ff1_k", "ff2_k"):
        w = plain[name]
        x = torch.randn((rows, w.shape[0]), generator=gen, device=device).to(torch.bfloat16)
        xq = torch.randint(-127, 128, x.shape, generator=gen, device=device, dtype=torch.int8)
        log("encoders", step="w8a8_op", matmul=name, rows=rows, k=w.shape[0], n=w.shape[1],
            bf16_ms=device_ms([lambda: x @ w], reps=20),
            qdot_ms=device_ms([lambda: _qdot(x, quant[name])], reps=20),
            int_mm_ms=device_ms([lambda: torch._int_mm(xq, quant[name]["q"])], reps=20))


def encoders_phase(device, seed: int, checked: dict, texts, lengths, n_texts: int = ENCODER_TEXTS) -> dict:
    """The rest of the encoder family at full width on the main corpus:
    BGE-base (12 layers, H=768, hd=64, CLS pooling), then all-MiniLM-L6-v2
    in bf16 and W8A8, on the same texts in the same call."""
    import pathway_tpu_torch as pt
    from pathway_tpu_torch.models.encoder import fused_sentence_apply
    from pathway_tpu_torch.models.tokenizer import bucket_seq_len, pad_batch
    from pathway_tpu_torch.ops.attention import encoder_attention, encoder_attention_reference

    on_card = torch.device(device).type == "cuda"
    texts, lengths = texts[:n_texts], lengths[:n_texts]
    order = np.argsort(lengths, kind="stable")
    kw = {} if on_card else {"device": device}
    bge = pt.SentenceEncoder(BGE_MODEL, seed=seed, **kw)
    bf16 = pt.SentenceEncoder("all-MiniLM-L6-v2", seed=seed, **kw)
    w8a8 = pt.SentenceEncoder("all-MiniLM-L6-v2", seed=seed, quantize="int8", **kw)
    cfg = bge.config
    log("encoders", step="models", texts=len(texts), bge=dict(model=BGE_MODEL, layers=cfg.layers,
        hidden=cfg.hidden, heads=cfg.heads, head_dim=cfg.hidden // cfg.heads, pooling=cfg.pooling,
        n_params=bge.n_params()), w8a8=dict(quantize=w8a8._quantize, n_params=w8a8.n_params()))
    seen: dict[tuple, int] = {}
    hooks = [record_launches(m, seen) for m in (bge, bf16, w8a8)]
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # ---- the counted run: counts zeroed just before, read just after ----
    encoder_attention.launches = 0
    bge_embs, bge_s = encode_sorted(bge, texts, order)
    bf16_embs, bf16_s = encode_sorted(bf16, texts, order)
    w8a8_embs, w8a8_s = encode_sorted(w8a8, texts, order)
    launches = {"encoder_attention": encoder_attention.launches}
    # ---- end of the counted run ----
    for h in hooks:
        h.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    n = len(texts)
    rates = {"bge_emb_per_s": n / bge_s, "minilm_bf16_emb_per_s": n / bf16_s, "minilm_w8a8_emb_per_s": n / w8a8_s}
    step = {}
    if on_card:  # one forward at the largest length-sorted batch, device and host together
        ids_t = torch.randint(104, bf16.config.vocab_size, (bf16.max_batch, 64), device=device)
        mask_t = torch.ones_like(ids_t)
        with torch.inference_mode():
            for name, enc in (("bge", bge), ("minilm_bf16", bf16), ("minilm_w8a8", w8a8)):
                step[f"{name}_forward_ms"] = time_ms(lambda enc=enc: enc.model(ids_t, mask_t), iters=10)
    log("encoders", step="encode", order="length-sorted", texts=n, **rates, **step, peak_mem_gb=peak_gb)
    if on_card:
        w8a8_matmuls(bf16, w8a8, device)

    expected = sum(seen.values()) if on_card else 0
    by_shape = dict(seen) if on_card else {}
    if launches["encoder_attention"] != expected or (on_card and not expected):
        fail(f"encoders: attention launches {launches['encoder_attention']} != {expected} "
             f"(layers x forwards per shape {seen})")
    for name, e, dim in (("bge", bge_embs, cfg.hidden), ("bf16", bf16_embs, 384), ("w8a8", w8a8_embs, 384)):
        if not np.isfinite(e).all() or e.shape != (n, dim):
            fail(f"encoders: {name} embeddings of shape {e.shape} or non-finite")

    # BGE's embeddings from the counted run against the plain attention, on
    # the first, a middle and the last length-sorted batch (seq buckets
    # 16, 32 and 64 at the full corpus)
    n_batches = -(-n // bge.max_batch)
    worst = 1.0
    with torch.inference_mode():
        for b in sorted({0, n_batches // 2, n_batches - 1}):
            ids = order[b * bge.max_batch : (b + 1) * bge.max_batch]
            id_lists = [bge.tokenizer.encode(texts[i]) for i in ids]
            tok, mask = pad_batch(id_lists, bucket_seq_len(max(len(x) for x in id_lists)))
            ref = fused_sentence_apply(bge.model.tree(), torch.from_numpy(tok).to(device),
                                       torch.from_numpy(mask).to(device), cfg,
                                       attention=encoder_attention_reference).cpu().numpy()
            cos = (ref * bge_embs[ids]).sum(1) / (np.linalg.norm(ref, axis=1) * np.linalg.norm(bge_embs[ids], axis=1))
            worst = min(worst, float(cos.min()))
            log("encoders", step="check_bge", batch=b, seq=tok.shape[1], min_cos_kernel_vs_plain=float(cos.min()))
    if worst <= COS_MIN:
        fail(f"BGE kernel-path embeddings vs plain attention: min cosine {worst}")

    # W8A8 against bf16: every row's cosine, and the neighbours of 256 rows
    cos = (w8a8_embs * bf16_embs).sum(1) / (np.linalg.norm(w8a8_embs, axis=1) * np.linalg.norm(bf16_embs, axis=1))
    rows = np.random.default_rng(seed + 6).choice(n, size=min(OVERLAP_QUERIES, n), replace=False)
    k = min(OVERLAP_K, n - 1)
    a, b = top_neighbours(bf16_embs, rows, k, device), top_neighbours(w8a8_embs, rows, k, device)
    overlap = float(np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)]))
    log("encoders", step="check_w8a8", min_cos_vs_bf16=float(cos.min()), mean_cos_vs_bf16=float(cos.mean()),
        neighbour_overlap=overlap, queries=len(rows), k=k, w8a8_over_bf16_emb_per_s=rates["minilm_w8a8_emb_per_s"]
        / rates["minilm_bf16_emb_per_s"])
    if cos.min() <= W8A8_COS_MIN:
        fail(f"W8A8 vs bf16 embeddings: min cosine {cos.min()}")
    if overlap <= OVERLAP_MIN:
        fail(f"W8A8 vs bf16 top-{k} neighbour overlap {overlap}")

    if on_card:
        gen = torch.Generator(device=device).manual_seed(seed + 6)
        for shape in sorted(set(seen) - set(checked)):
            checked[shape] = check_attention_shape(gen, shape, device)
    log("encoders", step="shapes", launches={str(list(sh)): n_ for sh, n_ in sorted(by_shape.items())},
        max_abs_err={str(list(sh)): checked[sh] for sh in sorted(by_shape)})
    return {"launches": launches, "attention_launches": by_shape, **rates, "peak_mem_gb": peak_gb}


# ---------------------------------------------------------------------------
# The shared executor's rail around phases 4-6, and phase 7: the executor.
# ---------------------------------------------------------------------------

EXEC_BATCHES = 32  # benchmarks/device_executor.py:90-131's overlap pattern; 64 until [cluster]
EXEC_BATCH = 512
BATCHER_TEXTS = 4096  # 8,192 until [cluster]
BATCHER_MAX = 256  # SentenceTransformerEmbedder's max_batch_size (xpacks/llm/embedders.py:49)
BATCHER_FLUSH_S = 0.002
OOM_ROWS = 512
OOM_CAP = 64  # the largest bucket the OOM part's scratch lets fit
FAULT_TEXTS = 16
BREAKER_COOLDOWN_S = 1.0
# The deadline bounds every job of the hang part's executor, the healthy
# submit after the wedge too: that one takes milliseconds (``next_submit_ms``),
# but a 2 s deadline once failed it in a host stall, so the deadline leaves
# it room; the wedge sleeps twice as long.
HANG_DEADLINE_S = 10.0
RAIL_PIN = 0.02  # the reference's happy-path pin (benchmarks/device_fault_recovery.py:11)


@contextlib.contextmanager
def env_knobs(**knobs):
    """Set ``PATHWAY_*`` knobs for a block (an executor or a registration
    reads them when it is made), then restore them."""
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update({k: str(v) for k, v in knobs.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rail_state(device) -> dict:
    """The default executor's rail counters and padding totals, to difference
    around a run."""
    from pathway_tpu_torch.device import get_default_executor
    from pathway_tpu_torch.engine import metrics

    reg = metrics.get_registry()
    fam = reg.family("device.failures")
    padding = get_default_executor(device).device_snapshot()["padding"]
    return {
        "fallback_batches": reg.counter("device.fallback.batches").value,
        "quarantined": reg.counter("device.quarantine.batches").value,
        "failures": sum(child.value for _, child in fam.items()) if fam else 0.0,
        "pad_rows": padding["pad_rows"],
        "real_rows": padding["real_rows"],
    }


def rail_gate(phase: str, device, before: dict) -> dict:
    """Fail unless every batch since ``before`` was served on the device: no
    fallback batch, no classified failure, no quarantine, every breaker of the
    shared executor closed; logs those and the run's padding-waste fraction."""
    from pathway_tpu_torch.device import get_default_executor

    after = rail_state(device)
    resilience = get_default_executor(device).device_snapshot()["resilience"]
    breakers = {name: st["breaker"]["state"] for name, st in resilience["callables"].items() if st["breaker"]}
    out = {k: after[k] - before[k] for k in ("fallback_batches", "quarantined", "failures", "pad_rows", "real_rows")}
    total = out["pad_rows"] + out["real_rows"]
    out["padding_waste_fraction"] = out["pad_rows"] / total if total else 0.0
    log(phase, step="executor", rail=resilience["enabled"], breakers=breakers, **out)
    if out["fallback_batches"] or out["quarantined"] or out["failures"]:
        fail(f"{phase}: the shared executor's rail moved: {out}")
    if any(state != "closed" for state in breakers.values()):
        fail(f"{phase}: a breaker is not closed: {breakers}")
    return out


def forward_events(encoder):
    """Hooks that bracket every forward of ``encoder.model`` with CUDA events
    on the current stream; returns (the list of [start, end] pairs, remove)."""
    events = []

    def pre(_module, _args):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        events.append([start, None])

    def post(_module, _args, _out):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        events[-1][1] = end

    hooks = [encoder.model.register_forward_pre_hook(pre), encoder.model.register_forward_hook(post)]
    return events, lambda: [h.remove() for h in hooks]


def events_ms(events) -> float:
    """Device ms from start to end of each bracketed forward, summed."""
    torch.cuda.synchronize()
    return float(sum(start.elapsed_time(end) for start, end in events))


def paired_us(run, set_rail, reps: int) -> tuple[float, float]:
    """Median host µs per dispatch of ``run`` with the rail on and off,
    interleaved on/off/off/on in every rep so drift cancels."""
    on, off = [], []
    for _ in range(reps):
        set_rail(True)
        a = run()
        set_rail(False)
        b, c = run(), run()
        set_rail(True)
        d = run()
        on += [a, d]
        off += [b, c]
    return float(np.median(on)), float(np.median(off))


def pass_us(executor, name: str, batches, operands=()) -> float:
    """Host µs per ``run_batch`` over ``batches`` (each a tuple of arrays)."""
    t0 = time.perf_counter()
    for arrays in batches:
        executor.run_batch(name, arrays, operands=operands)
    return (time.perf_counter() - t0) / len(batches) * 1e6


def oom_part(ex, device, seed: int, reg) -> dict:
    """A real CUDA OOM: the callable allocates scratch in proportion to its
    bucket, sized from the free memory so that buckets above 64 cannot fit.
    The rail must split the 512-row batch down to cap 64, give the unfaulted
    outputs and leave the allocated bytes where they were."""
    from pathway_tpu_torch.device import BucketPolicy

    gc.collect()
    torch.cuda.empty_cache()
    x = np.random.default_rng(seed).normal(size=(OOM_ROWS, 64)).astype(np.float32)
    free, _total = torch.cuda.mem_get_info(device)
    row_bytes = int(free * 0.75) // OOM_CAP  # 64 rows take 75% of the free bytes, 128 rows 150%

    def hungry(xt):
        scratch = torch.empty((xt.shape[0], row_bytes), dtype=torch.uint8, device=xt.device)
        scratch[:, 0] = 1
        return xt * 2.0 + scratch[:, :1].float()

    ex.register("executor:oom", hungry, policy=BucketPolicy(max_bucket=OOM_ROWS))
    allocated = torch.cuda.memory_allocated(device)
    splits = reg.counter("device.oom.splits").value
    t0 = time.perf_counter()
    out = ex.run_batch("executor:oom", (x,))
    seconds = time.perf_counter() - t0
    after = torch.cuda.memory_allocated(device)  # no collection first: the rail let the failed calls go
    gc.collect()
    after_gc = torch.cuda.memory_allocated(device)
    st = ex.resilience_stats("executor:oom")
    oom = dict(rows=OOM_ROWS, free_gb=free / 1e9, scratch_gb_per_row=row_bytes / 1e9,
               splits=reg.counter("device.oom.splits").value - splits, bucket_cap=st["bucket_cap"],
               bucket_cap_gauge=ex.metrics_snapshot().get("device.bucket.cap{callable=executor:oom}"),
               failures=st["failures"], seconds=seconds, allocated_before=allocated, allocated_after=after,
               allocated_after_gc=after_gc,
               equal_to_unfaulted=bool(np.array_equal(out, x * 2.0 + 1.0)))
    log("executor", part="faults", fault="oom", **oom)
    torch.cuda.empty_cache()
    if oom["splits"] < 1 or st["bucket_cap"] != OOM_CAP or not oom["equal_to_unfaulted"] or after_gc != allocated:
        fail(f"executor: OOM ratchet {oom}")
    return oom


def executor_phase(device, seed: int, checked: dict, texts) -> dict:
    """Phase 7: all-MiniLM-L6-v2 at full width through the port's executor:
    the submit overlap, the micro-batcher, the fault rail on the card, the
    rail's host cost and the accountant.  ``checked`` gains the attention
    shapes the run gave the kernel."""
    import asyncio

    import pathway_tpu_torch as pt
    from pathway_tpu_torch.device import BucketPolicy, DeviceExecutor, get_default_executor, resilience
    from pathway_tpu_torch.engine import faults, metrics
    from pathway_tpu_torch.models.tokenizer import pad_batch
    from pathway_tpu_torch.ops.attention import encoder_attention
    from pathway_tpu_torch.utils.batching import AsyncMicroBatcher

    reg = metrics.get_registry()
    ex = get_default_executor(device)
    enc = pt.SentenceEncoder("all-MiniLM-L6-v2", seed=seed)
    cfg = enc.config
    if enc._executor is not ex:
        fail("executor: the encoder is not on the device's default executor")
    # the main corpus in arrival order (taken round again when it is short)
    stream = [texts[i % len(texts)] for i in range(EXEC_BATCHES * EXEC_BATCH + BATCHER_TEXTS)]
    batches = [stream[i * EXEC_BATCH : (i + 1) * EXEC_BATCH] for i in range(EXEC_BATCHES)]
    sample = stream[EXEC_BATCHES * EXEC_BATCH :]
    seen: dict[tuple, int] = {}
    hooks = [record_launches(enc, seen)]
    events, remove_events = forward_events(enc)

    def tokenize(batch):
        return [enc.tokenizer.encode(t) for t in batch]

    for batch in batches[:2]:  # warm-up: each new key's first dispatch runs under the FLOP count
        enc._run_padded(tokenize(batch))

    # ---- the counted run: counts zeroed just before, read just after ----
    encoder_attention.launches = 0
    seen.clear()
    before = rail_state(device)
    # 1. overlap: tokenize batch i, then run_batch; against submit, with batch
    # i+1 tokenized on this thread while the dispatch thread runs batch i
    events.clear()
    t0 = time.perf_counter()
    sync_rows = [enc._run_padded(tokenize(batch)) for batch in batches]
    sync_s = time.perf_counter() - t0
    sync_dev_ms = events_ms(events)
    events.clear()
    t0 = time.perf_counter()
    futures, ids = [], tokenize(batches[0])
    for i in range(EXEC_BATCHES):
        futures.append(ex.submit(lambda ids=ids: enc._run_padded(ids), name="executor:overlap"))
        if i + 1 < EXEC_BATCHES:
            ids = tokenize(batches[i + 1])
    submit_rows = [f.result(timeout=600) for f in futures]
    submit_s = time.perf_counter() - t0
    submit_dev_ms = events_ms(events)
    a, b = np.concatenate(sync_rows), np.concatenate(submit_rows)
    cos = float((a * b).sum(1).min())
    overlap = dict(texts=len(a), batches=EXEC_BATCHES, batch=EXEC_BATCH,
                   sync_emb_per_s=len(a) / sync_s, submit_emb_per_s=len(a) / submit_s, ratio=sync_s / submit_s,
                   sync_wall_ms=sync_s * 1e3, sync_device_ms=sync_dev_ms,
                   sync_idle_share=1.0 - sync_dev_ms / (sync_s * 1e3),
                   submit_wall_ms=submit_s * 1e3, submit_device_ms=submit_dev_ms,
                   submit_idle_share=1.0 - submit_dev_ms / (submit_s * 1e3),
                   min_cos=cos, max_abs_diff=float(np.abs(a - b).max()))
    log("executor", part="overlap", **overlap)
    if cos <= COS_MIN or not np.isfinite(b).all() or b.shape != (len(a), cfg.hidden):
        fail(f"executor: submit vs synchronous embeddings, min cosine {cos}")

    # 2. batcher: one coroutine per text, as SentenceTransformerEmbedder sends them
    sizes: list[int] = []

    def process(items):
        sizes.append(len(items))
        return enc.encode(items)

    batcher = AsyncMicroBatcher(process, max_batch_size=BATCHER_MAX, flush_delay=BATCHER_FLUSH_S,
                                executor=ex, name="executor:batcher")

    async def embed(items):
        return await asyncio.gather(*(batcher.submit(t) for t in items))

    asyncio.run(embed(sample[:1024]))  # warm-up
    sizes.clear()
    t0 = time.perf_counter()
    rows = np.stack(asyncio.run(embed(sample)))
    batcher_s = time.perf_counter() - t0
    direct = np.concatenate([enc.encode(sample[i : i + EXEC_BATCH]) for i in range(0, len(sample), EXEC_BATCH)])
    cos = float((rows * direct).sum(1).min())
    batcher_line = dict(texts=len(sample), max_batch_size=BATCHER_MAX, flush_delay_s=BATCHER_FLUSH_S,
                        emb_per_s=len(sample) / batcher_s, seconds=batcher_s, batches=len(sizes),
                        batch_sizes={int(s): sizes.count(s) for s in sorted(set(sizes))}, min_cos_vs_encode=cos)
    log("executor", part="batcher", **batcher_line)
    if cos <= COS_MIN or rows.shape != (len(sample), cfg.hidden):
        fail(f"executor: batcher rows of shape {rows.shape}, min cosine vs encode {cos}")
    rail = rail_gate("executor", device, before)

    # 3. faults on the card
    oom = oom_part(ex, device, seed, reg)

    few = sample[:FAULT_TEXTS]
    ref = enc.encode(few)
    retries = reg.counter("device.retry.attempts").value
    faults.install_plan(faults.FaultPlan([{"kind": "device_error", "source": enc._callable, "nth": 1}], seed=seed))
    try:
        got = enc.encode(few)
    finally:
        faults.clear_plan()
    transient = dict(retries=reg.counter("device.retry.attempts").value - retries,
                     bitwise_equal=bool(np.array_equal(got, ref)))
    log("executor", part="faults", fault="transient", **transient)
    if transient["retries"] != 1 or not transient["bitwise_equal"]:
        fail(f"executor: injected transient {transient}")

    # a breaker trip (threshold 5, each failed batch after 2 retries) onto
    # an explicit CPU MiniLM fallback, then the half-open probe's recovery
    with env_knobs(PATHWAY_DEVICE_BREAKER_COOLDOWN_S=BREAKER_COOLDOWN_S, PATHWAY_DEVICE_RETRY_BACKOFF_MS=1):
        twin = pt.SentenceEncoder("all-MiniLM-L6-v2", seed=seed, device="cpu")
        guarded = pt.SentenceEncoder("all-MiniLM-L6-v2", seed=seed, host_fallback=twin.as_host_fallback())
    hooks.append(record_launches(guarded, seen))
    card_rows = guarded.encode(few)
    fallbacks = reg.counter("device.fallback.batches").value
    faults.install_plan(faults.FaultPlan([{"kind": "device_error", "source": guarded._callable, "from_nth": 1}],
                                         seed=seed))
    states, fallback_rows = [], []
    try:
        for _ in range(7):  # 5 failing batches trip it, 2 more while it is open
            fallback_rows.append(guarded.encode(few))
            states.append(ex.resilience_stats(guarded._callable)["breaker"]["state"])
    finally:
        faults.clear_plan()
    time.sleep(BREAKER_COOLDOWN_S + 0.1)
    launches = encoder_attention.launches
    recovered = guarded.encode(few)
    st = ex.resilience_stats(guarded._callable)
    breaker = dict(states=states, after_cooldown=st["breaker"]["state"], trips=st["breaker"]["trips"],
                   fallback_batches=reg.counter("device.fallback.batches").value - fallbacks,
                   failures=st["failures"],
                   min_cos_fallback_vs_card=min(float((r * card_rows).sum(1).min()) for r in fallback_rows),
                   launches_after_recovery=encoder_attention.launches - launches,
                   recovered_equal=bool(np.array_equal(recovered, card_rows)))
    log("executor", part="faults", fault="breaker", **breaker)
    if (states != ["closed"] * 4 + ["open"] * 3 or breaker["after_cooldown"] != "closed"
            or breaker["fallback_batches"] != 7 or breaker["min_cos_fallback_vs_card"] <= COS_MIN
            or breaker["launches_after_recovery"] != cfg.layers):
        fail(f"executor: breaker {breaker}")

    # a hang: the dispatch deadline fails the wedged job, a fresh thread serves on
    with env_knobs(PATHWAY_DEVICE_DISPATCH_DEADLINE_S=HANG_DEADLINE_S):
        hx = DeviceExecutor(device, collector_name=None)
    restarts = reg.counter("device.dispatch.restarts").value
    few_ids = tokenize(few)
    faults.install_plan(faults.FaultPlan(
        [{"kind": "device_hang", "source": "executor:hang", "nth": 1, "delay_ms": 20000}], seed=seed))
    try:
        t0 = time.perf_counter()
        wedged = hx.submit(lambda: enc._run_padded(few_ids), name="executor:hang")
        try:
            wedged.result(timeout=30)
        except resilience.DeviceDispatchHangError:
            hang_s = time.perf_counter() - t0
        else:
            fail("executor: the wedged job returned")
        launches = encoder_attention.launches
        t0 = time.perf_counter()
        try:
            after = hx.submit(lambda: enc._run_padded(few_ids), name="executor:after").result(timeout=60)
        except resilience.DeviceDispatchHangError as exc:
            faulthandler.dump_traceback(all_threads=True)  # where the healthy job stood
            fail(f"executor: the submit after the hang was failed too: {exc}")
        next_ms = (time.perf_counter() - t0) * 1e3
    finally:
        faults.clear_plan()
        hx.close()
    hang = dict(deadline_s=HANG_DEADLINE_S, failed_after_s=hang_s, next_submit_ms=next_ms,
                restarts=reg.counter("device.dispatch.restarts").value - restarts,
                next_submit_launches=encoder_attention.launches - launches,
                next_submit_equal=bool(np.array_equal(after, ref)))
    log("executor", part="faults", fault="hang", **hang)
    if hang["restarts"] != 1 or hang["next_submit_launches"] != cfg.layers or not hang["next_submit_equal"]:
        fail(f"executor: hang {hang}")

    # 4. overhead: host µs per dispatch with the rail on and off, on a
    # trivial callable and on a (512, 64) MiniLM dispatch
    ox = DeviceExecutor(device, collector_name=None)
    ox.register("executor:rowsum", lambda t: torch.sum(t * t, dim=1), policy=BucketPolicy(max_bucket=64))
    ox.warmup("executor:rowsum", row_shapes=((64,),), dtypes=(np.float32,))
    rng = np.random.default_rng(seed + 7)
    small = [(rng.normal(size=(int(k), 64)).astype(np.float32),) for k in rng.integers(1, 65, size=64)]
    small_on, small_off = paired_us(lambda: pass_us(ox, "executor:rowsum", small), ox.set_resilience, reps=9)
    # the rail alone: the same path with the device call stubbed out
    real = ox._dispatch_fixed
    ox._dispatch_fixed = lambda entry, operands, arrays, static, warmup=False: np.zeros(len(arrays[0]), np.float32)
    try:
        stub_on, stub_off = paired_us(lambda: pass_us(ox, "executor:rowsum", small), ox.set_resilience, reps=9)
    finally:
        ox._dispatch_fixed = real
        ox.set_resilience(True)
    big = [pad_batch([x[:64] for x in tokenize(stream[:EXEC_BATCH])], 64)] * 8
    pass_us(ex, enc._callable, big[:1], operands=(enc.model,))  # the key's counting dispatch
    acc_before = ex._accountant.snapshot()
    big_on, big_off = paired_us(lambda: pass_us(ex, enc._callable, big, operands=(enc.model,)),
                                ex.set_resilience, reps=5)
    acc_after = ex._accountant.snapshot()
    wrapper_us = max(0.0, stub_on - stub_off)
    trips, opened = [], []
    rows16 = rng.normal(size=(16, 64)).astype(np.float32)
    for _ in range(5):
        with env_knobs(PATHWAY_DEVICE_BREAKER_THRESHOLD=1, PATHWAY_DEVICE_RETRIES=0,
                       PATHWAY_DEVICE_BREAKER_COOLDOWN_S=3600):
            tx = DeviceExecutor(device, collector_name=None)
            tx.register("executor:trip", lambda t: torch.sum(t * t, dim=1), policy=BucketPolicy(max_bucket=64),
                        host_fallback=lambda t: torch.sum(t * t, dim=1))
        tx.warmup("executor:trip", row_shapes=((64,),), dtypes=(np.float32,))
        faults.install_plan(faults.FaultPlan([{"kind": "device_error", "source": "executor:trip", "nth": 1}],
                                             seed=seed))
        try:
            t0 = time.perf_counter()
            tx.run_batch("executor:trip", (rows16,))  # fails, trips, served by the fallback
            trips.append((time.perf_counter() - t0) * 1e3)
        finally:
            faults.clear_plan()
        t0 = time.perf_counter()
        for _ in range(8):
            tx.run_batch("executor:trip", (rows16,))
        opened.append((time.perf_counter() - t0) / 8 * 1e3)
        if tx.resilience_stats("executor:trip")["fallback_batches"] != 9:
            fail("executor: the tripped breaker did not route to the fallback")
    overhead = dict(trivial_on_us=small_on, trivial_off_us=small_off, minilm_512x64_on_us=big_on,
                    minilm_512x64_off_us=big_off, rail_us=wrapper_us, rail_stub_on_us=stub_on,
                    rail_stub_off_us=stub_off, rail_share_trivial=wrapper_us / small_off,
                    rail_share_minilm=wrapper_us / big_off, end_to_end_share_minilm=(big_on - big_off) / big_off,
                    reference_pin=RAIL_PIN, trip_ms=float(np.median(trips)),
                    open_fallback_ms=float(np.median(opened)))
    log("executor", part="overhead", **overhead)

    # 5. accounting: the (512, 64) key's counted FLOPs against the analytic
    # count, the rate over the overhead part's MiniLM dispatches, memory
    key = next((k for k in ex.costs(enc._callable) if k[0][-1][0] == (EXEC_BATCH, 64)), None)
    if key is None:
        fail("executor: no (512, 64) cache key was counted")
    cost = ex.costs(enc._callable)[key]
    B, S, H, F = EXEC_BATCH, 64, cfg.hidden, cfg.intermediate
    analytic = cfg.layers * (2 * B * S * (4 * H * H + 2 * H * F) + 4 * B * S * S * H)
    flops = acc_after["flops_total"] - acc_before["flops_total"]
    seconds = acc_after["device_seconds"] - acc_before["device_seconds"]
    snap = ex.metrics_snapshot()
    in_use = torch.cuda.memory_allocated(device)
    accounting = dict(key_flops=cost["flops"], analytic_flops=analytic, analyzed=cost["analyzed"],
                      key_bytes=cost["bytes_accessed"],
                      dispatches=acc_after["costed_dispatches"] - acc_before["costed_dispatches"],
                      dispatch_seconds=seconds, achieved_tflops=flops / seconds / 1e12,
                      utilization=flops / seconds / ex._accountant.peak,
                      peak_tflops=ex._accountant.peak / 1e12, peak_source=ex._accountant.peak_source,
                      hbm_bytes_in_use=snap["device.hbm.bytes_in_use"], memory_allocated=in_use,
                      hbm_peak=snap["device.hbm.peak"])
    log("executor", part="accounting", **accounting)
    if cost["flops"] != analytic or cost["analyzed"] != 1.0:
        fail(f"executor: the (512, 64) key's flops {cost['flops']} != analytic {analytic}")
    if snap["device.hbm.bytes_in_use"] != in_use:
        fail(f"executor: device.hbm.bytes_in_use {snap['device.hbm.bytes_in_use']} != memory_allocated {in_use}")
    launches = {"encoder_attention": encoder_attention.launches}
    # ---- end of the counted run ----
    for h in hooks:
        h.remove()
    remove_events()

    expected = sum(seen.values())
    if launches["encoder_attention"] != expected or not expected:
        fail(f"executor: attention launches {launches['encoder_attention']} != {expected} "
             f"(layers x forwards per shape {seen})")
    gen = torch.Generator(device=device).manual_seed(seed + 8)
    for shape in sorted(set(seen) - set(checked)):
        checked[shape] = check_attention_shape(gen, shape, device)
    log("executor", step="shapes", launches={str(list(sh)): n for sh, n in sorted(seen.items())},
        max_abs_err={str(list(sh)): checked[sh] for sh in sorted(seen)})
    return {"launches": launches, "attention_launches": dict(seen), "overlap": overlap, "batcher": batcher_line,
            "rail": rail, "oom": oom, "overhead": overhead, "accounting": accounting}


# ---------------------------------------------------------------------------
# Phase 7b: a Table program that embeds through the encoder kernel.
# ---------------------------------------------------------------------------

DATAFLOW_DOCS = 16384  # 65,536 until [cluster] (PERF.md section 4)
DATAFLOW_EPOCHS = 8  # at even times 2-16
DATAFLOW_SOURCES = 64
DATAFLOW_CHANGES = 1024  # retracted, and as many replaced, in a ninth epoch
DATAFLOW_BATCH = 256  # SentenceTransformerEmbedder's max_batch_size (xpacks/llm/embedders.py:49)
DATAFLOW_SUM_REL = 1e-3


def dataflow_stream(texts, n_docs: int, epochs: int, changes: int, n_sources: int, seed: int) -> dict:
    """The ``[dataflow]`` program's input: ``n_docs`` of ``texts`` keyed by
    ``doc_id``, each with one of ``n_sources`` source ids, in ``epochs``
    epochs at even times from 2; a last epoch retracts ``changes`` docs and
    replaces the text of ``changes`` others (``texts[n_docs:]``) under the
    same keys.  Returns the rows ``(doc_id, text, source, time, diff)``,
    the source rows, the live ``{doc_id: (text, source)}`` after the last
    epoch, and the retracted and replaced ids."""
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, n_sources, size=n_docs)
    per = n_docs // epochs
    rows = [(i, texts[i], int(sources[i]), 2 + 2 * (i // per), 1) for i in range(n_docs)]
    picked = [int(i) for i in rng.permutation(n_docs)[: 2 * changes]]
    retracted, replaced = picked[:changes], picked[changes:]
    last = 2 + 2 * epochs
    rows += [(i, texts[i], int(sources[i]), last, -1) for i in picked]
    rows += [(i, texts[n_docs + j], int(sources[i]), last, 1) for j, i in enumerate(replaced)]
    live = {i: (texts[i], int(sources[i])) for i in range(n_docs)}
    for i in retracted:
        del live[i]
    for j, i in enumerate(replaced):
        live[i] = (texts[n_docs + j], int(sources[i]))
    names = [(s, f"source-{s:02d}") for s in range(n_sources)]
    return {"rows": rows, "sources": names, "live": live, "retracted": retracted, "replaced": replaced}


def embedding_udf(pw, submit, cache_strategy=None):
    """An async ``pw.udf`` over ``submit`` (a micro-batcher's), as
    ``SentenceTransformerEmbedder`` builds it (xpacks/llm/embedders.py:50-80),
    its results cached by ``cache_strategy`` when one is given."""

    @pw.udf(executor=pw.udfs.async_executor(), deterministic=True, cache_strategy=cache_strategy)
    async def embed(text: str) -> np.ndarray:
        return await submit(text)

    return embed


def dataflow_schemas(pw):
    """The ``[dataflow]`` program's input schemas: docs keyed by ``doc_id``
    and their sources keyed by ``source``."""

    class Doc(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str
        source: int

    class Source(pw.Schema):
        source: int = pw.column_definition(primary_key=True)
        name: str

    return Doc, Source


def dataflow_program(pw, stream: dict, embed, query, docs=None, sources=None) -> dict:
    """The ``[dataflow]`` Table program, for either package as ``pw``: the
    docs (``stream["rows"]``, or the table ``docs``) embedded by ``embed``,
    scored against the unit vector ``query``, joined with their source (the
    table ``sources``, or ``stream["sources"]``), and each source's count
    and score sum.  Returns ``{"docs": ..., "per_source": ...}``."""
    Doc, Source = dataflow_schemas(pw)
    if docs is None:
        docs = pw.debug.table_from_rows(Doc, stream["rows"], is_stream=True)
    if sources is None:
        sources = pw.debug.table_from_rows(Source, stream["sources"])
    query = np.asarray(query, np.float32)
    vecs = docs.select(doc_id=pw.this.doc_id, source=pw.this.source, vec=embed(pw.this.text))
    scored = vecs.select(pw.this.doc_id, pw.this.source, pw.this.vec,
                         score=pw.apply_with_type(lambda v: float(np.dot(v, query)), float, pw.this.vec))
    joined = scored.join(sources, pw.left.source == pw.right.source).select(
        doc_id=pw.left.doc_id, name=pw.right.name, vec=pw.left.vec, score=pw.left.score)
    per_source = joined.groupby(pw.this.name).reduce(
        name=pw.this.name, count=pw.reducers.count(), total=pw.reducers.sum(pw.this.score))
    return {"docs": joined, "per_source": per_source}


def final_rows(deltas) -> dict:
    """``{key: row}`` of a change stream ``[(key, row, time, diff)]`` after
    its last epoch (an epoch retracts a key's old row before it inserts the
    new one)."""
    live: dict = {}
    for key, row, _time, diff in sorted(deltas, key=lambda d: (d[2], d[3])):
        if diff > 0:
            live[key] = row
        else:
            live.pop(key, None)
    return live


def dataflow_phase(device, seed: int, checked: dict) -> dict:
    """Phase 7b: the dataflow core and the Table API at full all-MiniLM-L6-v2
    width, through ``pw.run``.  ``checked`` gains the attention shapes the
    run gave the kernel."""
    import asyncio

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import native
    from pathway_tpu_torch.device import get_default_executor
    from pathway_tpu_torch.engine import dataflow as df
    from pathway_tpu_torch.ops.attention import encoder_attention
    from pathway_tpu_torch.utils.batching import AsyncMicroBatcher

    if native.get() is None:
        fail("dataflow: the native core did not load")
    ex = get_default_executor(device)
    enc = pw.SentenceEncoder("all-MiniLM-L6-v2", seed=seed)
    texts, _, _, _ = synthetic_corpus(DATAFLOW_DOCS + DATAFLOW_CHANGES, seed + 101)
    stream = dataflow_stream(texts, DATAFLOW_DOCS, DATAFLOW_EPOCHS, DATAFLOW_CHANGES, DATAFLOW_SOURCES, seed + 103)
    query = np.random.default_rng(seed + 107).normal(size=enc.dimensions).astype(np.float32)
    query /= np.linalg.norm(query)
    sizes: list[int] = []
    embedded: set = set()

    def process(items):
        sizes.append(len(items))
        embedded.update(items)
        return enc.encode(items)

    batcher = AsyncMicroBatcher(process, max_batch_size=DATAFLOW_BATCH, executor=ex, name="dataflow:embedder")

    async def warm_up():
        return await asyncio.gather(*(batcher.submit(t) for t in texts[:1024]))

    asyncio.run(warm_up())
    sizes.clear()
    embedded.clear()
    tables = dataflow_program(pw, stream, embedding_udf(pw, batcher.submit), query)
    captured = {name: [] for name in tables}
    for name, table in tables.items():
        table._subscribe_raw(lambda k, r, t, d, out=captured[name]: out.append((k, r, t, d)), name=f"dataflow:{name}")

    # host time per epoch, and the async-UDF node's share of it (the awaits)
    epochs_ms: list[float] = []
    udf_s = [0.0]
    run_epoch, udf_step = df.Scope.run_epoch, df.AsyncValuesNode.step

    def timed_epoch(scope, time_):
        t0 = time.perf_counter()
        try:
            return run_epoch(scope, time_)
        finally:
            if scope.parent is None:
                epochs_ms.append((time.perf_counter() - t0) * 1e3)

    def timed_udf(node, time_):
        t0 = time.perf_counter()
        try:
            return udf_step(node, time_)
        finally:
            udf_s[0] += time.perf_counter() - t0

    seen: dict[tuple, int] = {}
    hooks = [record_launches(enc, seen)]
    events, remove_events = forward_events(enc)
    df.Scope.run_epoch, df.AsyncValuesNode.step = timed_epoch, timed_udf
    # ---- the counted run: counts zeroed just before, read just after ----
    encoder_attention.launches = 0
    seen.clear()
    before = rail_state(device)
    try:
        t0 = time.perf_counter()
        result = pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        wall_s = time.perf_counter() - t0
    finally:
        df.Scope.run_epoch, df.AsyncValuesNode.step = run_epoch, udf_step
        pw.G.clear()
    launches = {"encoder_attention": encoder_attention.launches}
    # ---- end of the counted run ----
    device_ms = events_ms(events)
    for h in hooks:
        h.remove()
    remove_events()
    rail = rail_gate("dataflow", device, before)

    live = stream["live"]
    docs = final_rows(captured["docs"])
    got = {row[0]: row for row in docs.values()}
    errors = sum(1 for rows in captured.values() for _k, row, _t, _d in rows if any(v is pw.ERROR for v in row))
    ids = sorted(live)
    direct = np.concatenate([enc.encode([live[i][0] for i in ids[j : j + 512]]) for j in range(0, len(ids), 512)])
    missing = [i for i in ids if i not in got]
    vecs = np.stack([np.asarray(got[i][2], np.float32) for i in ids]) if not missing else None
    cos = (vecs * direct).sum(1) / (np.linalg.norm(vecs, axis=1) * np.linalg.norm(direct, axis=1)) if vecs is not None \
        else np.zeros(1)
    names = dict(stream["sources"])
    want_count = {names[s]: 0 for s in names}
    want_total = {names[s]: 0.0 for s in names}
    for i, v in zip(ids, direct):
        name = names[live[i][1]]
        want_count[name] += 1
        want_total[name] += float(np.dot(v, query))
    groups = {row[0]: row for row in final_rows(captured["per_source"]).values()}
    count_ok = {n: c for n, c in want_count.items() if c} == {n: row[1] for n, row in groups.items()}
    sum_err = max(abs(groups[n][2] - want_total[n]) / max(abs(want_total[n]), 1.0) for n in groups) if groups else 1.0
    replaced_new = [texts[DATAFLOW_DOCS + j] for j in range(len(stream["replaced"]))]
    res = {
        "docs": DATAFLOW_DOCS, "epochs": result.epochs, "sources": DATAFLOW_SOURCES, "changes": DATAFLOW_CHANGES,
        "rows_in": len(stream["rows"]), "rows_per_s": len(stream["rows"]) / wall_s, "wall_ms": wall_s * 1e3,
        "host_ms_per_epoch": epochs_ms, "udf_ms": udf_s[0] * 1e3,
        "dataflow_host_ms_outside_udf": sum(epochs_ms) - udf_s[0] * 1e3,
        "device_ms": device_ms, "idle_share": 1.0 - device_ms / (wall_s * 1e3),
        "batches": len(sizes), "batch_sizes": {int(s): sizes.count(s) for s in sorted(set(sizes))},
        "texts_embedded": sum(sizes), "live_docs": len(ids), "missing_docs": len(missing),
        "retracted_present": sum(1 for i in stream["retracted"] if i in got),
        "replaced_not_embedded": sum(1 for t in replaced_new if t not in embedded),
        "min_cos_vs_encode": float(cos.min()), "count_equal": count_ok, "max_sum_rel_err": sum_err,
        "error_rows": errors, "native": native.get() is not None, "launches": launches,
    }
    log("dataflow", **{k: v for k, v in res.items() if k != "launches"}, kernel_launches=launches)
    # the docs' epochs, the changes' and the sources' (static, at time 0)
    if res["epochs"] != DATAFLOW_EPOCHS + 2 or missing or res["retracted_present"]:
        fail(f"dataflow: {res['epochs']} epochs, {len(missing)} live docs missing, "
             f"{res['retracted_present']} retracted docs present")
    if res["min_cos_vs_encode"] <= COS_MIN:
        fail(f"dataflow: final rows against a direct encode, min cosine {res['min_cos_vs_encode']}")
    if res["replaced_not_embedded"]:
        fail(f"dataflow: {res['replaced_not_embedded']} replaced texts were not re-embedded")
    if not count_ok or not sum_err <= DATAFLOW_SUM_REL:
        fail(f"dataflow: per-source counts equal {count_ok}, score sums off by {sum_err} relative")
    if errors:
        fail(f"dataflow: {errors} rows hold ERROR")
    expected = sum(seen.values())
    if launches["encoder_attention"] != expected or not expected:
        fail(f"dataflow: attention launches {launches['encoder_attention']} != {expected} "
             f"(layers x forwards per shape {seen})")
    gen = torch.Generator(device=device).manual_seed(seed + 109)
    for shape in sorted(set(seen) - set(checked)):
        checked[shape] = check_attention_shape(gen, shape, device)
    log("dataflow", step="shapes", launches={str(list(sh)): n for sh, n in sorted(seen.items())},
        max_abs_err={str(list(sh)): checked[sh] for sh in sorted(seen)})
    return {"launches": launches, "attention_launches": dict(seen), "rail": rail, **res}


# ---------------------------------------------------------------------------
# Phase 7c: the temporal slice, a live windowed topic monitor over BGE-base.
# ---------------------------------------------------------------------------

TEMPORAL_MODEL = BGE_MODEL  # BASELINE.md's streaming-ingest model
TEMPORAL_EVENTS = 16384  # 32,768 until [cluster] (PERF.md section 4)
TEMPORAL_COMMITS = 64  # of about 512 events, in event-time order
TEMPORAL_TOPICS = 16  # drawn Zipf-distributed, exponent 1.0
TEMPORAL_DAY = 86400  # event times in seconds
TEMPORAL_LATE = 0.02  # share of events held back ...
TEMPORAL_LATE_COMMITS = (2, 6)  # ... this many commits
TEMPORAL_ALERTS = 512
TEMPORAL_QUESTIONS = 256  # in 4 commits, after every 16th commit of events
TEMPORAL_TEXT_WORDS = (8, 32)  # of alerts and questions
TEMPORAL_HOP, TEMPORAL_SPAN = 600, 3600  # the sliding windows
TEMPORAL_DELAY, TEMPORAL_CUTOFF = 300, 600  # their common_behavior
TEMPORAL_HOUR = 3600  # the tumbling windows, exactly_once_behavior
TEMPORAL_GAP = 900  # the sessions' max_gap
TEMPORAL_JOIN = (-300, 300)  # the alerts' interval join
TEMPORAL_REL = 1e-4  # vector sums, dot products and scores against the replay
TEMPORAL_PLAIN = 256  # events re-embedded on the plain attention path
TEMPORAL_WAIT_S = 300.0  # the longest the subject waits for an epoch


def temporal_stream(n_events: int, commits: int, n_alerts: int, n_questions: int, seed: int,
                    span: int = TEMPORAL_DAY) -> list:
    """The ``[temporal]`` program's input as a list of commits, each a list of
    rows ``{n, kind, t, topic, text, batch}``: ``n_events`` texts of 6-60
    words at event times spread over ``span`` seconds, each with one of
    ``TEMPORAL_TOPICS`` topics drawn Zipf-distributed (exponent 1.0), in
    ``commits`` commits in event-time order, but a share ``TEMPORAL_LATE``
    held back 2-6 commits; ``n_alerts`` alerts of 8-32 words, each in the
    commit of its time; ``n_questions`` questions of 8-32 words in 4 commits
    of their own, after every quarter of the events' commits."""
    rng = np.random.default_rng(seed)
    texts, _, _, _ = synthetic_corpus(n_events, seed + 1)
    short, _, _, _ = synthetic_corpus(n_alerts + n_questions, seed + 2, words_per_text=TEMPORAL_TEXT_WORDS)
    p = 1.0 / np.arange(1, TEMPORAL_TOPICS + 1)
    p /= p.sum()
    times = np.sort(rng.integers(0, span, size=n_events))
    topics = rng.choice(TEMPORAL_TOPICS, size=n_events, p=p)
    per = -(-n_events // commits)
    slot = np.arange(n_events) // per
    lo, hi = TEMPORAL_LATE_COMMITS
    late = rng.random(n_events) < TEMPORAL_LATE
    slot = np.where(late, np.minimum(slot + rng.integers(lo, hi + 1, size=n_events), commits - 1), slot)
    batches: list[list] = [[] for _ in range(commits)]
    for i in range(n_events):
        batches[slot[i]].append(dict(n=i, kind="event", t=int(times[i]), topic=int(topics[i]), text=texts[i]))
    alert_t = rng.integers(0, span, size=n_alerts)
    alert_topic = rng.choice(TEMPORAL_TOPICS, size=n_alerts, p=p)
    for j in range(n_alerts):
        c = min(int(np.searchsorted(times, alert_t[j])) // per, commits - 1)
        batches[c].append(dict(n=n_events + j, kind="alert", t=int(alert_t[j]), topic=int(alert_topic[j]),
                               text=short[j]))
    q_topic = rng.choice(TEMPORAL_TOPICS, size=n_questions, p=p)
    out, per_q, q = [], n_questions // 4, 0
    for c, rows in enumerate(batches):
        out.append(rows)
        if (c + 1) % (commits // 4) == 0:
            head = int(times[min((c + 1) * per, n_events) - 1])  # the question's own time: the events' head
            out.append([dict(n=n_events + n_alerts + q + k, kind="question", t=head, topic=int(q_topic[q + k]),
                             text=short[n_alerts + q + k]) for k in range(per_q)])
            q += per_q
    for b, rows in enumerate(out):
        for row in rows:
            row["batch"] = b
    return out


def temporal_schema(pw):
    class TemporalRow(pw.Schema):
        n: int = pw.column_definition(primary_key=True)
        kind: str
        t: int
        topic: int
        text: str
        batch: int

    return TemporalRow


def _dot(a, b) -> float:
    return float(np.dot(a, b))


def _cos_to_sum(q, s) -> float:
    return float(np.dot(q, s) / np.linalg.norm(s))


def temporal_program(pw, stream, embed) -> dict:
    """The ``[temporal]`` Table program, for either package as ``pw``, over
    the table ``stream`` (``temporal_schema``): every text embedded by
    ``embed``; the events summarised per topic in (a) sliding windows of an
    hour every 10 minutes under ``common_behavior(delay=300, cutoff=600)``
    (count, vector sum, first and last time), (b) hourly tumbling windows
    under ``exactly_once_behavior()`` (count, vector sum) and (c) sessions
    of ``max_gap`` 900 (count, start, end); (d) each alert's events of its
    topic within 300 s by ``interval_join``, reduced to their count and the
    largest dot product; (e) each question answered by ``asof_now_join``
    against its topic's latest sliding window, scored by the cosine to the
    window's centroid.  Returns the tables by name, ``embedded`` first."""
    temporal = pw.temporal
    filtering = importlib.import_module(pw.__name__ + ".stdlib.utils.filtering")
    embedded = stream.select(pw.this.n, pw.this.kind, pw.this.t, pw.this.topic, pw.this.batch,
                             vec=embed(pw.this.text))
    events = embedded.filter(pw.this.kind == "event").select(pw.this.n, pw.this.t, pw.this.topic, pw.this.vec)
    # the join sides' columns are named apart: a join-select that reads one
    # name from both sides takes the engine's row path
    alerts = embedded.filter(pw.this.kind == "alert").select(
        alert=pw.this.n, at=pw.this.t, atopic=pw.this.topic, avec=pw.this.vec)
    questions = embedded.filter(pw.this.kind == "question").select(
        q=pw.this.n, qtopic=pw.this.topic, qvec=pw.this.vec)
    window = dict(topic=pw.this._pw_instance, start=pw.this._pw_window_start, end=pw.this._pw_window_end,
                  count=pw.reducers.count())
    sliding = events.windowby(
        events.t, window=temporal.sliding(hop=TEMPORAL_HOP, duration=TEMPORAL_SPAN), instance=events.topic,
        behavior=temporal.common_behavior(delay=TEMPORAL_DELAY, cutoff=TEMPORAL_CUTOFF),
    ).reduce(**window, vsum=pw.reducers.sum(pw.this.vec), tmin=pw.reducers.min(pw.this.t),
             tmax=pw.reducers.max(pw.this.t))
    hourly = events.windowby(
        events.t, window=temporal.tumbling(TEMPORAL_HOUR), instance=events.topic,
        behavior=temporal.exactly_once_behavior(),
    ).reduce(**window, vsum=pw.reducers.sum(pw.this.vec))
    times = events.select(pw.this.t, pw.this.topic)
    sessions = times.windowby(times.t, window=temporal.session(max_gap=TEMPORAL_GAP),
                              instance=times.topic).reduce(**window)
    pairs = alerts.interval_join(events, alerts.at, events.t, temporal.interval(*TEMPORAL_JOIN),
                                 alerts.atopic == events.topic).select(alerts.alert, alerts.avec, events.vec)
    per_alert = pairs.select(pw.this.alert, dot=pw.apply_with_type(_dot, float, pw.this.avec, pw.this.vec)).groupby(
        pw.this.alert).reduce(pw.this.alert, pairs=pw.reducers.count(), best=pw.reducers.max(pw.this.dot))
    latest = filtering.argmax_rows(sliding, sliding.topic, what=sliding.end)
    answers = questions.asof_now_join(latest, questions.qtopic == latest.topic).select(
        questions.q, questions.qtopic, start=latest.start, end=latest.end,
        score=pw.apply_with_type(_cos_to_sum, float, questions.qvec, latest.vsum))
    return {"embedded": embedded, "sliding": sliding, "hourly": hourly, "sessions": sessions,
            "alerts": per_alert, "answers": answers}


class PlainWindows:
    """A plain replay of ``windowby`` under a buffer-then-freeze behavior, as
    the engine runs it.  Each epoch's events (in arrival order) are assigned
    their windows window-major (the columnar branches, one per window offset,
    concatenated); the buffer ingests them, its watermark the largest event
    time ingested so far, this epoch included, and releases (in ingestion
    order) every held row whose threshold is at most the watermark; the
    freeze walks the released rows in that order, drops a row whose cutoff
    threshold is at most its own watermark (the largest time of the rows it
    has let through, advanced row by row), and lets the rest through to the
    per-(topic, start, end) count, vector sum and first and last time.  At
    the end of the stream the buffer releases what it still holds.  With
    ``window_major`` False the rows go event by event instead, each event's
    windows in turn, as the flatten path of the assignment gives them."""

    def __init__(self, windows, release, cutoff, window_major: bool = True):
        self.windows, self.release, self.cutoff = windows, release, cutoff
        self.window_major = window_major
        self.held: list = []
        self.wm_buffer = self.wm_freeze = None
        self.groups: dict = {}  # (topic, start, end) -> [count, vectors, tmin, tmax]
        self.dropped = self.peak_held = 0

    def vsum(self, key) -> np.ndarray:
        """The vector sum of the window ``key`` so far, in float64."""
        return np.sum(self.groups[key][1], axis=0, dtype=np.float64)

    def epoch(self, events) -> list:
        """Feed one epoch's ``[(t, topic, vec)]``; returns its changes
        ``[((topic, start, end), count, diff)]``."""
        rows = []
        if events:
            per_event = [self.windows(t) for t, _topic, _vec in events]
            if self.window_major:
                for j in range(len(per_event[0])):
                    rows += [(t, topic, vec, *w[j]) for (t, topic, vec), w in zip(events, per_event)]
            else:
                rows = [(t, topic, vec, *w) for (t, topic, vec), ws in zip(events, per_event) for w in ws]
            top = max(t for t, _topic, _vec in events)
            self.wm_buffer = top if self.wm_buffer is None else max(self.wm_buffer, top)
        self.held += rows
        out, keep = [], []
        for row in self.held:
            (out if self.release(*row[:1], *row[3:]) <= self.wm_buffer else keep).append(row)
        self.held = keep
        self.peak_held = max(self.peak_held, len(keep))
        return self._apply(out)

    def finish(self) -> list:
        out, self.held = self.held, []
        return self._apply(out)

    def _apply(self, rows) -> list:
        touched: dict = {}
        for t, topic, vec, start, end in rows:
            if self.wm_freeze is not None and self.cutoff(start, end) <= self.wm_freeze:
                self.dropped += 1
                continue
            self.wm_freeze = t if self.wm_freeze is None else max(self.wm_freeze, t)
            key = (topic, start, end)
            g = self.groups.get(key)
            touched.setdefault(key, None if g is None else g[0])
            if g is None:
                self.groups[key] = [1, [vec], t, t]
            else:
                g[0] += 1
                g[1].append(vec)
                g[2], g[3] = min(g[2], t), max(g[3], t)
        changes = []
        for key, old in touched.items():
            if old is not None:
                changes.append((key, old, -1))
            changes.append((key, self.groups[key][0], 1))
        return sorted(changes)


def sliding_windows(t: int) -> list:
    base = t // TEMPORAL_HOP * TEMPORAL_HOP
    m = TEMPORAL_SPAN // TEMPORAL_HOP
    return [(base - (m - 1 - j) * TEMPORAL_HOP, base - (m - 1 - j) * TEMPORAL_HOP + TEMPORAL_SPAN) for j in range(m)]


def temporal_replay(epochs: list) -> dict:
    """The ``[temporal]`` program replayed in plain Python on ``epochs``, the
    embedded table's rows ``(n, kind, t, topic, batch, vec)`` of each epoch
    in the order the run delivered them: the sliding, hourly and session
    windows, the alerts' pairs and the questions' answers, with the sliding
    windows' rows dropped by the cutoff (and what the flatten path's
    event-major order would drop) and the hourly windows' changes per
    epoch."""
    behavior = (lambda t, s, e: t + TEMPORAL_DELAY, lambda s, e: e + TEMPORAL_CUTOFF)
    sliding = PlainWindows(sliding_windows, *behavior)
    event_major = PlainWindows(sliding_windows, *behavior, window_major=False)
    hourly = PlainWindows(lambda t: [(t // TEMPORAL_HOUR * TEMPORAL_HOUR, t // TEMPORAL_HOUR * TEMPORAL_HOUR + TEMPORAL_HOUR)],
                          lambda t, s, e: e, lambda s, e: e)
    hourly_changes, answers, events, alerts = [], {}, [], []
    for rows in epochs:
        batch = [(r[2], r[3], r[5]) for r in rows if r[1] == "event"]
        events += batch
        alerts += [r for r in rows if r[1] == "alert"]
        sliding.epoch(batch)
        event_major.epoch(batch)
        hourly_changes.append(hourly.epoch(batch))
        for n, kind, _t, topic, _b, qvec in rows:
            live = [(key[2], key) for key in sliding.groups if key[0] == topic] if kind == "question" else ()
            if live:
                _, key = max(live)
                vsum = sliding.vsum(key)
                answers[n] = (topic, key[1], key[2], float(np.dot(qvec, vsum) / np.linalg.norm(vsum)))
    sliding.finish()
    event_major.finish()
    hourly_changes.append(hourly.finish())
    by_topic: dict = {}
    for t, topic, vec in events:
        by_topic.setdefault(topic, []).append((t, vec))
    index, sessions = {}, {}
    for topic, rows in by_topic.items():
        rows.sort(key=lambda r: r[0])
        ts = np.array([t for t, _vec in rows])
        index[topic] = (ts, np.stack([vec for _t, vec in rows]))
        breaks = np.flatnonzero(np.diff(ts) > TEMPORAL_GAP)
        for a, b in zip(np.concatenate(([0], breaks + 1)), np.concatenate((breaks, [len(ts) - 1]))):
            sessions[(topic, int(ts[a]), int(ts[b]))] = int(b - a + 1)
    per_alert = {}
    for n, _kind, at, topic, _b, avec in alerts:
        ts, vecs = index.get(topic, (np.zeros(0, np.int64), None))
        lo, hi = np.searchsorted(ts, at + TEMPORAL_JOIN[0]), np.searchsorted(ts, at + TEMPORAL_JOIN[1], side="right")
        if hi > lo:
            per_alert[n] = (int(hi - lo), float((vecs[lo:hi] @ avec).max()))
    for windows in (sliding, hourly):
        for key, g in windows.groups.items():
            g[1] = windows.vsum(key)
    return {"sliding": sliding.groups, "dropped": sliding.dropped, "dropped_event_major": event_major.dropped,
            "peak_held": sliding.peak_held,
            "hourly": hourly.groups, "hourly_changes": [c for c in hourly_changes if c],
            "sessions": sessions, "alerts": per_alert, "answers": answers}


def temporal_checks(run: dict, replay: dict) -> dict:
    """The run's final tables and change streams against the replay's:
    the number of each mismatch, and the largest relative errors."""
    def rel(a, b) -> float:
        return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30))

    sliding = {(r["topic"], r["start"], r["end"]): r for r in run["sliding"].values()}
    want = replay["sliding"]
    bad = [k for k in want if k not in sliding or (sliding[k]["count"], sliding[k]["tmin"], sliding[k]["tmax"])
           != (want[k][0], want[k][2], want[k][3])]
    out = {"sliding_windows": len(sliding), "sliding_mismatched": len(bad) + len(set(sliding) - set(want)),
           "sliding_sum_rel": max((rel(sliding[k]["vsum"], want[k][1]) for k in want if k in sliding), default=0.0)}
    hourly = {(r["topic"], r["start"], r["end"]): r for r in run["hourly"].values()}
    out["hourly_windows"] = len(hourly)
    out["hourly_mismatched"] = sum(1 for k, g in replay["hourly"].items() if k not in hourly or hourly[k]["count"] != g[0]) \
        + len(set(hourly) - set(replay["hourly"]))
    out["hourly_sum_rel"] = max((rel(hourly[k]["vsum"], g[1]) for k, g in replay["hourly"].items() if k in hourly),
                                default=0.0)
    by_time: dict = {}
    for _key, row, time_, add in run["hourly_stream"]:
        by_time.setdefault(time_, []).append(((row["topic"], row["start"], row["end"]), row["count"], 1 if add else -1))
    out["hourly_stream_equal"] = [sorted(by_time[t]) for t in sorted(by_time)] == replay["hourly_changes"]
    out["hourly_retractions"] = sum(1 for *_r, add in run["hourly_stream"] if not add)
    sessions = {(r["topic"], r["start"], r["end"]): r["count"] for r in run["sessions"].values()}
    out["sessions"] = len(sessions)
    out["sessions_equal"] = sessions == replay["sessions"]
    alerts = {r["alert"]: (r["pairs"], r["best"]) for r in run["alerts"].values()}
    out["alerts_with_pairs"] = len(alerts)
    out["alert_pairs"] = sum(c for c, _b in alerts.values())
    out["alert_counts_equal"] = {n: c for n, (c, _b) in alerts.items()} == {n: c for n, (c, _b) in replay["alerts"].items()}
    out["alert_best_err"] = max((abs(alerts[n][1] - b) for n, (_c, b) in replay["alerts"].items() if n in alerts),
                                default=0.0)
    answers = {r["q"]: (r["qtopic"], r["start"], r["end"], r["score"]) for r in run["answers"].values()}
    out["answers"] = len(answers)
    out["answers_revised"] = sum(1 for *_r, add in run["answers_stream"] if not add)
    out["answer_windows_equal"] = {q: a[:3] for q, a in answers.items()} == \
        {q: a[:3] for q, a in replay["answers"].items()}
    out["answer_score_err"] = max((abs(answers[q][3] - a[3]) for q, a in replay["answers"].items() if q in answers),
                                  default=0.0)
    return out


def temporal_phase(device, seed: int, checked: dict) -> dict:
    """Phase 7c: the temporal slice at full BGE-base width: ``pw.temporal``'s
    windows, behaviors and time joins over a live topic stream fed by
    ``pw.io.python.read``, through ``pw.run``, held to a plain replay of the
    epochs the run had.  ``checked`` gains the attention shapes the run gave
    the kernel."""
    import threading

    t_setup = time.perf_counter()
    import pathway_tpu_torch as pw
    from pathway_tpu_torch import native
    from pathway_tpu_torch.engine import dataflow as df
    from pathway_tpu_torch.internals import vector_compiler as vc
    from pathway_tpu_torch.models.encoder import init_params
    from pathway_tpu_torch.ops.attention import encoder_attention
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    if native.get() is None:
        fail("temporal: the native core did not load")
    embedder = SentenceTransformerEmbedder(TEMPORAL_MODEL)
    enc = embedder._encoder
    enc.set_params(init_params(enc.config, seed))  # seeded weights at full width
    batches = temporal_stream(TEMPORAL_EVENTS, TEMPORAL_COMMITS, TEMPORAL_ALERTS, TEMPORAL_QUESTIONS, seed + 601)
    enc.encode([row["text"] for row in batches[-1]])  # warm-up, outside the counted run
    setup_s = time.perf_counter() - t_setup

    progress = threading.Condition()
    seen = {"batch": -1, "epoch_max": -1}
    commit_at: list[float] = []
    stalled: list[str] = []

    class Topics(pw.io.python.ConnectorSubject):
        """Each commit waits until the run has taken it into an epoch: a
        producer that reads its log as fast as the pipeline keeps up."""

        def run(self):
            for b, rows in enumerate(batches):
                for row in rows:
                    self.next(**row)
                self.commit()
                commit_at.append(time.perf_counter())
                with progress:
                    if not progress.wait_for(lambda: seen["batch"] >= b, timeout=TEMPORAL_WAIT_S):
                        stalled.append(f"commit {b} reached no epoch in {TEMPORAL_WAIT_S} s")
                        break
            self.close()

    stream = pw.io.python.read(Topics(), schema=temporal_schema(pw))
    tables = temporal_program(pw, stream, embedder)
    arrivals: list[tuple] = []  # (time, n, kind, t, topic, batch, vec) in delivery order
    captured = {name: [] for name in tables if name != "embedded"}
    epoch_end: dict[int, float] = {}  # sliding output's epochs: time -> wall clock at on_time_end

    def on_embedded(key, row, time, is_addition):
        arrivals.append((time, row["n"], row["kind"], row["t"], row["topic"], row["batch"], row["vec"]))
        seen["epoch_max"] = max(seen["epoch_max"], row["batch"])

    def on_embedded_epoch(time):
        with progress:
            seen["batch"] = max(seen["batch"], seen["epoch_max"])
            progress.notify_all()

    pw.io.subscribe(tables["embedded"], on_change=on_embedded, on_time_end=on_embedded_epoch)
    for name in captured:
        pw.io.subscribe(tables[name], on_change=lambda key, row, time, is_addition, out=captured[name]:
                        out.append((key, row, time, is_addition)),
                        on_time_end=(lambda time: epoch_end.__setitem__(time, _now())) if name == "sliding" else None)

    sizes: list[int] = []
    process = embedder._batcher.process_batch

    def counted(items):
        sizes.append(len(items))
        return process(items)

    embedder._batcher.process_batch = counted
    scopes: list = []
    held_peak: dict[int, int] = {}
    run_epoch, buffer_step = df.Scope.run_epoch, df.BufferNode.step

    def first_scope(scope, time_):
        if not scopes:
            scopes.append(scope)
        return run_epoch(scope, time_)

    def peak_buffer(node, time_):
        try:
            return buffer_step(node, time_)
        finally:
            held_peak[node.id] = max(held_peak.get(node.id, 0), len(node._held))

    seen_shapes: dict[tuple, int] = {}
    hooks = [record_launches(enc, seen_shapes)]
    events, remove_events = forward_events(enc)
    bails_before = dict(vc.BAIL_COUNTS)
    df.Scope.run_epoch, df.BufferNode.step = first_scope, peak_buffer
    # ---- the counted run: counts zeroed just before, read just after ----
    encoder_attention.launches = 0
    seen_shapes.clear()
    before = rail_state(device)
    try:
        t0 = time.perf_counter()
        result = pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        wall_s = time.perf_counter() - t0
    finally:
        df.Scope.run_epoch, df.BufferNode.step = run_epoch, buffer_step
        embedder._batcher.process_batch = process
        pw.G.clear()
    launches = {"encoder_attention": encoder_attention.launches}
    # ---- end of the counted run ----
    t_after = time.perf_counter()
    device_ms = events_ms(events)
    for h in hooks:
        h.remove()
    remove_events()
    rail = rail_gate("temporal", device, before)
    if stalled:
        fail(f"temporal: {stalled[0]}")

    # the run's graph: node host time by class, the behaviors' nodes
    nodes = scopes[0].nodes if scopes else []
    node_ms: dict[str, float] = {}
    for node in nodes:
        node_ms[type(node).__name__] = node_ms.get(type(node).__name__, 0.0) + node.step_seconds * 1e3
    buffers = [n for n in nodes if isinstance(n, df.BufferNode)]
    sliding_buffer = [n for n in buffers if isinstance(n.inputs[0], df.ConcatNode)
                      and len(n.inputs[0].inputs) == TEMPORAL_SPAN // TEMPORAL_HOP
                      and all(isinstance(b, df.SaltRekeyNode) for b in n.inputs[0].inputs)]
    freezes = {n.inputs[0].id: n for n in nodes if isinstance(n, df.FreezeNode)}
    temporal_nodes = {f"{type(n).__name__}#{n.id}<{type(n.inputs[0]).__name__}": {
                      "vec_batches": n.vec_batches, "row_batches": n.row_batches, "ms": n.step_seconds * 1e3}
                      for n in nodes if isinstance(n, (df.BufferNode, df.FreezeNode, df.GroupByNode))}
    dropped = [freezes[b.id].rows_in - freezes[b.id].rows_out for b in sliding_buffer if b.id in freezes]

    def lineage(node, depth: int = 4) -> str:
        names = []
        while node is not None and len(names) < depth:
            names.append(f"{type(node).__name__}#{node.id}")
            node = node.inputs[0] if node.inputs else None
        return "<".join(names)

    top_nodes = {lineage(n): {"ms": n.step_seconds * 1e3, "rows_in": n.rows_in, "rows_out": n.rows_out}
                 for n in sorted(nodes, key=lambda n: -n.step_seconds)[:10]}
    bails = {f"{op}:{reason}": n - bails_before.get((op, reason), 0) for (op, reason), n in vc.BAIL_COUNTS.items()
             if n != bails_before.get((op, reason), 0)}

    # the replay, on the epochs the run had
    by_time: dict[int, list] = {}
    for time_, *row in arrivals:
        by_time.setdefault(time_, []).append(tuple(row))
    epochs = [by_time[t] for t in sorted(by_time)]
    t_check = time.perf_counter()
    replay = temporal_replay(epochs)
    run = {name: final_rows(rows) for name, rows in captured.items()}
    run["hourly_stream"], run["answers_stream"] = captured["hourly"], captured["answers"]
    res = temporal_checks(run, replay)
    res["dropped_run"], res["dropped_replay"] = sum(dropped), replay["dropped"]
    res["dropped_replay_event_major"] = replay["dropped_event_major"]

    # the embeddings against the plain attention path
    rng = np.random.default_rng(seed + 607)
    event_rows = [row for rows in batches for row in rows if row["kind"] == "event"]
    sample = [event_rows[i] for i in rng.choice(len(event_rows), size=TEMPORAL_PLAIN, replace=False)]
    got = {n: vec for _t, n, _k, _tt, _top, _b, vec in arrivals}
    plain = plain_embeddings(enc, [row["text"] for row in sample], device)
    mine = np.stack([got[row["n"]] for row in sample])
    cos = (plain * mine).sum(1) / (np.linalg.norm(plain, axis=1) * np.linalg.norm(mine, axis=1))
    check_s = time.perf_counter() - t_check

    # throughput and latency: commit -> the first sliding update at or after the commit's epoch
    landed = {}
    for time_, _n, _k, _t, _top, b, _v in arrivals:
        landed.setdefault(b, time_)
    updates = sorted(t for t in epoch_end if any(d[2] == t for d in captured["sliding"]))
    event_batches = [b for b, rows in enumerate(batches) if rows and rows[0]["kind"] != "question"]
    latency = []
    for b in event_batches:
        after = [t for t in updates if t >= landed.get(b, float("inf"))]
        if after:
            latency.append((epoch_end[after[0]] - commit_at[b]) * 1e3)
    n_events = len(event_rows)
    span_s = (epoch_end[updates[-1]] - commit_at[0]) if updates else float("nan")
    res.update({
        "events": n_events, "alerts": TEMPORAL_ALERTS, "questions": TEMPORAL_QUESTIONS, "commits": len(batches),
        "epochs": result.epochs, "input_epochs": len(epochs), "wall_ms": wall_s * 1e3, "setup_s": setup_s,
        "check_s": check_s, "after_run_s": t_check - t_after, "events_per_s": n_events / span_s,
        "commit_to_window_ms": percentiles(latency) if latency else {},
        "host_ms_per_epoch_by_node": {k: v / max(result.epochs, 1) for k, v in sorted(node_ms.items(), key=lambda kv: -kv[1])},
        "top_nodes": top_nodes, "behavior_nodes": temporal_nodes, "peak_buffered": {f"buffer{i}": held_peak.get(b.id, 0) for i, b in enumerate(buffers)},
        "peak_buffered_replay": replay["peak_held"], "columnar_bails": bails,
        "device_ms": device_ms, "idle_share": 1.0 - device_ms / (wall_s * 1e3), "batches": len(sizes),
        "batch_sizes": {int(s): sizes.count(s) for s in sorted(set(sizes))}, "texts_embedded": sum(sizes),
        "min_cos_vs_plain": float(cos.min()), "sliding_branches": len(sliding_buffer), "launches": launches,
    })
    log("temporal", **{k: v for k, v in res.items() if k != "launches"}, kernel_launches=launches)
    if len(latency) != len(event_batches):
        fail(f"temporal: {len(event_batches) - len(latency)} commits of events never showed in the sliding windows")
    if len(sliding_buffer) != 1:
        fail("temporal: the sliding windows were not assigned by the columnar branches (a flatten path ran)")
    if res["min_cos_vs_plain"] <= COS_MIN:
        fail(f"temporal: embeddings against the plain attention path, min cosine {res['min_cos_vs_plain']}")
    if res["sliding_mismatched"] or res["sliding_sum_rel"] > TEMPORAL_REL or res["dropped_run"] != res["dropped_replay"]:
        fail(f"temporal: sliding windows against the replay: {res['sliding_mismatched']} mismatched, vector sums "
             f"{res['sliding_sum_rel']} relative, dropped {res['dropped_run']} against {res['dropped_replay']}")
    if res["hourly_mismatched"] or res["hourly_sum_rel"] > TEMPORAL_REL or not res["sessions_equal"]:
        fail(f"temporal: hourly windows {res['hourly_mismatched']} mismatched (sums {res['hourly_sum_rel']}), "
             f"sessions equal {res['sessions_equal']}")
    if not res["hourly_stream_equal"]:
        fail("temporal: the exactly-once hourly stream is not the replay's, epoch by epoch")
    if not res["alert_counts_equal"] or res["alert_best_err"] > TEMPORAL_REL:
        fail(f"temporal: interval join counts equal {res['alert_counts_equal']}, best dot off by {res['alert_best_err']}")
    if not res["answer_windows_equal"] or res["answer_score_err"] > TEMPORAL_REL or res["answers_revised"]:
        fail(f"temporal: as-of-now answers name the replay's windows {res['answer_windows_equal']}, scores off by "
             f"{res['answer_score_err']}, {res['answers_revised']} revised")
    expected = sum(seen_shapes.values())
    if launches["encoder_attention"] != expected or not expected:
        fail(f"temporal: attention launches {launches['encoder_attention']} != {expected} "
             f"(layers x forwards per shape {seen_shapes})")
    gen = torch.Generator(device=device).manual_seed(seed + 611)
    t_shapes = time.perf_counter()
    for shape in sorted(set(seen_shapes) - set(checked)):
        checked[shape] = check_attention_shape(gen, shape, device)
    log("temporal", step="shapes", launches={str(list(sh)): n for sh, n in sorted(seen_shapes.items())},
        max_abs_err={str(list(sh)): checked[sh] for sh in sorted(seen_shapes)},
        check_s=time.perf_counter() - t_shapes)
    return {"launches": launches, "attention_launches": dict(seen_shapes), "rail": rail, **res}


# ---------------------------------------------------------------------------
# Phase 8: decoder generation, dense DecoderLM and the continuous scheduler.
# ---------------------------------------------------------------------------

GEN_MODEL = "mistral-7b-instruct"
GEN_WIDTHS = dict(layers=32, hidden=4096, heads=32, kv_heads=8, intermediate=14336, vocab_size=32000)
GEN_CACHE = 1024
GEN_REQUESTS = 16  # 32 until the script passed its time limit (PERF.md section 5)
GEN_SAMPLED = 4
GEN_NEW_TOKENS = 128  # JaxChat's default
GEN_PROMPT_LENS = (64, 896)
GEN_TEMP, GEN_TOP_P = 0.7, 0.9
GEN_REF_BATCH = 8  # dense reference batch: bounds its [B, heads, S, C] f32 scores
GEN_LOGIT_ROWS = 4


def near_tie_tol(logits):
    """0.05·(max|logit|+1) per row: the relative form of the JAX package's
    cross-encoder pin (tests/test_attention_kernel.py:135)."""
    return 0.05 * (logits.abs().amax(dim=-1) + 1.0)


def eager_ms(fn, iters: int = 10) -> float:
    """Host-clock ms per eager call that ends in a synchronize: what one
    call costs the calling thread, launches and waiting included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def fed_tokens(rows, steps: int, device):
    """``rows`` as ``[B, steps]`` ids (0 past a row's end) and their live mask."""
    tok = torch.zeros((len(rows), steps), dtype=torch.int64, device=device)
    live = torch.zeros((len(rows), steps), dtype=torch.bool, device=device)
    for r, o in enumerate(rows):
        tok[r, : min(len(o), steps)] = torch.tensor(o[:steps], dtype=torch.int64, device=device)
        live[r, : len(o)] = True
    return tok, live


def dense_prefill(lm, tree, prompts):
    """``prefill`` of ``prompts`` with the weights ``tree`` over the dense
    path of ``lm``: logits, caches and the prompt lengths."""
    from pathway_tpu_torch.models import decoder as dec

    dev = lm.device
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    ids = torch.zeros((len(prompts), dec._bucket_prompt_len(int(lens.max()), lm.max_cache)),
                      dtype=torch.int64, device=dev)
    for i, p in enumerate(prompts):
        ids[i, : len(p)] = torch.tensor(p, device=dev)
    return (*dec.prefill(tree, ids, lens, lm.config, lm.max_cache), lens)


def dense_step_logits(lm, prompts, tokens, steps):
    """Dense-path logits ``[B, steps, V]`` of ``prompts`` fed ``tokens``
    (teacher forcing): step t's logits are the ones token t is chosen
    from.  Rows shorter than ``steps`` are fed 0s past their end."""
    from pathway_tpu_torch.models import decoder as dec

    logits, kc, vc, lens = dense_prefill(lm, lm.params, prompts)
    feed = fed_tokens(tokens, steps, lm.device)[0]
    out = [logits]
    for t in range(steps - 1):
        logits, kc, vc = dec.decode_step(lm.params, kc, vc, feed[:, t], lens + t, lm.config)
        out.append(logits)
    return torch.stack(out, dim=1)


def dense_greedy(lm, tree, prompts, steps):
    """Greedy rows of ``steps`` tokens (no EOS stop) of the weights ``tree``
    over the dense path of ``lm``."""
    from pathway_tpu_torch.models import decoder as dec

    logits, kc, vc, lens = dense_prefill(lm, tree, prompts)
    out = [logits.argmax(dim=-1)]
    for t in range(steps - 1):
        logits, kc, vc = dec.decode_step(tree, kc, vc, out[-1], lens + t, lm.config)
        out.append(logits.argmax(dim=-1))
    return torch.stack(out, dim=1).tolist()


def paged_step_logits(lm, prompts, tokens, steps):
    """The same teacher-forced logits through the paged path: chunked
    ``paged_prefill_chunk`` then ``paged_decode_step``, on a fresh pool,
    at the scheduler's default chunk and page sizes."""
    from pathway_tpu_torch.models import decoder as dec

    B, dev, cfg = len(prompts), lm.device, lm.config
    chunk, page = 32, 16
    G = lm.max_cache // page
    k_pool, v_pool = dec.init_kv_pool(cfg, 1 + B * G, page, dev)
    bt = (1 + torch.arange(B * G, device=dev)).reshape(B, G)
    lens = [len(p) for p in prompts]
    done = [0] * B
    logits = torch.zeros((B, cfg.vocab_size), device=dev)
    while any(d < n for d, n in zip(done, lens)):
        ids = torch.zeros((B, chunk), dtype=torch.int64, device=dev)
        clens, starts, take = [0] * B, list(done), [False] * B
        for i, p in enumerate(prompts):
            n = min(chunk, lens[i] - done[i])
            if n > 0:
                ids[i, :n] = torch.tensor(p[done[i]:done[i] + n], device=dev)
                clens[i], take[i] = n, done[i] + n >= lens[i]
        new, k_pool, v_pool = dec.paged_prefill_chunk(
            lm.params, k_pool, v_pool, bt, ids, torch.tensor(clens, device=dev),
            torch.tensor(starts, device=dev), cfg)
        logits = torch.where(torch.tensor(take, device=dev)[:, None], new, logits)
        done = [d + c for d, c in zip(done, clens)]
    feed = fed_tokens(tokens, steps, dev)[0]
    seq = torch.tensor(lens, device=dev)
    out = [logits]
    for t in range(steps - 1):
        logits, k_pool, v_pool = dec.paged_decode_step(lm.params, k_pool, v_pool, bt, seq + t, feed[:, t], cfg)
        out.append(logits)
    return torch.stack(out, dim=1)


def serve_burst(lm, prompts, sampled, new_tokens: int, seed: int, phase: str) -> dict:
    """Submit every prompt at once to a ``GenerationScheduler`` at the repo's
    defaults (rows in ``sampled`` at temperature 0.7 / top-p 0.9, the rest
    greedy) and wait for all: the answers, tokens/s, TTFT, latency and the
    pages, with the encoder kernel's launches counted over the burst."""
    from pathway_tpu_torch.ops import attention as attn
    from pathway_tpu_torch.serving.generation import GenerationScheduler

    lengths = np.array([len(p) for p in prompts])
    sched = GenerationScheduler(lm, seed=seed)  # the repo's defaults
    log(phase, step="scheduler", slots=sched.slots, page_size=sched.page_size,
        pages=sched.num_pages, prefill_chunk=sched.prefill_chunk, queue_limit=sched.queue_limit,
        pool_gb=2 * sched._k_pool.numel() * sched._k_pool.element_size() / 1e9,
        dense_kv_gb=sched.dense_kv_bytes / 1e9, requests=len(prompts), sampled=sampled,
        host_gc_objects=len(gc.get_objects()), cuda_reserved_gb=torch.cuda.memory_reserved() / 1e9,
        prompt_len_min=int(lengths.min()), prompt_len_max=int(lengths.max()),
        prompt_len_mean=float(lengths.mean()))

    # ---- the counted run: counts zeroed just before, read just after ----
    attn.encoder_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [
        sched.submit_request(p, max_new_tokens=new_tokens,
                             **({"temperature": GEN_TEMP, "top_p": GEN_TOP_P} if i in sampled else {}))
        for i, p in enumerate(prompts)
    ]
    outs = [r.future.result(timeout=900) for r in reqs]  # raises if a request failed
    burst_s = time.perf_counter() - t0
    launches = {"encoder_attention": attn.encoder_attention.launches}
    # ---- end of the counted run ----
    snap = sched.snapshot()
    sched.shutdown()
    tokens = sum(len(o) for o in outs)
    ttft = [r.ttft_s * 1e3 for r in reqs]
    latency = [(r.finished_at - r.submitted_at) * 1e3 for r in reqs]
    burst = {
        "tokens": tokens, "seconds": burst_s, "tokens_per_s": tokens / burst_s,
        "ttft_ms_p50": float(np.percentile(ttft, 50)), "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "latency_ms_p50": float(np.percentile(latency, 50)),
        "latency_ms_p99": float(np.percentile(latency, 99)),
        "decode_ticks": snap["decode_steps"], "prefill_chunks": snap["prefill_chunks"],
        "ms_per_tick": burst_s * 1e3 / snap["decode_steps"],
        "kv_peak_gb": snap["kv_bytes_peak"] / 1e9, "kv_dense_gb": snap["kv_bytes_dense"] / 1e9,
    }
    log(phase, step="burst", **burst, kernel_launches=launches, snapshot=snap)
    if snap["pages_used"] or snap["pages_reserved"]:
        fail(f"{phase}: pages left after the burst: {snap['pages_used']} used, {snap['pages_reserved']} reserved")
    if not 0 < snap["kv_bytes_peak"] < snap["kv_bytes_dense"]:
        fail(f"{phase}: peak KV {snap['kv_bytes_peak']} not in (0, dense {snap['kv_bytes_dense']})")
    if snap["requests"] != len(prompts) or any(r.finished_at is None for r in reqs):
        fail(f"{phase}: not every request was served")
    return {"outs": outs, "launches": launches, "burst": burst, "sched_slots": sched.slots}


def first_parting(a, b) -> int | None:
    """The first step at which token rows ``a`` and ``b`` differ, ``None``
    when they are equal."""
    if a == b:
        return None
    return next((j for j in range(min(len(a), len(b))) if a[j] != b[j]), min(len(a), len(b)))


def below_max(logits, tok, live) -> dict:
    """How far each fed token's logit lies below the max of its step, over
    ``near_tie_tol`` of that step: the tokens counted (``live``), those at
    the max, those ``tol`` or more below it, and the worst gap/tol."""
    chosen = logits.gather(-1, tok[..., None])[..., 0]
    top = logits.amax(dim=-1)
    ratio = torch.where(live, (top - chosen) / near_tie_tol(logits), 0.0)
    tokens, over = int(live.sum()), int((ratio >= 1.0).sum())
    return {"tokens": tokens, "max_share": int(((chosen == top) & live).sum()) / tokens,
            "tokens_over_tol": over, "share_over_tol": over / tokens, "worst_gap_over_tol": float(ratio.max())}


def emitted_gaps(lm, prompts, rows, steps: int, batch: int = GEN_REF_BATCH) -> dict:
    """:func:`below_max` of every token of ``rows`` (each continuing its
    prompt) teacher-forced through the dense path of ``lm``, in batches of
    ``batch``."""
    parts = [below_max(dense_step_logits(lm, prompts[b : b + batch], rows[b : b + batch], steps),
                       *fed_tokens(rows[b : b + batch], steps, lm.device))
             for b in range(0, len(rows), batch)]
    tokens = sum(q["tokens"] for q in parts)
    over = sum(q["tokens_over_tol"] for q in parts)
    return {"tokens": tokens, "max_share": sum(q["max_share"] * q["tokens"] for q in parts) / tokens,
            "tokens_over_tol": over, "share_over_tol": over / tokens,
            "worst_gap_over_tol": max(q["worst_gap_over_tol"] for q in parts)}


def check_generation(lm, prompts, outs, greedy, sampled, new_tokens: int, device, phase: str,
                     reference=None) -> int:
    """The burst's answers against the dense path: every greedy token,
    teacher-forced through the dense path, within tol of the max of its
    step (the rows equal to ``DecoderLM.generate_ids`` but at near-ties);
    the paged path's teacher-forced logits within tol of the dense path's;
    every sampled token inside its top-p support.  The dense path is that
    of ``reference`` (a ``DecoderLM``; ``lm`` itself by default), the paged
    path that of ``lm``.  Each check is logged before the run fails on any.
    Returns the greedy rows that parted."""
    from pathway_tpu_torch.models import decoder as dec

    ref = lm if reference is None else reference
    # greedy rows against the dense DecoderLM.generate_ids, in batches
    dense = {}
    for b in range(0, len(greedy), GEN_REF_BATCH):
        rows = greedy[b : b + GEN_REF_BATCH]
        for i, o in zip(rows, ref.generate_ids([prompts[i] for i in rows], max_new_tokens=new_tokens)):
            dense[i] = o
    parted = {i: t for i in greedy if (t := first_parting(outs[i], dense[i])) is not None}
    emitted = emitted_gaps(ref, [prompts[i] for i in greedy], [outs[i] for i in greedy], new_tokens)

    # logits of the paged path against the dense path, teacher-forced
    rows = greedy[:GEN_LOGIT_ROWS]
    feed = [dense[i] for i in rows]
    d = dense_step_logits(ref, [prompts[i] for i in rows], feed, new_tokens)
    p = paged_step_logits(lm, [prompts[i] for i in rows], feed, new_tokens)
    tol = near_tie_tol(d)
    tok, live = fed_tokens(feed, new_tokens, device)
    steps = live.clone()
    steps[:, 0] = True  # step 0's logits follow the prompt alone
    ratio = torch.where(steps, (p - d).abs().amax(dim=-1), 0.0) / tol  # [rows, steps]
    check = {"rows": rows, "steps": new_tokens, "min_tol": float(tol.min()),
             "max_abs_err": float((ratio * tol).max()), "worst_err_over_tol": float(ratio.max()),
             "steps_over_tol": int((ratio >= 1.0).sum())}
    problems = [] if bool(torch.isfinite(p).all()) else [f"{phase}: paged logits are not finite"]
    if lm.config.experts:
        # Top-2 routing is discontinuous: where rounding differs, a near-tied
        # router sends a token to other experts, and its logits (and, through
        # its K/V, later steps') part by more than tol.  The control is the
        # dense path against itself, each row run alone (a batch of one):
        # its logits against the batched dense path's, and the batched dense
        # path's greedy tokens against its max.  The paged path may part from
        # the dense path no more often, and by no more, than that.
        alone = torch.cat([dense_step_logits(ref, [prompts[i]], [f], new_tokens) for i, f in zip(rows, feed)])
        ctrl = torch.where(steps, (alone - d).abs().amax(dim=-1), 0.0) / tol
        check.update(control_worst_err_over_tol=float(ctrl.max()), control_steps_over_tol=int((ctrl >= 1.0).sum()))
        control = below_max(alone, tok, live)
        if (emitted["share_over_tol"] > control["share_over_tol"]
                or emitted["worst_gap_over_tol"] > control["worst_gap_over_tol"]):
            problems.append(f"{phase}: greedy tokens part from the dense path's max more than the dense path's own "
                            f"tokens do with its rows run alone: {emitted} against {control}")
        if (check["steps_over_tol"] > check["control_steps_over_tol"]
                or check["worst_err_over_tol"] > check["control_worst_err_over_tol"]):
            problems.append(f"{phase}: paged logits part from the dense path more than the dense path from itself: "
                            f"{check['steps_over_tol']} steps over tol (control {check['control_steps_over_tol']}), "
                            f"worst err/tol {check['worst_err_over_tol']} (control "
                            f"{check['control_worst_err_over_tol']})")
        emitted["control_rows_alone"] = control
    else:
        if emitted["tokens_over_tol"]:
            problems.append(f"{phase}: {emitted['tokens_over_tol']} greedy token(s) lie tol or more below the dense "
                            f"path's max (worst gap/tol {emitted['worst_gap_over_tol']})")
        if check["worst_err_over_tol"] >= 1.0:
            problems.append(f"{phase}: paged logits left the dense path's bound: err/tol {check['worst_err_over_tol']}")
    log(phase, step="check_greedy", rows=len(greedy), identical=len(greedy) - len(parted), parted=len(parted),
        parted_at_step=parted, **emitted)
    log(phase, step="check_logits", **check)

    # each sampled token lies in the support its filters leave
    if sampled:
        feed = [outs[i] for i in sampled]
        lg = dense_step_logits(ref, [prompts[i] for i in sampled], feed, new_tokens)
        kept = torch.isfinite(dec._filter_logits(lg / GEN_TEMP, top_p=GEN_TOP_P))
        kept_min = torch.where(kept, lg, float("inf")).amin(dim=-1)
        tok, live = fed_tokens(feed, new_tokens, device)
        chosen = lg.gather(-1, tok[..., None])[..., 0]
        inside = kept.gather(-1, tok[..., None])[..., 0] & live
        near = (chosen >= kept_min - near_tie_tol(lg)) & live
        log(phase, step="check_sampled", rows=sampled, tokens=int(live.sum()),
            in_support=int(inside.sum()), within_tol_of_support=int(near.sum()),
            mean_support_size=float(kept.sum(-1).float()[live].mean()))
        if int(near.sum()) != int(live.sum()):
            problems.append(f"{phase}: {int(live.sum()) - int(near.sum())} sampled token(s) outside the top-p support")
    if problems:
        fail("; ".join(problems))
    return len(parted)


def burst_prompts(rng, n: int, n_sampled: int, lens: tuple[int, int], vocab: int):
    """``n`` prompts of ``lens`` token ids, and which rows sample."""
    lengths = rng.integers(lens[0], lens[1] + 1, size=n)
    prompts = [rng.integers(3, vocab, size=int(m)).tolist() for m in lengths]
    sampled = sorted(rng.choice(n, size=n_sampled, replace=False).tolist())
    return prompts, sampled, [i for i in range(n) if i not in sampled]


def generate_phase(device, seed: int, card: str) -> dict:
    """Drive the generation path at full mistral-7b-instruct width through
    its entry points, check it against the dense path, and time its parts."""
    from pathway_tpu_torch.models import decoder as dec

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = dec.DecoderLM(GEN_MODEL, seed=seed, max_cache=GEN_CACHE)  # on cuda:0 by default
    torch.cuda.synchronize()
    cfg = lm.config
    widths = {k: getattr(cfg, k) for k in GEN_WIDTHS}
    weight_bytes = tensor_bytes(lm.params)
    log("generate", step="model", model=GEN_MODEL, **widths, sliding_window=cfg.sliding_window,
        dtype=str(cfg.dtype), n_params=lm.n_params(), weights_gb=weight_bytes / 1e9,
        init_s=time.perf_counter() - t0, device=str(lm.device))
    if widths != GEN_WIDTHS:
        fail(f"decoder widths {widths} are not mistral-7b-instruct's {GEN_WIDTHS}")

    prompts, sampled, greedy = burst_prompts(np.random.default_rng(seed + 3), GEN_REQUESTS, GEN_SAMPLED,
                                             GEN_PROMPT_LENS, cfg.vocab_size)
    run = serve_burst(lm, prompts, sampled, GEN_NEW_TOKENS, seed, "generate")
    burst = run["burst"]
    with torch.inference_mode():
        parted = check_generation(lm, prompts, run["outs"], greedy, sampled, GEN_NEW_TOKENS, device, "generate")
        timing = generate_timing(lm, [len(prompts[i]) for i in range(run["sched_slots"])], device)
    timing["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    timing["weights_gb"] = weight_bytes / 1e9
    log("generate", step="summary", card=card, **burst,
        parted_greedy_rows=parted, **timing)
    return {"launches": run["launches"], "attention_launches": {}, **burst, **timing}


def decode_tick_inputs(lm, prompt_lens, device) -> dict:
    """A decode tick mid-generation at ``len(prompt_lens)`` slots, as the
    scheduler's pool holds it: random K/V pools, each slot's block table,
    and each slot holding its prompt and 64 generated tokens.  Returns the
    generator it drew from, for the caller's further draws."""
    from pathway_tpu_torch.models import decoder as dec

    cfg = lm.config
    S, page = len(prompt_lens), 16
    G = lm.max_cache // page
    gen = torch.Generator(device=device).manual_seed(7)
    k_pool, v_pool = dec.init_kv_pool(cfg, 1 + S * G, page, device)
    k_pool.normal_(generator=gen)
    v_pool.normal_(generator=gen)
    bt = (1 + torch.arange(S * G, device=device)).reshape(S, G)
    seq = torch.tensor([min(n + 64, lm.max_cache - 1) for n in prompt_lens], device=device)
    tok = torch.randint(3, cfg.vocab_size, (S,), generator=gen, device=device)
    return {"k_pool": k_pool, "v_pool": v_pool, "bt": bt, "seq": seq, "tok": tok, "gen": gen,
            "page": page, "G": G, "live_tokens": int(seq.sum()) + S}


def decode_tick(tree, cfg, t: dict, reps: int = 4, replays: int = 5, iters: int = 10) -> dict:
    """Device ms (CUDA graphs of ``reps`` ticks, ``replays`` replays) and
    host ms (``iters`` eager ticks) of one ``paged_decode_step`` over the
    weights ``tree`` at the tick ``t`` of :func:`decode_tick_inputs`, beside
    its bytes bound (every weight, the live K/V, the logits) and the idle
    share 1 − device/host."""
    from pathway_tpu_torch.models import decoder as dec

    S, H, V = len(t["seq"]), cfg.hidden, cfg.vocab_size
    step = lambda: dec.paged_decode_step(tree, t["k_pool"], t["v_pool"], t["bt"], t["seq"], t["tok"], cfg)  # noqa: E731
    step_bytes = (tensor_bytes(tree["layers"]) + tensor_bytes(tree["lm_head"]) + H * 2 * (1 + S)
                  + t["live_tokens"] * dec.kv_bytes_per_token(cfg) + S * V * 4)
    out = {
        "decode_device_ms": device_ms([step], reps=reps, replays=replays),
        "decode_host_ms": eager_ms(step, iters=iters),
        "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
    }
    out["decode_idle_share"] = 1.0 - out["decode_device_ms"] / out["decode_host_ms"]
    return out


def generate_timing(lm, prompt_lens, device) -> dict:
    """Device and host ms of a decode tick and a prefill chunk at 8 slots,
    paged attention per layer beside its bytes bound and SDPA, and each op
    of the decode step with its calls per tick."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.ops import attention as attn

    cfg, tree = lm.config, lm.params
    S, H, V = len(prompt_lens), cfg.hidden, cfg.vocab_size
    NH, KH, D, L, F_ = cfg.heads, cfg.kv_heads, cfg.head_dim, cfg.layers, cfg.intermediate
    tick = decode_tick_inputs(lm, prompt_lens, device)
    k_pool, v_pool, bt, seq, tok, gen = (tick[k] for k in ("k_pool", "v_pool", "bt", "seq", "tok", "gen"))
    page, G, live_tokens = tick["page"], tick["G"], tick["live_tokens"]
    kv_tok = dec.kv_bytes_per_token(cfg)
    hbm = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
    flops = lambda f: f / BF16_FLOPS_PER_S * 1e3  # noqa: E731

    layer_bytes = tensor_bytes(tree["layers"])
    out = {
        "decode_slots": S, "decode_context_tokens": live_tokens, "decode_table_width": G,
        **decode_tick(tree, cfg, tick),
        "decode_weights_all_ms": hbm(tensor_bytes(tree)),
    }

    T = 32
    ids = torch.randint(3, V, (S, T), generator=gen, device=device)
    starts = torch.full((S,), 256, device=device)
    clens = torch.full((S,), T, device=device)
    chunk = lambda: dec.paged_prefill_chunk(tree, k_pool, v_pool, bt, ids, clens, starts, cfg)  # noqa: E731
    ctx = S * T * (256 + T / 2)
    chunk_flops = 2 * S * T * (layer_bytes // 2) + 4 * NH * D * ctx * L + 2 * S * H * V
    chunk_bytes = layer_bytes + tensor_bytes(tree["lm_head"]) + S * (256 + T) * kv_tok
    out.update({
        "prefill_chunk_tokens": S * T, "prefill_chunk_device_ms": device_ms([chunk], reps=2, replays=5),
        "prefill_chunk_host_ms": eager_ms(chunk, iters=5),
        "prefill_chunk_bound_ms": max(hbm(chunk_bytes), flops(chunk_flops)),
    })

    # paged attention at the decode shape, KV writes included; every timed
    # op below cycles through the 32 layers' weights and pools, as the step
    # reads them, so no operand is served from L2 on repeats
    x = torch.randn((S, 1, H), generator=gen, device=device).to(cfg.dtype)
    rope = dec._rope_tables(seq[:, None], D, cfg.rope_theta)
    q, k, v = dec._qkv(dec._layer(tree, 0), x, rope, cfg)
    rows = attn.kv_rows(bt, seq[:, None], page)
    mask = torch.arange(G * page, device=device)[None, None, :] <= seq[:, None, None]

    def paged_attention(kp, vp):
        attn.write_kv_rows(kp, rows, k)
        attn.write_kv_rows(vp, rows, v)
        return attn.paged_gqa_attention(q, kp, vp, bt, mask)

    layers = [(dec._layer(tree, i), k_pool[i], v_pool[i]) for i in range(L)]
    attention = [lambda kp=kp, vp=vp: paged_attention(kp, vp) for _, kp, vp in layers]
    ref = attention[0]()  # the gathered K/V below then hold this tick's writes
    qs, ms = q.transpose(1, 2), mask[:, None, :, :]
    gathered = [[attn.gather_kv_pages(p_, bt).transpose(1, 2) for p_ in (kp, vp)]  # [S, KH, C, D]
                for _, kp, vp in layers]
    sdpa = [lambda kg=kg, vg=vg: torch.nn.functional.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=ms, enable_gqa=True) for kg, vg in gathered]
    attn_bytes = live_tokens * KH * D * 2 * 2 + 2 * S * NH * D * 2 + S * KH * D * 2 * 2
    out.update({
        "paged_attention_ms_per_layer": device_ms(attention, reps=2 * L),
        "paged_attention_bound_ms": hbm(attn_bytes),
        "sdpa_on_gathered_kv_ms": device_ms(sdpa, reps=2 * L),
    })
    out["paged_attention_ms_per_tick"] = out["paged_attention_ms_per_layer"] * L
    got = sdpa[0]().transpose(1, 2).reshape(S, 1, NH * D)
    out["paged_attention_vs_sdpa_max_abs_err"] = float((ref.float() - got.float()).abs().max())
    del gathered, sdpa

    # each op of the decode step at its decode shape: device ms per call
    # (CUDA graphs), calls per tick, and the call's bytes bound
    lp0 = layers[0][0]
    h = dec._rms(x, lp0["ln0"], cfg.norm_eps)
    ctx_ = torch.randn((S, 1, NH * D), generator=gen, device=device).to(cfg.dtype)
    logits = torch.randn((S, V), generator=gen, device=device)
    cos, sin = rope
    wb = lambda *names: sum(lp0[n].numel() * 2 for n in names)  # noqa: E731
    act = S * H * 2
    ops = [  # (name, op at one layer's weights and pools, calls per tick, bytes per call)
        ("embed rows", lambda lp, kp, vp: tree["embed"][tok], 1, 2 * act),
        ("rms norm", lambda lp, kp, vp: dec._rms(x, lp["ln0"], cfg.norm_eps), 2 * L + 1, 2 * act + H * 2),
        ("q, k, v projections", lambda lp, kp, vp: (h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]), L,
         wb("wq", "wk", "wv") + act + S * (NH + 2 * KH) * D * 2),
        ("rope on q, k", lambda lp, kp, vp: (dec._apply_rope(q, cos, sin), dec._apply_rope(k, cos, sin)), L,
         2 * 2 * S * (NH + KH) * D),
        ("KV writes + paged attention", lambda lp, kp, vp: paged_attention(kp, vp), L, attn_bytes),
        ("o projection + residual", lambda lp, kp, vp: x + ctx_ @ lp["wo"], L, wb("wo") + 3 * act),
        ("SwiGLU MLP + residual", lambda lp, kp, vp: x + dec._ffn(lp, h, cfg)[0], L,
         wb("wg", "wu", "wd") + 3 * act),
        ("lm_head", lambda lp, kp, vp: dec._logits(tree, x[:, 0], cfg), 1,
         tensor_bytes(tree["lm_head"]) + act + S * V * 4),
        ("greedy argmax", lambda lp, kp, vp: logits.argmax(-1), 1, S * V * 4),
    ]
    table = []
    for name, op, calls, nbytes in ops:
        ms = device_ms([lambda layer=layer, op=op: op(*layer) for layer in layers], reps=2 * L)
        table.append({"op": name, "ms_per_call": ms, "calls_per_tick": calls, "ms_per_tick": ms * calls,
                      "bound_ms_per_tick": hbm(nbytes) * calls})
    top_p = torch.full((S, 1), GEN_TOP_P, device=device)
    ms = time_ms(lambda: dec.sample_logits(logits, gen, GEN_TEMP, top_p=top_p), iters=20)
    table.append({"op": "top-p sample (events over eager calls)", "ms_per_call": ms, "calls_per_tick": 1,
                  "ms_per_tick": ms, "bound_ms_per_tick": hbm(S * V * 4)})
    for row in table:
        log("generate", step="op", **row)
    out["ops_ms_per_tick_sum"] = sum(r["ms_per_tick"] for r in table[:-1])
    log("generate", step="timing", **out)
    return out


# ---------------------------------------------------------------------------
# Phase 9: mixtral-8x7b-instruct with int8 weights through the scheduler;
# phase 10: self-speculative decoding at mistral-7b-instruct width.
# ---------------------------------------------------------------------------

MOE_MODEL = "mixtral-8x7b-instruct"
MOE_WIDTHS = dict(layers=32, hidden=4096, heads=32, kv_heads=8, intermediate=14336, vocab_size=32000,
                  experts=8, experts_top_k=2, rope_theta=1e6, max_len=8192)
MOE_REQUESTS = 8  # 16 until the script passed its time limit (PERF.md section 5); [lora]'s too
MOE_SAMPLED = 2
MOE_NEW_TOKENS = 64
MOE_PROMPT_LENS = (64, 512)
MOE_CHECK_TOKENS = 64
REL_TOL = 2e-2  # ||got - ref|| / ||ref|| of a bf16 path against its f32 version
SPEC_PROMPTS = 8
SPEC_NEW_TOKENS = 64
SPEC_DRAFT = 8


def rel_err(got, ref) -> float:
    return float((got.float() - ref).norm() / ref.norm())


def moe_layer_check(lm, device, seed: int) -> dict:
    """Layer 0's ``moe_ffn`` at full width on 64 random tokens against a
    per-token loop over each token's own top-2 experts in f32 (activations
    and dequantized weights ``q.float() * s``, renormalised gates); then the
    int8 ``_mm`` at the ``wq`` shape against ``x.float() @ (q.float() * s)``."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.parallel import moe

    cfg = lm.config
    lp = dec._layer(lm.params, 0)
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    x = torch.randn((MOE_CHECK_TOKENS, cfg.hidden), generator=gen, device=device).to(cfg.dtype)
    mcfg = dec.moe_config(cfg)
    got, aux = moe.moe_ffn(dec.moe_params(lp), x, mcfg, full_capacity=True)
    xf = x.float()
    router_logits = xf @ lp["moe_router"]
    chosen = moe._routing(router_logits, mcfg, MOE_CHECK_TOKENS)[0].sum(-1) > 0  # [T, E]
    probs = torch.softmax(router_logits, dim=-1)
    gates, experts = probs.topk(cfg.experts_top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    want_chosen = torch.zeros_like(chosen).scatter_(1, experts, True)
    if not torch.equal(chosen, want_chosen):
        fail(f"moe: routing chose other experts than the f32 top-{cfg.experts_top_k} for "
             f"{int((chosen != want_chosen).any(-1).sum())} token(s)")
    ref = torch.zeros((MOE_CHECK_TOKENS, cfg.hidden), device=device)
    picks = experts.cpu().numpy()
    for e in range(cfg.experts):
        wg, wu, wd = (lp[n]["q"][e].float() * lp[n]["s"][e] for n in ("wg", "wu", "wd"))
        for t, k in zip(*np.nonzero(picks == e)):
            h = torch.nn.functional.silu(xf[t] @ wg) * (xf[t] @ wu)
            ref[t] += gates[t, k] * (h @ wd)
        del wg, wu, wd
    err = rel_err(got, ref)
    wq = lp["wq"]
    mm_err = rel_err(dec._mm(x, wq), xf @ (wq["q"].float() * wq["s"]))
    out = {"tokens": MOE_CHECK_TOKENS, "experts_identical": True, "moe_ffn_rel_err": err,
           "moe_ffn_max_abs_err": float((got.float() - ref).abs().max()), "ref_abs_max": float(ref.abs().max()),
           "aux": float(aux), "tokens_per_expert": chosen.sum(0).tolist(), "int8_mm_wq_rel_err": mm_err,
           "tol": REL_TOL}
    log("moe", step="check_layer", **out)
    if not err < REL_TOL:
        fail(f"moe: moe_ffn against the f32 per-token loop: relative error {err} >= {REL_TOL}")
    if not mm_err < REL_TOL:
        fail(f"moe: int8 _mm at wq against f32: relative error {mm_err} >= {REL_TOL}")
    return out


def moe_timing(lm, prompt_lens, device) -> dict:
    """Device and host ms of a decode tick and a prefill chunk at 8 slots
    beside their bounds, and each op of the MoE FFN at the decode shape,
    beside the int8 ``_mm`` and a bf16 product at the ``wq`` shape."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.parallel import moe

    cfg, tree = lm.config, lm.params
    S, H, V = len(prompt_lens), cfg.hidden, cfg.vocab_size
    NH, KH, D, L, F_, E = cfg.heads, cfg.kv_heads, cfg.head_dim, cfg.layers, cfg.intermediate, cfg.experts
    K = cfg.experts_top_k
    tick = decode_tick_inputs(lm, prompt_lens, device)
    k_pool, v_pool, bt, gen = (tick[k] for k in ("k_pool", "v_pool", "bt", "gen"))
    kv_tok = dec.kv_bytes_per_token(cfg)
    hbm = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
    flops = lambda f: f / BF16_FLOPS_PER_S * 1e3  # noqa: E731

    # the dense GShard dispatch computes every expert, so a tick reads every
    # expert's codes: its bound counts all weights
    layer_bytes = tensor_bytes(tree["layers"])
    out = {"decode_slots": S, "decode_context_tokens": tick["live_tokens"],
           **decode_tick(tree, cfg, tick, reps=2, replays=3, iters=5)}
    out["decode_over_bound"] = out["decode_device_ms"] / out["decode_bound_ms"]

    T = 32
    ids = torch.randint(3, V, (S, T), generator=gen, device=device)
    starts = torch.full((S,), 256, device=device)
    clens = torch.full((S,), T, device=device)
    chunk = lambda: dec.paged_prefill_chunk(tree, k_pool, v_pool, bt, ids, clens, starts, cfg)  # noqa: E731
    ctx = S * T * (256 + T / 2)
    # the work the tokens need: attention projections, each token's top-2
    # experts, attention over its context, and the logits of each row's last token
    per_token = 2 * H * (2 * NH * D + 2 * KH * D) + K * 6 * H * F_ + 2 * H * E
    chunk_flops = L * S * T * per_token + 4 * NH * D * ctx * L + 2 * S * H * V
    chunk_bytes = layer_bytes + tensor_bytes(tree["lm_head"]) + S * (256 + T) * kv_tok
    out.update({
        "prefill_chunk_tokens": S * T, "prefill_chunk_device_ms": device_ms([chunk], reps=1, replays=3),
        "prefill_chunk_host_ms": eager_ms(chunk, iters=3),
        "prefill_chunk_bound_ms": max(hbm(chunk_bytes), flops(chunk_flops)),
    })

    # each op of the MoE FFN at the decode shape (8 tokens, one group of 8
    # slots per expert), cycling through layers so that no weight is served
    # from L2; device ms per call (CUDA graphs) and its bytes bound
    mcfg = dec.moe_config(cfg)
    layers = [dec._layer(tree, i) for i in range(L)]
    x = torch.randn((S, 1, H), generator=gen, device=device).to(cfg.dtype)
    xg = x.reshape(1, S, H)
    valid = torch.ones((1, S), dtype=torch.bool, device=device)
    disp, comb, _ = moe._routing(xg.float() @ layers[0]["moe_router"], mcfg, S, valid)
    disp, comb = disp.to(cfg.dtype), comb.to(cfg.dtype)
    expert_in = torch.einsum("gtec,gth->gech", disp, xg)
    hmid = torch.randn((1, E, S, F_), generator=gen, device=device).to(cfg.dtype)
    expert_out = torch.randn((1, E, S, H), generator=gen, device=device).to(cfg.dtype)
    # bf16 weights at the wq shape: four layers' dequantized wq, more than L2
    wq_bf16 = [(lp["wq"]["q"].float() * lp["wq"]["s"]).to(cfg.dtype) for lp in layers[:4]]
    codes = lambda n: tensor_bytes(layers[0][n])  # noqa: E731
    act, slots = S * H * 2, E * S
    ops = [  # (name, op at one layer's weights, calls per tick, bytes per call)
        ("_routing", lambda lp: moe._routing(xg.float() @ lp["moe_router"], mcfg, S, valid), L,
         H * E * 4 + act + 2 * S * E * S * 4),
        ("dispatch einsum", lambda lp: torch.einsum("gtec,gth->gech", disp, xg), L,
         S * E * S * 2 + act + slots * H * 2),
        ("wg int8 einsum", lambda lp: moe._qeinsum("gech,ehf->gecf", expert_in, lp["wg"]), L,
         codes("wg") + slots * (H + F_) * 2),
        ("wu int8 einsum", lambda lp: moe._qeinsum("gech,ehf->gecf", expert_in, lp["wu"]), L,
         codes("wu") + slots * (H + F_) * 2),
        ("wd int8 einsum", lambda lp: moe._qeinsum("gecf,efh->gech", hmid, lp["wd"]), L,
         codes("wd") + slots * (H + F_) * 2),
        ("combine einsum", lambda lp: torch.einsum("gtec,gech->gth", comb, expert_out), L,
         S * E * S * 2 + slots * H * 2 + act),
        ("moe_ffn (all of the above and the SwiGLU)", lambda lp: moe.moe_ffn(dec.moe_params(lp), x, mcfg,
                                                                              full_capacity=True), L,
         codes("wg") + codes("wu") + codes("wd") + H * E * 4 + 2 * act),
        ("int8 _mm at wq", lambda lp: dec._mm(x, lp["wq"]), L, codes("wq") + act + S * NH * D * 2),
    ]
    table = []
    for name, op, calls, nbytes in ops:
        # four layers in turn: each layer's experts are far larger than L2
        ms = device_ms([lambda lp=lp, op=op: op(lp) for lp in layers[:4]], reps=8, replays=3)
        table.append({"op": name, "ms_per_call": ms, "calls_per_tick": calls, "ms_per_tick": ms * calls,
                      "bound_ms_per_tick": hbm(nbytes) * calls})
    ms = device_ms([lambda w=w: x @ w for w in wq_bf16], reps=8, replays=3)
    table.append({"op": "bf16 product at the wq shape (comparison)", "ms_per_call": ms, "calls_per_tick": L,
                  "ms_per_tick": ms * L, "bound_ms_per_tick": hbm(H * NH * D * 2 + act + S * NH * D * 2) * L})
    # where an int8 expert einsum's time goes: the conversion of the codes
    # alone, and the product on an already converted bf16 copy (two layers'
    # wg, each far larger than L2) by einsum and by bmm
    wg_bf16 = [lp["wg"]["q"].to(cfg.dtype) for lp in layers[:2]]
    parts = [
        ("wg codes to bf16 alone", [lambda lp=lp: lp["wg"]["q"].to(cfg.dtype) for lp in layers[:4]],
         codes("wg") + E * H * F_ * 2),
        ("wg einsum on a bf16 copy", [lambda w=w: torch.einsum("gech,ehf->gecf", expert_in, w) for w in wg_bf16],
         E * H * F_ * 2 + slots * (H + F_) * 2),
        ("wg bmm on a bf16 copy", [lambda w=w: torch.bmm(expert_in[0], w) for w in wg_bf16],
         E * H * F_ * 2 + slots * (H + F_) * 2),
    ]
    for name, calls, nbytes in parts:
        ms = device_ms(calls, reps=8, replays=3)
        table.append({"op": name, "ms_per_call": ms, "calls_per_tick": L, "ms_per_tick": ms * L,
                      "bound_ms_per_tick": hbm(nbytes) * L})
    for row in table:
        log("moe", step="op", **row)
    del wq_bf16, wg_bf16
    log("moe", step="timing", **out)
    return out


def moe_phase(device, seed: int, card: str) -> dict:
    """Serve mixtral-8x7b-instruct with int8 weights at full width through
    the continuous-batching scheduler, check it against the dense path and
    the MoE layer against an f32 per-token loop, and time its parts."""
    from pathway_tpu_torch.models import decoder as dec

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = dec.DecoderLM(MOE_MODEL, seed=seed, max_cache=GEN_CACHE, quantize="int8")  # on cuda:0
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = lm.config
    widths = {k: getattr(cfg, k) for k in MOE_WIDTHS}
    weight_bytes = tensor_bytes(lm.params)
    log("moe", step="model", model=MOE_MODEL, **widths, dtype=str(cfg.dtype), quantize="int8",
        n_params=lm.n_params(), weights_gb=weight_bytes / 1e9, init_s=init_s,
        init_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, pretrained=lm.pretrained,
        device=str(lm.device))
    if widths != MOE_WIDTHS:
        fail(f"decoder widths {widths} are not mixtral-8x7b-instruct's {MOE_WIDTHS}")
    if not lm.quantized or lm.params["layers"]["wg"]["q"].dtype != torch.int8:
        fail("moe: the model is not int8")

    prompts, sampled, greedy = burst_prompts(np.random.default_rng(seed + 9), MOE_REQUESTS, MOE_SAMPLED,
                                             MOE_PROMPT_LENS, cfg.vocab_size)
    run = serve_burst(lm, prompts, sampled, MOE_NEW_TOKENS, seed, "moe")
    burst = run["burst"]
    with torch.inference_mode():
        parted = check_generation(lm, prompts, run["outs"], greedy, sampled, MOE_NEW_TOKENS, device, "moe")
        layer = moe_layer_check(lm, device, seed)
        timing = moe_timing(lm, [len(prompts[i]) for i in range(run["sched_slots"])], device)
    timing["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    timing["weights_gb"] = weight_bytes / 1e9
    log("moe", step="summary", card=card, **burst, parted_greedy_rows=parted,
        moe_ffn_rel_err=layer["moe_ffn_rel_err"], int8_mm_wq_rel_err=layer["int8_mm_wq_rel_err"], **timing)
    return {"launches": run["launches"], "attention_launches": {}, **burst, **timing}


def speculative_phase(device, seed: int, card: str) -> dict:
    """Self-speculative greedy decoding at full mistral-7b-instruct width
    (bf16 target, int8 draft) beside plain greedy ``generate_ids`` on the
    same prompts: rows equal but at near-ties, acceptance, tokens/s, and the
    device ms of the int8 draft's decode step against the bf16 one."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.ops import attention as attn

    torch.cuda.reset_peak_memory_stats()
    lm = dec.DecoderLM(GEN_MODEL, seed=seed, max_cache=GEN_CACHE)  # bf16, on cuda:0
    cfg = lm.config
    rng = np.random.default_rng(seed + 13)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(MOE_PROMPT_LENS[0], MOE_PROMPT_LENS[1] + 1, size=SPEC_PROMPTS)]
    # warm-up: builds the int8 draft (timed), then one short call of each path
    t0 = time.perf_counter()
    lm.generate_ids_speculative([prompts[0][:16]], max_new_tokens=2, n_draft=SPEC_DRAFT)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    lm.generate_ids([prompts[0][:16]], max_new_tokens=2)
    stats0 = dict(lm.speculative_stats)

    # ---- the counted run: counts zeroed just before, read just after ----
    attn.encoder_attention.launches = 0
    t0 = time.perf_counter()
    spec = lm.generate_ids_speculative(prompts, max_new_tokens=SPEC_NEW_TOKENS, n_draft=SPEC_DRAFT)
    spec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = lm.generate_ids(prompts, max_new_tokens=SPEC_NEW_TOKENS)
    plain_s = time.perf_counter() - t0
    launches = {"encoder_attention": attn.encoder_attention.launches}
    # ---- end of the counted run ----
    stats = {k: lm.speculative_stats[k] - stats0[k] for k in stats0}
    spec_tokens, plain_tokens = sum(map(len, spec)), sum(map(len, plain))
    run = {
        "prompts": SPEC_PROMPTS, "new_tokens": SPEC_NEW_TOKENS, "n_draft": SPEC_DRAFT,
        "rounds": stats["rounds"], "accepted_per_round": stats["accepted"] / stats["row_rounds"],
        "acceptance_rate": (stats["accepted"] - stats["row_rounds"]) / (stats["row_rounds"] * (SPEC_DRAFT - 1)),
        "speculative_tokens_per_s": spec_tokens / spec_s, "plain_tokens_per_s": plain_tokens / plain_s,
        "speculative_s": spec_s, "plain_s": plain_s, "draft_build_and_warmup_s": warm_s,
    }
    log("speculative", step="run", **run, kernel_launches=launches, stats=stats)

    with torch.inference_mode():
        # every emitted token, teacher-forced through the bf16 target, within
        # tol of the target's max; the int8 draft's own greedy rows through
        # the same check, to show that it tells the two chains apart: the
        # emitted rows' share of tokens at the target's max must lie nearer
        # 1 (the target's chain) than the draft's rows' share
        parted = {i: t for i in range(SPEC_PROMPTS) if (t := first_parting(spec[i], plain[i])) is not None}
        emitted = emitted_gaps(lm, prompts, spec, SPEC_NEW_TOKENS)
        drafted = emitted_gaps(lm, prompts, dense_greedy(lm, lm._draft_tree, prompts, SPEC_NEW_TOKENS),
                               SPEC_NEW_TOKENS)
        log("speculative", step="check", rows=SPEC_PROMPTS, identical=SPEC_PROMPTS - len(parted),
            parted=len(parted), parted_at_step=parted, row_tokens=[len(r) for r in spec], **emitted,
            draft_rows=drafted)
        if emitted["tokens_over_tol"]:
            fail(f"speculative: {emitted['tokens_over_tol']} emitted token(s) lie tol or more below the target's "
                 f"max (worst gap/tol {emitted['worst_gap_over_tol']})")
        if emitted["max_share"] <= (1.0 + drafted["max_share"]) / 2:
            fail(f"speculative: the emitted rows are no nearer the target's greedy chain than the draft's: "
                 f"{emitted['max_share']} of their tokens at the target's max, the draft's rows {drafted['max_share']}")

        # the draft's decode step against the target's at B=8, mid-generation
        B, C = SPEC_PROMPTS, lm.max_cache
        gen = torch.Generator(device=device).manual_seed(17)
        shape = (cfg.layers, B, C, cfg.kv_heads, cfg.head_dim)
        kc = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
        vc = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
        pos = torch.tensor([len(p) + SPEC_NEW_TOKENS // 2 for p in prompts], device=device)
        tok = torch.randint(3, cfg.vocab_size, (B,), generator=gen, device=device)
        block = torch.randint(3, cfg.vocab_size, (B, SPEC_DRAFT), generator=gen, device=device)
        draft = lm._draft_tree
        buf = (torch.empty_like(kc), torch.empty_like(vc))
        kv_read = B * C * dec.kv_bytes_per_token(cfg)
        hbm = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
        timing = {
            "bf16_decode_step_device_ms": device_ms(
                [lambda: dec.decode_step(lm.params, kc, vc, tok, pos, cfg)], reps=4, replays=3),
            "int8_decode_step_device_ms": device_ms(
                [lambda: dec.decode_step(draft, kc, vc, tok, pos, cfg)], reps=4, replays=3),
            "verify_block_device_ms": device_ms(
                [lambda: dec.verify_block(lm.params, kc, vc, block, pos, cfg)], reps=2, replays=3),
            "draft_cache_refresh_device_ms": device_ms(
                [lambda: (buf[0].copy_(kc), buf[1].copy_(vc))], reps=4, replays=3),
            "bf16_decode_step_bound_ms": hbm(tensor_bytes(lm.params["layers"]) + tensor_bytes(lm.params["lm_head"])
                                             + kv_read),
            "int8_decode_step_bound_ms": hbm(tensor_bytes(draft["layers"]) + tensor_bytes(draft["lm_head"])
                                             + kv_read),
            "draft_cache_refresh_bound_ms": hbm(2 * 2 * kc.numel() * kc.element_size()),
            "bf16_weights_gb": tensor_bytes(lm.params) / 1e9, "int8_weights_gb": tensor_bytes(draft) / 1e9,
        }
        timing["int8_over_bf16_decode_step"] = (timing["int8_decode_step_device_ms"]
                                                / timing["bf16_decode_step_device_ms"])
        del kc, vc, buf
    timing["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("speculative", step="summary", card=card, **run, parted_rows=len(parted), **timing)
    return {"launches": launches, "attention_launches": {}, **run, **timing}


# ---------------------------------------------------------------------------
# Phase 11: the SigLIP dual encoder; phase 12: LoRA-adapted decoder serving.
# ---------------------------------------------------------------------------

VISION_MODEL = "siglip-base-patch16-224"
VISION_WIDTHS = dict(image_size=224, patch=16, hidden=768, layers=12, heads=12, intermediate=3072, proj_dim=768)
TEXT_TOWER_WIDTHS = dict(hidden=768, layers=12, heads=12, intermediate=3072)  # bge-base-en-v1.5
VISION_BATCH = 256  # MultimodalEncoder's default max_batch
VISION_IMAGES = 2048  # 4,096 each until [cluster] (PERF.md section 4)
VISION_TEXTS = 2048
VISION_CHECK_ROWS = 64
RESIZE_IMAGES, RESIZE_FROM = 256, 320
SO400M_MODEL = "siglip-so400m-patch14-384"
SO400M_WIDTHS = dict(image_size=384, patch=14, hidden=1152, layers=27, heads=16, intermediate=4304, proj_dim=1152)
SO400M_IMAGES = 512
LORA_RANK, LORA_ALPHA = 8, 16.0  # lora_decoder_tree's defaults
LORA_B_STD = 0.02  # tests/test_lora.py:81-84
LORA_TIMING_RANK = 16
ZERO_INIT_PROMPTS = 4


def vision_flops(cfg) -> float:
    """FLOPs of one image through the image tower: the patch embedding, per
    layer the QKV, score, context, output and MLP products, and the
    projection (2 per multiply-add)."""
    N, H, F_, P = cfg.n_patches, cfg.hidden, cfg.intermediate, cfg.patch**2 * 3
    layer = 2 * N * H * 3 * H + 2 * 2 * N * N * H + 2 * N * H * H + 2 * 2 * N * H * F_
    return 2 * N * P * H + cfg.layers * layer + 2 * H * cfg.proj_dim


def cosine_rows(a, b):
    return (a * b).sum(axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def to_f32(tree):
    return {k: to_f32(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.float()


def detached(tree):
    return {k: detached(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.detach()


def vision_phase(device, seed: int, card: str) -> dict:
    """Embed images and texts at full siglip-base-patch16-224 width through
    ``MultimodalEncoder`` (bge-base-en-v1.5 text tower), check them against
    an f32 run of the same functions, time the host and device parts, the
    plain vision attention beside SDPA and the encoder kernel, and
    siglip-so400m-patch14-384's image tower."""
    import dataclasses

    from pathway_tpu_torch.models import vision as vis
    from pathway_tpu_torch.models.encoder import SentenceEncoderModule
    from pathway_tpu_torch.models.tokenizer import bucket_batch, bucket_seq_len, pad_batch
    from pathway_tpu_torch.ops import attention as attn

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    enc = vis.MultimodalEncoder(VISION_MODEL, seed=seed, max_batch=VISION_BATCH, device=device)
    torch.cuda.synchronize()
    vcfg, tcfg = enc.vision_config, enc.text_config
    widths = {k: getattr(vcfg, k) for k in VISION_WIDTHS}
    text_widths = {k: getattr(tcfg, k) for k in TEXT_TOWER_WIDTHS}
    gflop = vision_flops(vcfg) / 1e9
    log("vision", step="model", model=VISION_MODEL, **widths, n_patches=vcfg.n_patches, dtype=str(vcfg.dtype),
        text_tower=text_widths, text_dtype=str(tcfg.dtype), init_s=time.perf_counter() - t0,
        device=str(enc.device), gflop_per_image=gflop, flop_bound_images_per_s=BF16_FLOPS_PER_S / (gflop * 1e9))
    if widths != VISION_WIDTHS or text_widths != TEXT_TOWER_WIDTHS:
        fail(f"vision: widths {widths}, text {text_widths} are not {VISION_MODEL}'s")

    rng = np.random.default_rng(seed + 21)
    S = vcfg.image_size
    images = rng.integers(0, 256, size=(VISION_IMAGES, S, S, 3), dtype=np.uint8)
    texts = synthetic_corpus(VISION_TEXTS, seed + 22)[0]
    enc.embed_images(images[:VISION_BATCH])  # one untimed warm-up batch of each
    enc.embed_texts(texts[:VISION_BATCH])

    # ---- the counted run: counts zeroed just before, read just after ----
    attn.encoder_attention.launches = 0
    t0 = time.perf_counter()
    img_emb = enc.embed_images(images)
    image_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    txt_emb = enc.embed_texts(texts)
    text_s = time.perf_counter() - t0
    launches = {"encoder_attention": attn.encoder_attention.launches}
    # ---- end of the counted run ----
    batches, text_batches = -(-VISION_IMAGES // VISION_BATCH), -(-VISION_TEXTS // VISION_BATCH)
    run = {"images": VISION_IMAGES, "images_per_s": VISION_IMAGES / image_s, "image_s": image_s,
           "texts": VISION_TEXTS, "texts_per_s": VISION_TEXTS / text_s, "text_s": text_s}
    log("vision", step="run", **run, kernel_launches=launches)
    for name, e in (("image", img_emb), ("text", txt_emb)):
        n = VISION_IMAGES if name == "image" else VISION_TEXTS
        if e.shape != (n, vcfg.proj_dim) or not np.isfinite(e).all():
            fail(f"vision: {name} embeddings of shape {e.shape} or non-finite")
        if np.abs(np.linalg.norm(e, axis=1) - 1.0).max() > 1e-3:
            fail(f"vision: {name} embeddings are not unit vectors")

    with torch.inference_mode():
        # where a batch's time goes: the host conversion, padding and H2D
        # copy, the forward on the card (CUDA graphs) and eager
        batch = images[:VISION_BATCH]
        arr = enc.prepare_images(batch)

        def pad():
            padded = np.zeros((VISION_BATCH, S, S, 3), np.float32)
            padded[:] = arr
            return padded

        x = torch.from_numpy(arr).to(device)
        forward = lambda: vis.vision_forward(enc.params, x, vcfg)  # noqa: E731
        split = {
            "host_convert_ms": eager_ms(lambda: enc.prepare_images(batch), iters=3),
            "host_pad_ms": eager_ms(pad, iters=3),
            "h2d_ms": eager_ms(lambda: torch.from_numpy(arr).to(device), iters=3),
            "forward_device_ms": device_ms([forward], reps=2, replays=3),
            "forward_eager_ms": eager_ms(forward, iters=5),
            "wall_ms_per_batch": image_s * 1e3 / batches,
        }
        split["forward_flop_bound_ms"] = VISION_BATCH * gflop * 1e9 / BF16_FLOPS_PER_S * 1e3
        split["device_idle_share"] = 1.0 - split["forward_device_ms"] / split["wall_ms_per_batch"]
        # the text tower: its forward at the counted run's bucket, and the
        # share of it that casts the module's f32 kernels to bf16
        seq = bucket_seq_len(min(max(len(enc.tokenizer.encode(t)) for t in texts), tcfg.max_len))
        id_lists = [enc.tokenizer.encode(t) for t in texts[:VISION_BATCH]]
        ids, mask = (torch.from_numpy(a).to(device) for a in pad_batch(id_lists, seq))
        text_fwd = lambda: vis.text_forward(enc.text_module, enc.text_proj, ids, mask)  # noqa: E731
        floats = [b for b in enc.text_module.buffers() if b.dim() > 1]
        split.update({
            "text_seq_bucket": seq,
            "text_forward_device_ms": device_ms([text_fwd], reps=2, replays=3),
            "text_weight_cast_device_ms": device_ms([lambda: [b.to(tcfg.dtype) for b in floats]], reps=2, replays=3),
            "text_wall_ms_per_batch": text_s * 1e3 / text_batches,
        })
        split["text_cast_share"] = split["text_weight_cast_device_ms"] / split["text_forward_device_ms"]
        # texts/s with the casts' device time taken out of the run
        split["texts_per_s_less_cast"] = VISION_TEXTS / (text_s - text_batches * split["text_weight_cast_device_ms"] / 1e3)
        log("vision", step="split", **split)

        # the host resize path: 320 x 320 images through embed_images
        big = rng.integers(0, 256, size=(RESIZE_IMAGES, RESIZE_FROM, RESIZE_FROM, 3), dtype=np.uint8)
        resize_ms = eager_ms(lambda: enc.prepare_images(big), iters=1)
        t0 = time.perf_counter()
        resized = enc.embed_images(big)
        resize = {"images": RESIZE_IMAGES, "from": RESIZE_FROM, "host_prepare_ms_per_image": resize_ms / RESIZE_IMAGES,
                  "embed_ms_per_image": (time.perf_counter() - t0) * 1e3 / RESIZE_IMAGES}
        log("vision", step="resize", **resize)
        if resized.shape != (RESIZE_IMAGES, vcfg.proj_dim) or not np.isfinite(resized).all():
            fail("vision: resized images gave no finite embeddings")

        # gates: bf16 against f32 of the same functions and weights; a
        # row of a padded batch against the image alone; score against the
        # logits of the embeddings it returns
        n = VISION_CHECK_ROWS
        f32_img = vis.vision_forward(to_f32(enc.params), torch.from_numpy(enc.prepare_images(images[:n])).to(device),
                                     dataclasses.replace(vcfg, dtype=torch.float32)).cpu().numpy()
        id_lists = [enc.tokenizer.encode(t) for t in texts[:n]]
        seq_n = bucket_seq_len(min(max(len(i) for i in id_lists), tcfg.max_len))
        ids_n, mask_n = (torch.from_numpy(a).to(device)
                         for a in pad_batch(id_lists + [[0]] * (bucket_batch(n, VISION_BATCH) - n), seq_n))
        module32 = SentenceEncoderModule(dataclasses.replace(tcfg, dtype=torch.float32), enc.text_params, device)
        f32_txt = vis.text_forward(module32, enc.text_proj, ids_n, mask_n).cpu().numpy()[:n]
        del module32
        five = enc.embed_images(images[:5])
        solo = enc.embed_images(images[2:3])
        sc = enc.score(images[:8], texts[:8])
        ref = vis.pairwise_logits(torch.from_numpy(enc.embed_images(images[:8])).to(device),
                                  torch.from_numpy(enc.embed_texts(texts[:8])).to(device), enc.params).cpu().numpy()
    check = {
        "rows": n, "image_min_cos_bf16_vs_f32": float(cosine_rows(img_emb[:n], f32_img).min()),
        "text_min_cos_bf16_vs_f32": float(cosine_rows(enc.embed_texts(texts[:n]), f32_txt).min()),
        "row2_of_5_cos_vs_alone": float(cosine_rows(five[2:3], solo)[0]),
        "score_max_abs_err": float(np.abs(sc - ref).max()), "score_range": [float(sc.min()), float(sc.max())],
    }
    log("vision", step="check", **check)
    problems = [f"{k} = {check[k]} <= {COS_MIN}" for k in
                ("image_min_cos_bf16_vs_f32", "text_min_cos_bf16_vs_f32", "row2_of_5_cos_vs_alone")
                if not check[k] > COS_MIN]
    if not check["score_max_abs_err"] < 1e-3:
        problems.append(f"score differs from pairwise_logits of its embeddings by {check['score_max_abs_err']}")
    if problems:
        fail("vision: " + "; ".join(problems))

    # the plain vision attention at the path's shape beside SDPA and the
    # encoder kernel (hd 64, any S) on the same q, k, v: a measurement
    # outside the counted run; the path's route is not changed
    B, N, heads, D = VISION_BATCH, vcfg.n_patches, vcfg.heads, vcfg.hidden // vcfg.heads
    gen = torch.Generator(device=device).manual_seed(seed + 23)
    q, k, v = (torch.randn((B, N, heads, D), generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    qp, kp, vp = (t.reshape(B, N, heads * D) for t in (q, k, v))
    bias = torch.zeros((B, N), device=device)
    with torch.inference_mode():
        plain = vis._attention(q, k, v).float()
        kernel_out = attn.encoder_attention(qp, kp, vp, bias, heads).float()
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2).reshape(B, N, -1)
        op = {
            "shape": [B, N, heads * D, heads], "head_dim": D,
            "plain_ms": device_ms([lambda: vis._attention(q, k, v)], reps=10),
            "sdpa_ms": device_ms([lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)], reps=10),
            "kernel_ms": device_ms([lambda: attn.encoder_attention(qp, kp, vp, bias, heads)], reps=10),
            "bytes_bound_ms": 4 * B * N * heads * D * 2 / HBM_BYTES_PER_S * 1e3,
            "flop_bound_ms": 4 * B * heads * N * N * D / BF16_FLOPS_PER_S * 1e3,
            "kernel_max_abs_err_vs_plain": float((kernel_out - plain).abs().max()),
            "sdpa_max_abs_err_vs_plain": float((sdpa_out.float() - plain).abs().max()),
        }
        op["plain_ms_per_forward"] = op["plain_ms"] * vcfg.layers
    log("vision", step="op", **op)
    if not op["kernel_max_abs_err_vs_plain"] < ATTN_TOL:
        fail(f"vision: the encoder kernel differs from the plain vision attention by {op['kernel_max_abs_err_vs_plain']}")
    del enc, images, x, q, k, v, qt, kt, vt, qp, kp, vp, plain, kernel_out, sdpa_out
    gc.collect()
    torch.cuda.empty_cache()

    # siglip-so400m-patch14-384 (hd 72, which no kernel takes), timed only
    so = vis.MultimodalEncoder(SO400M_MODEL, seed=seed, max_batch=VISION_BATCH, device=device)
    so_cfg = so.vision_config
    so_widths = {k: getattr(so_cfg, k) for k in SO400M_WIDTHS}
    if so_widths != SO400M_WIDTHS:
        fail(f"vision: widths {so_widths} are not {SO400M_MODEL}'s")
    so_images = rng.integers(0, 256, size=(SO400M_IMAGES, so_cfg.image_size, so_cfg.image_size, 3), dtype=np.uint8)
    so.embed_images(so_images[:VISION_BATCH])  # warm-up
    attn.encoder_attention.launches = 0
    t0 = time.perf_counter()
    so_emb = so.embed_images(so_images)
    so_s = time.perf_counter() - t0
    launches["encoder_attention"] += attn.encoder_attention.launches
    so_gflop = vision_flops(so_cfg) / 1e9
    with torch.inference_mode():
        x = torch.zeros((VISION_BATCH, so_cfg.image_size, so_cfg.image_size, 3), device=device)
        so_fwd_ms = time_ms(lambda: vis.vision_forward(so.params, x, so_cfg), iters=3, warmup=1)
    so_run = {"model": SO400M_MODEL, **so_widths, "n_patches": so_cfg.n_patches, "head_dim": so_cfg.hidden // so_cfg.heads,
              "images": SO400M_IMAGES, "images_per_s": SO400M_IMAGES / so_s, "gflop_per_image": so_gflop,
              "flop_bound_images_per_s": BF16_FLOPS_PER_S / (so_gflop * 1e9), "forward_ms": so_fwd_ms,
              "forward_flop_bound_ms": VISION_BATCH * so_gflop * 1e9 / BF16_FLOPS_PER_S * 1e3,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("vision", step="so400m", **so_run)
    if so_emb.shape != (SO400M_IMAGES, so_cfg.proj_dim) or not np.isfinite(so_emb).all():
        fail(f"vision: {SO400M_MODEL} embeddings of shape {so_emb.shape} or non-finite")
    del so, so_images, x
    summary = {**run, **split, "resize_host_ms_per_image": resize["host_prepare_ms_per_image"],
               "so400m_images_per_s": so_run["images_per_s"], "so400m_forward_ms": so_fwd_ms,
               "attention_plain_ms": op["plain_ms"], "attention_sdpa_ms": op["sdpa_ms"],
               "attention_kernel_ms": op["kernel_ms"]}
    log("vision", step="summary", card=card, **summary)
    return {"launches": launches, "attention_launches": {}, **summary}


def lora_phase(device, seed: int, card: str) -> dict:
    """Serve mistral-7b-instruct with LoRA adapters (rank 8 on wq and wv)
    through the continuous-batching scheduler beside the base tree, check
    the adapted answers against the dense path of the merged tree, pin
    zero-init adapters to the base, and time a decode tick of each."""
    import copy

    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.models import lora
    from pathway_tpu_torch.serving.generation import GenerationScheduler

    torch.cuda.reset_peak_memory_stats()
    lm = dec.DecoderLM(GEN_MODEL, seed=seed, max_cache=GEN_CACHE, device=device)
    cfg = lm.config
    widths = {k: getattr(cfg, k) for k in GEN_WIDTHS}
    if widths != GEN_WIDTHS:
        fail(f"decoder widths {widths} are not mistral-7b-instruct's {GEN_WIDTHS}")
    base = lm.params
    adapted = lora.lora_decoder_tree(base, cfg, rank=LORA_RANK, alpha=LORA_ALPHA, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 31)
    for name in lora.DEFAULT_TARGETS:
        b = adapted["layers"][name]["b"]
        b.copy_(torch.randn(b.shape, generator=gen, device=device) * LORA_B_STD)
    adapter_bytes = sum(tensor_bytes({k: w[k] for k in ("a", "b")})
                        for w in adapted["layers"].values() if isinstance(w, dict))
    log("lora", step="model", model=GEN_MODEL, **widths, dtype=str(cfg.dtype), rank=LORA_RANK, alpha=LORA_ALPHA,
        targets=lora.DEFAULT_TARGETS, b_std=LORA_B_STD, adapter_mb=adapter_bytes / 1e6,
        weights_gb=tensor_bytes(base) / 1e9, device=str(lm.device))

    prompts, sampled, greedy = burst_prompts(np.random.default_rng(seed + 29), MOE_REQUESTS, MOE_SAMPLED,
                                             MOE_PROMPT_LENS, cfg.vocab_size)
    for tree in (adapted, base):  # warm-up: one short request through a scheduler
        lm.params = tree
        sched = GenerationScheduler(lm, seed=seed)
        sched.submit_ids(prompts[0][:32], max_new_tokens=4).result(timeout=300)
        sched.shutdown()
    # each tree twice, in turns: host time per tick drifts within a call
    trees, runs = {"adapted": adapted, "base": base}, {"adapted": [], "base": []}
    for name in ("adapted", "base", "base", "adapted"):
        lm.params = trees[name]
        runs[name].append(serve_burst(lm, prompts, sampled, MOE_NEW_TOKENS, seed, f"lora:{name}"))
    launches = {"encoder_attention": sum(r["launches"]["encoder_attention"] for rs in runs.values() for r in rs)}
    outs = {name: rs[0]["outs"] for name, rs in runs.items()}

    with torch.inference_mode():
        lm.params = adapted
        reference = copy.copy(lm)
        reference.params = lora.merge_lora(adapted)  # the dense reference: the adapters merged
        parted = check_generation(lm, prompts, outs["adapted"], greedy, sampled, MOE_NEW_TOKENS, device,
                                  "lora", reference=reference)
        del reference
        gc.collect()
        torch.cuda.empty_cache()
        differ = [i for i in greedy if outs["adapted"][i] != outs["base"][i]]
        rows = [prompts[i] for i in greedy[:ZERO_INIT_PROMPTS]]
        lm.params = lora.lora_decoder_tree(base, cfg, rank=LORA_RANK, alpha=LORA_ALPHA, seed=seed)
        zero = lm.generate_ids(rows, max_new_tokens=MOE_NEW_TOKENS)
        lm.params = base
        plain = lm.generate_ids(rows, max_new_tokens=MOE_NEW_TOKENS)
        log("lora", step="check_adapters", greedy_rows=len(greedy), rows_differing_from_base=len(differ),
            zero_init_rows=len(rows), zero_init_equal_to_base=zero == plain)
        if not differ:
            fail("lora: the adapted greedy rows equal the base tree's: the adapters are not on the path")
        if zero != plain:
            fail("lora: zero-init adapters changed the greedy tokens")

        # a decode tick at 8 slots over each tree, and a timing-only rank-16
        # adapter on all seven targets
        everywhere = lora.lora_decoder_tree(base, cfg, rank=LORA_TIMING_RANK, alpha=LORA_ALPHA,
                                            targets=tuple(sorted(lora._ADAPTABLE)), seed=seed)
        tick = decode_tick_inputs(lm, [len(prompts[i]) for i in range(runs["base"][0]["sched_slots"])], device)
        timing = {}
        for name, tree in (("base", base), ("adapted", adapted), ("rank16_all", everywhere)):
            t = decode_tick(tree, cfg, tick)
            timing.update({f"{name}_{k}": v for k, v in t.items()})
            log("lora", step="tick", tree=name, adapter_mb=(tensor_bytes(tree) - tensor_bytes(base)) / 1e6, **t)
        del everywhere, tick
    rate = {name: float(np.mean([r["burst"]["tokens_per_s"] for r in rs])) for name, rs in runs.items()}
    summary = {
        **{f"{name}_{k}": [r["burst"][k] for r in rs] for name, rs in runs.items()
           for k in ("tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "latency_ms_p50", "latency_ms_p99", "ms_per_tick")},
        "adapted_over_base_tokens_per_s": rate["adapted"] / rate["base"],
        "parted_greedy_rows": parted, "rows_differing_from_base": len(differ), **timing,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("lora", step="summary", card=card, **summary)
    return {"launches": launches, "attention_launches": {}, **summary}


# ---------------------------------------------------------------------------
# Phase 13: training on one card.
# ---------------------------------------------------------------------------

TRAIN_ENCODERS = ("all-MiniLM-L6-v2", BGE_MODEL)
TRAIN_PAIRS = 256  # (query, passage) pairs a step
TRAIN_SEQ = 128
TRAIN_STEPS = 20
TRAIN_LR = 1e-4
TRAIN_LOSS_REL = 1e-2  # step 1: bf16 compute against f32 compute, |Δloss| / |loss|
TRAIN_GRAD_COS = 0.99  # and the flattened gradients' cosine
LM_SHAPE = (4, 512)  # one fixed batch of ids, real lengths in LM_LENS
LM_LENS = (256, 512)
LM_STEPS = 6
LM_LR = 1e-4
REMAT_LAYERS = 2  # remat on against off at full width, this many layers
REMAT_COS = 0.9999
LORA_SHAPE = (8, 512)
LORA_STEPS = 10
LORA_LR = 2e-3
LORA_SERVE_PROMPTS = 4
LORA_SERVE_TOKENS = 32
CKPT_STEP = 5  # the LoRA state is saved after this many steps and resumed
RESUME_REL = 1e-3
MOE_TRAIN_TOKENS = 4096
MOE_TRAIN_STEPS = 10
MOE_TRAIN_LR = 3e-4


def adam(lr: float, **kw):
    """``optax.adam(lr)``'s counterpart, as ``parallel/train.py`` maps it."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8, **kw)


def timed_step(run, state, *batch):
    """One train step: ``(state, loss, host ms, device ms)``, the host clock
    around the step and its loss read back, CUDA events around the step."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    state, loss = run(state, *batch)
    end.record()
    loss = float(loss)
    host = (time.perf_counter() - t0) * 1e3
    return state, loss, host, start.elapsed_time(end)


def profile_step(fn, step_ms: float, top: int = 6) -> dict:
    """One more step, ``fn``, under ``torch.profiler`` with CUDA activity:
    the kernels' summed device ms (user annotations such as the optimizer's
    step range left out: they span kernels already counted), the card's
    idle share of an unprofiled step of ``step_ms`` host ms (the profiler
    slows the host), and the ``top`` kernels by device time.  If the
    profiler cannot trace the card, ``kernel_ms`` is ``None``: not
    measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as err:  # no CUPTI on the machine: the breakdown is not measured
        return {"kernel_ms": None, "error": str(err)[:200]}
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    total = sum(ms for _, ms, _ in kernels)
    if not total:
        return {"kernel_ms": None, "wall_ms": wall}
    kernels.sort(key=lambda k: -k[1])
    return {"wall_ms": wall, "kernel_ms": total, "idle_share": 1.0 - total / step_ms, "kernels": len(kernels),
            "launches": sum(n for _, _, n in kernels),
            "top": [{"kernel": name[:80], "ms": ms, "share": ms / total, "calls": n} for name, ms, n in kernels[:top]]}


def grad_cosine(ga, gb) -> float:
    """Cosine of two gradient lists, flattened, summed in float64."""
    dot = sum(float((a.double() * b.double()).sum()) for a, b in zip(ga, gb))
    na = math.sqrt(sum(float(a.double().square().sum()) for a in ga))
    nb = math.sqrt(sum(float(b.double().square().sum()) for b in gb))
    return dot / (na * nb)


def grad_rel_l2(ga, gb) -> float:
    """``|ga - gb| / |gb|`` of two gradient lists, flattened, in float64:
    unlike the cosine, it fails a gradient off by a constant factor."""
    diff = math.sqrt(sum(float((a.double() - b.double()).square().sum()) for a, b in zip(ga, gb)))
    return diff / math.sqrt(sum(float(b.double().square().sum()) for b in gb))


def step_stats(losses, host, dev) -> dict:
    """Losses and per-step times; the means leave out step 1 (first-call
    allocation and autotuning)."""
    return {"losses": losses, "step_ms_host": float(np.mean(host[1:])), "step_ms_device": float(np.mean(dev[1:])),
            "step1_ms_host": host[0]}


def span_queries(rng, lengths, word_ids, vocab) -> list[str]:
    """One query per text: a span of 6-20 of its words (at most the text)
    with a quarter of them swapped, as ``rerank_queries`` draws them."""
    out = []
    for c in range(len(lengths)):
        n = min(int(rng.integers(QUERY_WORDS[0], QUERY_WORDS[1] + 1)), int(lengths[c]))
        start = int(rng.integers(0, lengths[c] - n + 1))
        words = word_ids[c][start : start + n].copy()
        swap = rng.random(n) < QUERY_SWAP
        words[swap] = rng.integers(0, len(vocab), size=int(swap.sum()))
        out.append(" ".join(vocab[w] for w in words))
    return out


def contrastive_part(device, seed: int) -> dict:
    """MiniLM then BGE-base: 20 Adam steps of symmetric InfoNCE on 256
    fresh (query, passage) pairs at seq 128, f32 trees with bf16 compute;
    step 1 held to f32 compute."""
    from pathway_tpu_torch.models import encoder as enc
    from pathway_tpu_torch.models.tokenizer import load_tokenizer, pad_batch
    from pathway_tpu_torch.parallel import train

    n = TRAIN_PAIRS * TRAIN_STEPS
    texts, lengths, word_ids, vocab = synthetic_corpus(n, seed)
    queries = span_queries(np.random.default_rng(seed + 43), lengths, word_ids, vocab)
    out = {}
    for model in TRAIN_ENCODERS:
        cfg = enc.config_for(model)
        tok = load_tokenizer(model, cfg.vocab_size, cfg.max_len)

        def tokens(rows):
            ids, mask = pad_batch([tok.encode(t, max_length=TRAIN_SEQ) for t in rows], TRAIN_SEQ)
            return torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)

        batches = [(*tokens(queries[s * TRAIN_PAIRS : (s + 1) * TRAIN_PAIRS]),
                    *tokens(texts[s * TRAIN_PAIRS : (s + 1) * TRAIN_PAIRS])) for s in range(TRAIN_STEPS)]
        tree = enc.init_params(cfg, seed)
        module = enc.SentenceEncoderModule(cfg, tree, device=device)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, _ = train.init_train_state(module, adam(TRAIN_LR), device=device)
        leaves = [state.params[k] for k in sorted(state.params)]

        # step 1 in bf16 compute against the same step in f32 compute
        loss_bf = train.contrastive_loss(module, state.params, *batches[0])
        g_bf = torch.autograd.grad(loss_bf, leaves)
        module32 = enc.SentenceEncoderModule(dataclasses.replace(cfg, dtype=torch.float32), tree, device=device)
        loss_32 = train.contrastive_loss(module32, state.params, *batches[0])
        g_32 = torch.autograd.grad(loss_32, leaves)
        loss_bf, loss_32 = float(loss_bf.detach()), float(loss_32.detach())
        check = {"loss_bf16": loss_bf, "loss_f32": loss_32, "loss_rel_diff": abs(loss_bf - loss_32) / abs(loss_32),
                 "grad_cosine": grad_cosine(g_bf, g_32), "check_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del module32, g_bf, g_32
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        run = train.make_contrastive_train_step(module, device=device)
        losses, host, dev = [], [], []
        for b in batches:
            state, loss, h, d = timed_step(run, state, *b)
            losses.append(loss)
            host.append(h)
            dev.append(d)
        res = {"model": model, "hidden": cfg.hidden, "layers": cfg.layers, "dtype": str(cfg.dtype),
               "params_m": sum(t.numel() for t in leaves) / 1e6, "pairs": TRAIN_PAIRS, "seq": TRAIN_SEQ,
               "steps": TRAIN_STEPS, "lr": TRAIN_LR, **check, **step_stats(losses, host, dev),
               "pairs_per_s": TRAIN_PAIRS * (TRAIN_STEPS - 1) / (sum(host[1:]) / 1e3),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        res["profile"] = profile_step(lambda: run(state, *batches[-1]), res["step_ms_host"])
        log("train", part="contrastive", **res)
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        if not np.isfinite(losses).all():
            fail(f"train: contrastive {model}: a loss is not finite: {losses}")
        if not last < first:
            fail(f"train: contrastive {model}: the last 5 losses ({last}) are not below the first 5 ({first})")
        if check["loss_rel_diff"] > TRAIN_LOSS_REL or check["grad_cosine"] <= TRAIN_GRAD_COS:
            fail(f"train: contrastive {model}: bf16 compute left f32's: {check}")
        out[model] = res
        del state, run, module, leaves, batches
    return out


def lm_full_part(device, seed: int) -> dict:
    """mistral-7b-instruct at full width and depth in bf16 with bf16 Adam
    moments and remat: 6 steps on one batch of 4 × 512 ids; first remat on
    against off at 2 layers of full width."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.parallel import train

    cfg = dataclasses.replace(dec.decoder_config_for(GEN_MODEL), remat=True)
    widths = {k: getattr(cfg, k) for k in GEN_WIDTHS}
    if widths != GEN_WIDTHS:
        fail(f"decoder widths {widths} are not mistral-7b-instruct's {GEN_WIDTHS}")
    rng = np.random.default_rng(seed + 47)
    B, S = LM_SHAPE
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, S))).to(device)
    lens = torch.from_numpy(rng.integers(LM_LENS[0], LM_LENS[1] + 1, size=B)).to(device)

    # remat on against off, at REMAT_LAYERS layers of full width
    small = dataclasses.replace(cfg, layers=REMAT_LAYERS)
    tree = dec.init_decoder_params(small, seed, device)
    leaves = list(train.named_leaves(tree).values())
    for t in leaves:
        t.requires_grad_(True)
    remat = {}
    for on in (False, True):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        loss = train.lm_loss(tree, ids, lens, dataclasses.replace(small, remat=on))
        grads = torch.autograd.grad(loss, leaves)
        remat[on] = (float(loss), grads, (torch.cuda.max_memory_allocated() - before) / 1e9)
    check = {"layers": REMAT_LAYERS, "loss_off": remat[False][0], "loss_on": remat[True][0],
             "grad_cosine": grad_cosine(remat[False][1], remat[True][1]),
             "step_mem_gb_off": remat[False][2], "step_mem_gb_on": remat[True][2]}
    log("train", part="lm_full", step="remat_check", **check)
    if check["grad_cosine"] <= REMAT_COS:
        fail(f"train: lm_full: remat on and off give other gradients: {check}")
    del tree, leaves, remat, grads, loss
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    init_state, run = train.make_causal_lm_train_step(cfg, adam(LM_LR, fused=True), device=device)
    state = init_state(seed)
    n_params = sum(t.numel() for t in train.named_leaves(state.params).values())
    reckoned = n_params * (2 + 2 + 2 + 2) / 1e9  # bf16 params, grads and two Adam moments
    log("train", part="lm_full", step="memory", params_b=n_params / 1e9, reckoned_state_gb=reckoned,
        allocated_gb=torch.cuda.memory_allocated() / 1e9)
    losses, host, dev = [], [], []
    for _ in range(LM_STEPS):
        state, loss, h, d = timed_step(run, state, ids, lens)
        losses.append(loss)
        host.append(h)
        dev.append(d)
    stats = step_stats(losses, host, dev)
    flops = 8 * n_params * B * S  # forward, remat forward, backward (4)
    res = {"model": GEN_MODEL, **widths, "dtype": str(cfg.dtype), "remat": cfg.remat, "optimizer": "Adam fused",
           "lr": LM_LR, "batch": LM_SHAPE, "tokens": int(lens.sum()), "params_b": n_params / 1e9,
           "reckoned_state_gb": reckoned, **stats,
           "tokens_per_s": int(lens.sum()) / (stats["step_ms_host"] / 1e3),
           "tflops_per_s": flops / (stats["step_ms_host"] / 1e3) / 1e12,
           "tflops_share_of_989": flops / (stats["step_ms_host"] / 1e3) / BF16_FLOPS_PER_S,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "remat_check": check}
    res["profile"] = profile_step(lambda: run(state, ids, lens), stats["step_ms_host"])
    log("train", part="lm_full", **{k: v for k, v in res.items() if k != "remat_check"})
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"train: lm_full: the losses are not finite and falling: {losses}")
    del state, run, init_state
    return res


def base_checksums(tree) -> dict:
    """Every leaf's bits summed as int16 words (layer by layer), exact."""
    from pathway_tpu_torch.parallel.train import named_leaves

    return {name: sum(int(m.reshape(-1).view(torch.int16).long().sum()) for m in t.reshape(-1, t.shape[-1]).split(4096))
            for name, t in named_leaves(tree).items()}


def lora_part(device, seed: int) -> dict:
    """mistral-7b-instruct at full depth with rank-8 adapters on wq/wv and
    remat: 10 steps on one batch of 8 × 512 ids, the state saved after 5,
    restored into a fresh state and run 5 more steps; then the trained tree
    serves 4 greedy prompts, held to the merged tree's dense path."""
    import copy
    import tempfile

    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.models import lora
    from pathway_tpu_torch.parallel import TrainCheckpointer
    from pathway_tpu_torch.parallel.train import named_leaves

    torch.cuda.reset_peak_memory_stats()
    lm = dec.DecoderLM(GEN_MODEL, seed=seed, max_cache=GEN_CACHE, device=device)
    cfg = dataclasses.replace(lm.config, remat=True)
    base = lm.params
    before = base_checksums(base)
    init_state, run = lora.make_lora_train_step(cfg, base, adam(LORA_LR, fused=True), device=device,
                                                rank=LORA_RANK, alpha=LORA_ALPHA, seed=seed)
    state = init_state()
    rng = np.random.default_rng(seed + 59)
    B, S = LORA_SHAPE
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, S))).to(device)
    lens = torch.from_numpy(rng.integers(LM_LENS[0], LM_LENS[1] + 1, size=B)).to(device)
    losses, host, dev = [], [], []
    with tempfile.TemporaryDirectory() as tmp, TrainCheckpointer(tmp) as ck:
        for step in range(LORA_STEPS):
            if step == CKPT_STEP:
                t0 = time.perf_counter()
                ck.save(state)
                save_ms = (time.perf_counter() - t0) * 1e3
                ckpt_mb = os.path.getsize(os.path.join(tmp, str(CKPT_STEP), "state.pt")) / 1e6
            state, loss, h, d = timed_step(run, state, ids, lens)
            losses.append(loss)
            host.append(h)
            dev.append(d)
        t0 = time.perf_counter()
        resumed = ck.restore(init_state())
        restore_ms = (time.perf_counter() - t0) * 1e3
    resumed_losses = []
    for _ in range(LORA_STEPS - CKPT_STEP):
        resumed, loss = run(resumed, ids, lens)
        resumed_losses.append(float(loss))
    after = base_checksums(base)
    adapters = {name: t for name, t in named_leaves(state.params).items() if name[-2:] in ("/a", "/b")}
    adapter_bytes = sum(t.numel() * t.element_size() for t in adapters.values())
    opt = state.opt_state
    held = {id(p) for group in opt.param_groups for p in group["params"]}
    moment_bytes = sum(s[k].numel() * s[k].element_size() for s in opt.state.values() for k in ("exp_avg", "exp_avg_sq"))
    b_moved = {name: float(state.params["layers"][name]["b"].detach().abs().max()) for name in lora.DEFAULT_TARGETS}
    resume_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed_losses, losses[CKPT_STEP:]))
    stats = step_stats(losses, host, dev)
    profile = profile_step(lambda: run(resumed, ids, lens), stats["step_ms_host"])
    res = {"model": GEN_MODEL, "rank": LORA_RANK, "alpha": LORA_ALPHA, "targets": lora.DEFAULT_TARGETS,
           "remat": cfg.remat, "lr": LORA_LR, "batch": LORA_SHAPE, "tokens": int(lens.sum()), **stats,
           "tokens_per_s": int(lens.sum()) / (stats["step_ms_host"] / 1e3),
           "adapter_mb": adapter_bytes / 1e6, "adam_moment_mb": moment_bytes / 1e6,
           "base_leaves_unchanged": sum(before[k] == after[k] for k in before), "base_leaves": len(before),
           "b_max_abs": b_moved, "checkpoint": {"step": CKPT_STEP, "file_mb": ckpt_mb, "save_ms": save_ms,
                                                "restore_ms": restore_ms, "resumed_losses": resumed_losses,
                                                "max_rel_diff": resume_rel}, "profile": profile}
    log("train", part="lora", **res)
    problems = []
    if before != after:
        problems.append(f"base leaves changed: {[k for k in before if before[k] != after[k]]}")
    if not all(v > 0 for v in b_moved.values()):
        problems.append(f"an adapter b did not move: {b_moved}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        problems.append(f"the losses are not finite and falling: {losses}")
    if held != {id(t) for t in adapters.values()} or moment_bytes != 2 * adapter_bytes:
        problems.append(f"Adam holds {moment_bytes} moment bytes over {len(held)} tensors, not 2 x {adapter_bytes} "
                        f"over the {len(adapters)} adapters")
    if resume_rel > RESUME_REL:
        problems.append(f"the resumed losses {resumed_losses} left the run's {losses[CKPT_STEP:]}")
    if problems:
        fail("train: lora: " + "; ".join(problems))
    del resumed, opt

    # the trained tree serves, held to the merged tree's dense path
    with torch.inference_mode():
        trained = detached(state.params)
        del state
        prompts, sampled, greedy = burst_prompts(np.random.default_rng(seed + 61), LORA_SERVE_PROMPTS, 0,
                                                 MOE_PROMPT_LENS, cfg.vocab_size)
        lm.params = trained
        outs = lm.generate_ids(prompts, max_new_tokens=LORA_SERVE_TOKENS)
        reference = copy.copy(lm)
        reference.params = lora.merge_lora(trained)
        res["serve_parted_rows"] = check_generation(lm, prompts, outs, greedy, sampled, LORA_SERVE_TOKENS, device,
                                                    "train", reference=reference)
        del reference, trained
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del lm, base
    return res


def moe_train_part(device, seed: int) -> dict:
    """The MoE layer at mixtral-8x7b width (8 experts, top-2, capacity
    factor 2.0, bf16): 10 Adam steps of the denoising regression on 4,096
    fresh tokens each, with the share of assignments dropped at capacity."""
    from pathway_tpu_torch.parallel import moe

    H, F_ = GEN_WIDTHS["hidden"], GEN_WIDTHS["intermediate"]
    cfg = moe.MoEConfig(hidden=H, experts=8, intermediate=F_, top_k=2, capacity_factor=2.0, dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn = moe.make_moe_train_step(cfg, adam(MOE_TRAIN_LR, fused=True), device=device)
    params, opt = init_fn(seed)
    gen = torch.Generator(device=device).manual_seed(seed + 53)
    target_map = torch.randn((H, H), generator=gen, device=device) / math.sqrt(H)
    xs = [torch.randn((MOE_TRAIN_TOKENS, H), generator=gen, device=device) for _ in range(MOE_TRAIN_STEPS)]

    def dropped(x) -> tuple[float, float]:
        with torch.no_grad():
            logits = (x.float() @ params["router"])[None]
            dispatch, _, _ = moe._routing(logits, cfg, cfg.capacity(MOE_TRAIN_TOKENS))
            _, aux = moe.moe_ffn(params, x, cfg)
        return 1.0 - float(dispatch.sum()) / (cfg.top_k * MOE_TRAIN_TOKENS), float(aux)

    drop0, aux0 = dropped(xs[0])
    losses, host, dev = [], [], []

    def run(state, x):
        p, o, loss = step_fn(*state, x, torch.tanh(x @ target_map))
        return (p, o), loss

    state = (params, opt)
    for x in xs:
        state, loss, h, d = timed_step(run, state, x)
        losses.append(loss)
        host.append(h)
        dev.append(d)
    drop1, aux1 = dropped(xs[-1])
    stats = step_stats(losses, host, dev)
    res = {"hidden": H, "experts": cfg.experts, "intermediate": F_, "top_k": cfg.top_k,
           "capacity_factor": cfg.capacity_factor, "capacity": cfg.capacity(MOE_TRAIN_TOKENS), "dtype": str(cfg.dtype),
           "tokens": MOE_TRAIN_TOKENS, "lr": MOE_TRAIN_LR, **stats,
           "tokens_per_s": MOE_TRAIN_TOKENS / (stats["step_ms_host"] / 1e3),
           "dropped_share_first": drop0, "dropped_share_last": drop1, "aux_first": aux0, "aux_last": aux1,
           "params_b": sum(t.numel() for t in params.values()) / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["profile"] = profile_step(lambda: run(state, xs[-1]), stats["step_ms_host"])
    log("train", part="moe", **res)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"train: moe: the losses are not finite and falling: {losses}")
    if not (np.isfinite(aux0) and np.isfinite(aux1)):
        fail(f"train: moe: the aux loss is not finite: {aux0}, {aux1}")
    del state, params, opt, xs
    return res


def train_phase(device, seed: int, card: str) -> dict:
    """Training on one card: the contrastive encoder step, causal-LM full
    fine-tuning and LoRA with remat, checkpoint/resume, and the MoE step.
    The encoder kernel is on none of these paths (both packages train
    through the module forward's plain attention): its launches are
    counted over the whole phase and must be 0."""
    from pathway_tpu_torch.ops import attention as attn

    parts, seconds = {}, {}
    attn.encoder_attention.launches = 0
    for name, part in (("contrastive", contrastive_part), ("lm_full", lm_full_part), ("lora", lora_part),
                       ("moe", moe_train_part)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        parts[name] = part(device, seed)
        seconds[name] = time.perf_counter() - t0
    launches = {"encoder_attention": attn.encoder_attention.launches}
    summary = {
        **{f"contrastive_{m}_{k}": parts["contrastive"][m][k] for m in TRAIN_ENCODERS
           for k in ("pairs_per_s", "step_ms_host", "step_ms_device", "peak_mem_gb", "loss_rel_diff", "grad_cosine")},
        **{f"{p}_{k}": parts[p][k] for p in ("lm_full", "lora", "moe")
           for k in ("tokens_per_s", "step_ms_host", "step_ms_device", "peak_mem_gb")},
        "lm_full_tflops_per_s": parts["lm_full"]["tflops_per_s"],
        "lm_full_remat_grad_cosine": parts["lm_full"]["remat_check"]["grad_cosine"],
        "lora_resume_max_rel_diff": parts["lora"]["checkpoint"]["max_rel_diff"],
        "moe_dropped_share": parts["moe"]["dropped_share_first"],
        "part_seconds": seconds, "kernel_launches": launches,
    }
    log("train", step="summary", card=card, **summary)
    return {"launches": launches, "attention_launches": {}, **summary}


# ---------------------------------------------------------------------------
# Phase 14: the multi-device layer, a world of one in this process.
# ---------------------------------------------------------------------------

PAR_ROWS = 2_097_152  # 8x the embed phase's index
PAR_DIM = 384  # all-MiniLM-L6-v2's width
PAR_BATCHES = 128  # timed, after one untimed batch
PAR_QUERIES = 64
PAR_K = 10
PAR_PLANTED = 8  # corpus rows planted as queries in each batch
RING_SHAPES = [(2, 256, 384, 12), (1, 512, 768, 12), (1, 1024, 384, 12), (1, 2048, 384, 6)]  # tests/test_ring_attention.py:24-33
RING_TRUTH_SHAPE = (1, 2048, 384, 12)  # :62
RING_TRUTH_TOL = 0.06  # :85
RING_PIN_SHAPE = (1, 256, 384, 12)  # :95
LONG_TEXTS = 4096  # of the main corpus
LONG_DOCS = 64
LONG_WORDS = (1000, 3000)
LONG_COS_MIN = 0.99  # tests/test_long_context.py:53
LONG_PAD_TOL = 0.02  # :77


def topk_parted(idx, vals, ref_idx, ref_vals) -> tuple[int, float]:
    """Rows whose ids part from the reference's, and the largest score gap
    between the two answers on those rows (a near-tie parts within
    ``SCORE_TOL``)."""
    rows = np.nonzero((idx != ref_idx).any(axis=1))[0]
    gap = float(np.abs(vals[rows] - ref_vals[rows]).max()) if len(rows) else 0.0
    return len(rows), gap


def parallel_index_part(mesh, device, seed: int, card: str) -> dict:
    """2,097,152 seeded unit rows x 384 in bf16 on the card through
    ``ShardedDeviceIndex`` and a mesh ``DeviceIndexCache``, against the
    single-device cache: planted rows found, ids equal but at near-ties,
    scores within SCORE_TOL of f32, p50/p99 ms per batch of 64 at k=10."""
    from pathway_tpu_torch.ops import topk
    from pathway_tpu_torch.parallel import ShardedDeviceIndex

    gen = torch.Generator(device=device).manual_seed(seed + 60)
    t0 = time.perf_counter()
    rows = torch.randn((PAR_ROWS, PAR_DIM), generator=gen, device=device)
    rows /= torch.linalg.norm(rows, dim=1, keepdim=True)
    matrix = rows.cpu().numpy()  # kept on the card too: the f32 scores of the same vectors
    rng = np.random.default_rng(seed + 61)
    batches = []
    for _ in range(PAR_BATCHES + 1):
        q = rng.normal(size=(PAR_QUERIES, PAR_DIM)).astype(np.float32)
        planted = rng.choice(PAR_ROWS, size=PAR_PLANTED, replace=False)
        slots = rng.choice(PAR_QUERIES, size=PAR_PLANTED, replace=False)
        q[slots] = matrix[planted]
        batches.append((q, slots, planted))
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    sharded = ShardedDeviceIndex(mesh, PAR_DIM, dtype=torch.bfloat16)
    sharded.add(matrix)
    sharded._sync()
    mesh_cache = topk.DeviceIndexCache(mesh=mesh)
    single_cache = topk.DeviceIndexCache(device=device)
    mesh_cache.get(matrix, 1, "cos")
    single_cache.get(matrix, 1, "cos")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def unit(q):
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    paths = {
        "sharded_index": lambda q: sharded.search(unit(q), PAR_K),
        "mesh_cache": lambda q: topk.topk_search_cached(matrix, q, PAR_K, "cos", cache=mesh_cache, version=1),
        "single_cache": lambda q: topk.topk_search_cached(matrix, q, PAR_K, "cos", cache=single_cache, version=1),
    }
    times = {name: [] for name in paths}
    answers = {name: [] for name in paths}
    for b, (q, _, _) in enumerate(batches):
        for name, search in paths.items():  # in turns, batch by batch
            t0 = time.perf_counter()
            answers[name].append(search(q))
            if b:  # the first batch is untimed
                times[name].append((time.perf_counter() - t0) * 1e3)

    worst_score, missed, parted, gaps = 0.0, 0, {}, {}
    for name in paths:
        n_parted, gap = 0, 0.0
        for (q, slots, planted), (idx, vals), (ref_idx, ref_vals) in zip(
            batches, answers[name], answers["single_cache"]
        ):
            missed += int((idx[slots, 0] != planted).sum())
            p, g_ = topk_parted(idx, vals, ref_idx, ref_vals)
            n_parted += p
            gap = max(gap, g_)
            qs = torch.from_numpy(unit(q)).to(device)
            f32 = (qs[:, None, :] * rows[torch.from_numpy(idx).to(device)]).sum(-1)
            worst_score = max(worst_score, float((f32.cpu() - torch.from_numpy(vals)).abs().max()))
        parted[name], gaps[name] = n_parted, gap
    index_bytes = PAR_ROWS * PAR_DIM * 2 + PAR_ROWS * 4  # bf16 rows and the f32 mask, read once a batch
    res = {"card": card, "rows": PAR_ROWS, "dim": PAR_DIM, "index_gb": PAR_ROWS * PAR_DIM * 2 / 1e9,
           "capacity": int(sharded._docs.shape[0]), "batches": PAR_BATCHES, "queries": PAR_QUERIES, "k": PAR_K,
           "planted_per_batch": PAR_PLANTED, "setup_s": setup_s, "build_s": build_s,
           **{f"{name}_ms": percentiles(t) for name, t in times.items()},
           "bound_ms": index_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "planted_missed": missed, "parted_rows": parted, "parted_max_gap": gaps,
           "max_score_err": worst_score}
    log("parallel", part="index", **res)
    if missed:
        fail(f"parallel: index: {missed} planted rows not found first")
    if max(gaps.values()) >= SCORE_TOL:
        fail(f"parallel: index: ids part from the single-device answers beyond a near-tie: {gaps}")
    if worst_score >= SCORE_TOL:
        fail(f"parallel: index: scores differ from f32 scores of the stored rows by {worst_score}")
    del sharded, mesh_cache, single_cache, rows, matrix
    return res


def sdpa(q, k, v, bias, heads):
    """The library call for the same attention: SDPA on [B, heads, S, hd]."""
    B, S, H = q.shape

    def split(x):
        return x.reshape(B, S, heads, H // heads).transpose(1, 2)

    mask = bias[:, None, None, :].to(q.dtype)
    out = torch.nn.functional.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=mask)
    return out.transpose(1, 2).reshape(B, S, H)


def ring_part(mesh, device, seed: int, card: str) -> dict:
    """``ring_encoder_attention`` at the JAX test's shapes in bf16 with a
    masked tail of 10%: against the plain attention (< ATTN_TOL), against
    the f32 truth at (1, 2048, 384, 12) (< 0.06), the masked-key pin
    (< PIN_TOL); device ms per shape beside SDPA on the same q, k, v."""
    from pathway_tpu_torch.ops.attention import encoder_attention_reference
    from pathway_tpu_torch.parallel import ring_encoder_attention

    gen = torch.Generator(device=device).manual_seed(seed + 62)

    def inputs(B, S, H, masked_from, dtype=torch.bfloat16):
        q, k, v = (torch.randn((B, S, H), generator=gen, device=device).to(dtype) for _ in range(3))
        bias = torch.zeros((B, S), device=device)
        bias[:, int(S * masked_from):] = -1e9
        return q, k, v, bias

    shapes = []
    for shape in RING_SHAPES:
        B, S, H, heads = shape
        q, k, v, bias = inputs(B, S, H, 0.9)
        with torch.inference_mode():
            out = ring_encoder_attention(mesh, q, k, v, bias, heads)
            err = float((out.float() - encoder_attention_reference(q, k, v, bias, heads).float()).abs().max())
            row = {"shape": list(shape), "max_abs_err": err,
                   "ms": device_ms([lambda: ring_encoder_attention(mesh, q, k, v, bias, heads)]),
                   "library_ms": device_ms([lambda: sdpa(q, k, v, bias, heads)])}
        shapes.append(row)
        if not err < ATTN_TOL:
            fail(f"parallel: ring at {shape}: {err} from the plain attention")
    B, S, H, heads = RING_TRUTH_SHAPE
    q, k, v, bias = inputs(B, S, H, 0.95, torch.float32)
    with torch.inference_mode():
        truth = encoder_attention_reference(q, k, v, bias, heads)
        ring = ring_encoder_attention(mesh, q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, heads)
        truth_err = float((ring.float() - truth).abs().max())
        B, S, H, heads = RING_PIN_SHAPE
        q, k, v, bias = inputs(B, S, H, 0.5)
        k2, v2 = k.clone(), v.clone()
        k2[:, S // 2:] = 77.0
        v2[:, S // 2:] = -77.0
        pin = float((ring_encoder_attention(mesh, q, k, v, bias, heads).float()
                     - ring_encoder_attention(mesh, q, k2, v2, bias, heads).float()).abs().max())
    res = {"card": card, "shapes": shapes, "truth_err": truth_err, "pin_err": pin}
    log("parallel", part="ring", **res)
    if not truth_err < RING_TRUTH_TOL:
        fail(f"parallel: ring against the f32 truth: {truth_err}")
    if not pin < PIN_TOL:
        fail(f"parallel: masked keys moved the ring's output by {pin}")
    return res


def long_context_part(mesh, device, seed: int, card: str, texts) -> dict:
    """``LongContextSentenceEncoder`` (all-MiniLM-L6-v2, full width, seeded)
    on main-corpus texts and 64 texts of 1,000-3,000 words (cut at 512 ids
    at world 1), against ``SentenceEncoder`` on the same weights; emb/s of
    both and the ms of one (64, 512) forward of each.  The encoder kernel's
    launches in the long-context forwards are counted (the phase's count)."""
    import pathway_tpu_torch as pt
    from pathway_tpu_torch.models.long_context import LongContextSentenceEncoder, long_context_sentence_apply
    from pathway_tpu_torch.models.tokenizer import pad_batch
    from pathway_tpu_torch.ops import attention as attn

    long_docs = synthetic_corpus(LONG_DOCS, seed + 63, LONG_WORDS)[0]
    lce = LongContextSentenceEncoder("all-MiniLM-L6-v2", mesh, seed=seed)
    enc = pt.SentenceEncoder("all-MiniLM-L6-v2", seed=seed)
    alone_text = "a modest sentence"

    def run(encoder, docs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encoder.encode(docs)
        return out, time.perf_counter() - t0

    lce.encode(texts[:PAR_QUERIES])  # warm-up, untimed
    attn.encoder_attention.launches = 0
    lce_corpus, lce_corpus_s = run(lce, texts)
    lce_long, lce_long_s = run(lce, long_docs)
    alone = lce.encode([alone_text])[0]
    padded = lce.encode([alone_text, long_docs[0]])[0]
    cfg = lce.config
    ids, mask = pad_batch([lce.tokenizer.encode(t, max_length=cfg.max_len) for t in long_docs], cfg.max_len)
    ids_t, mask_t = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    with torch.inference_mode():
        lce_ms = time_ms(lambda: long_context_sentence_apply(lce._tree, ids_t, mask_t, cfg, mesh), iters=10)
    launches = attn.encoder_attention.launches

    enc.encode(texts[:PAR_QUERIES])
    enc_corpus, enc_corpus_s = run(enc, texts)
    enc_long, enc_long_s = run(enc, long_docs)
    with torch.inference_mode():
        enc_ms = time_ms(lambda: enc.model(ids_t, mask_t), iters=10)
    cos = float(min(cosine_rows(lce_corpus, enc_corpus).min(), cosine_rows(lce_long, enc_long).min()))
    pad_err = float(np.abs(alone - padded).max())
    res = {"card": card, "model": "all-MiniLM-L6-v2", "world": mesh.size(), "texts": len(texts),
           "long_docs": LONG_DOCS, "long_words": list(LONG_WORDS), "max_ids": cfg.max_len * mesh.size(),
           "lce_emb_per_s": len(texts) / lce_corpus_s, "encoder_emb_per_s": len(texts) / enc_corpus_s,
           "lce_long_emb_per_s": LONG_DOCS / lce_long_s, "encoder_long_emb_per_s": LONG_DOCS / enc_long_s,
           "forward_shape": list(ids.shape), "lce_forward_ms": lce_ms, "encoder_forward_ms": enc_ms,
           "min_cos": cos, "padding_err": pad_err, "encoder_kernel_launches": launches}
    log("parallel", part="long_context", **res)
    if not cos > LONG_COS_MIN:
        fail(f"parallel: long-context embeddings against SentenceEncoder: min cosine {cos}")
    if not pad_err < LONG_PAD_TOL:
        fail(f"parallel: a batch-mate moved a long-context embedding by {pad_err}")
    del lce, enc
    return res


def parallel_phase(device, seed: int, card: str, texts) -> dict:
    """The multi-device layer as a world of one in this process, over NCCL:
    the sharded index top-k, ring attention and the long-context encoder.
    The encoder kernel is on none of their paths: its launches in the
    long-context forwards are the phase's count and must be 0."""
    import torch.distributed as dist

    from pathway_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh()
    try:
        log("parallel", step="mesh", card=card, backend=dist.get_backend(), world=dist.get_world_size(),
            axes=list(mesh.mesh_dim_names), shape=list(mesh.shape), seconds=time.perf_counter() - t0)
        parts = {"index": parallel_index_part(mesh, device, seed, card)}
        gc.collect()
        torch.cuda.empty_cache()
        parts["ring"] = ring_part(mesh, device, seed, card)
        parts["long_context"] = long_context_part(mesh, device, seed, card, texts)
    finally:
        dist.destroy_process_group()
    launches = {"encoder_attention": parts["long_context"]["encoder_kernel_launches"]}
    return {"launches": launches, "attention_launches": {}, **parts}


# ---------------------------------------------------------------------------
# Phase 15: tensor-, data-, expert- and pipeline-parallel, a world of one.
# ---------------------------------------------------------------------------

SHARD_PROMPTS = 8
SHARD_DECODE_STEPS = 32
SHARD_MOE_LAYERS = 2  # bf16 mixtral is 93.4 GB: its full depth needs EP across cards
SHARD_MOE_PROMPTS = 4
SHARD_MOE_STEPS = 16
SHARD_TRAIN_LAYERS = 8  # mistral-7b width, depth cut: two states and their moments fit one card
SHARD_STEPS = 4  # after the compared step 0
SHARD_LR = 1e-4
SHARD_LOSS_REL = 1e-3  # step 0: the sharded step against its single-device form
SHARD_GRAD_COS = 0.999
SHARD_GRAD_REL = 0.045  # relative L2 of the step-0 gradients: the cosine's angle, sqrt(2 * (1 - 0.999))
PP_SHAPE = (8, 512)
PP_MICRO = 4
PP_STEPS = 6
CKPT_STEPS = 3


class CaptureAdam(torch.optim.Adam):
    """``torch.optim.Adam`` that keeps a copy of every gradient of its first
    step (the local shard of a DTensor's; the whole one at world 1)."""

    def step(self, closure=None):
        if not hasattr(self, "first_grads"):
            self.first_grads = [(p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad).clone()
                                for g in self.param_groups for p in g["params"]]
        return super().step(closure)


def capture_adam(lr: float):
    return functools.partial(CaptureAdam, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def teacher_forced(tree, cfg, ids, lens, cache: int, steps: int, feed=None):
    """Logits ``[B, steps, V]`` of ``prefill`` then ``steps - 1``
    ``decode_step`` calls, each fed the greedy token of its own logits, or
    ``feed [B, steps]`` (teacher forcing); and the tokens chosen."""
    from pathway_tpu_torch.models import decoder as dec

    with torch.no_grad():
        logits, kc, vc = dec.prefill(tree, ids, lens, cfg, cache)
        out, toks = [logits], [logits.argmax(-1) if feed is None else feed[:, 0]]
        for t in range(steps - 1):
            logits, kc, vc = dec.decode_step(tree, kc, vc, toks[-1], lens + t, cfg)
            out.append(logits)
            toks.append(logits.argmax(-1) if feed is None else feed[:, t + 1])
    return torch.stack(out, dim=1), torch.stack(toks, dim=1)


def tp_serve_check(name: str, tree, placed, cfg, ids, lens, steps: int) -> dict:
    """The tensor-parallel tree against the unsharded one on the same
    weights: the unsharded greedy chain's logits against the placed
    tree's, teacher-forced on the same tokens (within the near-tie tol of
    each step), and the placed tree's own greedy tokens, each within tol of
    the unsharded max of its step (``[generate]``'s gates); then ms per
    prefill and per decode step of both, CUDA events, and of the placed
    leaves in a plain dict (``checked``: the layout checked every call,
    not once at placement), with host µs per ``shard_view`` of each."""
    from pathway_tpu_torch.models import decoder as dec

    cache = GEN_CACHE
    ref, ref_tok = teacher_forced(tree, cfg, ids, lens, cache, steps)
    got, _ = teacher_forced(placed, cfg, ids, lens, cache, steps, feed=ref_tok)
    tol = near_tie_tol(ref)
    err = (got - ref).abs().amax(dim=-1)
    own, own_tok = teacher_forced(placed, cfg, ids, lens, cache, steps)
    parted = {r: t for r in range(len(ids)) if (t := first_parting(own_tok[r].tolist(), ref_tok[r].tolist()))
              is not None}
    live = torch.ones_like(own_tok, dtype=torch.bool)
    gaps = below_max(teacher_forced(tree, cfg, ids, lens, cache, steps, feed=own_tok)[0] if parted else ref,
                     own_tok, live)
    with torch.no_grad():
        timing = {}
        for label, t in (("unsharded", tree), ("sharded", placed), ("checked", dict(placed))):
            _, kc, vc = dec.prefill(t, ids, lens, cfg, cache)
            tok = ref_tok[:, 0]
            timing[f"prefill_ms_{label}"] = time_ms(lambda: dec.prefill(t, ids, lens, cfg, cache), iters=3, warmup=1)
            timing[f"decode_ms_{label}"] = time_ms(lambda: dec.decode_step(t, kc, vc, tok, lens, cfg), iters=10)
            del kc, vc
        timing["view_us_placed"] = host_us(lambda: dec.shard_view(placed, cfg))
        timing["view_us_checked"] = host_us(lambda: dec.shard_view(dict(placed), cfg))
    res = {"model": name, "layers": cfg.layers, "prompts": len(ids), "prompt_ids": [int(lens.min()), int(lens.max())],
           "steps": steps, "max_abs_err": float(err.max()), "worst_err_over_tol": float((err / tol).max()),
           "min_tol": float(tol.min()), "greedy_rows_parted": parted, **gaps, **timing,
           "prefill_ratio": timing["prefill_ms_sharded"] / timing["prefill_ms_unsharded"],
           "decode_ratio": timing["decode_ms_sharded"] / timing["decode_ms_unsharded"]}
    problems = []
    if not bool(torch.isfinite(got).all()):
        problems.append("sharded logits are not finite")
    if res["worst_err_over_tol"] >= 1.0:
        problems.append(f"sharded logits left the unsharded ones by {res['worst_err_over_tol']} tol")
    if gaps["tokens_over_tol"]:
        problems.append(f"{gaps['tokens_over_tol']} sharded greedy token(s) lie tol or more below the unsharded max")
    if problems:
        fail(f"sharded: {name}: " + "; ".join(problems))
    return res


def serve_prompts(rng, n: int, lens: tuple[int, int], vocab: int, device):
    lengths = rng.integers(lens[0], lens[1] + 1, size=n)
    ids = torch.zeros((n, int(lengths.max())), dtype=torch.int64)
    for r, m in enumerate(lengths):
        ids[r, :m] = torch.from_numpy(rng.integers(3, vocab, size=int(m)))
    return ids.to(device), torch.from_numpy(lengths).to(device)


def tp_serve_part(device, seed: int, card: str) -> dict:
    """mistral-7b-instruct at full width and depth, placed by
    ``tp_param_specs`` on a ``("model",)`` mesh of one, against the
    unsharded tree on the same weights."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.parallel import world_mesh

    cfg = dec.decoder_config_for(GEN_MODEL)
    tree = dec.init_decoder_params(cfg, seed, device)
    placed = dec.place_tp_params(tree, cfg, world_mesh((1,), ("model",), device=device))
    ids, lens = serve_prompts(np.random.default_rng(seed + 71), SHARD_PROMPTS, GEN_PROMPT_LENS, cfg.vocab_size, device)
    res = {"card": card, "params_b": sum(t.numel() for _, t in dec._leaf_items(tree)) / 1e9,
           **tp_serve_check(GEN_MODEL, tree, placed, cfg, ids, lens, SHARD_DECODE_STEPS)}
    log("sharded", part="tp_serve", **res)
    return res


def tp_moe_part(device, seed: int, card: str) -> dict:
    """The MoE decoder at mixtral-8x7b-instruct width in bf16, depth cut to
    ``SHARD_MOE_LAYERS``, its experts placed over ``model``."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.parallel import world_mesh

    cfg = dataclasses.replace(dec.decoder_config_for(MOE_MODEL), layers=SHARD_MOE_LAYERS)
    tree = dec.init_decoder_params(cfg, seed, device)
    placed = dec.place_tp_params(tree, cfg, world_mesh((1,), ("model",), device=device))
    ids, lens = serve_prompts(np.random.default_rng(seed + 73), SHARD_MOE_PROMPTS, MOE_PROMPT_LENS, cfg.vocab_size,
                              device)
    res = {"card": card, **tp_serve_check(MOE_MODEL, tree, placed, cfg, ids, lens, SHARD_MOE_STEPS)}
    log("sharded", part="tp_moe", **res)
    return res


def compared_steps(name: str, runs: dict, batch_fn) -> dict:
    """Each of ``runs`` (``{"device": (state, run), "sharded": ...}``, states
    over ``CaptureAdam``) takes ``1 + SHARD_STEPS`` steps on the batches of
    ``batch_fn(step)``; step 0's loss and gradients are compared.  Step ms
    (host and CUDA events) leave out step 0."""
    out, grads = {}, {}
    for label, (state, run) in runs.items():
        losses, host, devs = [], [], []
        for s in range(1 + SHARD_STEPS):
            state, loss, h, d = timed_step(run, state, *batch_fn(s))
            losses.append(loss)
            host.append(h)
            devs.append(d)
        grads[label] = state.opt_state.first_grads
        out[label] = step_stats(losses, host, devs)
        del state
    dev, sh = out["device"], out["sharded"]
    check = {"loss_rel_diff": abs(sh["losses"][0] - dev["losses"][0]) / abs(dev["losses"][0]),
             "grad_cosine": grad_cosine(grads["sharded"], grads["device"]),
             "grad_rel_l2": grad_rel_l2(grads["sharded"], grads["device"]),
             "ratio_host": sh["step_ms_host"] / dev["step_ms_host"],
             "ratio_device": sh["step_ms_device"] / dev["step_ms_device"]}
    for label in ("device", "sharded"):
        losses = out[label]["losses"]
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            fail(f"sharded: {name}: the {label} losses are not finite and falling: {losses}")
    if (check["loss_rel_diff"] > SHARD_LOSS_REL or not check["grad_cosine"] > SHARD_GRAD_COS
            or not check["grad_rel_l2"] < SHARD_GRAD_REL):
        fail(f"sharded: {name}: the sharded step left its single-device form: {check}")
    return {**out, **check}


def train_parts(device, seed: int, card: str) -> dict:
    """The contrastive step (MiniLM, 256 pairs × 128, ``make_mesh(1)``), the
    causal-LM step (mistral-7b width, 8 layers, 4 × 512) and the EP MoE
    step (one mixtral-width layer, 4,096 tokens, ``make_ep_mesh(1)``), each
    against its single-device form on the same tree and batches."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.models import encoder as enc
    from pathway_tpu_torch.parallel import make_ep_mesh, make_mesh, moe, train

    mesh = make_mesh(1, device=device)
    parts = {}
    rng = np.random.default_rng(seed + 79)
    ecfg = enc.config_for("all-MiniLM-L6-v2")
    module = enc.SentenceEncoderModule(ecfg, enc.init_params(ecfg, seed), device=device)
    lens = rng.integers(16, TRAIN_SEQ + 1, size=(2, TRAIN_PAIRS))
    batch = []
    for side in range(2):
        ids = torch.from_numpy(rng.integers(3, ecfg.vocab_size, size=(TRAIN_PAIRS, TRAIN_SEQ))).to(device)
        mask = (torch.arange(TRAIN_SEQ)[None, :] < torch.from_numpy(lens[side])[:, None]).long().to(device)
        batch += [ids, mask]
    runs = {}
    for label, kw in (("device", dict(device=device)), ("sharded", dict(mesh=mesh))):
        state, _ = train.init_train_state(module, capture_adam(TRAIN_LR), **kw)
        runs[label] = (state, train.make_contrastive_train_step(module, **kw))
    parts["contrastive"] = {"model": "all-MiniLM-L6-v2", "pairs": TRAIN_PAIRS, "seq": TRAIN_SEQ,
                            **compared_steps("contrastive", runs, lambda s: batch)}
    log("sharded", part="train", step="contrastive", card=card, **parts["contrastive"])
    del runs, module
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(dec.decoder_config_for(GEN_MODEL), layers=SHARD_TRAIN_LAYERS, remat=True)
    B, S = LM_SHAPE
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, S))).to(device)
    lm_lens = torch.from_numpy(rng.integers(LM_LENS[0], LM_LENS[1] + 1, size=B)).to(device)
    runs = {}
    for label, kw in (("device", dict(device=device)), ("sharded", dict(mesh=mesh))):
        init_state, run = train.make_causal_lm_train_step(cfg, capture_adam(SHARD_LR), **kw)
        runs[label] = (init_state(seed), run)
    parts["lm"] = {"model": GEN_MODEL, "layers": cfg.layers, "batch": LM_SHAPE, "remat": cfg.remat,
                   **compared_steps("lm", runs, lambda s: (ids, lm_lens))}
    log("sharded", part="train", step="lm", card=card, **parts["lm"])
    del runs
    gc.collect()
    torch.cuda.empty_cache()

    H, F_ = GEN_WIDTHS["hidden"], GEN_WIDTHS["intermediate"]
    mcfg = moe.MoEConfig(hidden=H, experts=8, intermediate=F_, top_k=2, capacity_factor=2.0, dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed + 83)
    target_map = torch.randn((H, H), generator=gen, device=device) / math.sqrt(H)
    xs = [torch.randn((MOE_TRAIN_TOKENS, H), generator=gen, device=device) for _ in range(1 + SHARD_STEPS)]
    runs = {}
    for label, kw in (("device", dict(device=device)), ("sharded", dict(mesh=make_ep_mesh(1, device=device)))):
        init_fn, step_fn = moe.make_moe_train_step(mcfg, capture_adam(MOE_TRAIN_LR), **kw)

        def run(state, x, step_fn=step_fn):
            p, o, loss = step_fn(state.params, state.opt_state, x, torch.tanh(x @ target_map))
            return train.TrainState(p, o, state.step + 1), loss

        runs[label] = (train.TrainState(*init_fn(seed)), run)
    parts["moe_ep"] = {"hidden": H, "experts": 8, "tokens": MOE_TRAIN_TOKENS,
                       **compared_steps("moe_ep", runs, lambda s: (xs[s],))}
    log("sharded", part="train", step="moe_ep", card=card, **parts["moe_ep"])
    del runs, xs
    return parts


def pp_part(device, seed: int, card: str) -> dict:
    """``make_pp_train_step`` at mistral-7b width, 8 layers, one stage,
    ``n_micro`` 4, 8 × 512 ids, ``PP_STEPS`` steps; step 0's loss and
    gradients against the single-device causal-LM step's on the same tree
    and batch."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.parallel import make_pp_mesh, make_pp_train_step, train

    cfg = dataclasses.replace(dec.decoder_config_for(GEN_MODEL), layers=SHARD_TRAIN_LAYERS, remat=True)
    rng = np.random.default_rng(seed + 89)
    B, S = PP_SHAPE
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, S))).to(device)
    lens = torch.from_numpy(rng.integers(LM_LENS[0], LM_LENS[1] + 1, size=B)).to(device)
    init_ref, run_ref = train.make_causal_lm_train_step(cfg, capture_adam(SHARD_LR), device=device)
    ref, ref_loss = run_ref(init_ref(seed), ids, lens)
    ref_loss, ref_grads = float(ref_loss), ref.opt_state.first_grads
    del ref, init_ref, run_ref
    gc.collect()
    torch.cuda.empty_cache()
    init_state, run = make_pp_train_step(cfg, capture_adam(SHARD_LR), make_pp_mesh(1, device=device), PP_MICRO)
    state = init_state(seed)
    losses, host, devs = [], [], []
    for _ in range(PP_STEPS):
        state, loss, h, d = timed_step(run, state, ids, lens)
        losses.append(loss)
        host.append(h)
        devs.append(d)
    grads = [g.reshape(r.shape) for g, r in zip(state.opt_state.first_grads, ref_grads)]
    res = {"card": card, "model": GEN_MODEL, "layers": cfg.layers, "stages": 1, "n_micro": PP_MICRO, "batch": PP_SHAPE,
           **step_stats(losses, host, devs), "ref_loss": ref_loss,
           "loss_rel_diff": abs(losses[0] - ref_loss) / abs(ref_loss), "grad_cosine": grad_cosine(grads, ref_grads),
           "grad_rel_l2": grad_rel_l2(grads, ref_grads), "tokens_per_s": int(lens.sum()) / (float(np.mean(host[1:])) / 1e3)}
    log("sharded", part="pp", **res)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"sharded: pp: the losses are not finite and falling: {losses}")
    if (res["loss_rel_diff"] > SHARD_LOSS_REL or not res["grad_cosine"] > SHARD_GRAD_COS
            or not res["grad_rel_l2"] < SHARD_GRAD_REL):
        fail(f"sharded: pp: the pipelined step left the causal-LM step: {res['loss_rel_diff']}, {res['grad_cosine']}, "
             f"{res['grad_rel_l2']}")
    del state, grads, ref_grads
    return res


def checkpoint_part(device, seed: int, card: str) -> dict:
    """A mesh-placed LoRA state (mistral-7b width, 8 layers, rank 8 on
    wq/wv) saved through ``torch.distributed.checkpoint`` after
    ``CKPT_STEPS`` steps and resumed into a fresh state: the resumed losses
    must equal the uninterrupted run's, bit for bit."""
    import tempfile

    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.models.lora import make_lora_train_step
    from pathway_tpu_torch.parallel import TrainCheckpointer, make_mesh

    cfg = dataclasses.replace(dec.decoder_config_for(GEN_MODEL), layers=SHARD_TRAIN_LAYERS, remat=True)
    rng = np.random.default_rng(seed + 97)
    B, S = LORA_SHAPE
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, S))).to(device)
    lens = torch.from_numpy(rng.integers(LM_LENS[0], LM_LENS[1] + 1, size=B)).to(device)
    init_state, run = make_lora_train_step(cfg, dec.init_decoder_params(cfg, seed, device), adam(LORA_LR),
                                           mesh=make_mesh(1, device=device), rank=LORA_RANK)
    state = init_state()
    for _ in range(CKPT_STEPS):
        state, _ = run(state, ids, lens)
    with tempfile.TemporaryDirectory() as tmp, TrainCheckpointer(tmp) as ck:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(state)
        save_ms = (time.perf_counter() - t0) * 1e3
        files = sorted(os.listdir(os.path.join(tmp, str(CKPT_STEPS))))
        size_mb = sum(os.path.getsize(os.path.join(tmp, str(CKPT_STEPS), f)) for f in files) / 1e6
        after = [float(run(state, ids, lens)[1]) for _ in range(CKPT_STEPS)]
        fresh = init_state()
        t0 = time.perf_counter()
        restored = ck.restore(fresh)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        resumed = [float(run(restored, ids, lens)[1]) for _ in range(CKPT_STEPS)]
    res = {"card": card, "layers": cfg.layers, "rank": LORA_RANK, "files": files, "size_mb": size_mb,
           "save_ms": save_ms, "restore_ms": restore_ms, "after": after, "resumed": resumed}
    log("sharded", part="checkpoint", **res)
    if resumed != after:
        fail(f"sharded: checkpoint: the resumed losses {resumed} are not the run's {after}")
    del state, fresh, restored
    return res


def sharded_phase(device, seed: int, card: str) -> dict:
    """Tensor-, data-, expert- and pipeline-parallel paths as a world of one
    in this process, over NCCL: TP serving of mistral-7b and the MoE
    decoder, the sharded train steps against their single-device forms,
    the GPipe step, a sharded checkpoint and ``dryrun_multichip(1)``.  The
    encoder kernel is on none of their paths: its launches over the whole
    phase are its count and must be 0."""
    import torch.distributed as dist

    from pathway_tpu_torch.ops import attention as attn
    from pathway_tpu_torch.parallel import dryrun_multichip

    attn.encoder_attention.launches = 0
    parts, seconds = {}, {}
    try:
        for name, part in (("tp_serve", tp_serve_part), ("tp_moe", tp_moe_part), ("train", train_parts),
                           ("pp", pp_part), ("checkpoint", checkpoint_part)):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            parts[name] = part(device, seed, card)
            seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dryrun_multichip(1, device=device)
        seconds["dryrun"] = time.perf_counter() - t0
        log("sharded", part="dryrun", world=dist.get_world_size(), backend=dist.get_backend(), ok=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    launches = {"encoder_attention": attn.encoder_attention.launches}
    summary = {
        "tp_serve_prefill_ms": [parts["tp_serve"]["prefill_ms_sharded"], parts["tp_serve"]["prefill_ms_unsharded"]],
        "tp_serve_decode_ms": [parts["tp_serve"]["decode_ms_sharded"], parts["tp_serve"]["decode_ms_unsharded"]],
        "tp_moe_decode_ms": [parts["tp_moe"]["decode_ms_sharded"], parts["tp_moe"]["decode_ms_unsharded"]],
        "tp_serve_decode_ms_checked": parts["tp_serve"]["decode_ms_checked"],
        "tp_serve_view_us": [parts["tp_serve"]["view_us_placed"], parts["tp_serve"]["view_us_checked"]],
        **{f"{k}_step_ms_host": [parts["train"][k]["sharded"]["step_ms_host"], parts["train"][k]["device"]["step_ms_host"]]
           for k in parts["train"]},
        **{f"{k}_ratio_device": parts["train"][k]["ratio_device"] for k in parts["train"]},
        **{f"{k}_grad_rel_l2": parts["train"][k]["grad_rel_l2"] for k in parts["train"]},
        "pp_step_ms_host": parts["pp"]["step_ms_host"], "pp_grad_cosine": parts["pp"]["grad_cosine"],
        "pp_grad_rel_l2": parts["pp"]["grad_rel_l2"],
        "checkpoint_save_ms": parts["checkpoint"]["save_ms"], "part_seconds": seconds, "kernel_launches": launches,
    }
    log("sharded", step="summary", card=card, **summary)
    return {"launches": launches, "attention_launches": {}, **parts}


# ---------------------------------------------------------------------------
# Phase 15d: persistence on one worker: stop and resume, kill and resume.
# ---------------------------------------------------------------------------

PERSIST_MODEL = "all-MiniLM-L6-v2"
PERSIST_DOCS = 8192  # in PERSIST_FILES jsonlines files; 16,384 until [cluster] (PERF.md section 4)
PERSIST_FILES = 8
PERSIST_FIRST = 6  # files of run 1; the other 2 (2,048 texts) come before run 2
PERSIST_SOURCES = 64
PERSIST_SERVED = 1024  # part B's files, of [vector_store]'s generator
PERSIST_SERVE_BATCH = 128  # files written at a time while child 1 ingests ...
PERSIST_SERVE_GAP_S = 0.5  # ... this far apart
PERSIST_KILL_AT = 512  # files indexed when child 1 is killed
PERSIST_ADDED = 64  # files added before child 2
PERSIST_QUERIES = 64
PERSIST_K = 10
PERSIST_WAIT_S = 300.0  # the longest any stage of part B may wait


def persist_docs(seed: int, n_docs: int = PERSIST_DOCS) -> dict:
    """Part A's input: ``n_docs`` texts of the main generator keyed by
    ``doc_id`` with one of ``PERSIST_SOURCES`` source ids, split into
    ``PERSIST_FILES`` files of consecutive ids."""
    texts, _, _, _ = synthetic_corpus(n_docs, seed + 301)
    if len(set(texts)) != len(texts):
        fail("persistence: the seeded corpus repeats a text")
    sources = np.random.default_rng(seed + 303).integers(0, PERSIST_SOURCES, size=n_docs)
    per = n_docs // PERSIST_FILES
    files = [[{"doc_id": i, "text": texts[i], "source": int(sources[i])} for i in range(f * per, (f + 1) * per)]
             for f in range(PERSIST_FILES)]
    names = [(s, f"source-{s:02d}") for s in range(PERSIST_SOURCES)]
    return {"texts": texts, "files": files, "sources": names, "first": per * PERSIST_FIRST}


def write_jsonlines(path: str, rows) -> None:
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def root_bytes(root: str) -> dict:
    """Bytes under a persistence root: the snapshots' and manifests', and the
    UDF cache's as its entry count times one entry's size (every entry is
    the pickle of one f32 vector of the model's width: one size), sparing a
    stat of each of thousands of entries."""
    cache = os.path.join(root, "udf_cache")
    snap = sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(root)
               if not d.startswith(cache) for n in names)
    entries = []
    for d, _, names in os.walk(cache):
        entries += [os.path.join(d, n) for n in names]
    one = os.path.getsize(entries[0]) if entries else 0
    return {"root_bytes": snap + one * len(entries), "snapshot_bytes": snap, "cache_entries": len(entries),
            "cache_entry_bytes": one}


def net_rows(*streams) -> dict:
    """``{key: row}`` after the change streams ``[(key, row, time, diff)]``
    of consecutive runs, each applied in its own epoch order (as
    :func:`final_rows` applies one)."""
    live: dict = {}
    for deltas in streams:
        for key, row, _time, diff in sorted(deltas, key=lambda d: (d[2], d[3])):
            if diff > 0:
                live[key] = row
            else:
                live.pop(key, None)
    return live


class PersistProbe:
    """What one Part A run did: the texts its forwards embedded, the
    ``DiskCache`` hits and misses, the rows ``replay_into`` replayed, the
    rows each ``InputNode`` took in, and the run's ``PersistentStorage``."""

    def __init__(self, pw):
        from pathway_tpu_torch.engine import dataflow as df
        from pathway_tpu_torch.engine import persistence as pz
        from pathway_tpu_torch.internals.udfs import caches

        self.hits = self.misses = 0
        self.cache_s = 0.0  # in DiskCache._get and _put
        self.replayed: list = []
        self.inserted = 0
        self.storages: list = []
        probe = self
        self._saved = [(pz.PersistentStorage, "__init__"), (pz.PersistentStorage, "replay_into"),
                       (df.InputNode, "insert"), (caches.DiskCache, "_get"), (caches.DiskCache, "_put")]
        self._orig = [getattr(cls, name) for cls, name in self._saved]
        init, replay, insert, get, put = self._orig

        def init_(storage, *a, **kw):
            init(storage, *a, **kw)
            probe.storages.append(storage)

        def replay_(storage, state, fn):
            n = replay(storage, state, fn)
            probe.replayed.append(n)
            return n

        def insert_(node, *a, **kw):
            probe.inserted += 1
            return insert(node, *a, **kw)

        def get_(cache, key):
            t0 = time.perf_counter()
            hit, value = get(cache, key)
            probe.cache_s += time.perf_counter() - t0
            if hit:
                probe.hits += 1
            else:
                probe.misses += 1
            return hit, value

        def put_(cache, key, value):
            t0 = time.perf_counter()
            put(cache, key, value)
            probe.cache_s += time.perf_counter() - t0

        for (cls, name), fn in zip(self._saved, (init_, replay_, insert_, get_, put_)):
            setattr(cls, name, fn)

    def close(self) -> None:
        for (cls, name), fn in zip(self._saved, self._orig):
            setattr(cls, name, fn)


def persist_run(pw, data: dict, docs_dir: str, embed_fn, query, root: str | None, mode: str | None,
                cached: bool) -> dict:
    """One ``pw.run`` of the ``[dataflow]`` program over the jsonlines in
    ``docs_dir`` (persisted on ``root`` in ``mode``, the UDF under
    ``DiskCache`` when ``cached``): its change streams, wall s and probe."""
    Doc, _Source = dataflow_schemas(pw)
    docs = pw.io.jsonlines.read(docs_dir, schema=Doc, mode="static", name="docs")
    embed = embedding_udf(pw, embed_fn, cache_strategy=pw.udfs.DiskCache() if cached else None)
    tables = dataflow_program(pw, {"sources": data["sources"]}, embed, query, docs=docs)
    captured = {name: [] for name in tables}
    for name, table in tables.items():
        table._subscribe_raw(lambda k, r, t, d, out=captured[name]: out.append((k, r, t, d)), name=f"persist:{name}")
    config = None
    if root is not None:
        config = pw.persistence.Config(pw.persistence.Backend.filesystem(root),
                                       persistence_mode=getattr(pw.PersistenceMode, mode))
    probe = PersistProbe(pw)
    try:
        t0 = time.perf_counter()
        pw.run(persistence_config=config, monitoring_level=pw.MonitoringLevel.NONE)
        wall_s = time.perf_counter() - t0
    finally:
        probe.close()
        pw.G.clear()
    return {"streams": captured, "wall_s": wall_s, "probe": probe}


def persist_state_check(live: dict, ref: dict) -> dict:
    """A resumed run's net sink state against the unbroken run's: keys and
    doc ids, names and counts exact; vectors at cosine > ``COS_MIN``;
    scores and score sums (functions of the vectors) within
    ``DATAFLOW_SUM_REL`` relative."""
    out = {}
    for name in ("docs", "per_source"):
        got, want = live[name], ref[name]
        out[f"{name}_keys_equal"] = sorted(got) == sorted(want)
    docs, ref_docs = live["docs"], ref["docs"]
    common = sorted(set(docs) & set(ref_docs))
    a = np.stack([np.asarray(docs[k][2], np.float32) for k in common])
    b = np.stack([np.asarray(ref_docs[k][2], np.float32) for k in common])
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    out["min_cos_vs_unbroken"] = float(cos.min())
    out["ids_names_equal"] = all(docs[k][:2] == ref_docs[k][:2] for k in common)
    out["max_score_err"] = max(abs(docs[k][3] - ref_docs[k][3]) for k in common)
    groups, ref_groups = live["per_source"], ref["per_source"]
    out["counts_equal"] = all(groups[k][:2] == ref_groups[k][:2] for k in groups if k in ref_groups)
    out["max_sum_rel_err"] = max((abs(groups[k][2] - ref_groups[k][2]) / max(abs(ref_groups[k][2]), 1.0)
                                  for k in groups if k in ref_groups), default=1.0)
    return out


def persist_resume_part(pw, enc, ex, data: dict, query, base: str) -> dict:
    """Part A: run 1 over 6 files to a clean finish on a fresh root, 2 files
    added, run 2 resumed on it, in ``PERSISTING`` (the UDF under
    ``DiskCache``) and ``OPERATOR_PERSISTING``; one unbroken run over all 8
    files without persistence is the reference.  Returns each mode's
    report; fails on a gate."""
    import asyncio

    from pathway_tpu_torch.utils.batching import AsyncMicroBatcher

    sink: list = []

    def process(items):
        sink.append(list(items))
        return enc.encode(items)

    batcher = AsyncMicroBatcher(process, max_batch_size=DATAFLOW_BATCH, executor=ex, name="persistence:embedder")

    async def warm_up():
        return await asyncio.gather(*(batcher.submit(t) for t in data["texts"][:512]))

    asyncio.run(warm_up())
    all_dir = os.path.join(base, "all")
    os.makedirs(all_dir)
    for f, rows in enumerate(data["files"]):
        write_jsonlines(os.path.join(all_dir, f"part-{f}.jsonl"), rows)

    def one(docs_dir, root, mode, cached):
        sink.clear()
        run = persist_run(pw, data, docs_dir, batcher.submit, query, root, mode, cached)
        run["texts"] = [t for batch in sink for t in batch]
        run["forwards"] = len(sink)
        return run

    unbroken = one(all_dir, None, None, False)
    ref = {name: final_rows(deltas) for name, deltas in unbroken["streams"].items()}
    first_texts = set(data["texts"][: data["first"]])
    new_texts = set(data["texts"][data["first"]:])
    reports = {"unbroken": {"wall_s": unbroken["wall_s"], "texts": len(unbroken["texts"]),
                            "forwards": unbroken["forwards"]}}
    for mode, cached in (("PERSISTING", True), ("OPERATOR_PERSISTING", False)):
        docs_dir, root = os.path.join(base, mode, "docs"), os.path.join(base, mode, "root")
        os.makedirs(docs_dir)
        for f in range(PERSIST_FIRST):
            write_jsonlines(os.path.join(docs_dir, f"part-{f}.jsonl"), data["files"][f])
        run1 = one(docs_dir, root, mode, cached)
        for f in range(PERSIST_FIRST, PERSIST_FILES):
            write_jsonlines(os.path.join(docs_dir, f"part-{f}.jsonl"), data["files"][f])
        run2 = one(docs_dir, root, mode, cached)
        if mode == "PERSISTING":  # input snapshots: run 2 replays and re-emits the whole state
            live = {name: final_rows(deltas) for name, deltas in run2["streams"].items()}
        else:  # operator snapshots: run 2 emits the changes to run 1's state
            live = {name: net_rows(run1["streams"][name], run2["streams"][name]) for name in run2["streams"]}
        state = persist_state_check(live, ref)
        p1, p2 = run1["probe"], run2["probe"]
        storage = p2.storages[-1]
        gens = storage.backend.list_keys("manifests/0/")
        rep = {
            "run1_wall_s": run1["wall_s"], "run2_wall_s": run2["wall_s"],
            "run2_over_unbroken": run2["wall_s"] / unbroken["wall_s"],
            **root_bytes(root), "generations_kept": len(gens), "generation": storage.generation,
            "commit": storage.metrics.snapshot(),
            "run1_texts": len(run1["texts"]), "run1_forwards": run1["forwards"],
            "run2_texts": len(run2["texts"]), "run2_forwards": run2["forwards"],
            "run2_replayed_rows": sum(p2.replayed), "run2_input_rows": p2.inserted,
            "run2_cache_hits": p2.hits, "run2_cache_misses": p2.misses, "run1_cache_misses": p1.misses,
            "run1_cache_s": p1.cache_s, "run2_cache_s": p2.cache_s,
            **state,
        }
        log("persistence", part="resume", mode=mode, **rep)
        reports[mode] = rep
        # A1: the resumed net state is the unbroken run's
        if not (state["docs_keys_equal"] and state["per_source_keys_equal"] and state["ids_names_equal"]
                and state["counts_equal"]):
            fail(f"persistence: {mode}: run 2's net state is not the unbroken run's: {state}")
        if state["min_cos_vs_unbroken"] <= COS_MIN or state["max_sum_rel_err"] > DATAFLOW_SUM_REL \
                or state["max_score_err"] > SCORE_TOL:
            fail(f"persistence: {mode}: vectors or scores part from the unbroken run's: {state}")
        # A2: run 2 embeds exactly the texts run 1 did not
        if set(run1["texts"]) != first_texts or set(run2["texts"]) != new_texts - first_texts \
                or len(run2["texts"]) != len(new_texts):
            fail(f"persistence: {mode}: run 2 embedded {len(run2['texts'])} texts "
                 f"({len(set(run2['texts']) - new_texts)} of run 1), not the {len(new_texts)} new ones")
        if mode == "PERSISTING" and (p2.hits != sum(p2.replayed) or p2.hits != data["first"]
                                     or p2.misses != len(new_texts)):
            fail(f"persistence: {mode}: {sum(p2.replayed)} rows replayed, {p2.hits} cache hits, "
                 f"{p2.misses} misses")
        if mode == "OPERATOR_PERSISTING" and (sum(p2.replayed) or p2.inserted != len(new_texts)):
            fail(f"persistence: {mode}: replay_into gave {p2.replayed}, the input took {p2.inserted} rows")
    return reports


def served_corpus(seed: int) -> dict:
    """Part B's files (``[vector_store]``'s generator: 100-1,000 words, 500-word
    chunks), their chunk texts, and the queries: 8-32 word spans of final
    chunks with a quarter of the words swapped."""
    n = PERSIST_SERVED + PERSIST_ADDED
    texts, _lengths, ids, vocab = synthetic_corpus(n, seed + 311, words_per_text=VS_WORDS)
    chunks = [" ".join(vocab[w] for w in words) for t in range(n) for words in plain_chunks(ids[t])]
    chunk_words = [words for t in range(n) for words in plain_chunks(ids[t])]
    rng = np.random.default_rng(seed + 313)
    queries: list = []
    known = set(chunks)
    while len(queries) < PERSIST_QUERIES:  # distinct, and none a chunk's whole text
        words = chunk_words[int(rng.integers(len(chunk_words)))]
        k = min(int(rng.integers(VS_QUERY_WORDS[0], VS_QUERY_WORDS[1] + 1)), len(words))
        start = int(rng.integers(0, len(words) - k + 1))
        span = np.array(words[start : start + k])
        swap = rng.random(k) < QUERY_SWAP
        span[swap] = rng.integers(0, len(vocab), size=int(swap.sum()))
        text = " ".join(vocab[w] for w in span)
        if text not in known:
            known.add(text)
            queries.append(text)
    return {"texts": texts, "names": [f"doc{i:05d}.txt" for i in range(n)], "chunks": chunks, "queries": queries}


def persistence_child(spec: dict) -> None:
    """Part B's server, in a process of its own: ``VectorStoreServer`` over an
    async ``pw.udf`` under ``DiskCache`` that awaits the
    ``SentenceTransformerEmbedder`` batcher (MiniLM, seeded weights), fed by
    a streaming ``pw.io.fs.read``, served with ``with_cache=True`` on the
    persistence root once ``spec["go"]`` exists (child 1 is started early,
    so its import and model load overlap part A; child 2's gate is open at
    its start).  After each forward it writes its kernel launches,
    their shapes and its counts to ``spec["report"]``; once
    ``spec["stop"]`` exists it closes the server, writes the texts it
    embedded and exits."""
    entered = time.time()
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models.encoder import init_params
    from pathway_tpu_torch.ops.attention import encoder_attention
    from pathway_tpu_torch.xpacks.llm import VectorStoreServer
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    embedder = SentenceTransformerEmbedder(PERSIST_MODEL, device=spec["device"])
    enc = embedder._encoder
    enc.set_params(init_params(enc.config, spec["seed"]))
    seen: dict = {}
    record_launches(enc, seen)
    texts: list = []
    process = embedder._batcher.process_batch

    def report(final: bool = False) -> None:
        out = {"launches": encoder_attention.launches, "seen": [[list(k), v] for k, v in seen.items()],
               "texts": len(texts), "pid": os.getpid(), "entered": entered, "serving": serving}
        if final:
            out["embedded"] = list(texts)
        with open(spec["report"] + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(spec["report"] + ".tmp", spec["report"])

    def counted(items):
        out = process(items)
        texts.extend(items)
        report()  # after the forward: its launches and shapes agree
        return out

    embedder._batcher.process_batch = counted

    @pw.udf(executor=pw.udfs.async_executor(), cache_strategy=pw.udfs.DiskCache(), deterministic=True)
    async def embed(text: str) -> np.ndarray:
        return await embedder._batcher.submit(text)

    docs = pw.io.fs.read(spec["docs"], format="binary", mode="streaming", with_metadata=True)
    server = VectorStoreServer(docs, embedder=embed, splitter=TokenCountSplitter(), device=spec["device"])
    serving = time.time()  # the package imported and the model on the card
    while not os.path.exists(spec["go"]):
        time.sleep(0.02)
    encoder_attention.launches = 0
    seen.clear()
    report()

    def serve():
        try:
            server.run_server(spec["host"], spec["port"], with_cache=True,
                              cache_backend=pw.persistence.Backend.filesystem(spec["root"]))
        except BaseException:  # noqa: BLE001 - a failed run fails the child, and the phase with it
            import traceback

            traceback.print_exc()
            sys.stderr.flush()
            os._exit(3)

    threading.Thread(target=serve, daemon=True, name="persistence:server").start()
    while not os.path.exists(spec["stop"]):
        time.sleep(0.05)
    server._server.close()
    report(final=True)
    sys.stdout.flush()
    os._exit(0)  # the streaming fs reader polls on: nothing else ends the run


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def served_files(corpus: dict, docs_dir: str, lo: int, hi: int) -> None:
    for i in range(lo, hi):
        with open(os.path.join(docs_dir, corpus["names"][i]), "w") as f:
            f.write(corpus["texts"][i])


def file_count(url: str) -> int | None:
    """The files ``/v1/statistics`` reports indexed, or None without an answer."""
    res = http_call(url + "/v1/statistics", {}, timeout=10.0)
    if res["status"] != 200 or not isinstance(res.get("body"), dict):
        return None
    return int(res["body"].get("file_count", 0))


def start_child(ctx, spec: dict):
    proc = ctx.Process(target=persistence_child, args=(spec,), daemon=True)
    proc.started = time.time()
    proc.start()
    return proc


def wait_for(proc, fn, what: str, deadline_s: float = PERSIST_WAIT_S):
    """Poll ``fn()`` until it returns a true value; fail if ``proc`` dies or
    the deadline passes."""
    t0 = _now()
    while True:
        got = fn()
        if got:
            return got
        if not proc.is_alive():
            fail(f"persistence: the server died (exit {proc.exitcode}) while waiting for {what}")
        if _now() - t0 > deadline_s:
            fail(f"persistence: no {what} within {deadline_s} s")
        time.sleep(0.05)


def read_report(path: str) -> dict:
    with open(path) as f:
        rep = json.load(f)
    rep["seen"] = {tuple(k): v for k, v in rep["seen"]}
    return rep


def persist_children(seed: int, base: str, device) -> tuple:
    """Part B's two servers' specs, and child 1 started: its import and
    model load run while part A does, and it serves once its go file is
    written."""
    import multiprocessing

    docs_dir, root = os.path.join(base, "served"), os.path.join(base, "served_root")
    os.makedirs(docs_dir)
    ctx = multiprocessing.get_context("spawn")
    specs = []
    for n in (1, 2):
        specs.append({"seed": seed, "device": str(device), "docs": docs_dir, "root": root, "host": "127.0.0.1",
                      "port": free_port(), "report": os.path.join(base, f"child{n}.json"),
                      "stop": os.path.join(base, f"stop{n}"), "go": os.path.join(base, f"go{n}")})
    return ctx, specs, start_child(ctx, specs[0])


def persist_crash_part(pw, enc, seed: int, ctx, specs: list, child1, device) -> dict:
    """Part B: child 1 serves the growing corpus and is SIGKILLed once 512
    files are indexed; 64 files are added; child 2 resumes on the same root,
    indexes all 1,088 files, answers 64 ``/v1/retrieve`` queries and closes.
    Returns the report, the children's launch counts and shapes; fails on
    a gate."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    corpus = served_corpus(seed)
    docs_dir, root = specs[0]["docs"], specs[0]["root"]
    url1 = f"http://127.0.0.1:{specs[0]['port']}"
    # the statistics answer once documents exist: the first batch is there at the start
    served_files(corpus, docs_dir, 0, PERSIST_SERVE_BATCH)
    written = PERSIST_SERVE_BATCH
    t_start1 = _now()
    open(specs[0]["go"], "w").close()
    try:
        wait_for(child1, lambda: file_count(url1) is not None, "first answer of child 1")
        up1_s = _now() - t_start1
        while True:
            if written < PERSIST_SERVED:
                served_files(corpus, docs_dir, written, written + PERSIST_SERVE_BATCH)
                written += PERSIST_SERVE_BATCH
            t_batch = _now()
            indexed = 0
            while _now() - t_batch < PERSIST_SERVE_GAP_S:
                indexed = file_count(url1) or 0
                if indexed >= PERSIST_KILL_AT:
                    break
                time.sleep(0.05)
            if indexed >= PERSIST_KILL_AT:
                break
            if not child1.is_alive() or _now() - t_start1 > PERSIST_WAIT_S:
                fail(f"persistence: child 1 indexed {indexed} files (alive {child1.is_alive()})")
        os.kill(child1.pid, signal.SIGKILL)
        t_kill = _now()
        child1.join(30)
    finally:
        if child1.is_alive():
            child1.kill()
    if child1.exitcode != -signal.SIGKILL:
        fail(f"persistence: child 1 exited {child1.exitcode}, not by SIGKILL")
    rep1 = read_report(specs[0]["report"])
    cache_dir = os.path.join(root, "udf_cache", "default")
    cached_keys = set(n[:-4] for n in os.listdir(cache_dir) if n.endswith(".pkl"))

    def named(name):
        def fn():
            pass
        fn.__name__ = name
        return fn

    key_of = {c: pw.udfs.DiskCache._cache_key(named("embed"), (c,), {}) for c in corpus["chunks"]}
    uncached = {c for c in corpus["chunks"] if key_of[c] not in cached_keys}
    served_files(corpus, docs_dir, written, PERSIST_SERVED + PERSIST_ADDED)
    total = PERSIST_SERVED + PERSIST_ADDED
    url2 = f"http://127.0.0.1:{specs[1]['port']}"
    t_start2 = _now()
    open(specs[1]["go"], "w").close()
    child2 = start_child(ctx, specs[1])
    try:
        wait_for(child2, lambda: file_count(url2) is not None, "first answer of child 2")
        first_answer_s = _now() - t_start2
        wait_for(child2, lambda: (file_count(url2) or 0) >= total, f"{total} files indexed by child 2")
        full_index_s = _now() - t_start2
        with ThreadPoolExecutor(16) as pool:
            answers = list(pool.map(lambda q: http_call(url2 + "/v1/retrieve", {"query": q, "k": PERSIST_K}),
                                    corpus["queries"]))
        answered_s = _now() - t_kill
        open(specs[1]["stop"], "w").close()
        child2.join(60)
    finally:
        if child2.is_alive():
            child2.kill()
    if child2.exitcode != 0:
        fail(f"persistence: child 2 exited {child2.exitcode}")
    rep2 = read_report(specs[1]["report"])
    bad = [a for a in answers if a["status"] != 200 or not isinstance(a.get("body"), list)
           or len(a["body"]) != PERSIST_K]
    if bad:
        fail(f"persistence: {len(bad)} /v1/retrieve answers failed, first {bad[0]}")
    # B1: the answers against a direct encode and f32 topk of the final corpus
    chunk_ids = {c: i for i, c in enumerate(dict.fromkeys(corpus["chunks"]))}
    chunk_texts = list(chunk_ids)
    qs = corpus["queries"]
    embs = {name: encode_sorted(enc, texts, np.argsort([len(t) for t in texts]))[0]
            for name, texts in (("chunks", chunk_texts), ("queries", qs))}
    chunks = torch.from_numpy(embs["chunks"]).to(device)
    chunks = chunks / chunks.norm(dim=1, keepdim=True)
    q = torch.from_numpy(embs["queries"]).to(device)
    q = q / q.norm(dim=1, keepdim=True)
    vals, idx = torch.topk(q @ chunks.T, PERSIST_K, dim=1)
    ref_vals = vals.float().cpu().numpy()
    got_ids = np.array([[chunk_ids.get(h["text"], -1) for h in a["body"]] for a in answers])
    got_vals = np.array([[-float(h["dist"]) for h in a["body"]] for a in answers])
    known = got_ids >= 0
    own = torch.einsum("rd,rkd->rk", q, chunks[torch.from_numpy(np.maximum(got_ids, 0)).to(device)])
    own = own.float().cpu().numpy()
    parted, gap = topk_parted(got_ids, got_vals, idx.cpu().numpy(), ref_vals)
    check = {"queries": len(qs), "rows_parted": parted, "parted_max_gap": gap,
             "max_score_err": float(np.abs(got_vals - ref_vals).max()),
             "max_own_score_err": float(np.abs(np.where(known, got_vals - own, 0.0)).max()),
             "max_below_plain_kth": float(np.where(known, ref_vals[:, -1:] - own, 0.0).max()),
             "unknown_texts": int((~known).sum())}
    # B2: child 2 embeds exactly the chunks without a cache entry (and the queries)
    embedded2 = rep2["embedded"]
    query_set = set(qs)
    chunks2 = [t for t in embedded2 if t not in query_set]
    res = {
        "files": total, "killed_at_files": PERSIST_KILL_AT, "child1_go_to_answer_s": up1_s,
        "child1_chunks_embedded": rep1["texts"], "cache_entries_at_kill": len(cached_keys),
        "chunks": len(chunk_ids), "uncached_at_child2": len(uncached),
        "cache_hit_share": 1.0 - len(uncached) / len(chunk_ids),
        "child2_chunks_embedded": len(chunks2), "child2_queries_embedded": len(embedded2) - len(chunks2),
        "child2_first_answer_s": first_answer_s, "child2_full_index_s": full_index_s,
        "kill_to_answers_s": answered_s, "child1_launches": rep1["launches"], "child2_launches": rep2["launches"],
        "child_spawn_s": [rep["entered"] - proc.started for rep, proc in ((rep1, child1), (rep2, child2))],
        "child_setup_s": [rep["serving"] - rep["entered"] for rep in (rep1, rep2)],
        "retrieve_ms_p50": float(np.median([a["ms"] for a in answers])), **check,
    }
    log("persistence", part="crash", **res)
    if check["unknown_texts"] or check["max_own_score_err"] > SCORE_TOL or check["max_score_err"] > SCORE_TOL \
            or check["max_below_plain_kth"] > VS_TIE_TOL:
        fail(f"persistence: child 2's answers part from the plain check: {check}")
    if set(chunks2) != uncached or len(chunks2) != len(uncached) or len(embedded2) - len(chunks2) != len(qs):
        fail(f"persistence: child 2 embedded {len(chunks2)} chunks ({len(set(chunks2) - uncached)} cached), "
             f"not the {len(uncached)} without a cache entry")
    if not uncached or len(uncached) == len(chunk_ids):
        fail(f"persistence: the kill left {len(uncached)} of {len(chunk_ids)} chunks uncached: nothing resumed")
    # B3: both children launched the kernel, once per layer of each forward
    for n, rep in ((1, rep1), (2, rep2)):
        if not rep["launches"] or rep["launches"] != sum(rep["seen"].values()):
            fail(f"persistence: child {n} launched the kernel {rep['launches']} times "
                 f"(layers x forwards per shape {rep['seen']})")
    return {"report": res, "children": (rep1, rep2)}


def persistence_phase(device, seed: int, checked: dict) -> dict:
    """Phase 15d: persistence on one worker at full all-MiniLM-L6-v2 width.
    Part A stops and resumes the ``[dataflow]`` program in this process,
    part B kills and resumes a served ``VectorStoreServer`` in child
    processes (spawn).  ``checked`` gains the attention shapes the runs
    gave the kernel."""
    import shutil
    import tempfile
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.device import get_default_executor
    from pathway_tpu_torch.models.encoder import init_params
    from pathway_tpu_torch.ops.attention import encoder_attention

    ex = get_default_executor(device)
    enc = pw.SentenceEncoder(PERSIST_MODEL, seed=seed)
    enc.set_params(init_params(enc.config, seed))  # the children's weights
    data = persist_docs(seed)
    query = np.random.default_rng(seed + 307).normal(size=enc.dimensions).astype(np.float32)
    query /= np.linalg.norm(query)
    # the roots live in the checkout (an ignored directory), on the disk a
    # deployment's persistence root would use
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_persistence")
    os.makedirs(work, exist_ok=True)
    base = tempfile.mkdtemp(prefix="run_", dir=work)
    seen: dict = {}
    hook = record_launches(enc, seen)
    ctx, specs, child1 = persist_children(seed, base, device)
    try:
        # ---- the counted run (part A): counts zeroed just before, read just after ----
        encoder_attention.launches = 0
        seen.clear()
        before = rail_state(device)
        t0 = time.perf_counter()
        resume = persist_resume_part(pw, enc, ex, data, query, base)
        resume_s = time.perf_counter() - t0
        launches_a = encoder_attention.launches
        # ---- end of the counted run ----
        rail = rail_gate("persistence", device, before)
        expected = sum(seen.values())
        if launches_a != expected or not expected:
            fail(f"persistence: attention launches {launches_a} != {expected} (layers x forwards per shape {seen})")
        hook.remove()
        shapes = dict(seen)
        t0 = time.perf_counter()
        crash = persist_crash_part(pw, enc, seed, ctx, specs, child1, device)
        crash_s = time.perf_counter() - t0
    finally:
        hook.remove()
        if child1.is_alive():
            child1.kill()
        # thousands of cache entries: removed behind the later phases
        threading.Thread(target=shutil.rmtree, args=(base, True), daemon=True).start()
    for rep in crash["children"]:
        for shape, n in rep["seen"].items():
            shapes[shape] = shapes.get(shape, 0) + n
    launches = {"encoder_attention": launches_a + sum(rep["launches"] for rep in crash["children"])}
    gen = torch.Generator(device=device).manual_seed(seed + 317)
    for shape in sorted(set(shapes) - set(checked)):
        checked[shape] = check_attention_shape(gen, shape, device)
    log("persistence", step="shapes", launches={str(list(sh)): n for sh, n in sorted(shapes.items())},
        max_abs_err={str(list(sh)): checked[sh] for sh in sorted(shapes)})
    runs_s = resume["unbroken"]["wall_s"] + sum(resume[m]["run1_wall_s"] + resume[m]["run2_wall_s"]
                                                for m in ("PERSISTING", "OPERATOR_PERSISTING"))
    log("persistence", step="summary", resume_s=resume_s, resume_runs_s=runs_s, crash_s=crash_s,
        kernel_launches=launches)
    return {"launches": launches, "attention_launches": shapes, "rail": rail, "resume": resume,
            "crash": crash["report"], "resume_s": resume_s, "crash_s": crash_s}


# ---------------------------------------------------------------------------
# Phase 15e: more than one worker (the TCP mesh, the supervisor, standbys).
# ---------------------------------------------------------------------------

CLUSTER_MODEL = "all-MiniLM-L6-v2"
CLUSTER_DOCS = 16384  # of persist_docs's generator
CLUSTER_COMMIT = 256  # texts a commit of the subject: 64 epochs
CLUSTER_KILL_EPOCH = 24  # worker 1 dies at this epoch (C: the fault plan; D: from outside)
CLUSTER_SNAPSHOT_MS = 100
CLUSTER_WAIT_S = 300.0  # the longest a spawned run may take
CLUSTER_SUM_TOL = 1e-4  # scores and per-source sums (relative to max(|sum|, 1)) against run A's


def vec_text(v) -> str:
    """A vector as the docs sink writes it: its f16 bytes in base64 (1 KB a
    row where the f32 list would be 7 KB of JSON), rounding each component
    by 2^-11 at most, well inside the cosine > 0.999 gate."""
    import base64

    return base64.b64encode(np.asarray(v, np.float16).tobytes()).decode()


def cluster_program(pw, texts, sources, embed, query, out_dir: str, root: str | None):
    """``[persistence]`` part A's Table program over a ``pw.io.python`` subject
    that commits every ``CLUSTER_COMMIT`` texts (one epoch each) and ends:
    the async embedder UDF, the score, the join with the sources (a static
    table each worker keeps its key shard of) and the per-source groupby,
    into jsonlines sinks (``.part-N`` per worker), persisted with input
    snapshots on ``root`` when given."""
    from pathway_tpu_torch.io._utils import make_static_input_table

    Doc, Source = dataflow_schemas(pw)

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for start in range(0, len(texts), CLUSTER_COMMIT):
                for i in range(start, min(len(texts), start + CLUSTER_COMMIT)):
                    self.next(doc_id=i, text=texts[i], source=int(sources[i]))
                self.commit()

    docs = pw.io.python.read(Feed(), schema=Doc, name="docs")
    names = make_static_input_table(Source, [{"source": s, "name": f"source-{s:02d}"}
                                             for s in range(PERSIST_SOURCES)])
    tables = dataflow_program(pw, {}, embed, query, docs=docs, sources=names)
    out = tables["docs"].select(pw.this.doc_id, pw.this.name, pw.this.score,
                                vec=pw.apply_with_type(vec_text, str, pw.this.vec))
    pw.io.jsonlines.write(out, os.path.join(out_dir, "docs.jsonl"))
    pw.io.jsonlines.write(tables["per_source"], os.path.join(out_dir, "per_source.jsonl"))
    config = None
    if root is not None:
        config = pw.persistence.Config(pw.persistence.Backend.filesystem(root),
                                       snapshot_interval_ms=CLUSTER_SNAPSHOT_MS)
    try:
        pw.run(persistence_config=config, monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()  # a later phase's pw.run must not run these sinks again


def cluster_inputs(seed: int, n_docs: int):
    """The texts, their source ids and the unit query: ``[persistence]``
    part A's generator (``persist_docs``) at ``CLUSTER_DOCS``, so every
    process draws the same."""
    data = persist_docs(seed, CLUSTER_DOCS)
    sources = [row["source"] for rows in data["files"] for row in rows]
    query = np.random.default_rng(seed + 307).normal(size=384).astype(np.float32)
    return data["texts"][:n_docs], sources[:n_docs], query / np.linalg.norm(query)


class ClusterProbe:
    """What one process's forwards did: texts, forwards, their device ms
    (CUDA events around each) and end times, the kernel's launches and
    shapes.  ``write`` puts it, with the process's worker identity read
    from the environment then (a promoted standby's changes), into
    ``path``."""

    def __init__(self, enc, path: str | None, device):
        from pathway_tpu_torch.ops.attention import encoder_attention

        self.kernel = encoder_attention
        self.enc, self.path, self.device = enc, path, device
        self.seen: dict = {}
        self.hook = record_launches(enc, self.seen)
        self.texts = self.forwards = 0
        self.device_ms = 0.0
        self.ends: list = []
        self.fields: dict = {"pid": os.getpid()}

    def zero(self) -> None:
        self.kernel.launches = 0
        self.seen.clear()
        self.texts = self.forwards = 0
        self.device_ms = 0.0
        self.ends.clear()

    def process(self, items):
        cuda = self.device.type == "cuda"
        if cuda:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        out = self.enc.encode(items)
        if cuda:
            stop.record()
            stop.synchronize()
            self.device_ms += start.elapsed_time(stop)
        self.texts += len(items)
        self.forwards += 1
        self.ends.append(time.time())
        self.write()
        return out

    def write(self, **fields) -> None:
        self.fields.update(fields)
        if self.path is None:
            return
        standby = os.environ.get("PATHWAY_STANDBY_ID")
        out = dict(self.fields, process_id=int(os.environ.get("PATHWAY_PROCESS_ID", "0")),
                   standby=None if standby is None else int(standby),
                   attempt=int(os.environ.get("PATHWAY_RESTART_ATTEMPT", "0")),
                   launches=self.kernel.launches, seen=[[list(k), v] for k, v in self.seen.items()],
                   texts=self.texts, forwards=self.forwards, device_ms=self.device_ms, ends=self.ends)
        if self.device.type == "cuda":
            out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(self.device)
        with open(self.path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(self.path + ".tmp", self.path)


def cluster_worker(spec_path: str) -> int:
    """One worker process of runs B-D, started by ``python -m
    pathway_tpu_torch spawn`` as ``chip_smoke.py --cluster-worker SPEC``:
    MiniLM with the seeded weights on the card, then ``cluster_program``;
    after each forward and at its end it writes its ``ClusterProbe`` to
    ``reports/<pid>.json``, with whether it had to run ``nvcc``."""
    entered = time.time()
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pathway_tpu_torch.ops import _build

    nvcc_runs: list = []
    build = _build.build

    def counted_build(names=None, **kwargs):
        nvcc_runs.extend(n for n in (names or _build.sources()) if not _build.library_path(n).exists())
        return build(names, **kwargs)

    _build.build = counted_build  # load() builds through the module's name
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.device import get_default_executor
    from pathway_tpu_torch.models.encoder import init_params
    from pathway_tpu_torch.utils.batching import AsyncMicroBatcher

    device = torch.device(spec["device"])
    enc = pw.SentenceEncoder(CLUSTER_MODEL, seed=spec["seed"], device=device)
    enc.set_params(init_params(enc.config, spec["seed"]))
    texts, sources, query = cluster_inputs(spec["seed"], spec["docs"])
    probe = ClusterProbe(enc, os.path.join(spec["reports"], f"{os.getpid()}.json"), device)
    batcher = AsyncMicroBatcher(probe.process, max_batch_size=DATAFLOW_BATCH,
                                executor=get_default_executor(device), name="cluster:embedder")
    probe.write(entered=entered, ready=time.time(), nvcc=nvcc_runs, ended=False)
    while not os.path.exists(spec["go"]):  # the three clusters start together; each runs on its go
        time.sleep(0.02)
    probe.zero()
    run_start = time.time()
    probe.write(run_start=run_start)
    cluster_program(pw, texts, sources, embedding_udf(pw, batcher.submit), query, spec["out"], spec["root"])
    probe.write(run_end=time.time(), nvcc=nvcc_runs, ended=True)
    probe.hook.remove()
    return 0


def cluster_net(out_dir: str, workers: int = 2) -> dict:
    """The net state of a run's sinks over every worker's part file:
    ``{"docs": {doc_id: (name, score, vec)}, "per_source": {name: (count,
    total)}}``; fails on a key with two live rows."""
    import base64

    state: dict = {}
    for table in ("docs", "per_source"):
        net: dict = {}
        base = os.path.join(out_dir, f"{table}.jsonl")
        for path in [base] + [f"{base}.part-{w}" for w in range(1, workers)]:
            if not os.path.exists(path):
                continue
            with open(path) as f:
                for line in f:
                    obj = json.loads(line)
                    diff = obj.pop("diff")
                    obj.pop("time")
                    row = json.dumps(obj, sort_keys=True)
                    net[row] = net.get(row, 0) + diff
        if any(c < 0 or c > 1 for c in net.values()):
            fail(f"cluster: {out_dir}: {table} nets to counts outside 0/1")
        live: dict = {}
        for row, c in net.items():
            if c:
                obj = json.loads(row)
                key = obj["doc_id"] if table == "docs" else obj["name"]
                if key in live:
                    fail(f"cluster: {out_dir}: {table} key {key} has two live rows")
                live[key] = ((obj["name"], obj["score"], np.frombuffer(base64.b64decode(obj["vec"]), np.float16))
                             if table == "docs" else (obj["count"], obj["total"]))
        state[table] = live
    return state


def cluster_state_check(live: dict, ref: dict) -> dict:
    """A run's net state against run A's: keys, doc ids, names and counts
    exact; vectors at cosine > ``COS_MIN``; scores and per-source totals
    within ``CLUSTER_SUM_TOL``; each total the sum of its own live docs'
    scores (1e-6 relative: no row hides in a sum) and off run A's total by
    no more than its docs' scores are.  A worker's forwards hold other
    texts than run A's, so a text shares its batch with others: on the
    card the rows come out the same (PERF.md), where the CPU's plain path
    moves scores by up to 6e-4."""
    docs, ref_docs = live["docs"], ref["docs"]
    groups, ref_groups = live["per_source"], ref["per_source"]
    out = {"docs_keys_equal": sorted(docs) == sorted(ref_docs),
           "per_source_keys_equal": sorted(groups) == sorted(ref_groups)}
    common = sorted(set(docs) & set(ref_docs))
    if not common or not out["per_source_keys_equal"]:
        return dict(out, min_cos_vs_a=0.0, names_equal=False, counts_equal=False, max_score_err=1.0,
                    max_sum_rel_err=1.0, sums_consistent=False, sums_within_score_errors=False)
    a = np.stack([docs[k][2] for k in common]).astype(np.float32)
    b = np.stack([ref_docs[k][2] for k in common]).astype(np.float32)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    score_err = {k: abs(docs[k][1] - ref_docs[k][1]) for k in common}
    own_sum: dict = {}
    err_sum: dict = {}
    for k, (name, score, _vec) in docs.items():
        own_sum[name] = own_sum.get(name, 0.0) + score
        err_sum[name] = err_sum.get(name, 0.0) + score_err.get(k, 1.0)
    sum_err = {k: abs(groups[k][1] - ref_groups[k][1]) for k in groups}
    scale = {k: max(abs(ref_groups[k][1]), 1.0) for k in groups}
    out.update(
        min_cos_vs_a=float(cos.min()),
        names_equal=all(docs[k][0] == ref_docs[k][0] for k in common),
        max_score_err=max(score_err.values()),
        scores_within_1e4=sum(e <= CLUSTER_SUM_TOL for e in score_err.values()) / len(score_err),
        counts_equal=all(groups[k][0] == ref_groups[k][0] for k in groups),
        max_sum_rel_err=max(sum_err[k] / scale[k] for k in groups),
        sums_within_1e4=sum(sum_err[k] <= CLUSTER_SUM_TOL * scale[k] for k in groups) / len(groups),
        sums_consistent=all(abs(groups[k][1] - own_sum.get(k, 0.0)) <= 1e-6 * scale[k] for k in groups),
        sums_within_score_errors=all(sum_err[k] <= err_sum.get(k, 0.0) + 1e-6 * scale[k] for k in groups),
    )
    return out


def cluster_gate(run: str, state: dict) -> None:
    if not (state["docs_keys_equal"] and state["per_source_keys_equal"] and state["names_equal"]
            and state["counts_equal"] and state["sums_consistent"]):
        fail(f"cluster: run {run}'s net state is not run A's: {state}")
    if state["min_cos_vs_a"] <= COS_MIN or state["max_score_err"] > CLUSTER_SUM_TOL \
            or state["max_sum_rel_err"] > CLUSTER_SUM_TOL or not state["sums_within_score_errors"]:
        fail(f"cluster: run {run}'s vectors, scores or sums part from run A's: {state}")


def read_reports(reports_dir: str) -> list:
    out = []
    for name in sorted(os.listdir(reports_dir)):
        if name.endswith(".json"):
            with open(os.path.join(reports_dir, name)) as f:
                rep = json.load(f)
            rep["seen"] = {tuple(k): v for k, v in rep["seen"]}
            out.append(rep)
    return out


def cluster_start(run: str, base: str, seed: int, device, n_docs: int, args: list, env_extra: dict,
                  port: int) -> dict:
    """Start one run of ``cluster_worker`` through ``python -m
    pathway_tpu_torch spawn -n 2 <args>`` in a fresh interpreter, in a
    process group of its own (``cluster_stop`` kills it whole); its workers
    load the model and wait for the run's go file."""
    here = os.path.dirname(os.path.abspath(__file__))
    run_dir = os.path.join(base, run)
    out_dir, reports = os.path.join(run_dir, "out"), os.path.join(run_dir, "reports")
    os.makedirs(out_dir)
    os.makedirs(reports)
    root = os.path.join(run_dir, "pstore") if "--checkpoint-root" in args else None
    spec_path, go = os.path.join(run_dir, "spec.json"), os.path.join(run_dir, "go")
    with open(spec_path, "w") as f:
        json.dump({"seed": seed, "device": str(device), "docs": n_docs, "out": out_dir, "root": root,
                   "reports": reports, "go": go}, f)
    args = [root if a == "ROOT" else a for a in args]
    cmd = [sys.executable, "-m", "pathway_tpu_torch", "spawn", "-n", "2", "--first-port", str(port),
           *args, sys.executable, os.path.abspath(__file__), "--cluster-worker", spec_path]
    # one CPU thread a process: a worker's host work is the dataflow's Python
    # and the tokenizer, and eight processes starting at once on the host's
    # cores would otherwise each spin up a thread a core
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **env_extra)
    log_path = os.path.join(run_dir, "spawn.log")
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=log_file, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return {"run": run, "root": root, "out": out_dir, "reports_dir": reports, "go": go, "log_path": log_path,
            "proc": proc, "t_start": time.time()}


def cluster_stop(run: dict) -> None:
    """Kill the spawn CLI, its workers and standbys: the whole group."""
    import signal

    with contextlib.suppress(ProcessLookupError):
        os.killpg(run["proc"].pid, signal.SIGKILL)
    run["proc"].wait()


def cluster_finish(run: dict, watch=None) -> dict:
    """Open the run's go file and wait for its spawn to end, polling
    ``watch(reports_dir)`` meanwhile (run D's killer); the run's exit code
    must be 0.  Adds its stderr, its seconds from go to the end and the
    processes' reports."""
    proc = run["proc"]
    t0 = time.time()
    open(run["go"], "w").close()
    while proc.poll() is None:
        if time.time() - t0 > CLUSTER_WAIT_S:
            fail(f"cluster: run {run['run']} did not end within {CLUSTER_WAIT_S} s")
        if watch is not None:
            watch(run["reports_dir"])
        time.sleep(0.05)
    run.update(wall_s=time.time() - t0, t0=t0)
    with open(run["log_path"]) as f:
        run["log"] = f.read()
    if proc.returncode != 0:
        print(run["log"][-6000:], file=sys.stderr, flush=True)
        fail(f"cluster: run {run['run']} exited {proc.returncode}")
    run["reports"] = read_reports(run["reports_dir"])
    return run


def cluster_ready(runs: list, counts: list) -> float:
    """Wait until every run's processes (``counts``: workers and standbys)
    have the model on the card; fails if a spawn exits first.  Returns the
    seconds waited."""
    t0 = time.time()
    while True:
        ready = [len([r for r in read_reports(run["reports_dir"]) if "ready" in r]) for run in runs]
        if all(n >= c for n, c in zip(ready, counts)):
            return time.time() - t0
        for run in runs:
            if run["proc"].poll() is not None:
                with open(run["log_path"]) as f:
                    print(f.read()[-6000:], file=sys.stderr, flush=True)
                fail(f"cluster: run {run['run']} exited {run['proc'].returncode} before its go")
        if time.time() - t0 > CLUSTER_WAIT_S:
            fail(f"cluster: {ready} of {counts} processes ready after {CLUSTER_WAIT_S} s")
        time.sleep(0.1)


def free_port_run(n: int, taken: list) -> int:
    """The first of ``n`` consecutive free localhost ports, apart from the
    ranges in ``taken`` (appended to): every run gets ports of its own, so
    an old run's sockets in TIME_WAIT are never in the way."""
    import socket

    for _ in range(50):
        base = free_port()
        ok = all(abs(base - t) >= n for t in taken)
        for p in range(base, base + n):
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", p))
                except OSError:
                    ok = False
                    break
        if ok:
            taken.append(base)
            return base
    fail("cluster: no run of free ports")


def worker_stats(reports: list) -> list:
    """Per process: its identity, texts, forwards, device ms, idle share
    over its ``pw.run`` (1 - device s / run s), peak memory and nvcc runs."""
    out = []
    for r in reports:
        run_s = (r["run_end"] - r["run_start"]) if r.get("ended") else None
        out.append({"pid": r["pid"], "process_id": r["process_id"], "standby": r["standby"],
                    "attempt": r["attempt"], "ended": r.get("ended", False), "texts": r["texts"],
                    "forwards": r["forwards"], "device_ms": r["device_ms"],
                    "run_s": run_s, "idle_share": (1.0 - r["device_ms"] / 1000.0 / run_s) if run_s else None,
                    "peak_mem_bytes": r.get("peak_mem_bytes"), "nvcc": r.get("nvcc"),
                    "setup_s": r["ready"] - r["entered"], "launches": r["launches"]})
    return out


def generations(root: str) -> dict:
    mdir = os.path.join(root, "manifests")
    return {w: len([n for n in os.listdir(os.path.join(mdir, w)) if not n.endswith(".tmp")])
            for w in sorted(os.listdir(mdir))} if os.path.isdir(mdir) else {}


def scrub_ok(root: str) -> bool:
    """``python -m pathway_tpu_torch.cli scrub ROOT``'s exit code is 0 (its
    ``main``, called here: the same code without an interpreter's start)."""
    from pathway_tpu_torch import cli

    with contextlib.redirect_stdout(sys.stderr):
        return cli.main(["scrub", root]) == 0


def first_output_after(reports: list, t: float, exclude_pid: int | None = None) -> float | None:
    ends = [e for r in reports if r["pid"] != exclude_pid for e in r["ends"] if e > t]
    return min(ends) - t if ends else None


def cluster_phase(device, seed: int, checked: dict, n_docs: int = CLUSTER_DOCS) -> dict:
    """Phase 15e: ``[persistence]`` part A's program at full all-MiniLM-L6-v2
    width as one worker in this process (A), then as a 2-worker cluster
    through ``python -m pathway_tpu_torch spawn`` (B), supervised with
    worker 1 SIGKILLed at epoch 24 by the fault plan (C), and with a warm
    standby promoted in its place after a SIGKILL from here (D).
    ``checked`` gains the attention shapes the runs gave the kernel."""
    import shutil
    import signal
    import tempfile
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.device import get_default_executor
    from pathway_tpu_torch.models.encoder import init_params
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.utils.batching import AsyncMicroBatcher

    ex = get_default_executor(device)
    enc = pw.SentenceEncoder(CLUSTER_MODEL, seed=seed, device=device)
    enc.set_params(init_params(enc.config, seed))  # the workers' weights
    texts, sources, query = cluster_inputs(seed, n_docs)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cluster")
    os.makedirs(work, exist_ok=True)
    base = tempfile.mkdtemp(prefix="run_", dir=work)
    prebuilt = all(_build.library_path(n).exists() for n in _build.sources())
    probe = ClusterProbe(enc, None, device)
    batcher = AsyncMicroBatcher(probe.process, max_batch_size=DATAFLOW_BATCH, executor=ex,
                                name="cluster:embedder")
    started: list = []
    try:
        # ---- run A, the counted run in this process: counts zeroed just before, read just after ----
        a_out = os.path.join(base, "A")
        os.makedirs(a_out)
        probe.zero()
        t0 = time.perf_counter()
        cluster_program(pw, texts, sources, embedding_udf(pw, batcher.submit), query, a_out, None)
        a_s = time.perf_counter() - t0
        launches_a = probe.kernel.launches
        # ---- end of run A ----
        probe.hook.remove()
        expected = sum(probe.seen.values())
        if launches_a != expected or not expected:
            fail(f"cluster: run A: attention launches {launches_a} != {expected} ({probe.seen})")
        shapes = dict(probe.seen)
        ref = cluster_net(a_out, 1)
        a = {"rows_per_s": n_docs / a_s, "wall_s": a_s, "texts": probe.texts, "forwards": probe.forwards,
             "device_ms": probe.device_ms, "idle_share": 1.0 - probe.device_ms / 1000.0 / a_s}
        log("cluster", run="A", **a)
        if probe.texts != n_docs or len(ref["docs"]) != n_docs:
            fail(f"cluster: run A embedded {probe.texts} texts and left {len(ref['docs'])} docs, not {n_docs}")

        # ---- runs B-D start together (each a fresh `spawn`); each runs on its go, one at a time ----
        plan = {"seed": 7, "faults": [{"kind": "crash", "worker": 1, "at_epoch": CLUSTER_KILL_EPOCH, "attempt": 0}]}
        taken: list = []
        for name, args, extra in (
                ("B", [], {}),  # -n 2, unbroken
                ("C", ["--supervise", "--checkpoint-root", "ROOT"],  # worker 1 SIGKILLed at its epoch 24 by the plan
                 {"PATHWAY_FAULT_PLAN": json.dumps(plan)}),
                ("D", ["--supervise", "--standbys", "1", "--checkpoint-root", "ROOT"], {})):  # killed from here
            started.append(cluster_start(name, base, seed, device, n_docs, args, extra, free_port_run(4, taken)))
        ready_s = cluster_ready(started, [2, 2, 3])
        killed: dict = {}

        def killer(reports_dir):
            if killed:
                return
            reps = read_reports(reports_dir)
            primaries = [r for r in reps if r["standby"] is None]
            if sum(r["texts"] for r in primaries) < CLUSTER_KILL_EPOCH * CLUSTER_COMMIT:
                return
            victim = [r for r in primaries if r["process_id"] == 1]
            if victim:
                os.kill(victim[0]["pid"], signal.SIGKILL)
                killed.update(pid=victim[0]["pid"], t=time.time(),
                              texts=sum(r["texts"] for r in primaries))

        runs = {run["run"]: cluster_finish(run, killer if run["run"] == "D" else None) for run in started}
        if not killed:
            fail("cluster: run D ended before worker 1 could be killed")
        results = {"A": a}
        for name, run in runs.items():
            state = cluster_state_check(cluster_net(run["out"]), ref)
            reps = run["reports"]
            stats = worker_stats(reps)
            rep = {"wall_s": run["wall_s"], "state": state, "workers": stats,
                   "texts": sum(r["texts"] for r in reps), "nvcc_runs": sum(len(r.get("nvcc") or []) for r in reps)}
            if name == "B":
                starts = [r["run_start"] for r in reps]
                ends = [r["run_end"] for r in reps]
                rep["run_s"] = max(ends) - max(starts)
                rep["rows_per_s"] = n_docs / rep["run_s"]
                rep["rows_per_s_over_a"] = rep["rows_per_s"] / a["rows_per_s"]
                rep["spawn_to_go_s"] = run["t0"] - run["t_start"]
                if len(reps) != 2 or rep["texts"] != n_docs:
                    fail(f"cluster: run B: {len(reps)} workers embedded {rep['texts']} texts, not {n_docs}")
            else:
                rep["generations"] = generations(run["root"])
                rep["scrub_clean"] = scrub_ok(run["root"])
                if not rep["scrub_clean"]:
                    fail(f"cluster: run {name}: scrub of its root failed")
            if name == "C":
                dump = os.path.join(run["root"], "blackbox", "worker-1.attempt-0.json")
                if not os.path.exists(dump):
                    fail("cluster: run C: worker 1 left no flight-recorder dump of its crash")
                with open(dump) as f:
                    crash = json.load(f)
                t_kill = crash["dumped_at"]
                later = [r for r in reps if r["attempt"] >= 1]
                first = [r for r in reps if r["attempt"] == 0]
                if "recovered after" not in run["log"] or "exited -9" not in run["log"] \
                        or crash["reason"] != f"injected crash (worker 1, epoch {CLUSTER_KILL_EPOCH})":
                    fail(f"cluster: run C: no SIGKILL of worker 1 and group restart in the log: {crash['reason']}")
                if len(later) != 2 or not all(r.get("ended") for r in later) \
                        or any(r.get("ended") for r in first if r["process_id"] == 1):
                    fail(f"cluster: run C: attempts {[(r['attempt'], r['process_id'], r.get('ended')) for r in reps]}")
                rep["restarts"] = int(run["log"].split("recovered after ")[1].split(" ")[0])
                rep["kill_to_first_output_s"] = first_output_after(later, t_kill)
                rep["kill_to_end_s"] = max(r["run_end"] for r in later) - t_kill
                rep["texts_after_restart"] = sum(r["texts"] for r in later)
                rep["texts_before_kill"] = sum(r["texts"] for r in first)
            if name == "D":
                workers0 = {r["pid"] for r in reps if r["process_id"] == 0 and r["standby"] is None}
                promoted = [r for r in reps if r["pid"] != killed["pid"] and r["process_id"] == 1
                            and r.get("ended") and r["standby"] is None]
                if "standby promotion:" not in run["log"] or "recovered after" in run["log"]:
                    fail("cluster: run D: no promotion in the log, or a group restart")
                if len(workers0) != 1 or len(promoted) != 1 or not all(
                        r.get("ended") for r in reps if r["pid"] != killed["pid"] and r["standby"] is None):
                    fail(f"cluster: run D: worker 0 pids {workers0}, promoted {[r['pid'] for r in promoted]}")
                rep["killed_at_texts"] = killed["texts"]
                rep["kill_to_first_output_s"] = first_output_after(reps, killed["t"], killed["pid"])
                rep["kill_to_end_s"] = max(r["run_end"] for r in reps if r.get("ended")) - killed["t"]
                rep["promoted_standby_texts"] = promoted[0]["texts"]
                rep["kill_to_promoted_first_output_s"] = first_output_after(promoted, killed["t"])
                rep["promotion_line"] = run["log"].split("standby promotion:")[1].splitlines()[0].strip()
            log("cluster", run=name, **rep)
            cluster_gate(name, state)
            if rep["nvcc_runs"]:
                fail(f"cluster: run {name}: a worker ran nvcc ({rep['nvcc_runs']} builds)")
            for r in reps:  # every process launched the kernel once per layer of each forward
                if r["launches"] != sum(r["seen"].values()) or (r["texts"] and not r["launches"]):
                    fail(f"cluster: run {name}: pid {r['pid']} launched the kernel {r['launches']} times ({r['seen']})")
                for shape, n in r["seen"].items():
                    shapes[shape] = shapes.get(shape, 0) + n
            results[name] = rep
    finally:
        for run in started:
            cluster_stop(run)
        threading.Thread(target=shutil.rmtree, args=(base, True), daemon=True).start()
    launches = {"encoder_attention": launches_a + sum(r["launches"] for run in runs.values() for r in run["reports"])}
    gen = torch.Generator(device=device).manual_seed(seed + 331)
    for shape in sorted(set(shapes) - set(checked)):
        checked[shape] = check_attention_shape(gen, shape, device)
    log("cluster", step="shapes", launches={str(list(sh)): n for sh, n in sorted(shapes.items())},
        max_abs_err={str(list(sh)): checked[sh] for sh in sorted(shapes)})
    log("cluster", step="summary", prebuilt=prebuilt, kernel_launches=launches, b_to_d_ready_s=ready_s,
        c_vs_d_kill_to_first_output_s=[results["C"]["kill_to_first_output_s"],
                                       results["D"]["kill_to_first_output_s"]])
    return {"launches": launches, "attention_launches": shapes, "runs": results}


# ---------------------------------------------------------------------------
# Phase 16: the connectors and the retrieval half of the LLM xpack.
# ---------------------------------------------------------------------------

VS_MODEL = "all-MiniLM-L6-v2"
VS_FILES = 1024  # 16,384, 8,192, then 4,096 passed the script's time limit with the later phases (PERF.md section 4)
VS_WORDS = (100, 1000)
VS_BATCHES = 16  # per traffic stage, one commit each
VS_QUERIES = 64
VS_K = 10
VS_QUERY_WORDS = (8, 32)
VS_NEW, VS_DELETED, VS_REWRITTEN = 256, 128, 128
VS_BURSTS = 8  # the live changes, in bursts VS_BURST_GAP_S apart
VS_BURST_GAP_S = 0.25
VS_CHUNK_WORDS = 500  # TokenCountSplitter's max_tokens; the corpus has no sentence ends to break at
VS_WAIT_S = 300.0  # the longest any stage may wait on the run
# a returned chunk may score below the plain k-th by this much (a tie): by
# up to twice the error of one chunk's score (its own and the k-th's), and
# the bf16 index's scores parted from the plain re-encode's by up to 0.0027
# (NVIDIA H100 80GB HBM3, 700 W)
VS_TIE_TOL = 6e-3


class VectorStoreDone(Exception):
    """Ends the ``[vector_store]`` run from its answers' subscriber: a
    streaming fs source never finishes by itself."""


def plain_chunks(words) -> list:
    """``TokenCountSplitter()``'s chunks of a text without sentence ends:
    consecutive spans of 500 words (of ``words``, any sequence)."""
    return [words[a : a + VS_CHUNK_WORDS] for a in range(0, len(words), VS_CHUNK_WORDS)]


def vs_corpus(seed: int) -> dict:
    """The phase's documents: 8,192 initial ones, 512 to add, 256 to
    delete and 256 to rewrite (with new text); their chunks, and the
    queries: 2 stages of 32 batches of 64, each a span of 8-32 words of a
    live chunk with a quarter of its words swapped."""
    n_texts = VS_FILES + VS_NEW + VS_REWRITTEN
    texts, _lengths, ids, vocab = synthetic_corpus(n_texts, seed + 201, words_per_text=VS_WORDS)
    rng = np.random.default_rng(seed + 203)
    picked = [int(i) for i in rng.permutation(VS_FILES)[: VS_DELETED + VS_REWRITTEN]]
    deleted, rewritten = picked[:VS_DELETED], picked[VS_DELETED:]
    names = [f"doc{i:05d}.txt" for i in range(VS_FILES + VS_NEW)]
    # a file's text: texts[i] at first; a rewrite gives it texts[VS_FILES + VS_NEW + j]
    new_text = {i: VS_FILES + VS_NEW + j for j, i in enumerate(rewritten)}
    chunk_ids: dict[str, int] = {}
    chunk_words: list = []
    doc_chunks: dict[int, list[int]] = {}  # text index -> its chunk ids
    for t in range(n_texts):
        cids = []
        for words in plain_chunks(ids[t]):
            text = " ".join(vocab[w] for w in words)
            cid = chunk_ids.setdefault(text, len(chunk_ids))
            if cid == len(chunk_words):
                chunk_words.append(words)
            cids.append(cid)
        doc_chunks[t] = cids
    initial = [c for i in range(VS_FILES) for c in doc_chunks[i]]
    gone = set(deleted)
    final_docs = [new_text.get(i, i) for i in range(VS_FILES + VS_NEW) if i not in gone]
    final = [c for t in final_docs for c in doc_chunks[t]]

    def stage(live):
        out = []
        for _ in range(VS_BATCHES):
            batch = []
            for _ in range(VS_QUERIES):
                words = chunk_words[live[int(rng.integers(len(live)))]]
                n = min(int(rng.integers(VS_QUERY_WORDS[0], VS_QUERY_WORDS[1] + 1)), len(words))
                start = int(rng.integers(0, len(words) - n + 1))
                span = np.array(words[start : start + n])
                swap = rng.random(n) < QUERY_SWAP
                span[swap] = rng.integers(0, len(vocab), size=int(swap.sum()))
                batch.append(" ".join(vocab[w] for w in span))
            out.append(batch)
        return out

    return {"texts": texts, "names": names, "deleted": deleted, "rewritten": rewritten, "new_text": new_text,
            "chunk_ids": chunk_ids, "doc_chunks": doc_chunks, "initial": initial, "final": final,
            "queries": [stage(initial), stage(final)]}


def vs_changes(corpus: dict, seed: int) -> list:
    """The live changes ``(kind, file index)`` in a seeded order, in
    ``VS_BURSTS`` bursts."""
    ops = ([("new", VS_FILES + j) for j in range(VS_NEW)] + [("delete", i) for i in corpus["deleted"]]
           + [("rewrite", i) for i in corpus["rewritten"]])
    order = np.random.default_rng(seed + 205).permutation(len(ops))
    ops = [ops[i] for i in order]
    per = len(ops) // VS_BURSTS
    return [ops[b * per : (b + 1) * per] for b in range(VS_BURSTS)]


class VectorStoreTraffic:
    """The ``[vector_store]`` run's traffic and what its subscribers see.

    A thread waits until the initial corpus is indexed, opens stage 1 of the
    queries (32 batches of 64, each committed and answered before the next),
    then makes the live changes in bursts and, once the statistics show the
    final file count and every change has shown in the chunk table, opens
    stage 2.  The answers' subscriber ends the run (``VectorStoreDone``)
    at the last query's first answer.  A watchdog interrupts the run when a
    wait passes ``VS_WAIT_S``."""

    def __init__(self, corpus: dict, docs_dir: str, staging: str, bursts: list, key_of):
        import threading

        self.corpus, self.docs_dir, self.staging, self.bursts = corpus, docs_dir, staging, bursts
        self.n_queries = 2 * VS_BATCHES * VS_QUERIES
        self.query_of = {key_of(n): n for n in range(self.n_queries)}
        self.indexed = threading.Event()
        self.go = [threading.Event(), threading.Event()]
        self.batch_done = [threading.Event() for _ in range(2 * VS_BATCHES)]
        self.settled = threading.Event()
        self.failure: str | None = None
        self.t_run = self.t_indexed = self.t_stage1 = self.t_settled = None
        self.sent: list[float] = []  # per batch, just before its first row
        self.first: dict[int, tuple[float, tuple]] = {}  # query -> (time, ((chunk id, score), ...)) of its first answer
        self.live: dict[int, list] = {}  # query -> its live answers' hits
        self.batch_count = [0] * (2 * VS_BATCHES)
        self.stale: list = []  # answers naming a change already seen
        self.errors = 0
        self.file_count = None
        self.stats_seen: list[int] = []
        self.chunks_live = 0
        self.written: dict[str, tuple[str, float]] = {}  # file name -> (change kind, write time)
        self.seen: dict[str, float] = {}  # file name -> first chunk-table delta after its write
        rewritten = {corpus["names"][i] for i in corpus["rewritten"]}
        self.old_chunks = {corpus["names"][i]: set(corpus["doc_chunks"][i]) for i in corpus["rewritten"]}
        self.gone = {corpus["names"][i] for i in corpus["deleted"]}
        assert not rewritten & self.gone
        self.final_count = VS_FILES + VS_NEW - VS_DELETED

    # -- subscribers ---------------------------------------------------
    def on_chunk(self, key, row, time, is_addition):
        import pathway_tpu_torch as pw

        now = _now()
        if any(v is pw.ERROR for v in row.values()):
            self.errors += 1
            return
        self.chunks_live += 1 if is_addition else -1
        name = os.path.basename(row["metadata"].value["path"])
        if name in self.written and name not in self.seen:
            self.seen[name] = now

    def on_stats(self, key, row, time, is_addition):
        import pathway_tpu_torch as pw

        if row["result"] is pw.ERROR:
            self.errors += 1
        elif is_addition:
            self.file_count = row["result"].value["file_count"]
            self.stats_seen.append(self.file_count)

    def on_stats_epoch(self, time):
        if self.file_count == VS_FILES and not self.indexed.is_set():
            self.t_indexed = _now()
            self.indexed.set()
        if self.file_count == self.final_count and len(self.seen) == len(self.written) == VS_NEW + VS_DELETED + \
                VS_REWRITTEN and not self.settled.is_set():
            self.t_settled = _now()
            self.settled.set()

    def on_answer(self, key, row, time, is_addition):
        import pathway_tpu_torch as pw

        now = _now()
        if row["result"] is pw.ERROR:
            self.errors += 1
            return
        q = self.query_of[int(key.value)]
        chunk_ids = self.corpus["chunk_ids"]
        hits = tuple((chunk_ids.get(h["text"], -1), -float(h["dist"]), os.path.basename(h["metadata"]["path"]))
                     for h in row["result"].value)
        if not is_addition:
            self.live[q].remove(hits)
            return
        for cid, _score, name in hits:
            seen = self.seen.get(name)
            if seen is not None and seen < now and (name in self.gone or cid in self.old_chunks.get(name, ())):
                self.stale.append((q, name, cid))
        self.live.setdefault(q, []).append(hits)
        if q not in self.first:
            self.first[q] = (now, hits)
            b = q // VS_QUERIES
            self.batch_count[b] += 1
            if self.batch_count[b] == VS_QUERIES:
                self.batch_done[b].set()
                if b == len(self.batch_done) - 1:
                    raise VectorStoreDone

    # -- the traffic ---------------------------------------------------
    def wait(self, event, what: str) -> None:
        import _thread

        if not event.wait(VS_WAIT_S):
            self.failure = f"{what} took over {VS_WAIT_S} s"
            _thread.interrupt_main()
            raise SystemExit

    def subject(self, pw):
        traffic = self

        class Queries(pw.io.python.ConnectorSubject):
            def run(self):
                for stage, batches in enumerate(traffic.corpus["queries"]):
                    traffic.wait(traffic.go[stage], f"stage {stage + 1} of the queries")
                    for b, batch in enumerate(batches):
                        traffic.sent.append(_now())
                        for text in batch:
                            self.next(query=text, k=VS_K, metadata_filter=None, filepath_globpattern=None)
                        self.commit()
                        traffic.wait(traffic.batch_done[stage * VS_BATCHES + b], f"batch {b} of stage {stage + 1}")

        return Queries()

    def write(self, i: int, text: str) -> None:
        """Write a file whole: into the staging directory, then moved in."""
        name = self.corpus["names"][i]
        tmp = os.path.join(self.staging, name)
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, os.path.join(self.docs_dir, name))

    def drive(self) -> None:
        import time as _time

        self.wait(self.indexed, "indexing the initial corpus")
        self.go[0].set()
        self.wait(self.batch_done[VS_BATCHES - 1], "stage 1 of the queries")
        self.t_stage1 = _now()
        texts, names = self.corpus["texts"], self.corpus["names"]
        for burst in self.bursts:
            for kind, i in burst:
                if kind == "delete":
                    os.remove(os.path.join(self.docs_dir, names[i]))
                else:
                    self.write(i, texts[self.corpus["new_text"].get(i, i)])
                self.written[names[i]] = (kind, _now())
            _time.sleep(VS_BURST_GAP_S)
        self.wait(self.settled, "showing the live changes")
        self.go[1].set()


def _now() -> float:
    return time.perf_counter()


def vs_plain_check(enc, corpus: dict, traffic: VectorStoreTraffic, device) -> dict:
    """The plain answer: every chunk the run held and every query encoded
    directly by ``SentenceEncoder.encode`` on the card, f32 cosine scores
    and ``torch.topk`` over the live chunks of each stage.  Stage 1's
    first answers are held to the initial corpus, and every query's last
    answer (stage 1's revised through the changes) to the final one.  Each
    returned chunk is scored anew from the plain embeddings: that score
    must lie within ``SCORE_TOL`` of the one the answer reports, and
    within ``VS_TIE_TOL`` of the plain k-th or above it (ids equal but at
    ties); a chunk not live in the stage, or returned more often than it
    is live, is counted as misplaced."""
    from collections import Counter

    chunk_texts = sorted(corpus["chunk_ids"], key=corpus["chunk_ids"].get)
    queries = [q for stage in corpus["queries"] for batch in stage for q in batch]
    embs = {}
    for name, texts in (("chunks", chunk_texts), ("queries", queries)):
        lens = np.array([len(t) for t in texts])
        embs[name] = encode_sorted(enc, texts, np.argsort(lens))[0]
    chunks = torch.from_numpy(embs["chunks"]).to(device)
    chunks = chunks / chunks.norm(dim=1, keepdim=True)
    q_all = torch.from_numpy(embs["queries"]).to(device)
    q_all = q_all / q_all.norm(dim=1, keepdim=True)
    res = {}
    per_stage = VS_BATCHES * VS_QUERIES
    for label, live, rows, answers in (
        ("stage1_first", corpus["initial"], range(per_stage), {q: traffic.first[q][1] for q in range(per_stage)}),
        ("final", corpus["final"], range(2 * per_stage), {q: hits[0] for q, hits in traffic.live.items()}),
    ):
        held = Counter(live)
        live_t = torch.tensor(sorted(held), device=device)
        q = q_all[list(rows)]
        vals, idx = torch.topk(q @ chunks[live_t].T, VS_K, dim=1)
        ref_ids = live_t[idx].cpu().numpy()
        ref_vals = vals.float().cpu().numpy()
        got_ids = np.array([[h[0] for h in answers[r]] for r in rows])
        got_vals = np.array([[h[1] for h in answers[r]] for r in rows])
        misplaced = sum(1 for ids in got_ids for cid, n in Counter(ids.tolist()).items() if n > held.get(cid, 0))
        got_t = torch.from_numpy(np.maximum(got_ids, 0)).to(device)
        own = torch.einsum("rd,rkd->rk", q, chunks[got_t]).float().cpu().numpy()  # plain score of each returned chunk
        known = got_ids >= 0
        below = np.where(known, ref_vals[:, -1:] - own, 0.0)
        parted, gap = topk_parted(got_ids, got_vals, ref_ids, ref_vals)
        overlap = np.mean([len(set(g) & set(r)) / VS_K for g, r in zip(got_ids, ref_ids)])
        res[label] = {"queries": len(rows), "rows_parted": parted, "parted_max_gap": gap,
                      "positions_parted": int((got_ids != ref_ids).sum()), "ids_in_plain_topk": float(overlap),
                      "plain_top1_minus_topk_p50": float(np.median(ref_vals[:, 0] - ref_vals[:, -1])),
                      "max_score_err": float(np.abs(got_vals - ref_vals).max()),
                      "max_own_score_err": float(np.abs(np.where(known, got_vals - own, 0.0)).max()),
                      "max_below_plain_kth": float(below.max()),
                      "unknown_texts": int((~known).sum()), "misplaced": misplaced,
                      "multiple_live": sum(1 for r in rows if len(traffic.live.get(r, ())) != 1)}
    return res


def vector_store_phase(device, seed: int, checked: dict, card: str) -> dict:
    """Phase 16: ``VectorStoreServer`` over ``SentenceTransformerEmbedder``
    and ``BruteForceKnn``, fed by ``pw.io.fs.read`` in streaming mode and
    queried through ``pw.io.python.read``, its answers read by
    ``pw.io.subscribe``.  ``checked`` gains the attention shapes the run
    gave the kernel.  The fs reader polls on after the run, as in the JAX
    package (a streaming fs source has no stop): this phase runs last."""
    import shutil
    import tempfile
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import native
    from pathway_tpu_torch.engine import dataflow as df
    from pathway_tpu_torch.engine.types import sequential_key
    from pathway_tpu_torch.models.encoder import init_params
    from pathway_tpu_torch.ops.attention import encoder_attention
    from pathway_tpu_torch.xpacks.llm import DocumentStore, VectorStoreServer
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    if native.get() is None:
        fail("vector_store: the native core did not load")
    t_setup = time.perf_counter()
    embedder = SentenceTransformerEmbedder(VS_MODEL)
    enc = embedder._encoder
    enc.set_params(init_params(enc.config, seed))  # seeded weights at full width
    corpus = vs_corpus(seed)
    bursts = vs_changes(corpus, seed)
    root = tempfile.mkdtemp(prefix="vector_store_")
    docs_dir, staging = os.path.join(root, "docs"), os.path.join(root, "staging")
    os.makedirs(docs_dir)
    os.makedirs(staging)
    for i in range(VS_FILES):
        with open(os.path.join(docs_dir, corpus["names"][i]), "w") as f:
            f.write(corpus["texts"][i])
    setup_s = time.perf_counter() - t_setup

    traffic = VectorStoreTraffic(corpus, docs_dir, staging, bursts, sequential_key)
    docs = pw.io.fs.read(docs_dir, format="binary", mode="streaming", with_metadata=True)
    server = VectorStoreServer(docs, embedder=embedder, splitter=TokenCountSplitter())
    queries = pw.io.python.read(traffic.subject(pw), schema=DocumentStore.RetrieveQuerySchema)
    stats = pw.debug.table_from_rows(pw.schema_from_types(one=int), [(1,)]).select()
    pw.io.subscribe(server.document_store.chunked_docs, on_change=traffic.on_chunk)
    pw.io.subscribe(server.statistics_query(stats), on_change=traffic.on_stats, on_time_end=traffic.on_stats_epoch)
    pw.io.subscribe(server.retrieve_query(queries), on_change=traffic.on_answer)

    sizes: list[int] = []
    process = embedder._batcher.process_batch

    def counted(items):
        sizes.append(len(items))
        return process(items)

    embedder._batcher.process_batch = counted
    pad = {"ids": torch.zeros((), dtype=torch.int64, device=device), "slots": 0}

    def padding(_module, args):
        pad["ids"] += args[1].sum()
        pad["slots"] += args[1].numel()

    epochs: list[tuple[float, float]] = []  # (start, ms) of each root epoch
    scopes: list = []
    run_epoch, search_many = df.Scope.run_epoch, df.ExternalIndexNode._search_many
    searched = [0, 0]  # query rows answered by the index, calls

    def timed_epoch(scope, time_):
        t0 = time.perf_counter()
        try:
            return run_epoch(scope, time_)
        finally:
            if scope.parent is None:
                epochs.append((t0, (time.perf_counter() - t0) * 1e3))
                if not scopes:
                    scopes.append(scope)

    def counted_search(node, qrows):
        searched[0] += len(qrows)
        searched[1] += 1
        return search_many(node, qrows)

    seen: dict[tuple, int] = {}
    hooks = [record_launches(enc, seen), enc.model.register_forward_pre_hook(padding)]
    events, remove_events = forward_events(enc)
    stamps: list[float] = []  # host time of each forward's start, beside ``events``
    hooks.append(enc.model.register_forward_pre_hook(lambda _m, _a: stamps.append(_now())))
    traffic_thread = threading.Thread(target=traffic.drive, name="vector_store:traffic", daemon=True)
    df.Scope.run_epoch, df.ExternalIndexNode._search_many = timed_epoch, counted_search
    # ---- the counted run: counts zeroed just before, read just after ----
    encoder_attention.launches = 0
    seen.clear()
    before = rail_state(device)
    ended = None
    try:
        traffic.t_run = _now()
        traffic_thread.start()
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    except VectorStoreDone:
        ended = "done"
    except KeyboardInterrupt:
        ended = "by the watchdog"
    except Exception as exc:  # noqa: BLE001 - any other ending fails the phase below
        ended = f"by {exc!r}"
    finally:
        wall_s = _now() - traffic.t_run
        df.Scope.run_epoch, df.ExternalIndexNode._search_many = run_epoch, search_many
        pw.G.clear()
    launches = {"encoder_attention": encoder_attention.launches}
    # ---- end of the counted run ----
    device_ms = events_ms(events)
    ingest_device_ms = events_ms([ev for ev, t in zip(events, stamps) if t < traffic.t_indexed])
    for h in hooks:
        h.remove()
    remove_events()
    embedder._batcher.process_batch = process
    if ended != "done":
        fail(f"vector_store: the run ended {ended or 'by itself'}: {traffic.failure or ''}")
    traffic_thread.join(timeout=10)
    rail = rail_gate("vector_store", device, before)
    readers = sum(1 for t in threading.enumerate() if t.name == "pathway:connector")

    ingest_s = traffic.t_indexed - traffic.t_run
    epochs_ms = [ms for _end, ms in epochs]
    windows = {"ingest": traffic.t_indexed, "stage1": traffic.t_stage1, "changes": traffic.t_settled,
               "stage2": float("inf")}
    by_stage, start = {}, 0.0
    for name, end in windows.items():
        part = [ms for t, ms in epochs if start <= t < end]
        by_stage[name] = {"epochs": len(part), "host_ms": sum(part), "max_ms": max(part, default=0.0)}
        start = end
    node_s: dict[str, float] = {}
    for node in scopes[0].nodes if scopes else ():
        node_s[type(node).__name__] = node_s.get(type(node).__name__, 0.0) + node.step_seconds
    top_nodes = dict(sorted(node_s.items(), key=lambda kv: -kv[1])[:8])
    n_initial = len(corpus["initial"])
    query_ms = [(traffic.first[q][0] - traffic.sent[q // VS_QUERIES]) * 1e3 for q in range(traffic.n_queries)]
    stale = {}
    for kind in ("new", "rewrite", "delete"):
        names = [n for n, (k, _t) in traffic.written.items() if k == kind]
        stale[kind] = percentiles([(traffic.seen[n] - traffic.written[n][1]) * 1e3 for n in names])
    stale["all"] = percentiles([(traffic.seen[n] - t) * 1e3 for n, (_k, t) in traffic.written.items()])
    t_check = time.perf_counter()
    plain = vs_plain_check(enc, corpus, traffic, device)
    check_s = time.perf_counter() - t_check
    res = {
        "card": card, "model": VS_MODEL, "files": VS_FILES, "chunks_initial": n_initial,
        "chunks_final": len(corpus["final"]), "live_changes": {"new": VS_NEW, "deleted": VS_DELETED,
                                                               "rewritten": VS_REWRITTEN},
        "queries": traffic.n_queries, "k": VS_K, "setup_s": setup_s, "wall_s": wall_s,
        "ingest_s": ingest_s, "ingest_chunks_per_s": n_initial / ingest_s, "ingest_docs_per_s": VS_FILES / ingest_s,
        "epochs": len(epochs_ms), "host_ms_per_epoch": percentiles(epochs_ms) if epochs_ms else {},
        "host_ms_epochs_total": sum(epochs_ms), "epochs_by_stage": by_stage, "node_host_s": top_nodes,
        "index_query_rows_answered": searched[0], "index_search_calls": searched[1], "device_ms": device_ms,
        "idle_share": 1.0 - device_ms / (wall_s * 1e3), "ingest_device_ms": ingest_device_ms,
        "ingest_idle_share": 1.0 - ingest_device_ms / (ingest_s * 1e3), "forwards": len(events),
        "batches": len(sizes), "batch_sizes": {int(s): sizes.count(s) for s in sorted(set(sizes))},
        "padding_share_of_ids": 1.0 - float(pad["ids"]) / max(pad["slots"], 1),
        "query_latency_ms": percentiles(query_ms), "staleness_ms": stale,
        "file_count": traffic.file_count, "stale_answers": len(traffic.stale), "error_rows": traffic.errors,
        "native": native.get() is not None, "reader_threads_after_run": readers, "plain": plain,
        "check_s": check_s, "launches": launches,
    }
    log("vector_store", **{k: v for k, v in res.items() if k != "launches"}, kernel_launches=launches)
    shutil.rmtree(root, ignore_errors=True)
    if traffic.file_count != traffic.final_count:
        fail(f"vector_store: statistics report {traffic.file_count} files, not {traffic.final_count}")
    if traffic.stale:
        fail(f"vector_store: {len(traffic.stale)} answers named a change already seen, e.g. {traffic.stale[:3]}")
    for label, p in plain.items():
        if p["unknown_texts"] or p["misplaced"] or p["multiple_live"] or p["max_own_score_err"] > SCORE_TOL \
                or p["max_below_plain_kth"] > VS_TIE_TOL or p["max_score_err"] > SCORE_TOL:
            fail(f"vector_store: {label} answers against the plain answer: {p}")
    if traffic.errors:
        fail(f"vector_store: {traffic.errors} rows hold ERROR")
    expected = sum(seen.values())
    if launches["encoder_attention"] != expected or not expected:
        fail(f"vector_store: attention launches {launches['encoder_attention']} != {expected} "
             f"(layers x forwards per shape {seen})")
    gen = torch.Generator(device=device).manual_seed(seed + 207)
    for shape in sorted(set(seen) - set(checked)):
        checked[shape] = check_attention_shape(gen, shape, device)
    log("vector_store", step="shapes", card=card, launches={str(list(sh)): n for sh, n in sorted(seen.items())},
        max_abs_err={str(list(sh)): checked[sh] for sh in sorted(seen)})
    return {"launches": launches, "attention_launches": dict(seen), "rail": rail, **res}


# ---------------------------------------------------------------------------
# Phase 15b: the Adaptive RAG template served over pw.io.http.
# ---------------------------------------------------------------------------

RAG_INFLIGHT, RAG_QUEUE = 16, 8  # PATHWAY_SERVE_INFLIGHT and PATHWAY_SERVE_QUEUE for the phase
RAG_CLIENTS = 16  # the client's threads: the answering traffic never passes the admission budget
RAG_K = 10
RAG_SUMMARY_TEXTS, RAG_SUMMARY_WORDS = 3, 40
RAG_STARTING, RAG_FACTOR, RAG_ITERATIONS = 2, 2, 4  # BASELINE.md's answerer
RAG_RERANK_K = RAG_STARTING * RAG_FACTOR ** (RAG_ITERATIONS - 1)  # its over-fetch: 16 documents a question
RAG_WAIT_S = 600.0  # the longest any request or stage may wait
RAG_REF_BATCH = 24  # the dense references' batch: prompts of at most ~1,100 ids leave room on the card
RAG_NOT_FOUND = "No information found."  # AdaptiveRAGQuestionAnswerer's not-found answer
RAG_TEMPLATE = ('Use the below articles to answer the subsequent question. If the answer cannot be found, write '
                '"{not_found}"\nArticles:\n{context}\nQuestion: {question}\nAnswer:')  # question_answering.py:141-145


@dataclasses.dataclass(frozen=True)
class RagSizes:
    """The ``[rag]`` phase's scale (the defaults: BASELINE.md's Adaptive RAG
    configuration at full width, its depth cut to keep the script inside
    its time limit, PERF.md section 4)."""

    files: int = 2048
    words: tuple = (100, 1000)  # words per file
    questions: int = 16  # each sent to /v1/pw_ai_answer and to /v1/retrieve
    question_words: tuple = (8, 32)
    summaries: int = 2
    burst: int = 40  # past RAG_INFLIGHT + RAG_QUEUE
    model: str = "mistral-7b-instruct"
    new_tokens: int = 64
    cache: int = 4096  # two 500-word chunks and the template pass JaxChat's default 1024


class RagDone(Exception):
    """Ends a stage of the ``[rag]`` traffic that passed ``RAG_WAIT_S``."""


def rag_corpus(seed: int, sizes: RagSizes) -> dict:
    """The files, their chunks (``TokenCountSplitter()``'s 500-word spans)
    and the traffic: distinct questions (spans of random chunks with a
    quarter of the words swapped), summaries' text lists and the burst's."""
    texts, _lengths, ids, vocab = synthetic_corpus(sizes.files, seed + 301, words_per_text=sizes.words)
    chunk_ids: dict[str, int] = {}
    chunk_words: list = []
    for t in range(sizes.files):
        for words in plain_chunks(ids[t]):
            text = " ".join(vocab[w] for w in words)
            if chunk_ids.setdefault(text, len(chunk_ids)) == len(chunk_words):
                chunk_words.append(words)
    rng = np.random.default_rng(seed + 303)

    def span(lo: int, hi: int, swap: float) -> str:
        words = chunk_words[int(rng.integers(len(chunk_words)))]
        n = min(int(rng.integers(lo, hi + 1)), len(words))
        start = int(rng.integers(0, len(words) - n + 1))
        picked = np.array(words[start : start + n])
        swapped = rng.random(n) < swap
        picked[swapped] = rng.integers(0, len(vocab), size=int(swapped.sum()))
        return " ".join(vocab[w] for w in picked)

    questions: list[str] = []
    while len(questions) < sizes.questions:
        q = span(*sizes.question_words, QUERY_SWAP)
        if q not in questions:
            questions.append(q)
    summaries = [[span(RAG_SUMMARY_WORDS, RAG_SUMMARY_WORDS, 0.0) for _ in range(RAG_SUMMARY_TEXTS)]
                 for _ in range(sizes.summaries)]
    burst = [[span(4, 8, 0.0)] for _ in range(sizes.burst)]
    return {"texts": texts, "chunk_ids": chunk_ids, "questions": questions, "summaries": summaries,
            "burst": burst}


def http_call(url: str, body=None, headers=None, method: str = "POST", timeout: float | None = None) -> dict:
    """One request with the standard library: status, JSON body, headers and
    the client's ms; ``status`` None when no answer came (within ``timeout``
    s, ``RAG_WAIT_S`` by default)."""
    import urllib.error
    import urllib.request

    data = body if isinstance(body, bytes) or body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    t0 = _now()
    try:
        with urllib.request.urlopen(req, timeout=timeout or RAG_WAIT_S) as resp:
            status, raw, hdrs = resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        status, raw, hdrs = exc.code, exc.read(), dict(exc.headers)
    except Exception as exc:  # noqa: BLE001 - an unanswered socket: the status gate fails on it
        return {"status": None, "error": repr(exc), "ms": (_now() - t0) * 1e3}
    try:
        value = json.loads(raw) if raw else None
    except ValueError:
        value = raw.decode(errors="replace")
    return {"status": status, "body": value, "headers": hdrs, "ms": (_now() - t0) * 1e3}


class RagTraffic:
    """The ``[rag]`` client and what the run's subscribers see.

    A thread waits until every route is mounted and the corpus is indexed,
    then sends, 16 at a time, the /v1/retrieve questions with one
    /v1/statistics and one /v2/list_documents, then the questions to
    /v1/pw_ai_answer with the /v1/pw_ai_summary text lists, then the
    typed paths (malformed JSON, an unknown route, a 1 ms deadline) and a
    burst past the admission budget; then it opens the rerank program's
    queries and, once their top-5 sets have come, closes the server, which
    ends the run (the REST sources end with their server)."""

    def __init__(self, corpus: dict, sizes: RagSizes, n_chunks: int):
        import threading

        self.corpus, self.sizes, self.n_chunks = corpus, sizes, n_chunks
        self.url = ""
        self.server = None
        self.indexed, self.rerank_go, self.reranked = threading.Event(), threading.Event(), threading.Event()
        self.chunks_live = 0
        self.t_indexed = None
        self.calls: dict[str, list] = {}  # stage -> [(route, payload, result)]
        self.scored: list[tuple] = []  # (query, doc text, score) of every rerank pair
        self.kept: dict[str, tuple] = {}  # query -> (doc texts, scores) kept by rerank_topk_filter
        self.errors = 0
        self.failure: str | None = None
        self.burst_from = None  # index of the first scheduler request of the burst
        self.t_traffic = self.t_rerank = None

    # -- subscribers ---------------------------------------------------
    def on_chunk(self, key, row, time, is_addition):
        self.chunks_live += 1 if is_addition else -1

    def on_chunk_epoch(self, time):
        if self.chunks_live == self.n_chunks and not self.indexed.is_set():
            self.t_indexed = _now()
            self.indexed.set()

    def on_scored(self, key, row, time, is_addition):
        import pathway_tpu_torch as pw

        if row["score"] is pw.ERROR:
            self.errors += 1
        elif is_addition:
            self.scored.append((row["query"], row["doc"].value["text"], float(row["score"])))

    def on_kept(self, key, row, time, is_addition):
        import pathway_tpu_torch as pw

        if row["top"] is pw.ERROR:
            self.errors += 1
            return
        if is_addition:
            docs, scores = row["top"]
            self.kept[row["query"]] = (tuple(d.value["text"] for d in docs), tuple(scores))
            if len(self.kept) == len(self.corpus["questions"]):
                self.reranked.set()

    def rerank_subject(self, pw):
        traffic = self

        class RerankQueries(pw.io.python.ConnectorSubject):
            def run(self):
                if not traffic.rerank_go.wait(RAG_WAIT_S * 2):
                    return
                for q in traffic.corpus["questions"]:
                    self.next(query=q, k=RAG_RERANK_K, metadata_filter=None, filepath_globpattern=None)
                self.commit()

        return RerankQueries()

    # -- the client ----------------------------------------------------
    def send(self, stage: str, requests: list, threads: int = RAG_CLIENTS) -> None:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(threads) as pool:
            results = list(pool.map(lambda r: http_call(self.url + r[0], r[1], r[2] if len(r) > 2 else None),
                                    requests))
        self.calls[stage] = [(r[0], r[1], res) for r, res in zip(requests, results)]

    def burst(self, requests: list) -> None:
        """All of ``requests`` at once, released together by a barrier."""
        import threading
        from concurrent.futures import ThreadPoolExecutor

        gate = threading.Barrier(len(requests))

        def one(r):
            gate.wait()
            return http_call(self.url + r[0], r[1])

        with ThreadPoolExecutor(len(requests)) as pool:
            results = list(pool.map(one, requests))
        self.calls["burst"] = [(r[0], r[1], res) for r, res in zip(requests, results)]

    def wait(self, event, what: str) -> None:
        if not event.wait(RAG_WAIT_S):
            raise RagDone(f"{what} took over {RAG_WAIT_S} s")

    def drive(self, webserver, routes, sched_records: list) -> None:
        try:
            deadline = _now() + RAG_WAIT_S
            while set(webserver._route_docs) != set(routes) or not webserver._ready.is_set():
                if _now() > deadline:
                    raise RagDone("mounting the routes took too long")
                time.sleep(0.05)
            self.wait(self.indexed, "indexing the corpus")
            c = self.corpus
            self.t_traffic = _now()
            self.send("retrieve", [("/v1/retrieve", {"query": q, "k": RAG_K}) for q in c["questions"]]
                      + [("/v1/statistics", {}), ("/v2/list_documents", {})])
            answers = [("/v1/pw_ai_answer", {"prompt": q}) for q in c["questions"]]
            step = max(1, len(answers) // max(1, len(c["summaries"])))
            mixed = []
            for i, a in enumerate(answers):
                mixed.append(a)
                if i % step == step - 1 and i // step < len(c["summaries"]):
                    mixed.append(("/v1/pw_ai_summary", {"text_list": c["summaries"][i // step]}))
            self.send("answer", mixed)
            self.send("typed", [("/v1/pw_ai_answer", b"{not json"), ("/v1/no_such_route", {}),
                                ("/v1/retrieve", {"query": c["questions"][0], "k": RAG_K},
                                 {"X-Pathway-Deadline-Ms": "1"})], threads=1)
            self.burst_from = len(sched_records)
            self.burst([("/v1/pw_ai_summary", {"text_list": t}) for t in c["burst"]])
            self.t_rerank = _now()
            self.rerank_go.set()
            self.wait(self.reranked, "the rerank program")
        except BaseException as exc:  # noqa: BLE001 - recorded; the phase fails on it
            self.failure = repr(exc)
        finally:
            self.server.close()  # the REST sources end: the run ends


def rag_answers_check(lm, traffic: RagTraffic, records: list, sizes: RagSizes) -> dict:
    """Every answer against the greedy ``DecoderLM.generate_ids`` of the
    prompt its first round sent (the main traffic's summaries too): the
    response is the scheduler's tokens decoded, those tokens equal the
    dense path's greedy row or part from it only where the emitted token
    lies within the near-tie tol of the dense max (``emitted_gaps``); each
    first-round prompt is the template's literal text over the question
    and the two best documents of its /v1/retrieve answer (or two that tie
    with them within ``VS_TIE_TOL``)."""
    main = records[: traffic.burst_from]
    by_question: dict[str, list] = {}
    summaries = []
    for prompt, req in main:
        if prompt.startswith("user: Summarize"):
            summaries.append((prompt, req))
        else:
            q = prompt.rsplit("\nQuestion: ", 1)[1].rsplit("\nAnswer:", 1)[0]
            by_question.setdefault(q, []).append((prompt, req))
    retrieved = {p["query"]: res["body"] for route, p, res in traffic.calls["retrieve"] if route == "/v1/retrieve"}
    responses = {p["prompt"]: res["body"]["response"] for route, p, res in traffic.calls["answer"]
                 if route == "/v1/pw_ai_answer"}
    summary_responses = sorted(res["body"]["response"] for route, p, res in traffic.calls["answer"]
                               if route == "/v1/pw_ai_summary")
    decode = lm.tokenizer.decode
    problems, at_ties, rounds = [], 0, {}
    for q in traffic.corpus["questions"]:
        sent = by_question.get(q, [])
        rounds[len(sent)] = rounds.get(len(sent), 0) + 1
        if not sent:
            problems.append(f"no prompt reached the decoder for {q!r}")
            continue
        hits = retrieved[q]
        scores = [-h["dist"] for h in hits]
        ok = [(i, j) for i in range(len(hits)) for j in range(len(hits)) if i != j
              and abs(scores[i] - scores[0]) <= VS_TIE_TOL and abs(scores[j] - scores[1]) <= VS_TIE_TOL
              and sent[0][0] == "user: " + RAG_TEMPLATE.format(not_found=RAG_NOT_FOUND, question=q,
                                                               context=hits[i]["text"] + "\n\n" + hits[j]["text"])]
        if not ok:
            problems.append(f"the first-round prompt of {q!r} is not the template over its two best documents")
        elif ok[0] != (0, 1):
            at_ties += 1
        last = decode(sent[-1][1].out)
        got = responses.get(q)
        if got != last and not (got == RAG_NOT_FOUND and RAG_NOT_FOUND.lower().rstrip(".") in last.lower()):
            problems.append(f"the response to {q!r} is not the decoder's last round")
    if summary_responses != sorted(decode(req.out) for _p, req in summaries):
        problems.append("the summaries' responses are not the decoder's")
    rows = [r for sent in by_question.values() for r in sent] + summaries
    ids = [lm._encode_prompt(p) for p, _req in rows]
    outs = [list(req.out) for _p, req in rows]
    dense = []
    for b in range(0, len(rows), RAG_REF_BATCH):
        dense += lm.generate_ids(ids[b : b + RAG_REF_BATCH], max_new_tokens=sizes.new_tokens)
    parted = [i for i in range(len(rows)) if first_parting(outs[i], dense[i]) is not None]
    gaps = emitted_gaps(lm, [ids[i] for i in parted], [outs[i] for i in parted], sizes.new_tokens,
                        batch=RAG_REF_BATCH) if parted else {}
    if gaps.get("tokens_over_tol"):
        problems.append(f"{gaps['tokens_over_tol']} emitted token(s) lie tol or more below the dense max")
    return {"rows": len(rows), "identical": len(rows) - len(parted),
            "parted_at_step": {i: first_parting(outs[i], dense[i]) for i in parted}, "parted_gaps": gaps,
            "rounds": {str(k): v for k, v in sorted(rounds.items())},
            "second_rounds": sum(v for k, v in rounds.items() if k > 1),
            "prompt_tokens": percentiles([len(i) for i in ids]), "prompts_at_ties": at_ties,
            "not_found_answers": sum(1 for r in responses.values() if r == RAG_NOT_FOUND),
            "problems": problems}


def rag_retrieve_check(enc, traffic: RagTraffic, device) -> dict:
    """/v1/retrieve's answers against a direct ``encode`` of every chunk and
    question with f32 cosine scores and ``torch.topk`` (as ``[vector_store]``
    holds its answers)."""
    chunk_ids = traffic.corpus["chunk_ids"]
    chunk_texts = sorted(chunk_ids, key=chunk_ids.get)
    qs = traffic.corpus["questions"]
    embs = {}
    for name, texts in (("chunks", chunk_texts), ("queries", qs)):
        embs[name] = encode_sorted(enc, texts, np.argsort([len(t) for t in texts]))[0]
    chunks = torch.from_numpy(embs["chunks"]).to(device)
    chunks = chunks / chunks.norm(dim=1, keepdim=True)
    q = torch.from_numpy(embs["queries"]).to(device)
    q = q / q.norm(dim=1, keepdim=True)
    vals, idx = torch.topk(q @ chunks.T, RAG_K, dim=1)
    ref_vals = vals.float().cpu().numpy()
    answers = {p["query"]: res["body"] for route, p, res in traffic.calls["retrieve"] if route == "/v1/retrieve"}
    got_ids = np.array([[chunk_ids.get(h["text"], -1) for h in answers[t]] for t in qs])
    got_vals = np.array([[-float(h["dist"]) for h in answers[t]] for t in qs])
    known = got_ids >= 0
    own = torch.einsum("rd,rkd->rk", q, chunks[torch.from_numpy(np.maximum(got_ids, 0)).to(device)])
    own = own.float().cpu().numpy()
    parted, gap = topk_parted(got_ids, got_vals, idx.cpu().numpy(), ref_vals)
    return {"queries": len(qs), "rows_parted": parted, "parted_max_gap": gap,
            "max_score_err": float(np.abs(got_vals - ref_vals).max()),
            "max_own_score_err": float(np.abs(np.where(known, got_vals - own, 0.0)).max()),
            "max_below_plain_kth": float(np.where(known, ref_vals[:, -1:] - own, 0.0).max()),
            "unknown_texts": int((~known).sum())}


def rag_rerank_check(ce, traffic: RagTraffic) -> dict:
    """The rerank program's scores against a direct ``CrossEncoder.score``
    of the same pairs (in ``CrossEncoderReranker``'s micro-batches of 256),
    within 0.05·(max|ref|+1); each kept top 5 against the direct scores'
    top 5, parting only at ties within that tol."""
    pairs = [(q, d) for q, d, _s in traffic.scored]
    got = np.array([s for _q, _d, s in traffic.scored])
    ref = np.concatenate([ce.score(pairs[mb.start : mb.stop]) for mb in micro_batches(len(pairs))])
    tol = score_tol(ref)
    ref_of = {(q, d): r for (q, d), r in zip(pairs, ref)}
    parted = 0
    below = 0.0
    for q in traffic.corpus["questions"]:
        mine = sorted((r for (qq, _d), r in ref_of.items() if qq == q), reverse=True)
        kth = mine[RERANK_KEEP - 1]
        kept_docs, _scores = traffic.kept[q]
        want = {d for (qq, d), r in ref_of.items() if qq == q and r >= kth}
        if set(kept_docs) != want:
            parted += 1
            below = max(below, max(kth - ref_of[(q, d)] for d in kept_docs))
    return {"pairs": len(pairs), "max_abs_err": float(np.abs(got - ref).max()), "tol": tol,
            "sets_parted": parted, "parted_max_below_kth": below,
            "pairs_per_query": len(pairs) / max(1, len(traffic.kept))}


def rag_phase(device, seed: int, checked: dict, card: str, sizes: RagSizes = RagSizes()) -> dict:
    """Phase 15b: BASELINE.md's Adaptive RAG template served over
    ``pw.io.http``: ``AdaptiveRAGQuestionAnswerer`` over ``JaxChat`` on
    mistral-7b-instruct (seeded bf16 weights) and a ``DocumentStore`` of
    MiniLM embeddings of ``pw.io.fs.read(mode="static")`` files,
    ``build_server`` then ``run_server(threaded=True, with_cache=False)``,
    driven by a standard-library HTTP client, with a retrieve-then-rerank
    Table program (``CrossEncoderReranker``, ``rerank_topk_filter``) on the
    same store.  ``checked`` gains the attention shapes the run gave the
    kernel.  The run ends when the client closes the server."""
    import shutil
    import socket
    import tempfile
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import dataflow as df
    from pathway_tpu_torch.engine import metrics, serving, tracing
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.models.encoder import init_params
    from pathway_tpu_torch.ops.attention import encoder_attention
    from pathway_tpu_torch.serving import generation
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm import AdaptiveRAGQuestionAnswerer, DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.llms import JaxChat
    from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker, rerank_topk_filter
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    on_card = torch.device(device).type == "cuda"
    kw = {} if on_card else {"device": str(device)}
    t_setup = time.perf_counter()
    corpus = rag_corpus(seed, sizes)
    root = tempfile.mkdtemp(prefix="rag_")
    docs_dir = os.path.join(root, "docs")
    os.makedirs(docs_dir)
    for i, text in enumerate(corpus["texts"]):
        with open(os.path.join(docs_dir, f"doc{i:05d}.txt"), "w") as f:
            f.write(text)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # the scheduler JaxChat reaches (same key), built here so that its
    # submissions are recorded; seeded bf16 weights at full width
    sched = generation.shared_scheduler(sizes.model, max_cache=sizes.cache, device=kw.get("device"))
    lm = sched.lm
    if seed:
        lm.params = dec.init_decoder_params(lm.config, seed, lm.device)
    records: list = []  # (prompt, GenRequest) of every submission

    def recording_submit(prompt, **kwargs):
        from concurrent.futures import Future

        req = sched.submit_request(lm._encode_prompt(prompt), **kwargs)
        records.append((prompt, req))
        outer: Future = Future()

        def done(f):
            exc = f.exception()
            if exc is not None:
                outer.set_exception(exc)
            else:
                outer.set_result(lm.tokenizer.decode(f.result()))

        req.future.add_done_callback(done)
        return outer

    sched.submit = recording_submit
    with env_knobs(PATHWAY_SERVE_INFLIGHT=RAG_INFLIGHT, PATHWAY_SERVE_QUEUE=RAG_QUEUE):
        serving.reset_for_tests()  # a controller of this phase's budget, built from the knobs
        controller = serving.get_controller()
    tracing.reset_for_tests()

    embedder = SentenceTransformerEmbedder(VS_MODEL, **kw)  # max batch 256
    enc = embedder._encoder
    enc.set_params(init_params(enc.config, seed))
    store = DocumentStore(pw.io.fs.read(docs_dir, format="binary", mode="static", with_metadata=True),
                          BruteForceKnnFactory(embedder=embedder, **kw), parser=ParseUtf8(),
                          splitter=TokenCountSplitter())
    chat = JaxChat(sizes.model, max_new_tokens=sizes.new_tokens, max_cache=sizes.cache, **kw)
    rag = AdaptiveRAGQuestionAnswerer(chat, store, n_starting_documents=RAG_STARTING, factor=RAG_FACTOR,
                                      max_iterations=RAG_ITERATIONS)
    rag.build_server("127.0.0.1", port)
    reranker = CrossEncoderReranker(RERANK_MODEL, **kw)
    ce = reranker._ce
    ce.set_params(init_params(ce.config, seed, head=True))
    traffic = RagTraffic(corpus, sizes, len(corpus["chunk_ids"]))
    traffic.url, traffic.server = f"http://127.0.0.1:{port}", rag.server
    rq = pw.io.python.read(traffic.rerank_subject(pw), schema=DocumentStore.RetrieveQuerySchema)
    hits = rq.with_columns(docs=store.retrieve_query(rq).result)
    pairs = hits.select(pw.this.query, doc=pw.apply(lambda d: tuple(pw.Json(x) for x in d.value),
                                                   pw.this.docs)).flatten(pw.this.doc)
    scored = pairs.select(pw.this.query, pw.this.doc, score=reranker(pw.this.doc, pw.this.query))
    grouped = scored.groupby(pw.this.query).reduce(pw.this.query, docs=pw.reducers.tuple(pw.this.doc),
                                                   scores=pw.reducers.tuple(pw.this.score))
    kept = grouped.select(pw.this.query, top=rerank_topk_filter(pw.this.docs, pw.this.scores, k=RERANK_KEEP))
    pw.io.subscribe(store.chunked_docs, on_change=traffic.on_chunk, on_time_end=traffic.on_chunk_epoch)
    pw.io.subscribe(scored, on_change=traffic.on_scored)
    pw.io.subscribe(kept, on_change=traffic.on_kept)
    setup_s = time.perf_counter() - t_setup

    seen: dict[tuple, int] = {}
    removers = [h.remove for h in (record_launches(m, seen) for m in (enc, ce))]
    events: list = []
    paged = {"prefill": dec.paged_prefill_chunk, "decode": dec.paged_decode_step}
    dec_events: dict[str, list] = {name: [] for name in paged}
    if on_card:
        for m in (enc, ce):
            ev, remove = forward_events(m)
            events.append(ev)
            removers.append(remove)

        def timed(fn, ev):
            def call(*a, **k):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **k)
                end.record()
                ev.append([start, end])
                return out
            return call

        dec.paged_prefill_chunk = timed(paged["prefill"], dec_events["prefill"])
        dec.paged_decode_step = timed(paged["decode"], dec_events["decode"])
    epochs: list[tuple[float, float]] = []
    run_epoch = df.Scope.run_epoch

    def timed_epoch(scope, time_):
        t0 = time.perf_counter()
        try:
            return run_epoch(scope, time_)
        finally:
            if scope.parent is None:
                epochs.append((t0, (time.perf_counter() - t0) * 1e3))

    run_errors: list = []
    excepthook = threading.excepthook

    def on_thread_error(args):
        if args.thread is not None and args.thread.name == "pathway:server":
            run_errors.append(repr(args.exc_value))
        else:
            excepthook(args)

    client = threading.Thread(target=traffic.drive, args=(rag.server.webserver, rag.server._routes, records),
                              name="rag:client", daemon=True)
    df.Scope.run_epoch = timed_epoch
    threading.excepthook = on_thread_error
    before = rail_state(device) if on_card else None
    # ---- the counted run: counts zeroed just before, read just after ----
    encoder_attention.launches = 0
    seen.clear()
    try:
        t_run = _now()
        server_thread = rag.run_server(threaded=True, with_cache=False)
        client.start()
        client.join(timeout=RAG_WAIT_S * 4)
        server_thread.join(timeout=RAG_WAIT_S)
        wall_s = _now() - t_run
    finally:
        df.Scope.run_epoch = run_epoch
        threading.excepthook = excepthook
        dec.paged_prefill_chunk, dec.paged_decode_step = paged["prefill"], paged["decode"]
        pw.G.clear()
    launches = {"encoder_attention": encoder_attention.launches}
    # ---- end of the counted run ----
    for remove in removers:
        remove()
    if client.is_alive() or server_thread.is_alive() or traffic.failure or run_errors:
        fail(f"rag: the served run did not end cleanly: client alive {client.is_alive()}, run alive "
             f"{server_thread.is_alive()}, {traffic.failure or ''} {run_errors}")
    rail = rail_gate("rag", device, before) if on_card else {}
    enc_ms = sum(events_ms(ev) for ev in events) if on_card else None
    dec_ms = {name: events_ms(ev) for name, ev in dec_events.items()} if on_card else {}
    device_ms = (enc_ms + sum(dec_ms.values())) if on_card else None
    try:  # the listening socket is closed: a connection is refused
        socket.create_connection(("127.0.0.1", port), timeout=5).close()
        socket_closed = False
    except OSError:
        socket_closed = True

    # -- what the client saw ---------------------------------------------
    statuses: dict[str, dict] = {}
    latency: dict[str, list] = {}
    for stage, calls in traffic.calls.items():
        for route, _payload, res in calls:
            key = f"{stage}:{route}"
            statuses.setdefault(key, {})
            statuses[key][str(res["status"])] = statuses[key].get(str(res["status"]), 0) + 1
            if stage in ("retrieve", "answer"):
                latency.setdefault(route, []).append(res["ms"])
    expected = {"retrieve:/v1/retrieve": {"200": sizes.questions}, "retrieve:/v1/statistics": {"200": 1},
                "retrieve:/v2/list_documents": {"200": 1}, "answer:/v1/pw_ai_answer": {"200": sizes.questions},
                "answer:/v1/pw_ai_summary": {"200": sizes.summaries}, "typed:/v1/pw_ai_answer": {"400": 1},
                "typed:/v1/no_such_route": {"404": 1}, "typed:/v1/retrieve": {"504": 1}}
    burst = statuses.pop("burst:/v1/pw_ai_summary", {})
    rejected = [res for _r, _p, res in traffic.calls.get("burst", ()) if res["status"] == 429]
    retry_after = sorted({res["headers"].get("Retry-After") for res in rejected}, key=str)
    reg = metrics.get_registry()
    qwait = reg.histogram("serve.queue.wait.ms", buckets=metrics.MS_BUCKETS)
    spans: dict[str, list] = {}
    for trace in tracing.recent_requests(10**6):
        for sp in trace["spans"]:
            spans.setdefault(sp["name"], []).append(sp["duration_s"] * 1e3)
    main = [req for _p, req in records[: traffic.burst_from]]
    ttft = [req.ttft_s * 1e3 for req in main if req.ttft_s is not None]
    gen_s = max(r.finished_at for r in main) - min(r.submitted_at for r in main)
    snap = sched.snapshot()
    epochs_ms = [ms for _t, ms in epochs]
    stats = next(res["body"] for r, _p, res in traffic.calls["retrieve"] if r == "/v1/statistics")
    listed = next(res["body"] for r, _p, res in traffic.calls["retrieve"] if r == "/v2/list_documents")
    res = {
        "card": card, "files": sizes.files, "chunks": len(corpus["chunk_ids"]), "model": sizes.model,
        "max_cache": sizes.cache, "new_tokens": sizes.new_tokens, "setup_s": setup_s, "wall_s": wall_s,
        "ingest_s": traffic.t_indexed - t_run if traffic.t_indexed else None,
        "statuses": statuses, "burst": burst, "burst_retry_after": retry_after,
        "latency_ms": {route: percentiles(v) for route, v in sorted(latency.items())},
        "ttft_ms": percentiles(ttft), "tokens_per_s": sum(len(r.out) for r in main) / gen_s,
        "sched": {k: snap[k] for k in ("requests", "tokens_total", "prefill_chunks", "decode_steps",
                                        "prompts_truncated", "deadline_shed", "kv_bytes_peak")},
        "admission": {"queue_wait_ms_p50": qwait.quantile(0.5), "queue_wait_ms_p99": qwait.quantile(0.99),
                      "queued": qwait.snapshot()[3], "limits": controller.snapshot()["limits"]},
        "span_ms_p50": {name: float(np.median(v)) for name, v in sorted(spans.items())},
        "traces": tracing.snapshot()["buffered"],
        "epochs": len(epochs_ms), "host_ms_per_epoch": percentiles(epochs_ms) if epochs_ms else {},
        "host_ms_epochs_total": sum(epochs_ms), "encoder_device_ms": enc_ms, "decoder_device_ms": dec_ms,
        "device_ms": device_ms, "idle_share": 1.0 - device_ms / (wall_s * 1e3) if on_card else None,
        "statistics": stats, "listed_documents": len(listed), "socket_closed": socket_closed,
        "rerank_pairs": len(traffic.scored), "error_rows": traffic.errors,
    }
    t_check = time.perf_counter()
    with torch.inference_mode():
        res["retrieve_check"] = rag_retrieve_check(enc, traffic, device)
        res["rerank_check"] = rag_rerank_check(ce, traffic)
        res["answer_check"] = rag_answers_check(lm, traffic, records, sizes)
    res["check_s"] = time.perf_counter() - t_check
    log("rag", **res, kernel_launches=launches)
    shutil.rmtree(root, ignore_errors=True)
    # free the decoder before the next phase: the scheduler's pool, the
    # shared decoder and every reference the phase held
    generation.reset_shared_schedulers()
    dec.shared_decoder.cache_clear()
    del lm, sched, chat, rag, records
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    problems = [f"{k} answered {statuses.get(k)}, not {v}" for k, v in expected.items() if statuses.get(k) != v]
    if set(burst) - {"200", "429"} or not burst.get("429") or sum(burst.values()) != sizes.burst:
        problems.append(f"the burst of {sizes.burst} past the budget answered {burst}")
    if None in retry_after or not retry_after:
        problems.append(f"a 429 came without Retry-After: {retry_after}")
    if stats.get("file_count") != sizes.files or len(listed) != sizes.files:
        problems.append(f"statistics {stats} and {len(listed)} listed documents, not {sizes.files}")
    r = res["retrieve_check"]
    if r["unknown_texts"] or r["max_own_score_err"] > SCORE_TOL or r["max_score_err"] > SCORE_TOL \
            or r["max_below_plain_kth"] > VS_TIE_TOL:
        problems.append(f"/v1/retrieve against the plain answer: {r}")
    rr = res["rerank_check"]
    if rr["pairs"] != sizes.questions * RAG_RERANK_K or rr["max_abs_err"] > rr["tol"] \
            or rr["parted_max_below_kth"] > rr["tol"]:
        problems.append(f"the rerank program against CrossEncoder.score: {rr}")
    problems += res["answer_check"]["problems"]
    if res["answer_check"]["second_rounds"]:
        log("rag", step="second_rounds", questions=res["answer_check"]["second_rounds"])
    if snap["prompts_truncated"]:
        problems.append(f"{snap['prompts_truncated']} prompt(s) passed the cache budget and were cut")
    if traffic.errors:
        problems.append(f"{traffic.errors} rows hold ERROR")
    if not socket_closed:
        problems.append(f"port {port} still accepts connections after close()")
    if on_card:
        expected_launches = sum(seen.values())
        if launches["encoder_attention"] != expected_launches or not expected_launches:
            problems.append(f"attention launches {launches['encoder_attention']} != {expected_launches} "
                            f"(layers x forwards per shape {seen})")
    if problems:
        fail("rag: " + "; ".join(problems))
    if on_card:
        gen = torch.Generator(device=device).manual_seed(seed + 305)
        for shape in sorted(set(seen) - set(checked)):
            checked[shape] = check_attention_shape(gen, shape, device)
        log("rag", step="shapes", card=card, launches={str(list(sh)): n for sh, n in sorted(seen.items())},
            max_abs_err={str(list(sh)): checked[sh] for sh in sorted(seen)})
    return {"launches": launches, "attention_launches": dict(seen), "rail": rail, **res}


# ---------------------------------------------------------------------------
# Phase 15c: BASELINE.md's fourth configuration: hybrid BM25 + HNSW retrieval
# reranked by ms-marco (the index slice of stdlib/indexing).
# ---------------------------------------------------------------------------

HY_ZIPF = 1.0  # the words' Zipf exponent: BM25's idf and postings follow term skew
HY_FETCH = 3  # each inner index of a hybrid search fetches k·3 (stdlib/indexing/hybrid_index.py:30)
HY_RRF_K = 60.0  # HybridIndexFactory's k (stdlib/indexing/retrievers.py)
HY_RECALL_MIN = 0.9  # the HNSW recall pin (tests/test_hnsw.py:43)
# USearch's expansion_search: the recall pin is taken at 96 (tests/test_hnsw.py:30); at the default
# 64 a fetch of 48 leaves the beam 16 wider than k (recall@48 0.887-0.895 here, PERF.md section 6)
HY_EF = 96
HY_EF_SWEEP = (48, 64, 96, 128)
HY_HNSW_SCORE_TOL = 1e-4  # an HNSW score against the exact f32 cosine of its stored vectors
HY_BM25_REL = 1e-9  # a BM25 score against the plain BM25's, relative
BM25_K1, BM25_B = 1.2, 0.75  # BM25Index's defaults (stdlib/indexing/bm25.py:29)
HY_WAIT_S = 300.0  # the longest any stage may wait on the run


@dataclasses.dataclass(frozen=True)
class HybridSizes:
    """The ``[hybrid]`` phase's scale (the defaults: BASELINE.md's fourth
    configuration at full width, a quarter of its corpus and question
    count: at 4,096 files and 512 questions the phase took 184.1-349.6 s,
    and the script passed its limit, PERF.md sections 4-5)."""

    files: int = 1024
    words: tuple = (100, 1000)  # words per file
    questions: int = 128
    commits: int = 4  # the questions arrive in this many commits
    question_words: tuple = (8, 32)
    k: int = 16  # retrieve_query's k: each inner index fetches 48
    deleted: int = 64  # files whose chunks the change deletes
    rewritten: int = 64  # files the change rewrites with new text


def zipf_texts(n: int, seed: int, words_per_text: tuple[int, int]):
    """``n`` texts whose words are drawn Zipf-distributed (exponent
    ``HY_ZIPF``, rank = position) over ``synthetic_corpus``'s 20,000-word
    vocabulary of ``seed``: the texts, each text's word ids, the vocabulary."""
    _texts, _lengths, _ids, vocab = synthetic_corpus(0, seed)
    rng = np.random.default_rng(seed + 1)
    p = 1.0 / np.arange(1, len(vocab) + 1) ** HY_ZIPF
    lengths = rng.integers(words_per_text[0], words_per_text[1] + 1, size=n)
    words = rng.choice(len(vocab), size=int(lengths.sum()), p=p / p.sum())
    texts, ids, at = [], [], 0
    for length in lengths:
        ids.append(words[at : at + length])
        texts.append(" ".join(vocab[w] for w in ids[-1]))
        at += length
    return texts, ids, vocab


def hybrid_corpus(seed: int, sizes: HybridSizes) -> dict:
    """The files (their texts, then the rewritten files' new texts), the
    change (files deleted, files rewritten), the chunks
    (``TokenCountSplitter()``'s 500-word spans) live before and after it,
    and the questions: spans of 8-32 words of live chunks with a quarter of
    the words swapped, as ``rag_corpus`` makes them."""
    n_texts = sizes.files + sizes.rewritten
    texts, ids, vocab = zipf_texts(n_texts, seed + 401, sizes.words)
    rng = np.random.default_rng(seed + 403)
    picked = [int(i) for i in rng.permutation(sizes.files)[: sizes.deleted + sizes.rewritten]]
    deleted, rewritten = picked[: sizes.deleted], picked[sizes.deleted :]
    new_text = {i: sizes.files + j for j, i in enumerate(rewritten)}
    chunk_ids: dict[str, int] = {}
    chunk_words: list = []
    doc_chunks: dict[int, list[int]] = {}
    for t in range(n_texts):
        cids = []
        for words in plain_chunks(ids[t]):
            cid = chunk_ids.setdefault(" ".join(vocab[w] for w in words), len(chunk_ids))
            if cid == len(chunk_words):
                chunk_words.append(words)
            cids.append(cid)
        doc_chunks[t] = cids
    gone = set(deleted)
    initial = sorted({c for i in range(sizes.files) for c in doc_chunks[i]})
    final = sorted({c for i in range(sizes.files) if i not in gone for c in doc_chunks[new_text.get(i, i)]})
    questions: list[str] = []
    while len(questions) < sizes.questions:
        words = chunk_words[initial[int(rng.integers(len(initial)))]]
        n = min(int(rng.integers(sizes.question_words[0], sizes.question_words[1] + 1)), len(words))
        start = int(rng.integers(0, len(words) - n + 1))
        span = np.array(words[start : start + n])
        swap = rng.random(n) < QUERY_SWAP
        span[swap] = rng.integers(0, len(vocab), size=int(swap.sum()))
        q = " ".join(vocab[w] for w in span)
        if q not in questions:
            questions.append(q)
    return {"texts": texts, "deleted": deleted, "rewritten": rewritten, "new_text": new_text,
            "chunk_texts": sorted(chunk_ids, key=chunk_ids.get), "initial": initial, "final": final,
            "questions": questions}


def hybrid_store(pw, docs, embedder, dimensions=None):
    """BASELINE.md's fourth configuration's store, in either package
    (``pw``): ``DocumentStore(docs, HybridIndexFactory([UsearchKnnFactory
    (embedder), TantivyBM25Factory()]))`` over ``ParseUtf8`` and
    ``TokenCountSplitter()``, with the defaults' k 60 and HNSW M 16 and
    efC 128, and ef ``HY_EF``."""
    import importlib

    idx = importlib.import_module(pw.__name__ + ".stdlib.indexing")
    llm = importlib.import_module(pw.__name__ + ".xpacks.llm")
    factory = idx.HybridIndexFactory(retriever_factories=[
        idx.UsearchKnnFactory(embedder=embedder, dimensions=dimensions, expansion_search=HY_EF),
        idx.TantivyBM25Factory()])
    return llm.DocumentStore(docs, factory, parser=llm.parsers.ParseUtf8(),
                             splitter=llm.splitters.TokenCountSplitter())


def hybrid_hits(pw, store, queries):
    """The questions' retrieval, in either package: (query, docs)."""
    return queries.with_columns(docs=store.retrieve_query(queries).result).select(pw.this.query, pw.this.docs)


def rerank_program(pw, hits, reranker) -> dict:
    """``hits``' documents reranked: ``scored`` (one row a (query, doc)
    pair) and ``kept`` (``rerank_topk_filter``'s best ``RERANK_KEEP``)."""
    from pathway_tpu_torch.xpacks.llm.rerankers import rerank_topk_filter

    pairs = hits.select(pw.this.query, doc=pw.apply(lambda d: tuple(pw.Json(x) for x in d.value),
                                                   pw.this.docs)).flatten(pw.this.doc)
    scored = pairs.select(pw.this.query, pw.this.doc, score=reranker(pw.this.doc, pw.this.query))
    grouped = scored.groupby(pw.this.query).reduce(
        pw.this.query, docs=pw.reducers.tuple(pw.this.doc), scores=pw.reducers.tuple(pw.this.score))
    return {"scored": scored,
            "kept": grouped.select(pw.this.query, top=rerank_topk_filter(pw.this.docs, pw.this.scores, k=RERANK_KEEP))}


class HybridProbe:
    """Wraps the engine-side indexes of ``pw``'s hybrid index (its
    ``_HybridEngineIndex``, ``NativeHnswIndex``, ``PyHnswIndex`` and
    ``BM25Index``) while installed: each search's query, inner lists as they
    came back, fused list and host ms, and each indexed chunk's vector as
    the native store holds it."""

    def __init__(self, pw):
        import importlib

        pkg = pw.__name__ + ".stdlib.indexing."
        self.hybrid = importlib.import_module(pkg + "hybrid_index")._HybridEngineIndex
        hnsw = importlib.import_module(pkg + "hnsw")
        self.inner = [hnsw.NativeHnswIndex, hnsw.PyHnswIndex, importlib.import_module(pkg + "bm25").BM25Index]
        self.saved: list = []
        self.key_text: dict = {}  # engine key -> the chunk text it holds
        self.stored: dict[str, np.ndarray] = {}  # chunk text -> its vector in the native store
        self.dense_types: set = set()
        self.dense = None  # the hybrid index's dense inner index
        self.searches: list[dict] = []
        self.after = False  # set when the change is sent
        self._inner: list | None = None

    def _wrap(self, cls, name, make):
        self.saved.append((cls, name, cls.__dict__[name]))
        setattr(cls, name, make(cls.__dict__[name]))

    def install(self) -> None:
        probe = self

        def add(orig):
            def call(index, key, data, filter_data=None):
                orig(index, key, data, filter_data)
                probe.key_text[key] = data[1]
                dense = probe.dense = index.inners[0]
                probe.dense_types.add(type(dense).__name__)
                if hasattr(dense, "_node_of_key"):
                    vec = dense._nat.hnsw_get_vector(dense._h, dense._node_of_key[key])
                    probe.stored[data[1]] = np.frombuffer(vec, np.float32).copy()
            return call

        def remove(orig):
            def call(index, key):
                orig(index, key)
                probe.key_text.pop(key, None)
            return call

        def search(orig):
            def call(index, query, k, filter_query=None):
                probe._inner = []
                t0 = time.perf_counter()
                out = orig(index, query, k, filter_query)
                ms = (time.perf_counter() - t0) * 1e3
                inner, probe._inner = probe._inner, None
                text = probe.key_text.get
                probe.searches.append({
                    "query": query[1], "qvec": np.asarray(query[0], np.float32).reshape(-1), "k": k,
                    "after": probe.after, "ms": ms, "fused_keys": list(out),
                    "fused": [(text(key), s) for key, s in out],
                    "inner_keys": [list(res) for _n, res, _ms in inner],
                    "inner": {name: [(text(key), s) for key, s in res] for name, res, _ms in inner},
                    "inner_ms": {name: ms_ for name, _res, ms_ in inner}})
                return out
            return call

        def inner_search(name):
            def make(orig):
                def call(index, query, k, filter_query=None, *args, **kwargs):
                    t0 = time.perf_counter()
                    out = orig(index, query, k, filter_query, *args, **kwargs)
                    if probe._inner is not None:
                        probe._inner.append((name, out, (time.perf_counter() - t0) * 1e3))
                    return out
                return call
            return make

        self._wrap(self.hybrid, "add", add)
        self._wrap(self.hybrid, "remove", remove)
        self._wrap(self.hybrid, "search", search)
        for cls, name in zip(self.inner, ("hnsw", "hnsw", "bm25")):
            self._wrap(cls, "search", inner_search(name))

    def uninstall(self) -> None:
        for cls, name, orig in reversed(self.saved):
            setattr(cls, name, orig)
        self.saved.clear()


def rrf(lists, k: int, rrf_k: float = HY_RRF_K) -> list:
    """Reciprocal rank fusion of inner result lists, as the hybrid index
    fuses them: each key gains 1/(rrf_k + rank + 1) a list, best k kept."""
    fused: dict = {}
    for results in lists:
        for rank, (key, _score) in enumerate(results):
            fused[key] = fused.get(key, 0.0) + 1.0 / (rrf_k + rank + 1)
    return sorted(fused.items(), key=lambda e: -e[1])[:k]


class PlainBM25:
    """Okapi BM25 in numpy over a fixed list of chunk texts (k1 1.2, b 0.75,
    ``\\w+`` lower-cased tokens, each query token counted as often as it
    occurs), for any live subset of them: the plain version of the hybrid
    index's BM25."""

    def __init__(self, texts: list[str]):
        import re

        word = re.compile(r"\w+")
        vocab: dict[str, int] = {}
        docs, terms = [], []
        for d, text in enumerate(texts):
            toks = [vocab.setdefault(w.lower(), len(vocab)) for w in word.findall(text)]
            docs.append(np.full(len(toks), d, np.int64))
            terms.append(np.array(toks, np.int64))
        self.vocab, self.word = vocab, word
        docs, terms = np.concatenate(docs), np.concatenate(terms)
        self.dl = np.bincount(docs, minlength=len(texts)).astype(np.float64)
        pair, tf = np.unique(terms * len(texts) + docs, return_counts=True)
        self.post_doc, self.post_tf = pair % len(texts), tf.astype(np.float64)
        self.ptr = np.searchsorted(pair // len(texts), np.arange(len(vocab) + 1))

    def scores(self, query: str, live: np.ndarray) -> np.ndarray:
        """Every chunk's score for ``query`` over the chunks of the bool mask
        ``live`` (0 off it), in the index's order of float operations."""
        n_docs = int(live.sum())
        avgdl = float(self.dl[live].sum()) / n_docs
        out = np.zeros(len(self.dl))
        for w in self.word.findall(query):
            t = self.vocab.get(w.lower())
            if t is None:
                continue
            rows, tf = self.post_doc[self.ptr[t] : self.ptr[t + 1]], self.post_tf[self.ptr[t] : self.ptr[t + 1]]
            on = live[rows]
            rows, tf = rows[on], tf[on]
            if not len(rows):
                continue
            idf = math.log(1 + (n_docs - len(rows) + 0.5) / (len(rows) + 0.5))
            out[rows] += idf * tf * (BM25_K1 + 1) / (tf + BM25_K1 * (1 - BM25_B + BM25_B * self.dl[rows] / avgdl))
        return out


class HybridTraffic:
    """The ``[hybrid]`` run's two sources and what its subscribers see.

    The documents' subject sends every file in one commit; once the chunk
    table holds the initial corpus, the questions' subject sends its
    commits of questions, each answered and reranked before the next; then
    the documents' subject sends the change (deletions and rewrites) in one
    commit and ends once the chunk table holds the final corpus.  The run
    ends when both sources have.  A wait past ``HY_WAIT_S`` interrupts it."""

    def __init__(self, corpus: dict, sizes: HybridSizes):
        import threading

        self.corpus, self.sizes = corpus, sizes
        texts = corpus["chunk_texts"]
        self.initial = {texts[c] for c in corpus["initial"]}
        self.final = {texts[c] for c in corpus["final"]}
        per = sizes.questions // sizes.commits
        self.batches = [corpus["questions"][c * per : (c + 1) * per] for c in range(sizes.commits)]
        self.batch_of = {q: c for c, batch in enumerate(self.batches) for q in batch}
        self.batch_left = [len(b) for b in self.batches]
        self.batch_done = [threading.Event() for _ in self.batches]
        self.indexed, self.settled = threading.Event(), threading.Event()
        self.live_chunks: dict[str, int] = {}
        self.t_docs = self.t_indexed = self.t_change = self.t_settled = self.t_last_revision = None
        self.t_commit: list = [None] * sizes.commits
        self.first: dict[str, float] = {}  # question -> time of its first answer
        self.hits: dict[str, list] = {}  # question -> its live answers ((text, score), ...)
        self.kept: dict[str, list] = {}  # question -> its live kept (texts, scores)
        self.scored: list[tuple] = []  # (question, doc text, score) of every pair scored
        self.revised: set = set()  # questions whose answer changed after their first
        self.errors = 0
        self.failure: str | None = None
        self.probe: HybridProbe | None = None

    # -- subscribers ---------------------------------------------------
    def on_chunk(self, key, row, time, is_addition):
        import pathway_tpu_torch as pw

        if row["text"] is pw.ERROR:
            self.errors += 1
            return
        n = self.live_chunks.get(row["text"], 0) + (1 if is_addition else -1)
        if n:
            self.live_chunks[row["text"]] = n
        else:
            del self.live_chunks[row["text"]]

    def on_chunk_epoch(self, time):
        live = set(self.live_chunks)
        if not self.indexed.is_set() and live == self.initial:
            self.t_indexed = _now()
            self.indexed.set()
        if self.t_change is not None and not self.settled.is_set() and live == self.final:
            self.t_settled = _now()
            self.settled.set()

    def on_hits(self, key, row, time, is_addition):
        import pathway_tpu_torch as pw

        now = _now()
        if row["docs"] is pw.ERROR:
            self.errors += 1
            return
        q = row["query"]
        hits = tuple((h["text"], -float(h["dist"])) for h in row["docs"].value)
        live = self.hits.setdefault(q, [])
        if is_addition:
            live.append(hits)
        else:
            live.remove(hits)
        if not is_addition or q in self.first:
            self.revised.add(q)
            self.t_last_revision = now
        elif q not in self.first:
            self.first[q] = now

    def on_scored(self, key, row, time, is_addition):
        import pathway_tpu_torch as pw

        if row["score"] is pw.ERROR:
            self.errors += 1
        elif is_addition:
            self.scored.append((row["query"], row["doc"].value["text"], float(row["score"])))

    def on_kept(self, key, row, time, is_addition):
        import pathway_tpu_torch as pw

        if row["top"] is pw.ERROR:
            self.errors += 1
            return
        q = row["query"]
        docs, scores = row["top"]
        kept = (tuple(d.value["text"] for d in docs), tuple(scores))
        live = self.kept.setdefault(q, [])
        if not is_addition:
            live.remove(kept)
            return
        live.append(kept)
        b = self.batch_of[q]
        if len(live) == 1 and self.t_change is None:
            self.batch_left[b] -= 1
            if not self.batch_left[b]:
                self.batch_done[b].set()

    # -- the sources -----------------------------------------------------
    def wait(self, event, what: str) -> None:
        import _thread

        if not event.wait(HY_WAIT_S):
            self.failure = (f"{what} took over {HY_WAIT_S} s ({len(self.live_chunks)} live chunks, "
                            f"{len(self.first)} questions answered)")
            _thread.interrupt_main()
            raise SystemExit

    def subjects(self, pw):
        traffic, corpus, sizes = self, self.corpus, self.sizes

        def meta(i):
            return pw.Json({"path": f"doc{i:05d}.txt"})

        def row(i, text):
            return {"data": text.encode(), "_metadata": meta(i)}

        class Docs(pw.io.python.ConnectorSubject):
            def run(self):
                traffic.t_docs = _now()
                for i in range(sizes.files):
                    self.next(_pw_key=i, **row(i, corpus["texts"][i]))
                self.commit()
                traffic.wait(traffic.batch_done[-1], "answering the questions")
                if traffic.probe is not None:
                    traffic.probe.after = True
                traffic.t_change = _now()
                for i in corpus["deleted"]:
                    self._remove(i, row(i, corpus["texts"][i]))
                for i in corpus["rewritten"]:
                    self._remove(i, row(i, corpus["texts"][i]))
                    self.next(_pw_key=i, **row(i, corpus["texts"][corpus["new_text"][i]]))
                self.commit()
                traffic.wait(traffic.settled, "showing the change")

        class Questions(pw.io.python.ConnectorSubject):
            def run(self):
                traffic.wait(traffic.indexed, "indexing the corpus")
                for c, batch in enumerate(traffic.batches):
                    for q in batch:
                        self.next(query=q, k=sizes.k, metadata_filter=None, filepath_globpattern=None)
                    self.commit()
                    traffic.t_commit[c] = _now()
                    traffic.wait(traffic.batch_done[c], f"commit {c} of the questions")

        return Docs(), Questions()


def plain_embeddings(enc, texts: list[str], device) -> np.ndarray:
    """``texts`` through ``enc``'s weights on the plain attention path, in
    length-sorted batches small enough for its f32 scores."""
    from pathway_tpu_torch.models.encoder import fused_sentence_apply
    from pathway_tpu_torch.models.tokenizer import bucket_seq_len, pad_batch
    from pathway_tpu_torch.ops.attention import encoder_attention_reference

    cfg, tree = enc.config, enc.model.tree()
    id_lists = [enc.tokenizer.encode(t) for t in texts]
    order = np.argsort([len(x) for x in id_lists], kind="stable")
    out = np.empty((len(texts), enc.dimensions), np.float32)
    at = 0
    while at < len(order):
        seq = bucket_seq_len(len(id_lists[order[min(at + 255, len(order) - 1)]]))
        rows = min(256, plain_rows((256, seq, cfg.hidden, cfg.heads)))
        ids = order[at : at + rows]
        tok, mask = pad_batch([id_lists[i] for i in ids], bucket_seq_len(max(len(id_lists[i]) for i in ids)))
        out[ids] = fused_sentence_apply(tree, torch.from_numpy(tok).to(device), torch.from_numpy(mask).to(device),
                                        cfg, attention=encoder_attention_reference).float().cpu().numpy()
        at += rows
    return out


def plain_cross_scores(ce, pairs: list[tuple], device) -> np.ndarray:
    """``pairs`` scored by ``ce``'s weights on the plain attention path, in
    ``CrossEncoderReranker``'s micro-batches of 256, each padded to its
    longest pair and cut to rows whose f32 scores fit."""
    from pathway_tpu_torch.models.encoder import fused_cross_apply
    from pathway_tpu_torch.models.tokenizer import bucket_seq_len, pad_batch
    from pathway_tpu_torch.ops.attention import encoder_attention_reference

    cfg, tree = ce.config, ce.model.tree()
    out = np.empty(len(pairs), np.float32)
    for mb in micro_batches(len(pairs)):
        id_lists = [ce.tokenizer.encode_pair(*pairs[i]) for i in mb]
        ids, mask = pad_batch(id_lists, bucket_seq_len(max(len(x) for x in id_lists)))
        rows = plain_rows((len(mb), ids.shape[1], cfg.hidden, cfg.heads))
        for a in range(0, len(mb), rows):
            out[np.array(mb[a : a + rows])] = fused_cross_apply(
                tree, torch.from_numpy(ids[a : a + rows]).to(device), torch.from_numpy(mask[a : a + rows]).to(device),
                cfg, attention=encoder_attention_reference).float().cpu().numpy()
    return out


def hybrid_checks(probe: HybridProbe, traffic: HybridTraffic, enc, ce, device) -> dict:
    """Every gate of ``[hybrid]`` against a plain version: the stored
    embeddings against the plain attention path; each question's first
    search and its last after the change: HNSW against the exact f32 cosine
    top-48 of the stored vectors live then, BM25 against ``PlainBM25`` over
    the chunks live then, the fusion against ``rrf`` of its inner lists (every
    search); the final answers against their last fused list and free of the
    change's removed chunks; the rerank scores against the plain path and
    each final kept 5 against the plain top 5 but at near-ties."""
    corpus = traffic.corpus
    texts = corpus["chunk_texts"]
    cid = {t: i for i, t in enumerate(texts)}
    res: dict = {"problems": []}
    problems = res["problems"]

    stored_texts = sorted(probe.stored)
    plain = plain_embeddings(enc, stored_texts, device)
    got = np.stack([probe.stored[t] for t in stored_texts])
    cos = (plain * got).sum(1) / (np.linalg.norm(plain, axis=1) * np.linalg.norm(got, axis=1))
    res["embeddings"] = {"chunks": len(stored_texts), "min_cos": float(cos.min())}
    if cos.min() <= COS_MIN:
        problems.append(f"stored embeddings against the plain path: min cosine {cos.min()}")
    if set(stored_texts) != {texts[c] for c in corpus["initial"]} | {texts[c] for c in corpus["final"]}:
        problems.append("the stored chunks are not the chunks of the corpus and its change")

    fetch = traffic.sizes.k * HY_FETCH
    bm25 = PlainBM25(texts)
    first, last = {}, {}
    for s in probe.searches:
        if not s["after"]:
            first.setdefault(s["query"], s)
        else:
            last[s["query"]] = s
    fusion_bad = sum(1 for s in probe.searches if rrf(s["inner_keys"], s["k"]) != s["fused_keys"])
    res["fusion"] = {"searches": len(probe.searches), "not_rrf_of_inner": fusion_bad}
    if fusion_bad:
        problems.append(f"{fusion_bad} fused lists are not the RRF of their inner lists")
    for stage, picked, live_ids in (("before", first, corpus["initial"]), ("after", last, corpus["final"])):
        if set(picked) != set(corpus["questions"]):
            problems.append(f"{stage} the change: {len(picked)} of {len(corpus['questions'])} questions searched")
            continue
        live_texts = [texts[c] for c in live_ids]
        vecs = torch.from_numpy(np.stack([probe.stored[t] for t in live_texts])).to(device)
        row_of = {t: r for r, t in enumerate(live_texts)}
        qs = list(corpus["questions"])
        q = torch.from_numpy(np.stack([picked[x]["qvec"] for x in qs])).to(device)
        sims = (q / q.norm(dim=1, keepdim=True)) @ vecs.T
        exact = torch.topk(sims, fetch, dim=1).indices.cpu().numpy()
        sims = sims.cpu().numpy()
        recall, score_err, unknown = [], 0.0, 0
        mask = np.zeros(len(texts), bool)
        mask[live_ids] = True
        bm25_bad, bm25_err, bm25_ties = [], 0.0, 0
        for j, x in enumerate(qs):
            dense = picked[x]["inner"]["hnsw"]
            rows = [row_of.get(t, -1) for t, _s in dense]
            unknown += sum(r < 0 for r in rows)
            recall.append(len({r for r in rows if r >= 0} & set(exact[j].tolist())) / fetch)
            score_err = max([score_err] + [abs(s - float(sims[j, r])) for (_t, s), r in zip(dense, rows) if r >= 0])
            ref = bm25.scores(x, mask)
            order = np.argsort(-ref, kind="stable")[: min(fetch, int((ref > 0).sum()))]
            got_bm = picked[x]["inner"]["bm25"]
            if len(got_bm) != len(order):
                bm25_bad.append(x)
                continue
            for (t, s), r in zip(got_bm, order):
                own = ref[cid[t]] if t in cid else math.nan
                err = max(abs(s - ref[r]), abs(s - own)) / abs(ref[r])
                bm25_err = max(bm25_err, err)
                if not err <= HY_BM25_REL:
                    bm25_bad.append(x)
                    break
                bm25_ties += t != texts[r]
        if stage == "after" and probe.dense is not None:  # the final graph at other beams
            sweep = {}
            for ef in HY_EF_SWEEP:
                hits_ef = [{row_of.get(probe.key_text.get(key), -1)
                            for key, _s in probe.dense.search(picked[x]["qvec"], fetch, ef=ef)} for x in qs]
                sweep[ef] = float(np.mean([len(h & set(exact[j].tolist())) / fetch for j, h in enumerate(hits_ef)]))
            res["hnsw_recall_by_ef"] = sweep
        res[stage] = {"questions": len(qs), "hnsw_recall_mean": float(np.mean(recall)),
                      "hnsw_recall_min": float(np.min(recall)), "hnsw_max_score_err": score_err,
                      "hnsw_unknown": unknown, "bm25_max_rel_err": bm25_err, "bm25_parted_at_ties": bm25_ties,
                      "bm25_wrong": len(bm25_bad)}
        if np.mean(recall) < HY_RECALL_MIN or unknown or score_err > HY_HNSW_SCORE_TOL:
            problems.append(f"HNSW {stage} the change: {res[stage]}")
        if bm25_bad:
            problems.append(f"BM25 {stage} the change against the plain BM25: {len(bm25_bad)} questions, "
                            f"e.g. {bm25_bad[0]!r}")

    # the final answers: one each, the last fused list, none of the change's removed chunks
    removed = ({texts[c] for c in corpus["initial"]} - {texts[c] for c in corpus["final"]})
    finals, stale, not_last = {}, 0, 0
    for x in corpus["questions"]:
        live = traffic.hits.get(x, [])
        if len(live) != 1:
            problems.append(f"question {x!r} holds {len(live)} live answers")
            continue
        finals[x] = live[0]
        stale += sum(t in removed for t, _s in live[0])
        if x in last and [t for t, _s in live[0]] != [t for t, _s in last[x]["fused"]]:
            not_last += 1
    res["final"] = {"answers": len(finals), "removed_texts_in_answers": stale, "not_the_last_search": not_last}
    if stale or not_last:
        problems.append(f"final answers: {res['final']}")

    # the rerank: every scored pair against the plain path; the final kept 5
    pairs = list(dict.fromkeys((x, t) for x, t, _s in traffic.scored))
    got_of = {(x, t): s for x, t, s in traffic.scored}
    ref = plain_cross_scores(ce, pairs, device)
    ref_of = dict(zip(pairs, ref))
    tol = score_tol(ref)
    err = float(max(abs(got_of[p] - r) for p, r in ref_of.items()))
    parted, below, kept_stale = 0, 0.0, 0
    for x, (docs, _scores) in ((x, live[0]) for x, live in traffic.kept.items() if len(live) == 1):
        if x not in finals:
            continue
        mine = sorted((ref_of[(x, t)] for t, _s in finals[x]), reverse=True)
        kth = mine[RERANK_KEEP - 1]
        kept_stale += sum(t in removed for t in docs)
        if {t for t in docs} != {t for t, _s in finals[x] if ref_of[(x, t)] >= kth}:
            parted += 1
            below = max(below, max(kth - ref_of[(x, t)] for t in docs))
    res["rerank"] = {"pairs": len(pairs), "max_abs_err": err, "tol": tol, "sets_parted": parted,
                     "parted_max_below_kth": below, "removed_texts_kept": kept_stale,
                     "kept": sum(len(v) == 1 for v in traffic.kept.values())}
    if err > tol or below > tol or kept_stale or res["rerank"]["kept"] != len(corpus["questions"]):
        problems.append(f"the rerank against the plain path: {res['rerank']}")
    return res


def hybrid_phase(device, seed: int, checked: dict, card: str, sizes: HybridSizes = HybridSizes()) -> dict:
    """Phase 15c: BASELINE.md's fourth configuration: a ``DocumentStore``
    over ``HybridIndexFactory([UsearchKnnFactory(MiniLM),
    TantivyBM25Factory()])`` fed by ``pw.io.python.read``, questions through
    ``retrieve_query`` reranked by ``CrossEncoderReranker`` (ms-marco) and
    ``rerank_topk_filter``, then a change that deletes and rewrites files
    while the questions stand.  ``checked`` gains the attention shapes the
    run gave the kernel."""
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import native
    from pathway_tpu_torch.engine import dataflow as df
    from pathway_tpu_torch.models.encoder import init_params
    from pathway_tpu_torch.ops.attention import encoder_attention
    from pathway_tpu_torch.xpacks.llm import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    on_card = torch.device(device).type == "cuda"
    kw = {} if on_card else {"device": str(device)}
    if native.get() is None:
        fail("hybrid: the native core did not load")
    t_setup = time.perf_counter()
    corpus = hybrid_corpus(seed, sizes)
    embedder = SentenceTransformerEmbedder(VS_MODEL, **kw)  # max batch 256
    enc = embedder._encoder
    enc.set_params(init_params(enc.config, seed))
    reranker = CrossEncoderReranker(RERANK_MODEL, **kw)  # micro-batches of 256
    ce = reranker._ce
    ce.set_params(init_params(ce.config, seed, head=True))
    traffic = HybridTraffic(corpus, sizes)

    class Doc(pw.Schema):
        data: bytes
        _metadata: pw.Json

    doc_subject, question_subject = traffic.subjects(pw)
    docs = pw.io.python.read(doc_subject, schema=Doc)
    questions = pw.io.python.read(question_subject, schema=DocumentStore.RetrieveQuerySchema)
    store = hybrid_store(pw, docs, embedder, dimensions=enc.dimensions)
    hits = hybrid_hits(pw, store, questions)
    tables = rerank_program(pw, hits, reranker)
    pw.io.subscribe(store.chunked_docs, on_change=traffic.on_chunk, on_time_end=traffic.on_chunk_epoch)
    pw.io.subscribe(hits, on_change=traffic.on_hits)
    pw.io.subscribe(tables["scored"], on_change=traffic.on_scored)
    pw.io.subscribe(tables["kept"], on_change=traffic.on_kept)
    setup_s = time.perf_counter() - t_setup

    probe = HybridProbe(pw)
    traffic.probe = probe
    seen: dict[tuple, int] = {}
    removers = [h.remove for h in (record_launches(m, seen) for m in (enc, ce))]
    events: list = []
    if on_card:
        for m in (enc, ce):
            ev, remove = forward_events(m)
            events.append(ev)
            removers.append(remove)
    scoring = [0, 0.0]  # pairs, host s in CrossEncoder.score

    def timed_score(pairs, *args, score=ce.score, **kwargs):
        t0 = time.perf_counter()
        out = score(pairs, *args, **kwargs)
        scoring[0] += len(pairs)
        scoring[1] += time.perf_counter() - t0
        return out

    epochs: list[float] = []
    run_epoch = df.Scope.run_epoch

    def timed_epoch(scope, time_):
        t0 = time.perf_counter()
        try:
            return run_epoch(scope, time_)
        finally:
            if scope.parent is None:
                epochs.append((time.perf_counter() - t0) * 1e3)

    gc_time = [0.0, 0.0, 0]  # seconds in collections, the current start, collections

    def on_gc(phase, _info):
        if phase == "start":
            gc_time[1] = time.perf_counter()
        else:
            gc_time[0] += time.perf_counter() - gc_time[1]
            gc_time[2] += 1

    before = rail_state(device) if on_card else None
    probe.install()
    gc.callbacks.append(on_gc)
    ce.score = timed_score
    df.Scope.run_epoch = timed_epoch
    # ---- the counted run: counts zeroed just before, read just after ----
    encoder_attention.launches = 0
    seen.clear()
    try:
        t_run, cpu_run, process_run, threads = _now(), time.thread_time(), time.process_time(), threading.active_count()
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        wall_s, run_cpu_s = _now() - t_run, time.thread_time() - cpu_run
    except KeyboardInterrupt:
        fail(f"hybrid: {traffic.failure or 'interrupted'}")
    finally:
        df.Scope.run_epoch = run_epoch
        gc.callbacks.remove(on_gc)
        del ce.score
        probe.uninstall()
        pw.G.clear()
    launches = {"encoder_attention": encoder_attention.launches}
    # ---- end of the counted run ----
    for remove in removers:
        remove()
    if traffic.failure:
        fail(f"hybrid: {traffic.failure}")
    rail = rail_gate("hybrid", device, before) if on_card else {}
    device_ms = sum(events_ms(ev) for ev in events) if on_card else None

    searches = probe.searches
    stage_of = {False: "questions", True: "change"}
    by_stage: dict[str, dict] = {}
    for after, name in stage_of.items():
        mine = [s for s in searches if s["after"] == after]
        if not mine:
            by_stage[name] = {"searches": 0}
            continue
        hnsw_ms = [s["inner_ms"]["hnsw"] for s in mine]
        bm25_ms = [s["inner_ms"]["bm25"] for s in mine]
        fusion_ms = [s["ms"] - s["inner_ms"]["hnsw"] - s["inner_ms"]["bm25"] for s in mine]
        by_stage[name] = {"searches": len(mine), "questions": len({s["query"] for s in mine}),
                          "hnsw_ms": percentiles(hnsw_ms), "bm25_ms": percentiles(bm25_ms),
                          "fusion_ms": percentiles(fusion_ms), "hnsw_ms_total": sum(hnsw_ms),
                          "bm25_ms_total": sum(bm25_ms), "fusion_ms_total": sum(fusion_ms)}
    latency = [traffic.first[q] - traffic.t_commit[traffic.batch_of[q]] for q in traffic.first]
    n_chunks = len(corpus["initial"])
    res = {
        "card": card, "files": sizes.files, "chunks": n_chunks, "chunks_final": len(corpus["final"]),
        "questions": sizes.questions, "commits": sizes.commits, "k": sizes.k, "fetch": sizes.k * HY_FETCH,
        "deleted": sizes.deleted, "rewritten": sizes.rewritten, "setup_s": setup_s, "wall_s": wall_s,
        "ingest_s": traffic.t_indexed - traffic.t_docs, "ingest_chunks_per_s": n_chunks / (traffic.t_indexed - traffic.t_docs),
        "retrieve_latency_ms": percentiles(np.array(latency) * 1e3),
        "searches": by_stage, "dense_index": sorted(probe.dense_types),
        "revised_answers": len(traffic.revised),
        "change_to_last_revision_ms": ((traffic.t_last_revision - traffic.t_change) * 1e3
                                       if traffic.t_last_revision else None),
        "change_to_settled_ms": (traffic.t_settled - traffic.t_change) * 1e3,
        "rerank_pairs": scoring[0], "rerank_pairs_per_s": scoring[0] / scoring[1] if scoring[1] else None,
        "epochs": len(epochs), "host_ms_per_epoch": percentiles(epochs) if epochs else {},
        "device_ms": device_ms, "idle_share": 1.0 - device_ms / (wall_s * 1e3) if on_card else None,
        "run_thread_cpu_s": run_cpu_s, "process_cpu_s": time.process_time() - process_run,
        "gc_s": gc_time[0], "gc_collections": gc_time[2], "threads_at_start": threads,
        "error_rows": traffic.errors,
    }
    t_check = time.perf_counter()
    with torch.inference_mode():
        res["check"] = hybrid_checks(probe, traffic, enc, ce, device)
    res["check_s"] = time.perf_counter() - t_check
    log("hybrid", **res, kernel_launches=launches)

    problems = list(res["check"]["problems"])
    if probe.dense_types != {"NativeHnswIndex"}:
        problems.append(f"the dense index was {sorted(probe.dense_types)}, not NativeHnswIndex")
    if by_stage["questions"]["searches"] != sizes.questions:
        problems.append(f"{by_stage['questions']['searches']} searches answered {sizes.questions} questions")
    if traffic.errors:
        problems.append(f"{traffic.errors} rows hold ERROR")
    if on_card:
        expected = sum(seen.values())
        if launches["encoder_attention"] != expected or not expected:
            problems.append(f"attention launches {launches['encoder_attention']} != {expected} "
                            f"(layers x forwards per shape {seen})")
    if problems:
        fail("hybrid: " + "; ".join(problems))
    if on_card:
        gen = torch.Generator(device=device).manual_seed(seed + 405)
        for shape in sorted(set(seen) - set(checked)):
            checked[shape] = check_attention_shape(gen, shape, device)
        log("hybrid", step="shapes", card=card, launches={str(list(sh)): n for sh, n in sorted(seen.items())},
            max_abs_err={str(list(sh)): checked[sh] for sh in sorted(seen)})
    return {"launches": launches, "attention_launches": dict(seen) if on_card else {}, "rail": rail, **res}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs", type=int, default=65536)  # 131,072 until [cluster] (PERF.md section 4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--skip", default="", help="comma-separated phases to leave out: " + ", ".join(SKIPPABLE))
    parser.add_argument("--cluster-worker", metavar="SPEC", help=argparse.SUPPRESS)  # [cluster]'s workers
    args = parser.parse_args(argv)
    if args.cluster_worker:
        return cluster_worker(args.cluster_worker)
    skip = {name for name in args.skip.split(",") if name}
    if skip - set(SKIPPABLE):
        parser.error(f"--skip takes {', '.join(SKIPPABLE)}; got {args.skip!r}")
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pathway_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    try:  # a bf16 UDF result enters a column as an ml_dtypes.bfloat16 array (internals/dtype.py)
        import ml_dtypes  # noqa: F401

        bf16_arrays = True
    except ImportError:
        bf16_arrays = False
    log("card", nvidia_smi=card, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], ml_dtypes=bf16_arrays,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    messages = _build.build(ptxas_info=True)
    log("build", seconds=time.perf_counter() - t0, sources=_build.sources())
    for name, text in messages.items():
        for line in text.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    attention, checked, timed = attention_phase(device)
    log("kernels", **{k: v for k, v in attention.items() if k != "launches"})

    # phases 4-6 run on the shared default executor with the rail on: each
    # must serve every batch on the card
    seconds = {}  # each phase's wall seconds, for [total]
    t_phase = time.perf_counter()
    rail = rail_state(device)
    result = main_path(device, args.docs, args.seed, checked)
    result["rail"] = rail_gate("main", device, rail)
    texts, lengths = result.pop("texts"), result.pop("lengths")
    phases = {"main": result}
    seconds["main"] = time.perf_counter() - t_phase
    if "rerank" not in skip:
        t_phase = time.perf_counter()
        rail = rail_state(device)
        phases["rerank"] = rerank_phase(device, args.seed, checked)
        phases["rerank"]["rail"] = rail_gate("rerank", device, rail)
        seconds["rerank"] = time.perf_counter() - t_phase
    if "encoders" not in skip:
        t_phase = time.perf_counter()
        rail = rail_state(device)
        phases["encoders"] = encoders_phase(device, args.seed, checked, texts, lengths)
        phases["encoders"]["rail"] = rail_gate("encoders", device, rail)
        seconds["encoders"] = time.perf_counter() - t_phase
    if "executor" not in skip:
        t_phase = time.perf_counter()
        phases["executor"] = executor_phase(device, args.seed, checked, texts)
        seconds["executor"] = time.perf_counter() - t_phase
    if "dataflow" not in skip:
        t_phase = time.perf_counter()
        phases["dataflow"] = dataflow_phase(device, args.seed, checked)
        seconds["dataflow"] = time.perf_counter() - t_phase
    if "temporal" not in skip:
        t_phase = time.perf_counter()
        phases["temporal"] = temporal_phase(device, args.seed, checked)
        seconds["temporal"] = time.perf_counter() - t_phase
    parallel_texts = texts[:LONG_TEXTS]
    del texts, lengths
    # the decoder phases and the multimodal encoder, one model on the card at a time
    for name, phase in (("generate", generate_phase), ("moe", moe_phase), ("speculative", speculative_phase),
                        ("vision", vision_phase), ("lora", lora_phase), ("train", train_phase)):
        gc.collect()
        torch.cuda.empty_cache()
        if name not in skip:
            t_phase = time.perf_counter()
            phases[name] = phase(device, args.seed, card)
            seconds[name] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    if "parallel" not in skip:
        t_phase = time.perf_counter()
        phases["parallel"] = parallel_phase(device, args.seed, card, parallel_texts)
        seconds["parallel"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    if "sharded" not in skip:
        t_phase = time.perf_counter()
        phases["sharded"] = sharded_phase(device, args.seed, card)
        seconds["sharded"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    if "rag" not in skip:
        t_phase = time.perf_counter()
        phases["rag"] = rag_phase(device, args.seed, checked, card)
        seconds["rag"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    if "hybrid" not in skip:
        t_phase = time.perf_counter()
        phases["hybrid"] = hybrid_phase(device, args.seed, checked, card)
        seconds["hybrid"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    if "persistence" not in skip:
        t_phase = time.perf_counter()
        phases["persistence"] = persistence_phase(device, args.seed, checked)
        seconds["persistence"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    if "cluster" not in skip:
        t_phase = time.perf_counter()
        phases["cluster"] = cluster_phase(device, args.seed, checked)
        seconds["cluster"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    # last: its streaming fs reader polls on after the run, as the JAX package's does
    if "vector_store" not in skip:
        t_phase = time.perf_counter()
        phases["vector_store"] = vector_store_phase(device, args.seed, checked, card)
        seconds["vector_store"] = time.perf_counter() - t_phase
    attention["max_abs_err"] = max(checked.values())
    # one row per attention shape of each path, timed here if phase 3 had not
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    attention["shapes"] = []
    for phase, res in phases.items():
        for shape, n in sorted(res["attention_launches"].items()):
            if shape not in timed:
                timed[shape] = time_attention_shape(gen, shape, device)
            attention["shapes"].append(dict(timed[shape], phase=phase, launches=n, max_abs_err=checked[shape]))
    by_phase = {phase: res["launches"][attention["name"]] for phase, res in phases.items()}
    kernels = [dict(attention, launches=result["launches"][attention["name"]], launches_by_phase=by_phase)]
    for kern in kernels:
        for phase, n in kern["launches_by_phase"].items():
            if phase in NO_KERNEL_PHASES and n:
                fail(f"kernel {kern['name']} was launched {n} times on the {phase} path")
            if phase not in NO_KERNEL_PHASES and not n:
                fail(f"kernel {kern['name']} was not launched on the {phase} path")
    log("total", seconds=time.perf_counter() - started, phases=sorted(phases), phase_seconds=seconds)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
