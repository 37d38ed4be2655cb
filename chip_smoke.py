#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``; exits non-zero without them.  Phases, each printed as it ends:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``,
   with each kernel's registers and spills (ptxas) and its ``HGMMA``
   (tensor-core) instructions (``cuobjdump --dump-sass``);
3. each serving kernel (``pack_rows``, ``row_checksums``,
   ``gather_blocks``) at the shapes the serving path gives it and on edge
   cases, held bitwise against its plain PyTorch version, with CUDA-event
   medians of the kernel, the plain version and (where one exists) a
   one-call PyTorch library equivalent, next to the bytes bound at
   3.35 TB/s.  The two copy kernels (the bulk-async engine of
   ``csrc/copy.cuh``) are held on edge cases: leaves of 0, 1, 3 and 5
   words, unaligned sources, chunk boundaries inside a leaf and inside a
   block, a leaf longer than one pass of the whole grid, untouched words
   around the leaves, 3,000 leaves in one launch (and more than
   ``MAX_PACK_LEAVES`` refused), 21-word blocks, 66,000 (slot, block)
   pairs of 4-word blocks, table entries of 0 and entries outside the
   pool (zeros), no launch counted for an empty call; then timed beside
   two yardsticks: the event floor (an empty kernel) and a contiguous
   ``copy_`` of the same bytes;
4. the smoke-size model on the card against the same code on the CPU
   (prefill and decode logits within the reference's f32 tolerance);
5. the serving path: full-width iterpro-100m served through
   ``ServingEngine`` — 8 requests, prompt 128, 32 new tokens, 4 slots,
   block size 16, canary K=4, TF32 off, the engine step captured as 8
   CUDA graphs (K rotations x 2 read tables; their capture seconds
   printed) — once clean and once under a fault storm (one bit flip
   every 16 accepted tokens).  Asserts detected == injected > 0, recovered
   == detected, nothing dropped, storm tokens identical to clean tokens,
   and a launch count above 0 for every serving kernel (a graph replay
   counts the kernels captured in it);
5c. at-rest parity over the served params: ``ServingEngine(parity=True)``
   over the same params, one bit of the embedding flipped with
   ``corrupt_param`` (the other engines, which share the params, keep
   theirs), ``scrub_params`` repairs it bitwise; launch counts of that
   path;
5d. every serving mode on phase 5's params and requests, each path with
   the launch counts set to 0 just before it and read just after: the
   step's body run eagerly on the card (the yardstick), the paged engine
   donated and not, the dense slot-major cache (at the pool's capacity)
   donated (its ping-pong mode is the time cut: 10a-13a serve it) and
   ``prefill_chunk=32``.  Per mode: 8 graphs
   captured (none for the yardstick) with their seconds and their pool's
   bytes, clean tokens bitwise equal to phase 5's captured paged engine's
   (so captured == uncaptured, donated == not, dense == paged, chunked ==
   monolithic), in the paged ping-pong, dense and chunked modes a storm
   on the same engine with detected == injected == recovered and tokens
   == clean (phase 5 storms the paged donated engine; the uncaptured
   body and the dense ping-pong mode run no storm: the time cut), every
   kernel of the path launched; then
   4 steady steps under torch.profiler (the time cut; 9c-13a profile
   8): one ``cudaGraphLaunch`` and no ``cudaLaunchKernel`` a step
   (captured modes), ``digest.STATS`` 1 launch + 1 fetch a step, every
   pointer the step reads unchanged; the
   mode's decode p50 / p99, device busy ms a step and kernels by name;
6. the training kernels (``checksum_tiles``, ``vote3_tiles``) at the
   training path's shapes (the embedding leaf, an FFN leaf, a norm scale)
   and on edge cases, bitwise against their plain versions, timed as in
   phase 3; every wrapper refuses a non-contiguous CUDA operand;
6b. the parity kernels (``xor_update_tiles``, ``xor_fold_tiles``) at the
   parity plans' shapes (training: D = 4 over 2,291 tiles; serving: 764
   tiles) and on edge cases (1 tile, D = 1, R in {2, 5}, int32
   extremes), bitwise against their plain versions; ``xor_update_tiles``
   keeps the parity's ``data_ptr`` and equals the fold on a zero parity;
   timed as in phase 3, with the per-step pieces of the update (the delta
   build, the fault gate, the whole ``update_leaves``);
6c. flash attention (PyTorch's TF32 off; the kernel's own products are
   three TF32 passes on the tensor cores): ``flash_attention_bhsd``
   (with its layout kernel ``flash_layout_kv``) through
   ``ops.flash_attention`` against its plain version
   (``ref.flash_attention_ref``) on the reference's six FLASH_CASES and on
   edge cases (non-causal with a ragged Sk, causal with Sq < Sk and
   Sq > Sk, GQA with G = 3, a window with a softcap, Sq = 1, rows with no
   live key), within 2e-5 (f32) / 3e-2 (bf16); then at iterpro-100m's
   attention width (H = 12, KV = 4, D = 64, f32, causal) at B=4, S=128
   (the serving prefill) and B=1, S=8192 (long context), the entry point
   against the plain version and against the port's
   ``models.layers.attention`` (the chunked path at 8192 keys), within
   2e-5, with the distance to the kernel's arithmetic emulated in plain
   PyTorch (``ref.flash_attention_3xtf32``) printed beside; timed as in
   phase 3 beside the tensor-core bound (3 TF32 passes at 494.7 TFLOP/s),
   the SIMT bound (f32 at 67 TFLOP/s) and
   ``scaled_dot_product_attention`` (the yardstick; the port never calls
   it);
7. the training path: full-width iterpro-100m through
   ``repro_torch.launch.train.train`` — batch 8, seq 128, 20 steps,
   snapshot every 4, canary K=1, a disk checkpoint every 10 steps, TF32
   off, deterministic algorithms on — once clean and once with a bit
   flip in the params every 6 steps (no ``iv`` storm, the time cut:
   14 holds one on the mesh, through ``eq1``).  Asserts detected ==
   injected == recovered > 0, recovery rate 1, the params storm's final
   state bitwise equal to the clean run's; then the ``replica_vote`` rung
   (``RecoveryRuntime(replicas=...)``) on a flipped embedding leaf and
   the ``checkpoint`` rung from the storm's checkpoint, both bitwise
   against the clean state, and a corrupted checkpoint refused at load.
   A launch count above 0 for every kernel of the path; then
   ``pack_rows`` alone at the training canary's shape (41 leaves, 1.201
   GB) bitwise against its plain version and timed beside its bound, ``_foreach_copy_`` and a contiguous ``copy_``, and
   ``row_checksums`` over the whole 2.402 GB check+arm buffer; then a
   profiled window of 4 steady train steps (with the parity attached
   only in 7j since PR 25, the time cut);
7d. the parity path: the params storm again with ``parity=True`` (same
   settings).  Asserts detected == injected == recovered > 0, only the
   ``parity_xor`` and ``replay`` rungs, at least one ``parity_xor``, and
   the final state bitwise equal to the clean run's; the launches per
   step; then, at full width, a low-mantissa flip of the embedding
   repaired by ``parity_xor`` alone (0 steps replayed, bitwise), and 4
   canary steps whose incrementally kept parity equals a fresh build;
7f. the training modes at phase 7's settings: ``--donate`` under the
   params storm (no donated clean run or iv storm: the time cuts).
   Asserts the storm's final state bitwise equal to the functional
   clean run's, detected == injected == recovered,
   replay only under donation (never eq1) (the K=1
   ``--fused-detect`` modes, donated or not, run no storm here: their
   storms are held at K=4 below and by 9e-13c, their K=1 graphs by 7i
   and 7j; the time cut); then at K=4: ``--donate --fused-detect`` (8
   graphs) under a params storm (a flip every 5 steps, one of them in
   the slice checked), and ``--fused-detect --fused-warm lazy`` under the
   same storm, each storm bitwise the functional K=4 storm's with the
   same detections and recoveries (no donate+fused K=4 clean run here,
   the time cut: 10c-13c hold it at full width);
7g. parity with donation: an embedding flip caught by the donated pair
   (``consumed=False``) rebuilt by ``parity_xor`` into the live tensor;
7h. triage at full width on an ``opt/v`` FFN leaf: a bit-2 flip
   tolerated (0 bytes, 0 steps, the next check quiet), a bit-30 flip and
   a params flip escalated to replay, bitwise the clean state;
7i. the fused hot path with donation and parity from a fresh state: 8
   steady steps under torch.profiler — one ``cudaGraphLaunch`` a step and
   no kernel launched from the host, ``digest.STATS`` 1 launch and 1
   fetch a step, every state leaf, the pack buffer, both canary tables
   and the parity at the same ``data_ptr`` — then a params flip reported
   with ``consumed=True`` and replayed into the live state; the final
   state at step 20 bitwise the functional clean run's.  Launch counts of
   7f + 7i (a graph replay counts the kernels captured in it);
7j. each mode's hot path (functional, donate, fused, donate+fused):
   host step p50, device busy ms a step, steady-state peak memory above
   what was held before, graph capture seconds, beside the card's name
   and power limit;
8. the dense configurations at full width, bf16 params and compute, each
   path with the launch counts set to 0 just before it and read just
   after, its peak memory printed:
   8a. gemma3-1b served paged through the captured step (phase 5's
       traffic: 8 requests, prompt 128, 32 new tokens, 4 slots, K=4),
       clean and under a flip every 16 accepted tokens: 8 graphs, storm
       tokens == clean, detected == injected == recovered; decode p50 /
       p99 and device busy ms a step with where it goes;
   8b. gemma3-1b at 6 of its 26 layers (one 5 local + 1 global group;
       the depth cut keeps the whole script within its time limit) on
       ring caches: the dense engine (max_len 1,073 >
       the window of 1,024), 2 requests of prompt 1,040 and 32 new
       tokens, so every local layer's ring wraps; storm == clean, and
       the first decoded token equals the argmax of a 1,041-token
       prefill of the prompt and its first token;
   8c. command-r-35b at full width (d 8192, d_ff 22528, 64/8 heads,
       vocab 256,000, parallel blocks) and 2 of its 40 layers (the
       depth cut: the whole model needs the mesh), served clean and
       under the storm, tokens equal;
   8d. gemma3-1b at 6 of its 26 layers (one 5 local + 1 global group;
       the depth cut keeps the whole script within its time limit)
       trained (global batch 8, seq 128, 6 steps, K=1, one host snapshot
       and one disk checkpoint a run, their seconds):
       functional clean and under a params storm (a flip every 2 steps,
       detected == injected == recovered, final state == clean's
       bitwise); no ``--donate --fused-detect`` run (the time cut:
       7h-7i and 10c hold it);
   8f. ``pack_rows`` on 2-byte leaves, read in place and zero-extended:
       edge cases bitwise (bf16 / f16 / int16 leaves of odd lengths at
       2-, 4- and 6-byte offsets, a chunk boundary inside a leaf, a leaf
       longer than one grid pass, f32 leaves beside them, words around
       them untouched; a bool leaf refused), ``gather_blocks`` on the
       bf16 pool bitwise; then the gemma3-1b training canary's leaves
       (bf16 params, f32 moments of a full-depth state after one
       functional step) and the bf16 KV pool's check+arm
       slice bitwise and timed beside their bound (2 B read + 4 B
       written a bf16 element) and ``Tensor.to(torch.int32)`` of the same
       leaves, ``row_checksums`` over that buffer and ``checksum_tiles``
       of the bf16 embedding timed; its launches on 8a, 8b and 8d (no
       profiled gemma3-1b train steps, the time cut: 7j and 12c profile
       the train step);
   8e. h2o-danube-1.8b at full width and 6 of its 24 layers (the depth
       cut keeps the whole script within its time limit)
       trained with its microbatch 8 (global batch 8:
       8 slices of one sequence), ``--donate``, K=4, 4 steps, clean and
       under a params storm whose flip lands in the slice checked at its
       step: final states bitwise equal, replay only;
9. the optimizers and the MoE family at full width, each path with the
   launch counts set to 0 just before it and read just after, its peak
   memory printed:
   9a. ``pack_rows`` on 1-byte leaves, read in place and zero-extended:
       int8 and uint8 leaves of 0, 1, 3, 5, 7, 255, 256 and 257 bytes at
       byte offsets 1-3, one across a chunk boundary, mixed with 2- and
       4-byte leaves in one launch, the words around them untouched
       (bitwise against the plain version); then at 9b's canary (f32 params and scales, int8 ``q`` moments)
       bitwise and timed beside its bound, the event floor and
       ``Tensor.to(torch.int32)`` of the same leaves;
   9b. iterpro-100m with int8 AdamW moments at phase 7's settings (K=1):
       clean and under the params storm, final states bitwise equal,
       detected == injected == recovered; a live ``q`` byte flipped and
       recovered by replay; with triage, a flip in a ``q`` pad tail
       tolerated by the dead-region certificate (at d_model 776: at 768
       every leaf is whole 256-element blocks);
   9c. grok-1-314b served paged through the captured step at full width
       (d 6144, 48/8 heads of 128, 8 experts of 32768, top-2, vocab
       131,072, soft-caps 30) and 2 of its 64 layers (the depth cut: the
       whole model needs the mesh), phase 5's traffic clean and under
       the storm: 8 graphs, storm tokens == clean, detected == injected
       == recovered, 8 profiled steady steps of 1 ``cudaGraphLaunch``
       and no ``cudaLaunchKernel`` with ``digest.STATS`` 1 + 1, decode
       p50 / p99, device busy and the graph pools' MiB, ``gather_blocks``
       on its pool bitwise; then ``prefill_chunk=32`` captured == the
       same chunked engine uncaptured (capacity is per call, so chunked
       tokens need not equal monolithic ones);
   9d. kimi-k2-1t-a32b the same way at full width (d 7168, 64/8 heads of
       112, vocab 163,840) and 2 of its 61 layers: the dense first layer
       (d_ff 18432) and one MoE layer of 384 experts of 2048 with the
       shared expert; ``gather_blocks`` on its head width of 112 bitwise;
   9e. grok-1-314b trained at full width and 1 of its 64 layers with
       Adafactor (bf16 factored stats), microbatch 8, global batch 8 x
       128, K=4, ``--donate``, 4 steps, clean (no disk checkpoint since
       PR 25, the time cut: 12c holds a round trip, 7b the rung);
       host step p50 and the steady peak (no device profile of the
       step: the time cut);
       then ``--donate --fused-detect`` under flips in the slice
       checked at their step (replay only; no fused clean run, the time
       cut: the storm holds its checks), == donated clean, bitwise, when
       the donated peak (which already holds the plan's
       packing ring, the K rotations' only packing buffer; the fused
       factory adopts the loop's state, so it adds no version) fits 97 %
       of the card (else the arithmetic is printed and the storm runs
       donated, unfused), with the graph pool's size;
   9f. the launch counts of phase 9's paths (``pack_rows``,
       ``row_checksums``, ``gather_blocks`` and ``checksum_tiles`` each
       > 0);
10. the xLSTM family (xlstm-350m) at full width, bf16, at 8 of its 24
   layers (one group of 7 mLSTM + 1 sLSTM, d 1024, random from seed 0;
   the depth cut keeps the whole script within its time limit), each
   path with the launch counts set to 0 just before it and read just
   after:
   10a. served on the dense slot-major engine (no paged pool: the family
       has no ``prefill_chunk``) with phase 5's traffic: the step's body
       uncaptured (the reference tokens), then through phase 5d's mode
       loop captured donated and ping-pong: 8 graphs, clean
       tokens == uncaptured, a storm of armed-slice flips over the
       recurrent leaves (``C``, ``n``, ``m``, conv tails, the sLSTM
       state; the flips by leaf printed) == clean with detected ==
       injected == recovered and 0 dropped, 8 profiled steady steps of 1
       ``cudaGraphLaunch``, no ``cudaLaunchKernel`` and ``STATS``
       (1, 1), decode p50 / p99, device busy and the graph pool's MiB;
   10b. one prompt of 600 tokens (three 256-token mLSTM chunks, the last
       padded): its first decoded token == the argmax of a 601-token
       prefill, the largest logit difference printed beside it;
   10c. trained (global batch 8 x 128, AdamW, remat; 4 steps, one flip
       a storm): K=1 functional clean, a params storm under ``--parity``
       (``parity_xor``, == clean bitwise); ``--donate --fused-detect`` at
       K=4 under an armed-slice storm (replay, == clean; its graphs hold
       the clean run's checks) (the runs print the functional host p50;
       no fused clean run, no iv storm (14 holds one), no checkpoint
       round trip or donate+fused profile (7a-7b, 7j hold them): the time
       cuts);
   10d. the launches of ``pack_rows``, ``row_checksums``,
       ``checksum_tiles``, ``xor_update_tiles`` and ``xor_fold_tiles`` on
       phase 10's paths (each > 0);
11. the hybrid family (zamba2-7b) at full width, bf16 (d 3584, 32 heads
   of 112, vocab 32,000, untied head; random from seed 0), each path with
   the launch counts set to 0 just before it and read just after:
   11a. 13 of its 81 layers (2 x (5 Mamba-2 + the shared attention
       block, each invocation merging its own LoRA delta) + 1 Mamba-2;
       1,337,565,120 params; the depth cut keeps the script within its
       time limit) served as 10a (uncaptured, then
       captured donated and ping-pong, storms over ``ssm``, ``conv``,
       ``k``, ``v`` with the flips by leaf, 1 ``cudaGraphLaunch`` a
       steady step; decode p50 / p99, device busy, kernels a step,
       graph pool);
   11b. one prompt of 600 tokens (three 256-token SSD chunks, the last
       padded) as 10b;
   11c. 7 of its 81 layers ((1, 5 Mamba-2 + the shared block), (1, 1
       Mamba-2); 937,984,384 params) trained as 10c with the config's
       AdamW, microbatch 8 and remat, the memory of the runs reckoned
       from shapes and printed first: clean, the ``--parity`` storm and
       the donate+fused clean run (no iv storm, armed-slice storm,
       checkpoint or profile: the time cuts; 10c, 12c and 13c hold
       them);
   11d. the launches of 10d's kernels on phase 11's paths (each > 0);
12. the enc-dec family (seamless-m4t-large-v2) at full width, bf16 (d
   1024, 16 heads of 64, d_ff 8192 SwiGLU with biases, vocab 256,206,
   untied head; random from seed 0), each path with the launch counts
   set to 0 just before it and read just after:
   12a. 6 of its 24 encoder + 6 of its 24 decoder layers (903,543,808
       params; the depth cut: 13a serves a model at full depth) served
       as 10a, each request with its own 161 source frames (``max_len``):
       uncaptured, then captured donated and ping-pong, a storm over
       ``mem_k``, ``mem_v``, ``k``, ``v``, ``pos`` with the flips by leaf,
       1 ``cudaGraphLaunch`` a steady step; decode p50 / p99, device
       busy, kernels a step, graph pool;
   12b. one request with 4,160 source frames, above ``FLASH_THRESHOLD``:
       the encoder's self-attention takes ``attention_flash`` (counted,
       once per encoder layer: 6); the slot's memory K/V and the BOS
       logits within 3e-2 of the same prefill through
       ``attention_direct``, the first token's direct logit within twice
       that of the direct path's largest;
   12c. 6 encoder + 6 decoder layers (903,543,808 params) trained as 10c
       (AdamW with f32 moments, remat, batch 8 x 128 with 64 source
       frames), the memory of the runs reckoned first: clean, the
       ``--parity`` storm, the donate+fused clean run (no iv or
       armed-slice storm, held in 14 and 10c: the time cut; no
       checkpoint round trip, held in 7a-7b; no donate+fused profile,
       held in 7j);
   12d. the launches of 10d's kernels on phase 12's paths (each > 0);
13. the VLM family (qwen2-vl-7b) at full width, bf16 (d 3584, 28/4
   heads of 128, d_ff 18,944 SwiGLU, QKV biases, vocab 152,064, untied
   head, m-rope; random from seed 0; the vision tower a stub, as in the
   reference: each request carries its own ``patch_embeds`` of width
   1,280 and their (t, h, w) positions), each path with the launch
   counts set to 0 just before it and read just after:
   13a. all 28 layers (7,621,368,832 params) served as 10a with phase
       5's traffic, each request with an 8 x 8 image (64 patches at
       (0, row, col), the text from 8 on all three streams; max_len
       225): uncaptured, then captured donated and ping-pong, a storm
       over ``k``, ``v``, ``pos`` with the flips by leaf, 1
       ``cudaGraphLaunch`` a steady step; decode p50 / p99, device busy,
       kernels a step, graph pool;
   13b. a request whose patches, prompt, 1 and new tokens come to
       ``max_len`` + 1 refused with ``AdmissionError``; one request of a
       64 x 64 image and 128 tokens (4,224 keys, above
       ``FLASH_THRESHOLD``): every layer's attention takes
       ``attention_flash`` (counted: 28); the slot's K/V rows and the
       last logits held against the direct path and an f32 oracle (the
       flash path no further from the direct path than the direct path
       is from the oracle), the first token the flash prefill's argmax;
   13c. 1 of its 28 layers (1,327,688,704 params, 12.37 GiB of state)
       trained as 10c (AdamW with f32 moments, microbatch 8, remat;
       batch 8 x 128 with 16 patches), the memory of the runs reckoned
       first; the ``--parity`` storm at K=4 with its flip in the slice
       checked at its step (at K=1 the ring, the parity's stream scratch
       and the functional step's two versions do not fit the card; at
       K=4 it peaks at 74.0 GiB, so the cuBLAS workspaces the earlier
       phases' captures left are dropped first) and the donate+fused
       armed-slice storm (no iv storm, no donate+fused clean run, no
       checkpoint or profile: the time cuts; 14 holds an iv storm, the
       storm the fused run's checks, 12c the rest);
   13d. the launches of 10d's kernels on phase 13's paths (each > 0);
14. resilient training on a device mesh: iterpro-100m at full width and
   ``MESH_LAYERS`` of its 12 layers (f32, seed 0; 14d and 14e's e1 run
   all 12) on a 2 x 2 mesh, 4 ranks spawned by ``launch.mesh.spawn``
   sharing the card over gloo (each holding its own blocks of the
   state), tensor-parallel (each rank computes its heads, FFN columns
   and vocabulary rows from its blocks in place: no params gather in a
   step), batch 8 x 128, K=1, a
   snapshot every 2 steps, 3 steps a run through ``train(mesh="2,2")``:
   clean; a params flip every step (step 1 has no version-matched
   snapshot: replay; step 2 has: shard_patch, its bytes exactly the
   injured blocks'); an iv storm (eq1) with a disk checkpoint at step 0;
   every storm's final blocks bitwise the clean run's on every rank;
   each rank's launches (``pack_rows``, ``row_checksums``; rank 0
   ``checksum_tiles``), its ``pack_rows`` and ``row_checksums`` bitwise
   their plain versions on its own blocks, a steady check's STATS (1,
   1), the mesh step's host p50, recovery ms by rung, the model-axis
   collectives of a forward and backward and the step's three parts
   timed alone (forward + backward with the model-axis sums, the grads'
   exchange, the norm's all-gather); in the same ranks the training
   modes: (b) ``--donate
   --fused-detect --parity`` at K=2 under a params flip at step 2 in the
   checked slice (the clean fused run 14a was is cut: its checks hold
   here): the fused report consumed and replayed, every rank's final
   blocks bitwise the clean run's, every local leaf's ``data_ptr`` kept,
   ``STATS`` (1, 1) a step, the graphs captured (the head and the tail of
   each rotation and read table: the step's collectives run between
   them) and their pool's bytes, the parity kept by the fused tail's
   gated update (``xor_update_tiles``); (c) the donated pair with triage
   and the mesh parity: through ``train(mesh=..., donate=True,
   triage=True, parity=True)`` under a params flip at step 2
   (``parity_xor`` or ``replay``, every ``data_ptr`` kept, the final
   blocks bitwise the clean run's), then the same composition driven by
   hand on the initial state (no step loop) to place two flips: a
   bit-30 flip in an ``opt/v`` FFN leaf escalates past triage and is
   repaired by ``parity_xor`` (or ``replay`` when it does not localise)
   back to the state's bits before the flip, each rank's parity row then
   bitwise its plain version's (``xor_fold_tiles``, ``xor_update_tiles``
   on the rank's exchanged stream), then a bit-2 flip in the same leaf is
   tolerated by triage with 0 bytes moved, the same verdict on every
   rank, ``checksum_tiles`` launched only on the ranks holding the block
   (bitwise its plain version there) and the next full check clean;
   (f) the MoE mesh schedules at full width (``[mesh-moe]`` lines,
   ``_moe_mesh_calls``): on contexts the four ranks make anew,
   grok-1-314b's MoE layer (bf16) on 2 x 2 with fsdp, ``tp_ragged``
   (the ZeRO gather of the expert blocks over data timed alone), and
   kimi-k2-1t-a32b's on 1 x 4, ``ep_a2a`` and ``ep_token_a2a`` (96
   experts a rank, the shared expert tensor-parallel, capacity 8), each
   rank building only its blocks; every output and ``lb_loss`` within
   3e-2 of one device's ``_moe_local_math`` over the same rows (shard 0
   builds the whole layer once the ranks freed theirs), token-a2a's
   within 3e-2 of ep_a2a's;
   (e) mesh serving (``[mesh-serve]`` lines, ``_mesh_serve``),
   tensor-parallel: two graphs a rotation and read table around the
   eager model, no params gather in the run, the model-axis collectives
   of a steady step, tokens == one device's (e1 at 6 new tokens: the
   time cut);
   (g) the ssm, hybrid, encdec and vlm families on the mesh
   (``[mesh-fam]`` lines, ``_mesh_families``), tensor-parallel at full
   width (bf16, seed 0): xlstm-350m at 8 of 24 layers (7 mLSTM blocks
   and its first sLSTM), zamba2-7b at 6 of 81 (one pattern period: 5
   Mamba-2 blocks and the shared block with its LoRA), seamless at 1 + 1
   of 24 + 24 (with its cross-attention), qwen2-vl-7b at 1 of 28 (an
   8 x 8 patch image a request); each trained 2 steps of 4 x 32 (no
   microbatch: the time cut), clean and under a params flip every step
   (final state == clean bitwise), no ``gather_tree`` but the fsdp
   leaves' over ``data``, the model-axis collectives alike on every
   rank, the replicated leaves bitwise on the peers; served dense,
   donated, K=4 (xlstm with ``parity`` and a scrub), 4 slots, prompts of
   32, 4 new tokens, clean then with one flip in a slot (tokens ==
   clean), the caches bitwise on the peers, a steady step's collectives
   and bytes, decode p50 / p99; the mesh's first loss within 3e-2 of
   one device's, its first decode logits within 1e-3 in f32 and in bf16
   within 3e-2 or one device's own bf16-to-f32 distance (shard 0, after
   the ranks freed their blocks);
   (d) elastic hard loss, last (``[mesh-elastic]`` lines): iterpro-100m
   at all 12 layers with ``fsdp``, ``train(parity, elastic,
   kill_row_at=2, donate, fused_detect)``, 4 steps: row 1 (ranks 2-3)
   dies before step 2; its blocks are gathered first as the drill's
   oracle, then overwritten with ``ELASTIC_POISON``; the survivors take
   ``remesh`` alone (no disk restore, blocks rebuilt from the row-safe
   parity, their own blocks certified, none uncertified), resume on
   blocks bitwise the oracle's, finish 4 steps at 1 x 2 on the losses and
   final blocks of a clean 1 x 2 run from the oracle, STATS (1, 1) a
   step, 4 graphs captured again on the new context, every kernel of the
   path launched; the event's downtime, reconstruction and re-bind
   seconds and bytes printed beside the replay and checkpoint times; the
   dead ranks launch nothing after the loss;
15. the dry-run (``[dryrun]`` lines, ``dryrun_phase``): iterpro-100m's
   train cell at phase 7's shape (8 x 128, one device) traced on meta
   tensors on the host (``launch/dryrun.trace_cell``); its
   ``flops_per_device`` held equal to ``FlopCounterMode``'s count of one
   real functional train step on the card at the same shape (meta and the
   card dispatch the same work), and its roofline bound printed beside
   phase 7's measured functional step p50 and the card's name and power
   limit;
   then one JSON line describing every kernel (the 8 ports, the layout
   kernel ``flash_layout_kv`` of the flash port, ``pack_rows`` at 8f's
   two shapes and at 9a's 1-byte canary), then the device line.

A ``[time]`` line after each phase gives the seconds since the build
began.

Any failure raises; nothing is caught.
"""

from __future__ import annotations

import json
import os
import random
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12      # H100 SXM 32-bit rate outside tensor cores
TF32_OPS_PER_S = 494.7e12     # H100 SXM dense TF32 tensor-core rate
F32_TOL = 2e-5                # the reference's f32 tolerance
BF16_TOL = 3e-2               # the reference's bf16 tolerance
SPIN_CYCLES = 20_000_000      # ~10 ms device spin that hides host enqueue

# serving storms flip every 16 accepted tokens (the time cut: every
# serving path still storms, with half the flips)
N_REQUESTS, PROMPT, GEN, SLOTS, BLOCK, K, INJECT = 8, 128, 32, 4, 16, 4, 16
CHUNK = 32                    # --prefill-chunk of phase 5d's chunked mode
# the dense cache at the paged pool's capacity (max_len rounded up to whole
# blocks), so that both layouts attend over the same rows
DENSE_LEN = -(-(PROMPT + GEN + 1) // BLOCK) * BLOCK
T_BATCH, T_SEQ, T_STEPS, T_SNAP, T_CKPT, T_INJECT = 8, 128, 20, 4, 10, 6
WORK = ROOT / "build" / "chip_smoke"     # checkpoints (ignored by git)
_SMI = "?"                    # the card's name and power limit

FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, causal, window, softcap, dtype
    # the reference's FLASH_CASES (tests/test_kernels.py)
    (2, 128, 128, 4, 2, 32, True, 0, 0.0, "float32"),
    (1, 256, 256, 8, 8, 64, True, 64, 0.0, "float32"),
    (2, 64, 64, 4, 1, 16, True, 0, 30.0, "float32"),
    (1, 96, 96, 2, 2, 48, True, 0, 0.0, "float32"),
    (1, 128, 128, 2, 2, 128, False, 0, 0.0, "bfloat16"),
    (1, 64, 64, 4, 4, 160, True, 0, 0.0, "float32"),
    # edge cases
    (1, 100, 100, 2, 2, 16, False, 0, 0.0, "float32"),   # ragged Sk
    (1, 100, 300, 6, 2, 64, True, 0, 0.0, "float32"),    # Sq < Sk, G = 3
    (1, 300, 100, 6, 2, 64, True, 0, 0.0, "float32"),    # Sq > Sk
    (2, 200, 200, 12, 4, 64, True, 0, 0.0, "float32"),   # G = 3
    (1, 333, 333, 4, 2, 64, True, 50, 20.0, "float32"),  # window + softcap
    (1, 333, 333, 4, 2, 64, True, 50, 20.0, "bfloat16"),
    (3, 1, 257, 12, 4, 64, True, 0, 0.0, "float32"),     # Sq = 1
    (1, 150, 70, 6, 2, 32, True, 16, 0.0, "float32"),    # rows, no live key
    (2, 77, 77, 4, 2, 256, False, 0, 0.0, "bfloat16"),   # D = 256
]
FLASH_SHAPES = ((4, 128), (1, 8192))   # (B, S): serving prefill, long context


def _kernel_label(mangled: str) -> str:
    """``flash_attention_kernel<64, float>`` from an Itanium-mangled kernel
    name (its length-prefixed identifiers); the name's start otherwise."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        j = i + len(m.group())
        ident = mangled[j:j + int(m.group())]
        i = j + len(ident)
        if ident.endswith("_kernel"):
            t = re.match(r"ILi(\d+)E(f|13__nv_bfloat16)E", mangled[i:])
            if t:
                dtype = "float" if t.group(2) == "f" else "bf16"
                return f"{ident}<{t.group(1)}, {dtype}>"
            return ident
    return mangled[:48]


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _median_ms(fn, torch, flush, *, queued: bool, iters: int = 15,
               warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``, with L2 flushed (a
    64 MiB write) before each call.  ``queued``: a device-side spin holds
    the stream while the host enqueues the call, so the events time the
    device's work alone; otherwise the host's enqueue time is included
    (what a caller of the wrapper waits)."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        flush.zero_()
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


def _times(fn, torch, flush):
    """(device ms, per-call ms including the host's enqueue)."""
    return (_median_ms(fn, torch, flush, queued=True),
            _median_ms(fn, torch, flush, queued=False))


def _bound_ms(n_bytes: float, n_ops: float = 0.0):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_err(torch, a, b) -> int:
    """Largest word difference of two int32 views (0 == bitwise equal),
    taken 2^26 words at a time."""
    a, b = a.reshape(-1), b.reshape(-1)
    worst, step = 0, 1 << 26
    for i in range(0, a.numel(), step):
        d = (a[i:i + step].to(torch.int64) - b[i:i + step].to(torch.int64))
        worst = max(worst, int(d.abs().max()))
    return worst


def _rand_bits(torch, shape, dtype, gen):
    x = torch.randint(-2**31, 2**31, shape, dtype=torch.int64,
                      device="cuda", generator=gen).to(torch.int32)
    return x.view(dtype)


def check_kernels(torch, eng, flush):
    """Phase 3: bitwise checks and timings at the main path's shapes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import digest as kd
    from repro_torch.kernels import paged_kv as pkv
    from repro_torch.kernels import ref
    from repro_torch.serving import paged as pgd

    gen = torch.Generator(device="cuda").manual_seed(1234)
    # a pool and pos of the engine's shapes, filled with random bits
    pool = {"groups": [[{n: _rand_bits(torch, leaf.shape, leaf.dtype, gen)
                         for n, leaf in eng.pool["groups"][0][0].items()}]]}
    pos = _rand_bits(torch, (eng.S,), torch.int32, gen)
    view = pgd.paged_canary_view(pool, pos, eng.n_blocks, eng.S)
    plan = kd.plan_for(view)
    assert plan is eng.plan, "random view must share the engine's plan"
    core = eng._rotation(0)
    leaves = plan.leaves(view)
    flats = [ref.to_i32(leaves[i]) for i in core.union]
    starts = core.layout.starts
    n_words = sum(f.numel() for f in flats)
    rows = core.layout.padded_rows
    desc = ck.pack_descriptors(flats, starts, "cuda")

    def fresh():
        return torch.zeros(rows * ck.LANES, dtype=torch.int32, device="cuda")

    out = {}
    # -- pack_rows ---------------------------------------------------------
    # edge cases: leaves of 1, 3 and 5 words and of none, unaligned sources,
    # int32 extremes, chunk boundaries inside a leaf, and a leaf of 2^21
    # words (8 MiB), longer than one pass of the whole persistent grid
    # (132 CTAs x 32 KiB); then 3,000 leaves of 0-5 words (the kernel
    # stages their first_chunk column in 12 passes of its 256 threads)
    big = _rand_bits(torch, (1 << 21,), torch.int32, gen)
    edge = [torch.tensor([2**31 - 1], dtype=torch.int32, device="cuda"),
            torch.full((3,), -2**31, dtype=torch.int32, device="cuda"),
            _rand_bits(torch, (5,), torch.int32, gen), big[:0],
            _rand_bits(torch, (129,), torch.int32, gen),
            _rand_bits(torch, (1031,), torch.int32, gen)[1:],
            big[3:3 + 20_000], _rand_bits(torch, (5000,), torch.int32, gen),
            big]
    assert edge[5].data_ptr() % 16 and edge[6].data_ptr() % 16
    e_starts, r = [], 0
    for f in edge:
        e_starts.append(r * ck.LANES)
        r += max(1, -(-f.numel() // ck.LANES))
    r = -(-r // ck.TILE_ROWS) * ck.TILE_ROWS
    many_src = _rand_bits(torch, (3000 * 6 + 8,), torch.int32, gen)
    many = [many_src[6 * i + i % 3:6 * i + i % 3 + i % 6]
            for i in range(3000)]

    def pack_err(fl, st, n):
        """|kernel - plain| of one pack into a buffer of random bits (the
        words no leaf covers must stay as they were)."""
        bk = _rand_bits(torch, (n,), torch.int32, gen)
        bp = bk.clone()
        ck.pack_rows(bk, fl, st)
        ref.pack_rows_ref(bp, fl, st)
        return _max_err(torch, bk, bp)

    err = max(pack_err(flats, starts, rows * ck.LANES),
              pack_err(edge, e_starts, r * ck.LANES),
              pack_err(many, [ck.LANES * i for i in range(3000)],
                       3000 * ck.LANES))
    assert err == 0, f"pack_rows differs from its plain version ({err})"
    too_many = [many_src[:1]] * (ck.MAX_PACK_LEAVES + 1)
    try:
        ck.pack_rows(fresh(), too_many, [0] * len(too_many))
        raise AssertionError("pack_rows took more leaves than it stages")
    except ValueError as exc:
        assert "at most" in str(exc), exc
    del many_src, many, too_many
    ek = torch.zeros(r * ck.LANES, dtype=torch.int32, device="cuda")
    ck.pack_rows(ek, edge, e_starts)                # row_checksums' input
    del big, edge
    bk = fresh()
    ck.pack_rows(bk, flats, starts, desc=desc)      # row_checksums' input
    b = fresh()
    t_bytes, t_by = _bound_ms(2 * 4 * n_words)
    ms, call_ms = _times(lambda: ck.pack_rows(b, flats, starts, desc=desc),
                         torch, flush)
    plain_ms, plain_call_ms = _times(
        lambda: ref.pack_rows_ref(b, flats, starts), torch, flush)
    # one PyTorch call computing the same function: a fused multi-tensor
    # copy of every flat onto its slice view of the buffer
    dst = [b[st:st + f.numel()] for f, st in zip(flats, starts)]
    lib_ms = _median_ms(lambda: torch._foreach_copy_(dst, flats), torch,
                        flush, queued=True)
    same = torch.empty(n_words, dtype=torch.int32, device="cuda")
    copy_ms = _median_ms(lambda: b[:n_words].copy_(same), torch, flush,
                         queued=True)
    out["pack_rows"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/checksum.cu",
        replaces="src/repro/kernels/checksum.py:85", max_abs_err=err,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        plain_call_ms=plain_call_ms, bound_ms=t_bytes, bound_by=t_by,
        library_ms=lib_ms, library="torch._foreach_copy_",
        shape=f"{len(flats)} leaves, {n_words} words", copy_ms=copy_ms)

    # -- row_checksums -----------------------------------------------------
    x = bk.view(-1, ck.LANES)
    err = _max_err(torch, ck.row_checksums(x), ref.row_checksums_ref(x))
    ext = torch.tensor([2**31 - 1, -2**31, -1, 0], dtype=torch.int32,
                       device="cuda").repeat(ck.TILE_ROWS * ck.LANES // 4)
    xe = torch.cat([ek, ext]).view(-1, ck.LANES)
    err = max(err, _max_err(torch, ck.row_checksums(xe),
                            ref.row_checksums_ref(xe)))
    assert err == 0, f"row_checksums differs from its plain version ({err})"
    t_bound, t_by = _bound_ms(rows * (ck.LANES * 4 + 8),
                              rows * ck.LANES * 3)
    ms, call_ms = _times(lambda: ck.row_checksums(x), torch, flush)
    plain_ms, plain_call_ms = _times(lambda: ref.row_checksums_ref(x),
                                     torch, flush)
    out["row_checksums"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/checksum.cu",
        replaces="src/repro/kernels/checksum.py:136", max_abs_err=err,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        plain_call_ms=plain_call_ms, bound_ms=t_bound, bound_by=t_by,
        library_ms=None,
        shape=f"({rows}, {ck.LANES}) int32")

    # -- gather_blocks -----------------------------------------------------
    leaf = pool["groups"][0][0]["k"]
    perm = torch.randperm(eng.n_blocks - 1, generator=gen, device="cuda")
    bt = (perm[:eng.S * eng.max_blocks] + 1).view(
        eng.S, eng.max_blocks).to(torch.int32)
    bt[-1, -3:] = 0                              # unallocated -> scratch 0
    # edge cases: 21-word blocks, 66,000 (slot, block) pairs of 4-word
    # blocks, table entries of 0; the serving block (196,608 B) has chunk
    # boundaries inside it (6 chunks of 32 KiB)
    small = _rand_bits(torch, (5, 3, 7), torch.float32, gen)   # 21 words
    sbt = torch.tensor([[4, 0], [2, 2], [1, 3]], dtype=torch.int32,
                       device="cuda")
    tiny = _rand_bits(torch, (64, 4), torch.float32, gen)      # 4 words
    tbt = torch.randint(0, 64, (300, 220), dtype=torch.int32, device="cuda",
                        generator=gen)
    tbt[::7, ::5] = 0
    cases = [(leaf, bt), (small, sbt), (tiny, tbt)]
    err = 0
    for p, t in cases:
        err = max(err, _max_err(
            torch, pkv.gather_blocks(p, t).view(torch.int32),
            ref.gather_blocks_ref(p, t).view(torch.int32)))
    # an entry outside [0, n_blocks) gives a block of zeros
    obt = sbt.clone()
    obt[0, 1], obt[2, 0] = 5, -1
    got = pkv.gather_blocks(small, obt).view(torch.int32)
    want = ref.gather_blocks_ref(small, obt.clamp(0, 4)).view(
        torch.int32).clone()
    want[0, 1] = want[2, 0] = 0
    err = max(err, _max_err(torch, got, want))
    assert err == 0, f"gather_blocks differs from its plain version ({err})"
    del tiny, tbt
    # nothing to copy, no launch: an empty table, a pack of empty leaves
    before = dict(_build.LAUNCHES)
    assert pkv.gather_blocks(small, sbt[:0]).shape == (0, 2, 3, 7)
    nothing = torch.empty(0, dtype=torch.int32, device="cuda")
    ck.pack_rows(fresh(), [nothing, nothing], [0, ck.LANES])
    assert dict(_build.LAUNCHES) == before, "an empty call was counted"
    block_bytes = leaf[0].numel() * leaf.element_size()
    distinct = int(torch.unique(bt).numel())
    g_bound, g_by = _bound_ms((distinct + bt.numel()) * block_bytes)
    flat_bt = bt.reshape(-1).to(torch.int64)
    ms, call_ms = _times(lambda: pkv.gather_blocks(leaf, bt), torch, flush)
    plain_ms, plain_call_ms = _times(lambda: ref.gather_blocks_ref(leaf, bt),
                                     torch, flush)
    g_out = pkv.gather_blocks(leaf, bt)
    same = torch.empty_like(g_out)
    copy_ms = _median_ms(lambda: g_out.copy_(same), torch, flush,
                         queued=True)
    out["gather_blocks"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_kv.cu",
        replaces="src/repro/kernels/paged_kv.py:52", max_abs_err=err,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        plain_call_ms=plain_call_ms, bound_ms=g_bound, bound_by=g_by,
        library_ms=_median_ms(lambda: leaf.index_select(0, flat_bt),
                              torch, flush, queued=True),
        library="index_select",
        shape=f"pool {tuple(leaf.shape)}, bt {tuple(bt.shape)}",
        copy_ms=copy_ms)
    _print_kernels(out)
    floor_ms = _median_ms(lambda: torch.cuda._sleep(0), torch, flush,
                          queued=True)
    print(f"[copy] yardsticks: event floor {floor_ms:.4f} ms (an empty "
          f"kernel, torch.cuda._sleep(0)); contiguous copy_ of the same "
          f"bytes: pack_rows' {out['pack_rows']['copy_ms']:.4f} ms, "
          f"gather_blocks' {out['gather_blocks']['copy_ms']:.4f} ms")
    return out


def _print_kernels(out) -> None:
    for name, r in out.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms ({r['library']})"
        print(f"[kernel] {name}: bitwise equal to plain (max_abs_err "
              f"{r['max_abs_err']}), {r['shape']}: device time kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); per call with host enqueue: kernel "
              f"{r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms")


def check_reference(torch):
    """Phase 4: the smoke model on the card against the same code on the
    CPU, prefill + 4 decode steps, within the reference's f32 tolerance."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    m = get_config("iterpro-100m").smoke().model
    p_cpu = T.init_lm(m, 0, "cpu")
    p_gpu = tree_map(lambda t: t.to("cuda"), p_cpu)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, m.vocab_size, (1, 12))
        .astype(np.int32))
    worst = 0.0
    lc, cc = T.prefill(p_cpu, m, {"tokens": toks}, max_len=24)
    lg, cg = T.prefill(p_gpu, m, {"tokens": toks.cuda()}, max_len=24)
    for step in range(5):
        torch.testing.assert_close(lg.cpu(), lc, atol=F32_TOL, rtol=F32_TOL)
        assert bool(torch.isfinite(lg).all()) and lg.shape == (1,
                                                               m.vocab_size)
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
        if step < 4:
            t = lc.argmax(-1).to(torch.int32)
            lc, cc = T.decode_step(p_cpu, m, cc, t)
            lg, cg = T.decode_step(p_gpu, m, cg, t.cuda())
    print(f"[reference] smoke prefill + 4 decode steps on the card vs the "
          f"CPU: max |dlogit| {worst:.3e} (tolerance {F32_TOL})")


SERVE_MODES = (
    # name, engine keywords; "uncaptured" runs the step's body eagerly on
    # the card (the engine's private ``_replay`` hook): the yardstick
    ("uncaptured", dict()),
    ("paged", dict()),
    ("paged, no donation", dict(donate=False)),
    ("dense", dict(paged=False, max_len=DENSE_LEN)),
    # no dense ping-pong mode here (the time cut: 10a-13a serve it at
    # full width, 14e's e2 on the mesh)
    ("chunked", dict(prefill_chunk=CHUNK)),
)


# 5d's storms: the layouts and the ping-pong storage phase 5 does not
# storm (its paged donated engine does; the uncaptured body and the dense
# ping-pong mode run the same code as a stormed mode: the time cut)
STORM_MODES = ("paged, no donation", "dense", "chunked")


def _graph_pool_bytes(torch) -> int:
    """Bytes reserved in CUDA graphs' private memory pools."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) != (0, 0))


_UNIT_PREFIX = re.compile(r"^(slot|block)\d+/(groups/\d+/\d+/)?")


def _recording_storm(eng) -> "Counter":
    """Count the leaf kinds (``k``, ``state/C``, ``conv``, ``pos``, ...)
    the engine's storm flips, by wrapping its ``corrupt_slot``."""
    from collections import Counter
    hits = Counter()
    flip = eng.corrupt_slot

    def recorded(*a, **kw):
        out = flip(*a, **kw)
        hits[_UNIT_PREFIX.sub("", out[1])] += 1
        return out
    eng.corrupt_slot = recorded
    return hits


def serve_modes(torch, cfg, params, common, reqs, clean_tokens,
                steps: int = 8, modes=SERVE_MODES,
                label: str = "serve-modes", storms=None) -> dict:
    """Phase 5d: every serving mode at full width on phase 5's params and
    requests.  Per mode, with the launch counts set to 0 just before and
    read just after: ``warm()`` (2K = 8 graphs captured, their seconds and
    their pool's bytes), a clean run whose tokens equal phase 5's (the
    captured paged donated engine) bitwise, a storm run on the same
    engine (a flip every ``INJECT`` accepted tokens) with detected ==
    injected == recovered and tokens == clean, and every kernel of the
    path launched (through graph replays); then ``steps`` steady engine
    steps under torch.profiler: one ``cudaGraphLaunch`` and no
    ``cudaLaunchKernel`` a step on the captured modes, ``digest.STATS``
    1 launch + 1 fetch a step, every pointer the graphs read unchanged;
    each mode's decode p50 / p99 (the clean run) and device busy ms a
    step beside the card's name and power limit.  ``storms`` names the
    modes that run the storm (None: every mode).  Returns the launch
    counts summed over the modes."""
    import gc
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    from repro_torch.kernels import _build
    from repro_torch.kernels import digest as kd
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import ServingReport
    from repro_torch.tree import leaves

    def tokens_of(rep):
        return {rid: r["tokens"] for rid, r in rep.per_request.items()}

    total = Counter()
    for name, kw in modes:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        eng = ServingEngine(cfg, params=params, **dict(common, **kw))
        captured = name != "uncaptured"
        if not captured:
            eng._replay = False
        pool0 = _graph_pool_bytes(torch)
        warm_s = eng.warm()
        torch.cuda.synchronize()
        pool_bytes = _graph_pool_bytes(torch) - pool0
        assert eng.n_captures == (2 * K if captured else 0), eng.n_captures
        clean = eng.run(reqs())
        cs = clean.summary()
        assert cs["completed"] == N_REQUESTS and cs["dropped"] == 0, cs
        assert tokens_of(clean) == clean_tokens, (
            f"{name}: tokens differ from the reference tokens")
        stormed = "clean tokens == the reference tokens"
        if storms is None or name in storms:
            eng.report = ServingReport(n_slots=eng.S)
            hits = _recording_storm(eng)
            storm = eng.run(reqs(), inject_every=INJECT,
                            inject_rng=random.Random(0))
            ss = storm.summary()
            f = ss["faults"]
            assert f["injected"] > 0 and f["detected"] == f["injected"], f
            assert f["recovered"] == f["detected"] and ss["dropped"] == 0, ss
            assert tokens_of(storm) == clean_tokens, (
                f"{name}: storm tokens differ from clean tokens")
            stormed = (f"clean and storm tokens == the reference tokens, "
                       f"storm faults {f}, flips by leaf {dict(hits)}")
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        total.update(launches)
        path = ("pack_rows", "row_checksums") + (
            ("gather_blocks",) if eng.paged else ())
        for kernel in path:
            assert launches.get(kernel, 0) > 0, (name, kernel, launches)

        # steady window: every slot decoding, one rotation first
        for u, rq in enumerate(reqs()[:eng.S]):
            eng.admit(rq, u)
        for _ in range(K):
            assert eng.engine_step()[2] is None

        def pointers():
            return ([t.data_ptr() for v in eng._versions for t in leaves(v)]
                    + [t.data_ptr() for t in eng.canary._tables]
                    + [eng.plan.buffer_pointer(eng._rotation(r).union)
                       for r in range(K)]
                    + [t.data_ptr() for t in (eng.amask, eng.tok,
                                              eng._forced)]
                    + [t.data_ptr() for t in leaves(eng.params)]
                    + ([eng.bt.data_ptr()] if eng.paged else []))
        torch.cuda.synchronize()
        before = pointers()
        kd.STATS.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                assert eng.engine_step()[2] is None
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        stats = kd.STATS.snapshot()
        api = _api_counts(prof)
        assert stats == (steps, steps), stats
        assert pointers() == before, f"{name}: a pointer the step reads moved"
        if captured:
            assert api.get("cudaGraphLaunch", 0) == steps, api
            assert api.get("cudaLaunchKernel", 0) + \
                api.get("cuLaunchKernel", 0) == 0, api
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / steps
        cap = (f"{eng.n_captures} graphs captured in "
               f"{eng.capture_seconds:.3f} s (warm {warm_s:.3f} s), graph "
               f"pool {pool_bytes / 2**20:.1f} MiB" if captured
               else "no graph (the body run eagerly)")
        print(f"[{label}] {name}: {cap}; {stormed} for all {N_REQUESTS} "
              f"requests; launches {launches}; {steps} steady "
              f"steps: digest.STATS {stats[0]} launches {stats[1]} "
              f"fetches, host API {api}, every pointer the step reads "
              f"unchanged; decode p50 {cs['p50_decode_ms']:.3f} ms p99 "
              f"{cs['p99_decode_ms']:.3f} ms (clean run), device busy "
              f"{busy:.3f} ms/step [{_SMI}]")
        _report_profile(prof, steps, wall_ms, f"{name} engine step",
                        ("pack_rows_kernel", "row_checksums_kernel",
                         "gather_blocks_kernel"))
        del eng, prof
    return dict(total)


def _expect(exc, fn, what: str) -> str:
    """Run ``fn`` and require it to raise ``exc``; returns the message."""
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"{what} did not raise {exc.__name__}")


def check_train_kernels(torch, flush, state):
    """Phase 6: ``checksum_tiles`` and ``vote3_tiles`` bitwise against
    their plain versions at the training path's shapes and on edge cases,
    timed; every wrapper refuses a non-contiguous CUDA operand."""
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_kv as pkv
    from repro_torch.kernels import parity as pk
    from repro_torch.kernels import ref
    from repro_torch.kernels import vote as vk
    from repro_torch.tree import leaves

    gen = torch.Generator(device="cuda").manual_seed(4321)
    p = state["params"]
    shapes = {"embedding": tuple(p["embed"]["table"].shape),
              "ffn": tuple(p["groups"][0][0]["ffn"]["up"]["w"].shape),
              "norm": tuple(p["final_norm"]["scale"].shape)}
    main = {k: _rand_bits(torch, v, torch.float32, gen)
            for k, v in shapes.items()}
    big = _rand_bits(torch, (2 * ck.TILE + 8,), torch.int32, gen)
    edge = {"int32 extremes": torch.tensor(
                [2**31 - 1, -2**31, -1, 0], dtype=torch.int32,
                device="cuda").repeat(ck.TILE // 2),
            "1 word": big[:1], "tile-ragged": big[:ck.TILE + 5],
            "unaligned source": big[1:]}
    assert edge["unaligned source"].data_ptr() % 16

    out = {}
    # -- checksum_tiles ----------------------------------------------------
    err = 0
    for x in list(main.values()) + list(edge.values()):
        flat = ref.to_i32(x)
        err = max(err, _max_err(torch, ck.checksum_tiles(flat),
                                ref.checksum_tiles_ref(flat)),
                  _max_err(torch, ops.checksum(x), ref.checksum_ref(x)))
    assert err == 0, f"checksum_tiles differs from its plain version ({err})"
    flat = ref.to_i32(main["embedding"])
    n, nt = flat.numel(), -(-flat.numel() // ck.TILE)
    t_bound, t_by = _bound_ms(4 * n + 8 * nt, 3 * n)
    ms, call_ms = _times(lambda: ck.checksum_tiles(flat), torch, flush)
    plain_ms, plain_call_ms = _times(lambda: ref.checksum_tiles_ref(flat),
                                     torch, flush)
    out["checksum_tiles"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/checksum.cu",
        replaces="src/repro/kernels/checksum.py:122", max_abs_err=err,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        plain_call_ms=plain_call_ms, bound_ms=t_bound, bound_by=t_by,
        library_ms=None, shape=f"embedding leaf {shapes['embedding']} f32, "
        f"{nt} tiles")
    # a whole-state pass (what one checkpoint save launches)
    flats = [ref.to_i32(t) for t in leaves(state)]
    words = sum(f.numel() for f in flats)
    tiles = sum(max(1, -(-f.numel() // ck.TILE)) for f in flats)
    w_bound, _ = _bound_ms(4 * words + 8 * tiles, 3 * words)
    w_ms = _median_ms(lambda: [ck.checksum_tiles(f) for f in flats], torch,
                      flush, queued=True, iters=7)
    print(f"[kernel] checksum_tiles whole-state pass: {len(flats)} leaves, "
          f"{tiles} tiles, {4 * words / 1e9:.3f} GB: device time "
          f"{w_ms:.4f} ms, bound {w_bound:.4f} ms (bytes)")

    # -- vote3_tiles -------------------------------------------------------
    err = 0
    for x in list(main.values()) + list(edge.values()):
        a = ref.to_i32(x)
        b, c = a.clone(), a.clone()
        n_flip = max(1, a.numel() // 1000)
        for t, seed in ((b, 1), (c, 2)):
            pos = torch.randint(0, a.numel(), (n_flip,), device="cuda",
                                generator=gen)
            t[pos] ^= 1 << seed
        got = vk.vote3_tiles(a, b, c)
        err = max(err, _max_err(torch, got, ref.vote3_tiles_ref(a, b, c)))
        if a.numel() > 1:
            unaligned = vk.vote3_tiles(a[1:], b[1:], c[1:])
            err = max(err, _max_err(torch, unaligned,
                                    ref.vote3_tiles_ref(a[1:], b[1:], c[1:])))
        err = max(err, _max_err(torch,
                                ref.to_i32(ops.vote3(x, x.clone(), x.clone())),
                                ref.to_i32(x)))
    assert err == 0, f"vote3_tiles differs from its plain version ({err})"
    a = ref.to_i32(main["embedding"])
    b, c = a.clone(), a.clone()
    n = a.numel()
    t_bound, t_by = _bound_ms(16 * n, 5 * n)
    ms, call_ms = _times(lambda: vk.vote3_tiles(a, b, c), torch, flush)
    plain_ms, plain_call_ms = _times(lambda: ref.vote3_tiles_ref(a, b, c),
                                     torch, flush)
    out["vote3_tiles"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/vote.cu",
        replaces="src/repro/kernels/vote.py:27", max_abs_err=err,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        plain_call_ms=plain_call_ms, bound_ms=t_bound, bound_by=t_by,
        library_ms=None, shape=f"embedding leaf {shapes['embedding']} f32 "
        f"x 3")
    _print_kernels(out)

    # -- every wrapper refuses a non-contiguous CUDA operand --------------
    rows = _rand_bits(torch, (512, 2 * ck.LANES), torch.int32, gen)
    strided = rows[:, :ck.LANES]                   # (512, 128), stride 256
    assert not strided.is_contiguous()
    pool = _rand_bits(torch, (6, 4, 8), torch.float32, gen)
    bt = torch.zeros((3, 2), dtype=torch.int32, device="cuda")
    buf = torch.zeros(4 * ck.TILE_ROWS * ck.LANES, dtype=torch.int32,
                      device="cuda")
    wide = _rand_bits(torch, (2, 1, ck.TILE_ROWS, 2 * ck.LANES), torch.int32,
                      gen)
    tiles = wide[..., :ck.LANES]                   # (2, 1, 256, 128), strided
    assert not tiles.is_contiguous()
    refusals = {
        "pack_rows": lambda: ck.pack_rows(buf, [strided.reshape(-1)[::2]],
                                          [0]),
        "row_checksums": lambda: ck.row_checksums(strided),
        "gather_blocks (pool)": lambda: pkv.gather_blocks(
            pool.transpose(1, 2), bt),
        "gather_blocks (table)": lambda: pkv.gather_blocks(
            pool, torch.zeros((2, 3), dtype=torch.int32, device="cuda").t()),
        "checksum_tiles": lambda: ck.checksum_tiles(rows.reshape(-1)[::2]),
        "vote3_tiles": lambda: vk.vote3_tiles(*(rows.reshape(-1)[::2],) * 3),
        "xor_fold_tiles": lambda: pk.xor_fold_tiles(tiles),
        "xor_update_tiles (x)": lambda: pk.xor_update_tiles(
            tiles, torch.zeros_like(tiles[0])),
        "xor_update_tiles (parity)": lambda: pk.xor_update_tiles(
            tiles.contiguous(), tiles[0]),
    }
    for name, fn in refusals.items():
        _expect(ValueError, fn, name)
    print(f"[kernel] non-contiguous CUDA operands refused by "
          f"{', '.join(refusals)}")
    return out


def check_parity_kernels(torch, flush, state, params):
    """Phase 6b: ``xor_update_tiles`` and ``xor_fold_tiles`` bitwise against
    their plain versions at the parity plans' shapes and on edge cases,
    timed; then the per-step pieces of ``ParityPlan.update_leaves`` on the
    full-width state."""
    from repro_torch.core.parity import parity_plan_for
    from repro_torch.kernels import parity as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(2468)
    tplan, splan = parity_plan_for(state), parity_plan_for(params)
    print(f"[parity] plans: training {len(tplan.keys)} leaves, "
          f"{tplan.stream_len} words, {tplan.n_tiles} tiles, "
          f"{tplan.memory_bytes} B; serving {len(splan.keys)} leaves, "
          f"{splan.stream_len} words, {splan.n_tiles} tiles, "
          f"{splan.memory_bytes} B; D = {tplan.n_shards}")

    def tiles(d, nt):
        return _rand_bits(torch, (d, nt, pk.TILE_ROWS, pk.LANES),
                          torch.int32, gen)

    ext = torch.tensor([2**31 - 1, -2**31, -1, 0], dtype=torch.int32,
                       device="cuda").repeat(pk.TILE_ROWS * pk.LANES // 4)
    ext = ext.view(1, 1, pk.TILE_ROWS, pk.LANES)
    cases = {"training": tiles(tplan.n_shards, tplan.n_tiles),
             "serving": tiles(splan.n_shards, splan.n_tiles),
             "1 tile": tiles(4, 1), "D = 1": tiles(1, 3),
             "R = 2": tiles(2, 2), "R = 5": tiles(5, 2),
             "int32 extremes": torch.cat([ext, ~ext, ext.roll(1, -1)])}
    err = 0
    for name, x in cases.items():
        err = max(err, _max_err(torch, pk.xor_fold_tiles(x),
                                ref.xor_fold_tiles_ref(x)))
        p = _rand_bits(torch, x.shape[1:], torch.int32, gen)
        plain, ptr = p.clone(), p.data_ptr()
        got = pk.xor_update_tiles(x, p)
        assert got is p and p.data_ptr() == ptr, name
        err = max(err, _max_err(torch, p, ref.xor_update_tiles_ref(x, plain)))
        z = pk.xor_update_tiles(x, torch.zeros_like(p))
        err = max(err, _max_err(torch, z, pk.xor_fold_tiles(x)))
        del p, plain, z
    assert err == 0, f"parity kernels differ from their plain versions ({err})"
    print(f"[parity] xor_fold_tiles and xor_update_tiles bitwise equal to "
          f"their plain versions on {', '.join(cases)}; the update keeps "
          f"the parity's data_ptr and equals the fold on a zero parity")

    out = {}
    x = cases["training"]
    d, nt = x.shape[0], x.shape[1]
    n = nt * pk.TILE_ROWS * pk.LANES
    p = torch.zeros(x.shape[1:], dtype=torch.int32, device="cuda")
    shape = f"D = {d}, {nt} tiles ({4 * n / 1e6:.1f} MB each)"
    t_bound, t_by = _bound_ms((d + 2) * 4 * n, d * n)
    ms, call_ms = _times(lambda: pk.xor_update_tiles(x, p), torch, flush)
    plain_ms, plain_call_ms = _times(
        lambda: ref.xor_update_tiles_ref(x, p), torch, flush)
    out["xor_update_tiles"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/parity.cu",
        replaces="src/repro/kernels/parity.py:52", max_abs_err=err,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        plain_call_ms=plain_call_ms, bound_ms=t_bound, bound_by=t_by,
        library_ms=None, shape=shape)
    t_bound, t_by = _bound_ms((d + 1) * 4 * n, (d - 1) * n)
    ms, call_ms = _times(lambda: pk.xor_fold_tiles(x), torch, flush)
    plain_ms, plain_call_ms = _times(lambda: ref.xor_fold_tiles_ref(x),
                                     torch, flush)
    out["xor_fold_tiles"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/parity.cu",
        replaces="src/repro/kernels/parity.py:30", max_abs_err=err,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        plain_call_ms=plain_call_ms, bound_ms=t_bound, bound_by=t_by,
        library_ms=None, shape=f"R = {shape}")
    _print_kernels(out)
    xs = cases["serving"]
    ns = xs.shape[1] * pk.TILE_ROWS * pk.LANES
    s_ms = _median_ms(lambda: pk.xor_fold_tiles(xs), torch, flush,
                      queued=True)
    print(f"[kernel] xor_fold_tiles at the serving shape (R = "
          f"{xs.shape[0]}, {xs.shape[1]} tiles): device time {s_ms:.4f} ms, "
          f"bound {_bound_ms((xs.shape[0] + 1) * 4 * ns)[0]:.4f} ms (bytes)")
    del cases, x, xs, p

    # the per-step pieces of the gated incremental update on the real
    # full-width state (contents do not matter for the time)
    old = tplan.leaves(state)
    new = [t.clone() for t in old]
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    parity = tplan.rebuild_leaves(old)
    delta = tplan.stream_mat(old, new)
    words = sum(t.numel() for t in old)
    build_ms, build_call_ms = _times(lambda: tplan.stream_mat(old, new),
                                     torch, flush)
    gate_ms = _median_ms(lambda: delta.masked_fill_(flag, 0), torch, flush,
                         queued=True)
    upd_ms, upd_call_ms = _times(
        lambda: tplan.update_leaves(parity, old, new, flag), torch, flush)
    print(f"[parity] update_leaves on the full-width state ({words} words "
          f"in {len(old)} leaves): delta build {build_ms:.4f} ms device "
          f"({build_call_ms:.4f} ms per call), fault gate {gate_ms:.4f} ms, "
          f"whole update {upd_ms:.4f} ms device ({upd_call_ms:.4f} ms per "
          f"call); bytes bound of the delta build "
          f"{_bound_ms(3 * 4 * words)[0]:.4f} ms")
    return out


def _same_state(torch, a, b) -> bool:
    """``a`` and ``b`` bitwise equal, leaf for leaf; a leaf of ``b`` on
    another device than ``a``'s is copied to ``a``'s, one leaf at a time
    (a final state on the card against a host copy of the clean one)."""
    from repro_torch.tree import flatten_with_path, leaf_key
    fa = {leaf_key(p): t for p, t in flatten_with_path(a)}
    fb = {leaf_key(p): t for p, t in flatten_with_path(b)}
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].reshape(-1).view(torch.uint8),
                    fb[k].to(fa[k].device).reshape(-1).view(torch.uint8))
        for k in fa)


def _live_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(q, k) pairs the masks leave live, per head (top-left aligned)."""
    n = 0
    for qp in range(Sq):
        hi = min(Sk - 1, qp) if causal else Sk - 1
        lo = max(0, qp - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def check_flash(torch, flush, mcfg):
    """Phase 6c: ``flash_attention_bhsd`` against its plain version on the
    edge cases, then the main path at full attention width (launch
    counts read around it), held against the plain version and the
    model's attention, and timed."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1357)

    def qkv(B, Sq, Sk, H, KV, D, dtype=torch.float32):
        return tuple(torch.randn(shape, generator=gen, device="cuda")
                     .to(dtype) for shape in
                     ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))

    def plain(q, k, v, **kw):
        B, Sq, H, D = q.shape
        flat = [t.transpose(1, 2).reshape(-1, t.shape[1], D)
                for t in (q, k, v)]
        o = ref.flash_attention_ref(*flat, **kw)
        return o.reshape(B, H, Sq, D).transpose(1, 2)

    for case in FLASH_CASES:
        B, Sq, Sk, H, KV, D, causal, window, cap, dt = case
        q, k, v = qkv(B, Sq, Sk, H, KV, D, getattr(torch, dt))
        kw = dict(causal=causal, window=window, softcap=cap)
        got = ops.flash_attention(q, k, v, **kw)
        want = plain(q, k, v, **kw)
        tol = BF16_TOL if dt == "bfloat16" else F32_TOL
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        print(f"[flash] B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} "
              f"causal={causal} window={window} softcap={cap} {dt}: max "
              f"|kernel - plain| {err:.3e} (tolerance {tol})")

    H, KV, D = mcfg.n_heads, mcfg.n_kv_heads, mcfg.resolved_head_dim
    inputs = {(B, S): qkv(B, S, S, H, KV, D) for B, S in FLASH_SHAPES}
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    outs = {shape: ops.flash_attention(*t, causal=True)
            for shape, t in inputs.items()}
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for name in ("flash_layout_kv", "flash_attention_bhsd"):
        assert launches.get(name, 0) > 0, launches
    print(f"[flash] launches on the main path (ops.flash_attention at "
          f"{len(FLASH_SHAPES)} shapes): {launches}")

    rows, worst = {}, 0.0          # worst: |kernel - plain| at both shapes
    layout_rows = {}
    for (B, S), (q, k, v) in inputs.items():
        o = outs[(B, S)]
        assert o.shape == (B, S, H, D) and bool(torch.isfinite(o).all())
        want = plain(q, k, v, causal=True)
        pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S)
        model = L.attention(q, k, v, pos, pos)
        errs = [float((o - w).abs().max()) for w in (want, model)]
        for w in (want, model):
            torch.testing.assert_close(o, w, atol=F32_TOL, rtol=F32_TOL)
        worst = max(worst, errs[0])
        del want, model
        torch.cuda.empty_cache()
        flat = [t.transpose(1, 2).reshape(-1, S, D).contiguous()
                for t in (q, k, v)]
        # the kernel's own arithmetic (three TF32 passes), for reading only
        emu = ref.flash_attention_3xtf32(*flat).view(B, H, S, D)
        err_emu = float((o.transpose(1, 2) - emu).abs().max())
        del emu
        torch.cuda.empty_cache()
        path = "chunked" if S > L.FLASH_THRESHOLD else "direct"
        print(f"[flash] B={B} S={S} H={H} KV={KV} D={D} f32 causal: max "
              f"|kernel - plain| {errs[0]:.3e}, |kernel - model attention "
              f"({path})| {errs[1]:.3e} (tolerance {F32_TOL}); |kernel - "
              f"3xTF32 emulation| {err_emu:.3e}")

        n_ops = 4 * D * B * H * _live_pairs(S, S, True, 0)
        n_bytes = 4 * (2 * flat[0].numel() + flat[1].numel()
                       + flat[2].numel())
        # the products run on the tensor cores as three TF32 passes; the
        # SIMT bound (f32 on the CUDA cores) is kept beside it
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_tc = 3 * n_ops / TF32_OPS_PER_S * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_tc else \
            (t_tc, "operations")
        bound_simt, _ = _bound_ms(n_bytes, n_ops)
        ms, call_ms = _times(lambda: fa.flash_attention_bhsd(*flat), torch,
                             flush)
        plain_ms, plain_call_ms = _times(
            lambda: ref.flash_attention_ref(*flat), torch, flush)
        q4, k4, v4 = (t.view(B, -1, S, D) for t in flat)

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                  enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2) - o).abs().max())
        lib_ms = _median_ms(sdpa, torch, flush, queued=True)
        rows[(B, S)] = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:106",
            ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            plain_call_ms=plain_call_ms, bound_ms=bound, bound_by=by,
            bound_simt_ms=bound_simt, library_ms=lib_ms)
        # the layout kernel alone: its records bitwise against the plain
        # version's (the same TF32 split and layout), timed beside its
        # bytes bound (K and V read once, the records written once)
        kv, bk = flat[1:], fa.TILE_KEYS[D]
        rec = fa.flash_layout_kv(*kv)
        rec_plain = ref.flash_layout_kv_ref(*kv, S, bk)
        lay_err = _max_err(torch, rec.view(torch.int32),
                           rec_plain.view(torch.int32))
        assert lay_err == 0, f"flash_layout_kv differs from its plain " \
            f"version ({lay_err})"
        lay_bound, lay_by = _bound_ms(4 * (kv[0].numel() + kv[1].numel()
                                           + rec.numel()))
        lay_ms = _median_ms(lambda: fa.flash_layout_kv(*kv), torch, flush,
                            queued=True)
        lay_plain_ms = _median_ms(
            lambda: ref.flash_layout_kv_ref(*kv, S, bk), torch, flush,
            queued=True)
        del rec, rec_plain
        layout_rows[(B, S)] = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:106",
            ms=lay_ms, plain_ms=lay_plain_ms, bound_ms=lay_bound,
            bound_by=lay_by, library_ms=None, max_abs_err=lay_err)
        print(f"[flash] flash_layout_kv alone at B={B} S={S}: records "
              f"bitwise equal to plain (max_abs_err {lay_err}), device time "
              f"kernel {lay_ms:.4f} ms, plain {lay_plain_ms:.4f} ms, "
              f"library none, bound {lay_bound:.4f} ms ({lay_by})")
        print(f"[flash] B={B} S={S}: {n_ops:.4e} operations, {n_bytes} B: "
              f"device time kernel {ms:.4f} ms (flash_layout_kv + "
              f"flash_attention_bhsd), plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms (scaled_dot_product_attention, max "
              f"|sdpa - kernel| {lib_err:.3e}), bound {bound:.4f} ms ({by}, "
              f"3 TF32 passes on the tensor cores; kernel at "
              f"{100 * bound / ms:.1f} %), bound_simt_ms "
              f"{bound_simt:.4f} (f32 on the CUDA cores; kernel at "
              f"{100 * bound_simt / ms:.1f} %); per call with host "
              f"enqueue: kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} "
              f"ms")
    out = {"flash_attention_bhsd": dict(rows[FLASH_SHAPES[-1]],
                                        max_abs_err=worst),
           "flash_layout_kv": layout_rows[FLASH_SHAPES[-1]]}
    return out, launches


def train_run(torch, cfg, name, slices: int = 1, **kw):
    """One full-width run of the training entry point with the storm
    settings of phase 7 (checkpoints under ``WORK/<name>``), at canary
    rotation period ``slices``; prints its summary and returns
    ``(summary, final state)``."""
    from repro_torch.launch.train import train
    d = WORK / name.replace(" ", "_").replace("=", "")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    out, state = train(cfg, steps=T_STEPS, global_batch=T_BATCH,
                       seq_len=T_SEQ, seed=0, snapshot_interval=T_SNAP,
                       canary_slices=slices, checkpoint_dir=str(d),
                       checkpoint_interval=T_CKPT, verbose=False,
                       device="cuda", return_state=True, **kw)
    rec = out["recovery"]
    print(f"[train] {name}: {out['steps']} steps in "
          f"{time.perf_counter() - t0:.1f} s, final loss "
          f"{out['final_loss']:.6f}, step p50 {out['p50_step_ms']:.3f} "
          f"ms (mean {out['mean_step_ms']:.3f}), faults injected "
          f"{out['faults_injected']} detected {out['faults_detected']} "
          f"recovered {out['faults_recovered']}, recovery p50 "
          f"{out['p50_recovery_ms']:.3f} ms, rate "
          f"{rec['recovery_rate']}, rungs {rec['by_rung']}, p50 by rung "
          f"{rec['p50_wall_ms_by_rung']}")
    return out, state


def run_training(torch, cfg):
    """Phase 7a: clean and params-storm runs of the training entry point
    (no iv storm, the time cut: 14 holds one on the mesh, through eq1);
    returns {name: (summary, final state)}."""
    from repro_torch.tree import leaves
    runs = {}
    for name, kw in (("clean", {}),
                     ("params storm", dict(inject_every=T_INJECT))):
        runs[name] = train_run(torch, cfg, name, **kw)
    clean, clean_state = runs["clean"]
    assert clean["steps"] == T_STEPS and clean["faults_detected"] == 0
    assert clean["recovery"]["events"] == 0
    for name in ("params storm",):
        out, state = runs[name]
        assert out["steps"] == T_STEPS, out
        assert out["faults_injected"] > 0, out
        assert out["faults_detected"] == out["faults_injected"], out
        assert out["faults_recovered"] == out["faults_detected"], out
        assert out["recovery"]["recovery_rate"] == 1.0, out
    assert _same_state(torch, runs["params storm"][1], clean_state), \
        "params storm final state differs from the clean run's"
    print(f"[train] params storm final state == clean final state, bitwise "
          f"({sum(t.numel() for t in leaves(clean_state))} elements)")
    return runs


def recover_on_card(torch, cfg, clean_state):
    """Phase 7b: the replica_vote and checkpoint rungs on the card, and a
    corrupted checkpoint refused at load."""
    import numpy as np
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.detect import FaultReport
    from repro_torch.core.faults import InjectionPlan, inject
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import cuda_numerics
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import tree_map

    ckpt_dir = WORK / "params_storm"
    pipe = TokenPipeline(cfg.model.vocab_size, T_SEQ, T_BATCH, seed=0)
    clone = lambda tree: tree_map(torch.clone, tree)
    with cuda_numerics(torch.device("cuda")):
        rt = RecoveryRuntime(
            step_fn=make_train_step(cfg, global_batch=T_BATCH),
            batch_fn=lambda s: {k: v.cuda()
                                for k, v in pipe.batch_at(s).items()},
            iv_registry=promote(cfg, T_BATCH),
            micro=MicroCheckpointer(T_SNAP),
            replicas=lambda s: [clone(clean_state), clone(clean_state)],
            checkpoint=lambda: load_checkpoint(str(ckpt_dir), clean_state))
        bad = clone(clean_state)
        table = clean_state["params"]["embed"]["table"]
        inject(bad, InjectionPlan("embed/table", table.numel() // 3, 30,
                                  T_STEPS))
        assert not _same_state(torch, bad, clean_state)
        fixed, ev = rt.recover(bad, FaultReport(
            T_STEPS, "checksum", leaves=["params/embed/table"]), T_STEPS)
        assert ev.rung == "replica_vote", ev
        assert _same_state(torch, fixed, clean_state)
        print(f"[recover] replica_vote on a flipped embedding leaf: "
              f"{ev.wall_seconds * 1e3:.3f} ms, attempted {ev.attempted}, "
              f"result == clean state, bitwise")
        fixed, ev = rt.recover(bad, FaultReport(T_STEPS, "external"),
                               T_STEPS, ladder=["checkpoint"])
        assert ev.rung == "checkpoint" and ev.steps_replayed == T_STEPS - \
            T_CKPT, ev
        assert _same_state(torch, fixed, clean_state)
        print(f"[recover] checkpoint rung: digest-verified load of step "
              f"{T_CKPT} + {ev.steps_replayed} replayed steps in "
              f"{ev.wall_seconds * 1e3:.1f} ms, result == clean state, "
              f"bitwise")
    # a payload rewritten with one flipped byte is a valid zip with wrong
    # bytes: only the digest check can refuse it
    bad_dir = WORK / "corrupt"
    shutil.rmtree(bad_dir, ignore_errors=True)
    shutil.copytree(ckpt_dir, bad_dir)
    manifest = json.loads((bad_dir / "manifest.json").read_text())
    payload = bad_dir / manifest["payload"]
    with np.load(payload) as z:
        arrays = {k: z[k] for k in z.files}
    victim = "params/groups/0/0/ffn/down/w"
    arrays[victim] = arrays[victim].copy()
    arrays[victim].view(np.uint8).reshape(-1)[1001] ^= 0x10
    with open(payload, "wb") as f:
        np.savez(f, **arrays)
    del arrays
    msg = _expect(ValueError,
                  lambda: load_checkpoint(str(bad_dir), clean_state),
                  "load_checkpoint of a corrupted payload")
    assert "digest mismatch" in msg and victim in msg, msg
    print(f"[recover] corrupted checkpoint refused at load: {msg}")
    shutil.rmtree(WORK, ignore_errors=True)


def check_pack_training(torch, flush, state):
    """Phase 7b, after the rungs: ``pack_rows`` alone at the training
    canary's shape — the 41 leaves of the state into the check half of
    the K=1 check+arm buffer (1.201 GB read and written, what each of the
    two launches per step moves) — bitwise against its plain version,
    timed beside its bound, ``_foreach_copy_`` and a
    contiguous ``copy_`` of the same bytes; then the step's one
    ``row_checksums`` launch over the whole buffer, timed beside its
    bound."""
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import digest as kd
    from repro_torch.kernels import ref

    plan = kd.plan_for(state)
    n = plan.n_leaves
    lay = plan.layout(tuple(range(n)) * 2)           # the K=1 union
    flats = [ref.to_i32(x) for x in plan.leaves(state)]
    starts = lay.starts[:n]
    words = sum(f.numel() for f in flats)
    bk = torch.zeros(lay.padded_rows * ck.LANES, dtype=torch.int32,
                     device="cuda")
    bp = torch.zeros_like(bk)
    ref.pack_rows_ref(bp, flats, starts)
    desc = ck.pack_descriptors(flats, starts, "cuda")
    ck.pack_rows(bk, flats, starts, desc=desc)
    err = _max_err(torch, bk, bp)
    assert err == 0, f"pack_rows differs from its plain version at the " \
        f"training shape ({err})"
    del bp
    bound, _ = _bound_ms(2 * 4 * words)
    ms = _median_ms(lambda: ck.pack_rows(bk, flats, starts, desc=desc),
                    torch, flush, queued=True)
    plain_ms = _median_ms(lambda: ref.pack_rows_ref(bk, flats, starts),
                          torch, flush, queued=True)
    dst = [bk[st:st + f.numel()] for f, st in zip(flats, starts)]
    lib_ms = _median_ms(lambda: torch._foreach_copy_(dst, flats), torch,
                        flush, queued=True)
    same = torch.empty(words, dtype=torch.int32, device="cuda")
    copy_ms = _median_ms(lambda: bk[:words].copy_(same), torch, flush,
                         queued=True)
    # the step's one row_checksums launch reads the whole check+arm buffer
    rows = bk.view(-1, ck.LANES)
    rc_ms = _median_ms(lambda: ck.row_checksums(rows), torch, flush,
                       queued=True)
    rc_bound, rc_by = _bound_ms(rows.shape[0] * (ck.LANES * 4 + 8),
                                rows.shape[0] * ck.LANES * 3)
    print(f"[kernel] pack_rows at the training shape: bitwise equal to "
          f"plain (max_abs_err {err}), {n} leaves, {words} words "
          f"({4 * words / 1e9:.3f} GB) into a {bk.numel() * 4 / 1e9:.3f} GB "
          f"buffer, {desc.n_chunks} chunks: device time kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
          f"(torch._foreach_copy_), contiguous copy_ {copy_ms:.4f} ms, "
          f"bound {bound:.4f} ms (bytes)")
    print(f"[kernel] row_checksums over that check+arm buffer "
          f"({rows.shape[0]} rows): device time {rc_ms:.4f} ms, bound "
          f"{rc_bound:.4f} ms ({rc_by})")


def profile_train(torch, cfg, state, steps: int = 4,
                  parity: bool = False) -> None:
    """Phase 7c: where a steady train step's time goes (torch.profiler
    over ``steps`` steps of the training hot path: the step, the metric
    fetch and the K=1 canary's check_and_arm, with ``parity`` its gated
    parity update)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.parity import ParityStore
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import cuda_numerics
    from repro_torch.train.loop import make_train_step

    pipe = TokenPipeline(cfg.model.vocab_size, T_SEQ, T_BATCH, seed=0)
    with cuda_numerics(torch.device("cuda")):
        step_fn = make_train_step(cfg, global_batch=T_BATCH)
        canary = ChecksumCanary(state, n_slices=1)
        if parity:
            store = ParityStore(state)
            store.build(state)
            canary.attach_parity(store)

        def one(s, st):
            new, m = step_fn(st, {k: v.cuda()
                                  for k, v in pipe.batch_at(s).items()})
            torch.stack([m["loss"], m["grad_norm"]]).tolist()
            assert canary.check_and_arm(s, st, new) is None
            return new

        for s in range(T_STEPS, T_STEPS + 2):            # warm
            state = one(s, state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for s in range(T_STEPS + 2, T_STEPS + 2 + steps):
                state = one(s, state)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    _report_profile(prof, steps, wall_ms,
                    ("parity " if parity else "") + "train step",
                    ("pack_rows_kernel", "row_checksums_kernel")
                    + (("xor_update_tiles_kernel", "BitwiseXor",
                        "masked_fill") if parity else ()))


def run_parity_storm(torch, cfg, runs):
    """Phase 7d: the params storm with ``parity=True``; returns its
    summary."""
    from repro_torch.tree import leaves
    out, state = train_run(torch, cfg, "parity storm",
                           inject_every=T_INJECT, parity=True)
    rec = out["recovery"]
    assert out["steps"] == T_STEPS, out
    assert out["faults_injected"] > 0, out
    assert out["faults_detected"] == out["faults_injected"], out
    assert out["faults_recovered"] == out["faults_detected"], out
    assert rec["recovery_rate"] == 1.0, out
    assert set(rec["by_rung"]) <= {"parity_xor", "replay"}, rec
    assert rec["by_rung"].get("parity_xor", 0) > 0, rec
    clean_state = runs["clean"][1]
    assert _same_state(torch, state, clean_state), \
        "parity storm final state differs from the clean run's"
    replay = runs["params storm"][0]
    print(f"[parity] parity storm final state == clean final state, "
          f"bitwise ({sum(t.numel() for t in leaves(state))} elements); "
          f"recovery p50 {out['p50_recovery_ms']:.3f} ms (by rung "
          f"{rec['p50_wall_ms_by_rung']}) against the params storm's "
          f"{replay['p50_recovery_ms']:.3f} ms through replay")
    return out


def check_parity_recovery(torch, cfg, clean_state):
    """Phase 7e: at full width, a low-mantissa flip of the embedding
    repaired by ``parity_xor`` alone, and 4 canary steps whose
    incrementally kept parity equals a fresh build."""
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.faults import InjectionPlan, inject
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.parity import ParityStore
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import cuda_numerics
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import tree_map

    pipe = TokenPipeline(cfg.model.vocab_size, T_SEQ, T_BATCH, seed=0)

    def bfn(s):
        return {k: v.cuda() for k, v in pipe.batch_at(s).items()}

    with cuda_numerics(torch.device("cuda")):
        step_fn = make_train_step(cfg, global_batch=T_BATCH)
        canary = ChecksumCanary(clean_state, n_slices=1)
        store = ParityStore(clean_state)
        store.build(clean_state, T_STEPS)
        bad = tree_map(torch.clone, clean_state)
        table = clean_state["params"]["embed"]["table"]
        inject(bad, InjectionPlan("embed/table", table.numel() // 3, 2,
                                  T_STEPS))
        report = canary.check_full(T_STEPS, bad)
        assert report is not None and \
            report.leaves == ["params/embed/table"], report
        rt = RecoveryRuntime(step_fn=step_fn, batch_fn=bfn,
                             iv_registry=promote(cfg, T_BATCH),
                             micro=MicroCheckpointer(T_SNAP),
                             parity=store, canary=canary)
        fixed, ev = rt.recover(bad, report, T_STEPS, ladder=["parity_xor"])
        assert ev.rung == "parity_xor" and ev.steps_replayed == 0, ev
        assert _same_state(torch, fixed, clean_state)
        print(f"[recover] parity_xor on a flipped embedding leaf (bit 2): "
              f"{ev.wall_seconds * 1e3:.3f} ms, {ev.bytes_moved} B "
              f"reconstructed, 0 steps replayed, result == clean state, "
              f"bitwise")
        del bad, fixed

        canary = ChecksumCanary(clean_state, n_slices=2)
        store = ParityStore(clean_state)
        store.build(clean_state, T_STEPS)
        canary.attach_parity(store)
        ptr = store.parity.data_ptr()
        state = clean_state
        for s in range(T_STEPS, T_STEPS + 4):
            new, _ = step_fn(state, bfn(s))
            assert canary.check_and_arm(s, state, new) is None
            state = new
        fresh = ParityStore(state)
        fresh.build(state, T_STEPS + 4)
        assert store.version == T_STEPS + 4
        assert store.parity.data_ptr() == ptr
        assert torch.equal(store.parity, fresh.parity), \
            "incremental parity differs from a fresh build"
    print(f"[parity] 4 canary steps (K=2) with parity attached: the "
          f"incrementally kept parity ({store.memory_bytes} B, updated in "
          f"place) == a fresh build of the final state, bitwise")


def check_serving_parity(torch, cfg, eng, common):
    """Phase 5c: at-rest parity over the served params; returns the
    launch counts of that path."""
    from repro_torch.kernels import _build
    from repro_torch.serving import ServingEngine
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    par = ServingEngine(cfg, params=eng.params, parity=True, **common)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    key, bit = par.corrupt_param(random.Random(0), key="embed/table", bit=3)
    assert not _same_state(torch, par.params, eng.params)
    t0 = time.perf_counter()
    stats = par.scrub_params()
    scrub_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert stats["repaired"] == 1 and stats["failed"] == [], stats
    assert _same_state(torch, par.params, eng.params), \
        "scrubbed params differ from the served params"
    print(f"[serve] parity: engine with parity built in {build_ms:.1f} ms "
          f"({stats['memory_bytes']} B of parity); bit {bit} of {key} "
          f"flipped (the engines sharing the params keep theirs), scrub "
          f"{stats} in {scrub_ms:.1f} ms, params == served params, "
          f"bitwise; launches {launches}")
    assert launches.get("xor_fold_tiles", 0) > 0, launches
    return launches


# -- phase 7f: --donate, --fused-detect, both; triage -----------------------

# the K=1 ``--fused-detect`` modes, donated or not, run no storm here
# (the time cut): their storms are held at K=4 (the ``run_modes_k4``
# storms, eager and lazy capture) and at full width by 9e-13c, their
# clean K=1 graphs by 7i and 7j
MODES = (("donate", dict(donate=True)),)


def run_modes(torch, cfg, runs):
    """Phase 7f: ``--donate`` at phase 7's settings under the params
    storm (no donated clean run, the time cut: the storm's final state
    must be bitwise the functional clean run's); then the K=4 modes.
    Detected == injected == recovered; donation recovers by replay
    only."""
    clean_state = runs["clean"][1]
    for name, kw in MODES:
        out, state = train_run(torch, cfg, f"{name} params storm",
                               inject_every=T_INJECT, **kw)
        assert out["faults_injected"] > 0, out
        assert out["faults_detected"] == out["faults_injected"], out
        assert out["faults_recovered"] == out["faults_detected"], out
        assert set(out["recovery"]["by_rung"]) == {"replay"}, out
        assert _same_state(torch, state, clean_state), \
            f"{name}: storm final state differs from the clean run's"
        del state
        print(f"[modes] {name}: storm final state == functional clean "
              f"state, bitwise")
    # no donated iv storm since PR 25, the time cut: the donated replay
    # is held by the donate params storm above, the donated ladder for an
    # iv report by tests/test_torch_donate.py
    run_modes_k4(torch, cfg)


def run_modes_k4(torch, cfg, k: int = 4, every: int = 5):
    """Phase 7f at the default rotation period K=4: ``--donate
    --fused-detect`` (2K graphs, warmed eagerly) and ``--fused-detect
    --fused-warm lazy`` (ping-pong storage, graphs captured on first use)
    under a params storm (no donate+fused clean run here, the time cut:
    10c-13c hold it at full width).  A
    K-slice canary sees a flip only when its slice is checked that very
    step, so a storm is held against the functional K=4 storm: the same
    detections, recoveries and final state, bitwise.  A flip every 5
    steps puts one of the three (step 10's, in the embedding) in the
    slice checked that step, so the fused recovery runs too."""
    ref, ref_state = train_run(torch, cfg, f"functional K={k} params storm",
                               slices=k, inject_every=every)
    assert 0 < ref["faults_detected"] < ref["faults_injected"], ref
    assert ref["faults_recovered"] == ref["faults_detected"], ref
    for name, kw in ((f"donate+fused K={k} params storm",
                      dict(donate=True, fused_detect=True)),
                     (f"fused lazy K={k} params storm",
                      dict(fused_detect=True, fused_warm="lazy"))):
        out, state = train_run(torch, cfg, name, slices=k,
                               inject_every=every, **kw)
        for n in ("faults_injected", "faults_detected", "faults_recovered"):
            assert out[n] == ref[n], (n, out, ref)
        if kw.get("donate"):
            assert set(out["recovery"]["by_rung"]) <= {"replay"}, out
        assert 0 < out["fused"]["captures"] <= 2 * k, out
        assert _same_state(torch, state, ref_state), \
            f"{name}: final state differs from the functional K={k} storm's"
        del state
        print(f"[modes] {name}: {out['fused']['captures']} graphs "
              f"captured; injected {out['faults_injected']} detected "
              f"{out['faults_detected']} recovered "
              f"{out['faults_recovered']}, final state == the functional "
              f"K={k} storm's, bitwise")


def _mode_tools(torch, cfg):
    """(the step's batch on the host, on the card) of the training entry
    point: ``batch_for`` adds an enc-dec config's source frames."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import batch_for
    pipe = TokenPipeline(cfg.model.vocab_size, T_SEQ, T_BATCH, seed=0)

    def host_batch(s):
        return batch_for(cfg, pipe, s)
    return host_batch, lambda s: {k: v.cuda()
                                  for k, v in host_batch(s).items()}


def check_donated_rungs(torch, cfg, clean_state):
    """Phase 7g: with parity and donation, a single embedding flip caught
    by the donated pair (live buffers) is rebuilt by ``parity_xor`` into
    the live tensors."""
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.faults import flip_bit
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.parity import ParityStore
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.launch.train import cuda_numerics
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import leaves, tree_map

    _, bfn = _mode_tools(torch, cfg)
    with cuda_numerics(torch.device("cuda")):
        state = tree_map(torch.clone, clean_state)
        canary = ChecksumCanary(state, n_slices=1)
        store = ParityStore(state)
        store.build(state, T_STEPS)
        canary.attach_parity(store)
        rt = RecoveryRuntime(
            step_fn=make_train_step(cfg, global_batch=T_BATCH, donate=True),
            batch_fn=bfn, iv_registry=promote(cfg, T_BATCH),
            micro=MicroCheckpointer(T_SNAP), parity=store, canary=canary,
            donated=True)
        canary.arm_current(T_STEPS, state)
        ptrs = [t.data_ptr() for t in leaves(state)]
        table = state["params"]["embed"]["table"]
        flip_bit(table, table.numel() // 3, 2)
        report = canary.check(T_STEPS, state)
        assert report is not None and not report.consumed, report
        assert report.leaves == ["params/embed/table"], report
        fixed, ev = rt.recover(state, report, T_STEPS)
        assert ev.rung == "parity_xor" and ev.steps_replayed == 0, ev
        assert fixed is state and \
            [t.data_ptr() for t in leaves(state)] == ptrs
        assert _same_state(torch, state, clean_state)
    print(f"[modes] parity + donate: an embedding flip (bit 2) caught by "
          f"the donated pair (consumed=False) repaired by "
          f"{ev.attempted} -> {ev.rung} in {ev.wall_seconds * 1e3:.3f} ms, "
          f"{ev.bytes_moved} B into the live tensor, == clean, bitwise")


def check_triage(torch, cfg):
    """Phase 7h: rung 0 at full width on an ``opt/v`` FFN leaf: a
    mantissa-tail flip tolerated (0 bytes, 0 steps, the next check
    quiet), a bit-30 flip escalated to replay (bitwise the clean state),
    a params flip escalated."""
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.faults import flip_bit
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.launch.train import cuda_numerics
    from repro_torch.train.loop import make_train_state, make_train_step
    from repro_torch.tree import flatten_with_path, leaf_key, tree_map

    _, bfn = _mode_tools(torch, cfg)
    n = 6
    with cuda_numerics(torch.device("cuda")):
        step_fn = make_train_step(cfg, global_batch=T_BATCH)
        state = make_train_state(cfg, 0, global_batch=T_BATCH,
                                 device="cuda")
        micro = MicroCheckpointer(T_SNAP)
        for s in range(n):
            micro.maybe_snapshot(s, state)
            micro.record_iv(s, state["iv"])
            state, _ = step_fn(state, bfn(s))
        canary = ChecksumCanary(state, n_slices=1)
        rt = RecoveryRuntime(step_fn=step_fn, batch_fn=bfn,
                             iv_registry=promote(cfg, T_BATCH), micro=micro,
                             canary=canary, triage=True)
        key = next(leaf_key(p) for p, _ in flatten_with_path(state)
                   if leaf_key(p).startswith("opt/v/")
                   and "ffn" in leaf_key(p))
        for where, bit, want in ((key, 2, "triage"), (key, 30, "replay"),
                                 ("params/embed/table", 2, None)):
            bad = tree_map(torch.clone, state)
            leaf = {leaf_key(p): t for p, t in flatten_with_path(bad)}[where]
            flip_bit(leaf, leaf.numel() // 2 + 1, bit)
            report = canary.check(n, bad)
            assert report is not None and report.leaves == [where], report
            fixed, ev = rt.recover(bad, report, n)
            assert ev.attempted[0] == "triage", ev
            if want == "triage":
                assert ev.rung == "triage" and ev.bytes_moved == 0 \
                    and ev.steps_replayed == 0, ev
                assert _same_state(torch, fixed, bad)
                assert canary.check(n + 1, fixed) is None
            else:
                assert ev.rung != "triage", ev
                assert _same_state(torch, fixed, state)
                if want:
                    assert ev.rung == want, ev
            print(f"[triage] {where} bit {bit}: {ev.attempted} -> {ev.rung} "
                  f"in {ev.wall_seconds * 1e3:.3f} ms (rung 0 "
                  f"{ev.phase_seconds['triage'] * 1e3:.3f} ms), "
                  f"{ev.bytes_moved} B, "
                  f"{ev.steps_replayed} steps replayed"
                  + (" (state untouched, next check quiet)"
                     if ev.rung == "triage" else ", == clean, bitwise")
                  + f"; {ev.report.detail.split('|')[1].strip()[:160]}")
            canary.refresh(state)


def _api_counts(prof):
    """Host-side CUDA API calls in a profile, by name."""
    out = {}
    for e in prof.key_averages():
        for name in ("cudaGraphLaunch", "cudaLaunchKernel", "cuLaunchKernel",
                     "cudaMemcpyAsync"):
            if e.key.startswith(name):
                out[name] = out.get(name, 0) + e.count
    return out


def check_fused_path(torch, cfg, clean_state, steps: int = 8):
    """Phase 7i: the fused hot path with donation and parity, from a
    fresh state: ``steps`` steady steps profiled (one ``cudaGraphLaunch``
    a step and no kernel launched from the host, ``digest.STATS`` 1
    launch and 1 fetch a step, every pointer the graphs read unchanged),
    then a params flip: the report says ``consumed=True`` and replay
    repairs into the live state; the run's final state at step 20 is
    bitwise the functional clean run's."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.faults import flip_bit
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.parity import ParityStore
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.kernels import digest as kd
    from repro_torch.launch.train import cuda_numerics
    from repro_torch.train.loop import make_train_state, make_train_step
    from repro_torch.tree import leaves

    host_batch, bfn = _mode_tools(torch, cfg)
    with cuda_numerics(torch.device("cuda")):
        state = make_train_state(cfg, 0, global_batch=T_BATCH,
                                 device="cuda")
        step_fn = make_train_step(cfg, global_batch=T_BATCH, donate=True)
        canary = ChecksumCanary(state, n_slices=1)
        store = ParityStore(state)
        store.build(state)
        canary.attach_parity(store)
        micro = MicroCheckpointer(T_SNAP)
        rt = RecoveryRuntime(step_fn=step_fn, batch_fn=bfn,
                             iv_registry=promote(cfg, T_BATCH), micro=micro,
                             parity=store, canary=canary, donated=True)
        fused = canary.fuse_into_step(step_fn, donate=True, warm="eager",
                                      host_metrics=("loss", "grad_norm"))
        warm_s = fused.warm(state, host_batch(0))
        state = fused.load(state)

        def pointers():
            return ([t.data_ptr() for t in leaves(state)]
                    + [canary.plan.buffer_pointer(
                        tuple(range(canary.plan.n_leaves)) * 2)]
                    + [t.data_ptr() for t in canary._tables]
                    + [store.parity.data_ptr()])

        def one(s):
            new, m, rep = fused.step(s, state, host_batch(s))
            assert rep is None and new is state, rep
            return m

        for s in range(2):
            one(s)
        torch.cuda.synchronize()
        before = pointers()
        kd.STATS.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for s in range(2, 2 + steps):
                one(s)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        stats = kd.STATS.snapshot()
        api = _api_counts(prof)
        assert stats == (steps, steps), stats
        assert api.get("cudaGraphLaunch", 0) == steps, api
        assert api.get("cudaLaunchKernel", 0) + \
            api.get("cuLaunchKernel", 0) == 0, api
        assert pointers() == before, "a pointer the graphs read moved"
        print(f"[fused] donate + parity, {fused.n_compiles} graphs captured "
              f"in {fused.compile_seconds:.3f} s (warm-up and capture "
              f"{warm_s:.3f} s); {steps} steady steps: digest.STATS "
              f"{stats[0]} launches and {stats[1]} fetches, host API "
              f"{api} (the batch upload and the flag fetch are the "
              f"memcpys), every state leaf, the pack buffer, both tables "
              f"and the parity at the same data_ptr")
        _report_profile(prof, steps, wall_ms, "fused donated parity step",
                        ("pack_rows_kernel", "row_checksums_kernel",
                         "xor_update_tiles_kernel"))

        s = 2 + steps
        micro.snapshot(s, state)
        flip_at = s + 2
        while s < T_STEPS:
            micro.record_iv(s, state["iv"])
            if s == flip_at:
                table = state["params"]["embed"]["table"]
                flip_bit(table, table.numel() // 5, 27)
            new, m, rep = fused.step(s, state, host_batch(s))
            if rep is None:
                s += 1
                continue
            assert s == flip_at and rep.consumed, rep
            assert rep.resolve() == ["params/embed/table"], rep
            fixed, ev = rt.recover(state, rep, s)
            assert ev.rung == "replay" and fixed is state, ev
            canary.refresh(state)
            store.rebuild(state, s)
            assert fused.load(state) is state
            print(f"[fused] flip at step {s}: in-step report consumed="
                  f"{rep.consumed}, {ev.attempted} -> {ev.rung} "
                  f"({ev.steps_replayed} steps) into the live state in "
                  f"{ev.wall_seconds * 1e3:.1f} ms")
            flip_at = -1
        assert flip_at == -1, "the flip was not detected"
        assert pointers() == before
        assert _same_state(torch, state, clean_state), \
            "fused donated run differs from the functional clean run"
    print(f"[fused] final state at step {T_STEPS} == functional clean "
          f"state, bitwise")


PROFILE_MODES = ("functional", "donate", "fused", "donate+fused")


def profile_modes(torch, cfg, clean_state, steps: int = 8,
                  start: int = T_STEPS, label: str = "modes",
                  modes=PROFILE_MODES, prof_steps: int = 4) -> None:
    """Phase 7j / 10c: each mode's hot path from the clean state at step
    ``start`` (K=1 canary): host step p50 over ``steps`` unprofiled steps (the step,
    its canary and its one fetch), device busy ms a step over 4 profiled
    steps, and the steady-state peak memory of the loop (its state
    versions, the canary, the step's temporaries; with graphs also the
    segments of their private pool) above what was held before the mode
    was built."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.launch.train import cuda_numerics
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import tree_map
    import numpy as np

    host_batch, bfn = _mode_tools(torch, cfg)
    for name in modes:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        donate, fused_on = "donate" in name, "fused" in name
        with cuda_numerics(torch.device("cuda")):
            state = tree_map(torch.clone, clean_state)
            step_fn = make_train_step(cfg, global_batch=T_BATCH,
                                      donate=donate)
            canary = ChecksumCanary(state, n_slices=1)
            fused = None
            if fused_on:
                fused = canary.fuse_into_step(
                    step_fn, donate=donate, warm="eager",
                    host_metrics=("loss", "grad_norm"))
                fused.warm(state, host_batch(start))
                state = fused.load(state)

            def one(s, st):
                if fused is not None:
                    new, _, rep = fused.step(s, st, host_batch(s))
                    assert rep is None
                    return new
                if donate:
                    canary.arm_current(s, st)
                    assert canary.check(s, st) is None
                new, m = step_fn(st, bfn(s))
                torch.stack([m["loss"], m["grad_norm"]]).tolist()
                if not donate:
                    assert canary.check_and_arm(s, st, new) is None
                return new

            s = start
            for _ in range(2):
                state = one(s, state)
                s += 1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()      # the steady state
            host = []
            for _ in range(steps):
                t0 = time.perf_counter()
                state = one(s, state)
                host.append((time.perf_counter() - t0) * 1e3)
                s += 1
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(prof_steps):
                    state = one(s, state)
                    s += 1
                torch.cuda.synchronize()
            dev = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in dev) / 1e3 / \
                prof_steps
            n_kernels = sum(e.count for e in dev) / prof_steps
            peak = torch.cuda.max_memory_allocated() - base
            # a graph's temporaries live in its private pool: reserved for
            # the graph's life, not allocated between replays
            pool = sum(seg["total_size"]
                       for seg in torch.cuda.memory_snapshot()
                       if tuple(seg["segment_pool_id"]) != (0, 0))
            cap = (f", {fused.n_compiles} graphs captured in "
                   f"{fused.compile_seconds:.3f} s" if fused else "")
        print(f"[{label}] {name}: host step p50 {np.median(host):.3f} ms "
              f"(min {min(host):.3f}, max {max(host):.3f}; step + K=1 "
              f"canary + one fetch), device busy {busy:.3f} ms/step in "
              f"{n_kernels:.0f} device kernels/step, "
              f"steady peak memory of the loop {peak / 2**30:.3f} GiB "
              f"allocated + {pool / 2**30:.3f} GiB in graph pools = "
              f"{(peak + pool) / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB held before it{cap} [{_SMI}]")
        del state, canary, fused, step_fn, prof


def _report_profile(prof, steps, wall_ms, what, names) -> None:
    from torch.autograd import DeviceType
    # device-side events only: a CPU op's entry repeats its kernels' time
    stats = [(e.key, e.self_device_time_total / 1e3 / steps, e.count)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in stats)
    stats.sort(key=lambda st: -st[1])
    print(f"[profile] {steps} steady {what}s: wall {wall_ms:.3f} "
          f"ms/step, device busy {busy:.3f} ms/step "
          f"({100 * busy / wall_ms:.1f}%), "
          f"{sum(c for *_, c in stats) / steps:.0f} device kernels/step "
          f"(host time under the profiler)")
    for key, t, count in stats[:8]:
        print(f"[profile]   {t:.4f} ms/step  x{count // steps:<4d} "
              f"{key[:90]}")
    for name in names:
        t = sum(tt for key, tt, _ in stats if name in key)
        print(f"[profile]   {name}: {t:.4f} ms/step")


# -- phase 8: the dense configurations at full width -------------------------

GEMMA, COMMAND_R, DANUBE = "gemma3-1b", "command-r-35b", "h2o-danube-1.8b"
RING_PROMPT, RING_GEN = 1040, 32     # 8b: every local layer's ring wraps
CMD_LAYERS = 2                       # 8c: command-r-35b, 2 of its 40 layers
G_STEPS, G_INJECT, G_INTERVAL = 6, 2, 8   # 8d: one snapshot + checkpoint
G_CUT_LAYERS = 6                     # 8b, 8d: gemma3-1b 6 of 26 layers (5:1)
D_STEPS, D_SLICES = 4, 4             # 8e: steps (one storm flip), canary K
D_LAYERS = 6                         # 8e: h2o-danube-1.8b 6 of its 24 layers


def _release(torch) -> None:
    """Hand the allocator's cached, unused blocks back to the card, so a
    run does not start among the odd-sized free blocks of the last one
    (at 70 GiB of 79 a fragmented cache can refuse a 1 GiB block)."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _phase_start(torch) -> None:
    """Free what the previous phase left (the digest plans' cached
    packing buffers too: a whole-state K=1 buffer is 24 GB at gemma3-1b;
    and the parity plans' stream scratch) and zero the launch counts and
    the peak-memory mark."""
    from repro_torch.kernels import _build
    _drop_plans(torch)
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()


def _phase_end(torch, name: str) -> dict:
    """The phase's launch counts, with its peak memory printed."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(_build.LAUNCHES)
    print(f"[{name}] peak memory {peak:.3f} GiB allocated; launches "
          f"{launches} [{_SMI}]")
    return launches


def _full_width(name: str, **model):
    """A registered config, its model fields changed by ``model``."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **model))


def _steady_busy(torch, eng, rqs, name: str, steps: int = 8) -> float:
    """Device busy ms a step over ``steps`` profiled steady engine steps
    with every slot decoding (after one canary rotation); prints where
    the device time goes."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    for u, rq in enumerate(rqs[:eng.S]):
        eng.admit(rq, u)
    for _ in range(max(1, eng.K)):
        assert eng.engine_step()[2] is None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            assert eng.engine_step()[2] is None
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    _report_profile(prof, steps, wall_ms, f"{name} engine step",
                    ("pack_rows_kernel", "row_checksums_kernel",
                     "gather_blocks_kernel"))
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / steps


def serve_full_width(torch, cfg, name, reqs, *, paged, params=None,
                     **common):
    """8a/8b/8c: ``cfg`` served clean and under a storm (a flip every
    ``INJECT`` accepted tokens into the canary's armed window), the step
    captured as 2K graphs.  Asserts detected == injected == recovered >
    0, nothing dropped, storm tokens == clean tokens; prints decode p50
    / p99 and device busy ms a step.  Returns (clean engine, clean
    report, launches)."""
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import leaves

    _phase_start(torch)
    kw = dict(canary_slices=K, max_replays=10**6, device="cuda", **common)
    clean_eng = ServingEngine(cfg, seed=0, params=params, **kw)
    storm_eng = ServingEngine(cfg, params=clean_eng.params, **kw)
    assert clean_eng.paged == paged, (name, clean_eng.paged)
    for eng in (clean_eng, storm_eng):
        eng.warm()
        assert eng.n_captures == 2 * K, eng.n_captures
    n = len(reqs())
    clean = clean_eng.run(reqs())
    storm = storm_eng.run(reqs(), inject_every=INJECT,
                          inject_rng=random.Random(0))
    launches = _phase_end(torch, name)
    cs, ss = clean.summary(), storm.summary()
    f = ss["faults"]
    assert cs["completed"] == n and cs["dropped"] == 0, cs
    assert f["injected"] > 0 and f["detected"] == f["injected"], f
    assert f["recovered"] == f["detected"], f
    assert ss["dropped"] == 0 and ss["completed"] == n, ss
    for rid, rec in clean.per_request.items():
        assert storm.per_request[rid]["tokens"] == rec["tokens"], (
            f"{name} rid {rid}: storm tokens differ from clean tokens")
    path = ("pack_rows", "row_checksums") + (("gather_blocks",) if paged
                                             else ())
    for kernel in path:
        assert launches.get(kernel, 0) > 0, (name, kernel, launches)
    del storm_eng
    busy = _steady_busy(torch, clean_eng, reqs(), name)
    cache = clean_eng.pool if paged else clean_eng.cache
    print(f"[{name}] {'paged' if paged else 'dense'} engine, "
          f"{sum(t.numel() for t in leaves(clean_eng.params))} params "
          f"({leaves(clean_eng.params)[0].dtype}), cache leaves "
          f"{sorted({tuple(t.shape) for t in leaves(cache['groups'])})}, "
          f"{clean_eng.plan.n_leaves} canary units, "
          f"{clean_eng.n_captures} graphs in "
          f"{clean_eng.capture_seconds:.3f} s; clean {cs['completed']}/{n} "
          f"completed in {cs['engine_steps']} steps, storm faults {f}, "
          f"replay tokens {ss['replay_tokens']}, storm tokens == clean "
          f"tokens for all {n} requests; decode p50 "
          f"{cs['p50_decode_ms']:.3f} ms p99 {cs['p99_decode_ms']:.3f} ms "
          f"(clean), device busy {busy:.3f} ms/step [{_SMI}]")
    return clean_eng, clean, launches


def check_first_token(torch, eng, rq, tokens, label: str = "serve-ring",
                      tol: float = BF16_TOL) -> None:
    """8b / 10b / 11b: the engine's first decoded token (8b: at position
    RING_PROMPT, in row RING_PROMPT % window of every local layer's ring;
    10b / 11b: after three 256-token mLSTM / SSD chunks, the last padded)
    equals the argmax of a prefill of the prompt and its first token; the
    decode's logits within ``tol`` of that prefill's (None: printed only —
    the recurrent decode and the chunked prefill round differently, layer
    after layer, in bf16)."""
    m = eng.m
    prompt = torch.from_numpy(rq.prompt[None]).to("cuda")
    logits0, cache = eng.model.prefill(eng.params, m, {"tokens": prompt},
                                       max_len=eng.max_len)
    t0 = logits0.argmax(-1).to(torch.int32)
    dec, _ = eng.model.decode_step(eng.params, m, cache, t0)
    full, _ = eng.model.prefill(
        eng.params, m, {"tokens": torch.cat([prompt, t0[:, None]], 1)},
        max_len=eng.max_len)
    err = float((dec - full).abs().max())
    top2 = full[0].topk(2).values
    want = int(full[0].argmax())
    print(f"[{label}] first decoded token {tokens[0]}, argmax of the "
          f"{prompt.shape[1] + 1}-token prefill {want} (its top-2 gap "
          f"{float(top2[0] - top2[1]):.4f}), decode vs prefill logits "
          f"max |diff| {err:.5f} (largest |logit| "
          f"{float(full.abs().max()):.4f})")
    assert tokens[0] == int(dec[0].argmax()) == want
    if tol is not None:
        assert err <= tol * max(1.0, float(full.abs().max())), err


def train_full_width(torch, cfg, name, steps: int = G_STEPS,
                     disk: bool = True, **kw):
    """8d/8e/10c: one run of the training entry point at full width
    (global batch T_BATCH, seq T_SEQ; one host snapshot and, with
    ``disk``, one disk checkpoint, at step 0, with their seconds).
    Returns (summary, final state)."""
    from repro_torch.launch.train import train
    d = WORK / name.replace(" ", "_")
    shutil.rmtree(d, ignore_errors=True)
    _release(torch)
    t0 = time.perf_counter()
    out, state = train(cfg, steps=steps, global_batch=T_BATCH,
                       seq_len=T_SEQ, seed=0, snapshot_interval=G_INTERVAL,
                       checkpoint_dir=str(d) if disk else None,
                       checkpoint_interval=G_INTERVAL, verbose=False,
                       device="cuda", return_state=True, **kw)
    shutil.rmtree(d, ignore_errors=True)
    rec, snap = out["recovery"], out["snapshots"]
    ckpt = out.get("checkpoints") or {"count": 0, "blocking_seconds": 0.0,
                                      "write_seconds": 0.0}
    print(f"[{name}] {out['steps']} steps in "
          f"{time.perf_counter() - t0:.1f} s, final loss "
          f"{out['final_loss']:.6f}, step p50 {out['p50_step_ms']:.3f} ms, "
          f"faults injected {out['faults_injected']} detected "
          f"{out['faults_detected']} recovered {out['faults_recovered']}, "
          f"rungs {rec['by_rung']}, recovery p50 "
          f"{out['p50_recovery_ms']:.3f} ms; {snap['count']} host snapshot "
          f"(copy + host digests) {snap['seconds']:.2f} s, "
          f"{ckpt['count']} disk checkpoint {ckpt['blocking_seconds']:.2f} "
          f"s on the step path (device digests, host copy) + "
          f"{ckpt['write_seconds']:.2f} s written by its thread; phase "
          f"peak so far {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB [{_SMI}]")
    return out, state


def _host(torch, state):
    """A host copy of a final state (the card keeps one state at a time:
    a 10-18 GB state and a run's two versions and pack buffer fill it);
    ``_same_state`` holds a later state on the card against it, one leaf
    uploaded at a time."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to("cpu"), state)


def train_gemma(torch):
    """8d: gemma3-1b trained at full width (bf16 params, f32 moments) and
    ``G_CUT_LAYERS`` of its 26 layers (one 5 local + 1 global group; the
    depth cut keeps the whole script within its time limit),
    K=1: functional clean and under a params storm (detected == injected
    == recovered, final state == clean's bitwise); no ``--donate
    --fused-detect`` run (the time cut: 7h-7i hold it, 10c over bf16
    leaves).  Returns the phase's launches."""
    cfg = _full_width(GEMMA, n_layers=G_CUT_LAYERS)
    _phase_start(torch)
    clean, state = train_full_width(torch, cfg, "train-gemma clean",
                                    canary_slices=1)
    assert clean["faults_detected"] == 0 and clean["steps"] == G_STEPS
    clean_host = _host(torch, state)
    del state
    storm, state = train_full_width(
        torch, cfg, "train-gemma params storm", canary_slices=1,
        inject_every=G_INJECT)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_detected"] == f, storm
    assert storm["faults_recovered"] == f, storm
    assert _same_state(torch, state, clean_host), \
        "gemma3-1b params storm final state differs from the clean run's"
    del state
    del clean_host
    launches = _phase_end(torch, "train-gemma")
    for kernel in ("pack_rows", "row_checksums", "checksum_tiles"):
        assert launches.get(kernel, 0) > 0, (kernel, launches)
    print(f"[train-gemma] {G_CUT_LAYERS} of its 26 layers (the depth cut): "
          f"params storm final state == clean final state, bitwise (no "
          f"donate+fused run: the time cut; 7h-7i and 10c hold it)")
    return launches


def _stepped_state(torch, cfg):
    """A fresh full-depth train state of ``cfg`` after one functional
    step (random params, non-zero moments): 8f's canary leaves."""
    from repro_torch.launch.train import cuda_numerics
    from repro_torch.train.loop import make_train_state, make_train_step
    _, bfn = _mode_tools(torch, cfg)
    with cuda_numerics(torch.device("cuda")):
        state = make_train_state(cfg, 0, global_batch=T_BATCH,
                                 device="cuda")
        state, _ = make_train_step(cfg, global_batch=T_BATCH)(state, bfn(0))
    torch.cuda.synchronize()
    return state


def train_danube(torch):
    """8e: h2o-danube-1.8b trained at full width and ``D_LAYERS`` of its
    24 layers (the depth cut keeps the whole script within its time
    limit) with its microbatch 8 (global batch 8: 8 slices of one
    sequence), ``--donate``, K=4: clean and under a params storm whose
    flips land in the slice checked at their step; final states bitwise
    equal."""
    cfg = _full_width(DANUBE, n_layers=D_LAYERS)
    assert cfg.train.microbatch == 8
    _phase_start(torch)
    kw = dict(canary_slices=D_SLICES, donate=True, steps=D_STEPS)
    clean, state = train_full_width(torch, cfg, "train-danube clean", **kw)
    assert clean["faults_detected"] == 0 and clean["steps"] == D_STEPS
    assert int(state["iv"]["micro_count"]) == 8 * D_STEPS
    clean_host = _host(torch, state)
    del state
    storm, state = train_full_width(
        torch, cfg, "train-danube params storm", inject_every=G_INJECT,
        inject_armed_only=True, **kw)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_detected"] == f, storm
    assert storm["faults_recovered"] == f, storm
    assert set(storm["recovery"]["by_rung"]) <= {"replay"}, storm
    assert _same_state(torch, state, clean_host), \
        "h2o-danube params storm final state differs from the clean run's"
    del clean_host
    _phase_end(torch, "train-danube")
    print(f"[train-danube] {D_LAYERS} of its 24 layers (the depth cut), "
          f"microbatch {cfg.train.microbatch}, untied head, "
          f"head_dim {cfg.model.resolved_head_dim}: params storm final "
          f"state == clean final state, bitwise")
    del state


def check_pack_wide(torch, flush, state, eng, launches):
    """8f: ``pack_rows`` on the dense configs' leaves: 2-byte leaves read
    in place and zero-extended.  Edge cases bitwise against the plain
    version (bf16 / f16 / int16 leaves of odd lengths at 2-, 4- and
    6-byte offsets, chunk boundaries inside a leaf, a leaf longer than
    one pass of the grid, mixed with f32 leaves, untouched words around
    them; a bool leaf refused); then the gemma3-1b training canary's
    leaves (bf16 params, f32 moments) and the bf16 KV pool's check+arm
    slice of phase 8a's engine, bitwise and timed beside their bound
    (2 B read + 4 B written a bf16 element, 4 + 4 an f32 one) and
    ``torch.Tensor.to(torch.int32)`` of the same leaves.  Returns the
    kernel JSON entries."""
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import digest as kd
    from repro_torch.kernels import paged_kv as pkv
    from repro_torch.kernels import ref
    from repro_torch.serving import paged as pgd

    gen = torch.Generator(device="cuda").manual_seed(19)
    base = _rand_bits(torch, (1 << 22,), torch.int32, gen)
    half = base.view(torch.bfloat16)
    sizes = [(1, 1), (3, 2), (5, 3), (77, 1), (8193, 0), (16387, 2),
             (1 << 21, 1), (4, 0), (40000, 3)]    # (elements, 2-B offset)
    leaves, at = [], 0
    for i, (n, off) in enumerate(sizes):
        at = -(-at // 8) * 8 + off
        x = half[at:at + n]
        leaves.append(x if i % 3 == 0 else
                      x.view(torch.float16) if i % 3 == 1 else
                      x.view(torch.int16))
        at += n
    f32 = base.view(torch.float32)
    leaves += [f32[at // 2 + 1:at // 2 + 1 + 1000],        # unaligned f32
               f32[(1 << 21) + 4096:(1 << 21) + 4096 + 33000]]
    starts, r = [], 0
    for x in leaves:
        r += 1
        starts.append(r * ck.LANES)
        r += -(-x.numel() // ck.LANES)
    buf = _rand_bits(torch, (r * ck.LANES + ck.LANES,), torch.int32, gen)
    bk, bp = buf.clone(), buf.clone()
    ck.pack_rows(bk, leaves, starts)
    ref.pack_rows_ref(bp, leaves, starts)
    err = _max_err(torch, bk, bp)
    assert err == 0, f"widened pack_rows differs from its plain version " \
        f"on edge cases ({err})"
    msg = _expect(ValueError, lambda: ck.pack_rows(
        bk, [torch.zeros(5, dtype=torch.bool, device="cuda")], [0]),
        "pack_rows of a bool leaf")
    print(f"[pack-wide] edge cases bitwise equal to plain: {len(leaves)} "
          f"leaves (bf16/f16/int16 of 1 to 2^21 elements at 2-, 4- and "
          f"6-byte offsets, 2 f32), words around them untouched; a bool "
          f"leaf refused (int8 and uint8 leaves pack: phase 9a): {msg}")
    del base, buf, bk, bp, leaves

    # gather_blocks on the bf16 pool: its blocks move as 4-byte words
    leaf = eng.pool["groups"][0][0]["k"]
    got = pkv.gather_blocks(leaf, eng.bt)
    err = _max_err(torch, got.view(torch.int16),
                   ref.gather_blocks_ref(leaf, eng.bt).view(torch.int16))
    assert err == 0, f"gather_blocks differs on the bf16 pool ({err})"
    ms = _median_ms(lambda: pkv.gather_blocks(leaf, eng.bt), torch, flush,
                    queued=True)
    bound, _ = _bound_ms(2 * got.numel() * got.element_size())
    msg = _expect(TypeError, lambda: pkv.gather_blocks(
        torch.zeros((4, 3), dtype=torch.bfloat16, device="cuda"), eng.bt),
        "gather_blocks of 6-byte blocks")
    print(f"[pack-wide] gather_blocks on the bf16 pool leaf "
          f"{tuple(leaf.shape)} with the table {tuple(eng.bt.shape)}: "
          f"bitwise equal to plain, {ms:.4f} ms (bound {bound:.4f} ms); "
          f"a pool of 6-byte blocks refused: {msg}")

    out = {}
    plan = kd.plan_for(state)
    # the check half of the K=1 union lays the leaves out as one copy does
    lay = plan.layout(tuple(range(plan.n_leaves)))
    train_leaves = plan.leaves(state)
    pool_view = pgd.paged_canary_view(eng.pool, eng.pos, eng.n_blocks,
                                      eng.S)
    core = eng._rotation(0)
    pool_leaves = [eng.plan.leaves(pool_view)[i] for i in core.union]
    cases = (
        ("pack_rows (gemma3-1b training canary, bf16 params + f32 "
         "moments)", train_leaves, lay.starts[:plan.n_leaves],
         lay.padded_rows),
        ("pack_rows (gemma3-1b paged KV pool, bf16, K=4 check+arm)",
         pool_leaves, core.layout.starts,
         core.layout.padded_rows))
    for label, xs, starts, rows in cases:
        bk = torch.zeros(rows * ck.LANES, dtype=torch.int32, device="cuda")
        bp = torch.zeros_like(bk)
        ref.pack_rows_ref(bp, xs, starts)
        desc = ck.pack_descriptors(xs, starts, "cuda")
        ck.pack_rows(bk, xs, starts, desc=desc)
        err = _max_err(torch, bk, bp)
        assert err == 0, f"{label}: differs from its plain version ({err})"
        del bp
        n_bytes = sum(x.numel() * (x.element_size() + 4) for x in xs)
        two = sum(x.numel() for x in xs if x.element_size() == 2)
        bound, by = _bound_ms(n_bytes)
        ms = _median_ms(lambda: ck.pack_rows(bk, xs, starts, desc=desc),
                        torch, flush, queued=True)
        plain_ms = _median_ms(lambda: ref.pack_rows_ref(bk, xs, starts),
                              torch, flush, queued=True)
        to_ms = _median_ms(lambda: [x.to(torch.int32) for x in xs], torch,
                           flush, queued=True)
        print(f"[pack-wide] {label}: bitwise equal to plain, {len(xs)} "
              f"leaves, {two} 2-byte elements of "
              f"{sum(x.numel() for x in xs)}, {n_bytes / 1e9:.4f} GB moved, "
              f"{desc.n_chunks} chunks: device time kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, Tensor.to(int32) of the same "
              f"leaves {to_ms:.4f} ms, bound {bound:.4f} ms ({by}) "
              f"[{_SMI}]")
        out[label] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/checksum.cu",
            replaces="src/repro/kernels/checksum.py:85", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None, launches=launches)
        # the step's one row_checksums launch over that buffer
        rows = bk.view(-1, ck.LANES)
        rc = ck.row_checksums(rows)
        assert torch.equal(rc[:4096], ref.row_checksums_ref(rows[:4096]))
        rc_ms = _median_ms(lambda: ck.row_checksums(rows), torch, flush,
                           queued=True)
        rc_bound, rc_by = _bound_ms(rows.shape[0] * (ck.LANES * 4 + 8),
                                    rows.shape[0] * ck.LANES * 3)
        print(f"[pack-wide] row_checksums over that buffer ({rows.shape[0]} "
              f"rows): device time {rc_ms:.4f} ms, bound {rc_bound:.4f} ms "
              f"({rc_by}) [{_SMI}]")
        del bk, rows, rc
    # checksum_tiles on the bf16 embedding's words (a checkpoint digest)
    table = state["params"]["embed"]["table"]
    flat = ref.to_i32(table)
    got = ck.checksum_tiles(flat)
    err = _max_err(torch, got, ref.checksum_tiles_ref(flat))
    assert err == 0, f"checksum_tiles differs on the bf16 embedding ({err})"
    ms = _median_ms(lambda: ck.checksum_tiles(flat), torch, flush,
                    queued=True)
    bound, by = _bound_ms(4 * flat.numel() + 8 * got.shape[0],
                          3 * flat.numel())
    print(f"[pack-wide] checksum_tiles of the bf16 embedding "
          f"{tuple(table.shape)} ({flat.numel()} words): bitwise equal to "
          f"plain, device time {ms:.4f} ms, bound {bound:.4f} ms ({by}) "
          f"[{_SMI}]")
    return out


# -- phase 9: the optimizers and the MoE family at full width ----------------

GROK, KIMI = "grok-1-314b", "kimi-k2-1t-a32b"
MOE_LAYERS = 2                   # 9c/9d: grok 2 of 64, kimi 2 of 61 layers
GROK_TRAIN_LAYERS = 1            # 9e: grok 1 of its 64 layers
M_STEPS, M_SLICES, M_INJECT = 4, 4, 2    # 9e: steps, canary K, storm period
PAD_D = 776                      # 9b: a d_model whose leaves leave q pad tails


def _int8(cfg, **model):
    """``cfg`` trained with int8 AdamW moments (its model changed by
    ``model``); the reference has no CLI flag for them either."""
    import dataclasses
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        train=dataclasses.replace(cfg.train, moment_dtype="int8"))


def check_pack_bytes(torch, flush):
    """9a: ``pack_rows`` on 1-byte leaves, read in place and
    zero-extended: int8 and uint8 leaves of 0, 1, 3, 5, 7, 255, 256 and
    257 bytes at byte offsets 1-3, a leaf across a chunk boundary, an
    aligned one of 3 chunks and a ragged tail, mixed with bf16 / int16 /
    f32 leaves in one launch, into a random buffer whose other words must
    stay untouched: bitwise against the plain version."""
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(20)
    raw = _rand_bits(torch, (1 << 20,), torch.int32, gen).view(torch.uint8)
    specs = [(dt, n, 1 + i % 3) for i, n in enumerate(
        (0, 1, 3, 5, 7, 255, 256, 257)) for dt in (torch.int8, torch.uint8)]
    specs += [(torch.int8, 20000, 2),          # across a 32 KiB chunk
              (torch.uint8, 3 * 8192 + 77, 0),  # aligned: 4 values a load
              (torch.bfloat16, 333, 2), (torch.int16, 9, 4),
              (torch.float32, 1001, 0), (torch.uint8, 40000, 3)]
    leaves, at = [], 0
    for dt, n, off in specs:
        size = torch.empty(0, dtype=dt).element_size()
        at = -(-at // 16) * 16 + off
        leaves.append(raw[at:at + n * size].view(dt))
        at += n * size
    starts, r = [], 0
    for x in leaves:
        r += 1
        starts.append(r * ck.LANES)
        r += -(-x.numel() // ck.LANES)
    buf = _rand_bits(torch, (r * ck.LANES + ck.LANES,), torch.int32, gen)
    bk, bp = buf.clone(), buf.clone()
    ck.pack_rows(bk, leaves, starts)
    ref.pack_rows_ref(bp, leaves, starts)
    err = _max_err(torch, bk, bp)
    assert err == 0, f"1-byte pack_rows differs from its plain version " \
        f"on edge cases ({err})"
    print(f"[pack-bytes] edge cases bitwise equal to plain: {len(leaves)} "
          f"leaves in one launch (int8/uint8 of 0-257 bytes at byte offsets "
          f"1-3, 20,000 bytes across a chunk, 24,653 aligned, 40,000 at "
          f"offset 3; bf16, int16 and f32 beside them), words around them "
          f"untouched [{_SMI}]")


def time_pack_bytes(torch, flush, state, launches):
    """9a, timed: the int8-moment state's K=1 canary (f32 params and
    scales, 1-byte ``q`` leaves) packed by the kernel and by the plain
    version, bitwise; device times beside the bound (1 B read + 4 B
    written an int8 element, 4 + 4 an f32 one), the event floor and
    ``Tensor.to(torch.int32)`` of the same leaves.  Returns the kernel
    JSON entry."""
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import digest as kd
    from repro_torch.kernels import ref

    plan = kd.plan_for(state)
    lay = plan.layout(tuple(range(plan.n_leaves)))
    xs = plan.leaves(state)
    starts = lay.starts[:plan.n_leaves]
    bk = torch.zeros(lay.padded_rows * ck.LANES, dtype=torch.int32,
                     device="cuda")
    bp = torch.zeros_like(bk)
    ref.pack_rows_ref(bp, xs, starts)
    desc = ck.pack_descriptors(xs, starts, "cuda")
    ck.pack_rows(bk, xs, starts, desc=desc)
    err = _max_err(torch, bk, bp)
    assert err == 0, f"int8-state pack differs from its plain version ({err})"
    del bp
    n_bytes = sum(x.numel() * (x.element_size() + 4) for x in xs)
    ones = sum(x.numel() for x in xs if x.element_size() == 1)
    bound, by = _bound_ms(n_bytes)
    ms = _median_ms(lambda: ck.pack_rows(bk, xs, starts, desc=desc), torch,
                    flush, queued=True)
    plain_ms = _median_ms(lambda: ref.pack_rows_ref(bk, xs, starts), torch,
                          flush, queued=True)
    to_ms = _median_ms(lambda: [x.to(torch.int32) for x in xs], torch,
                       flush, queued=True)
    floor_ms = _median_ms(lambda: torch.cuda._sleep(0), torch, flush,
                          queued=True)
    print(f"[pack-bytes] pack_rows (iterpro-100m int8-moment training "
          f"canary, K=1): bitwise equal to plain, {len(xs)} leaves, {ones} "
          f"1-byte elements of {sum(x.numel() for x in xs)}, "
          f"{n_bytes / 1e9:.4f} GB moved, {desc.n_chunks} chunks: device "
          f"time kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"Tensor.to(int32) of the same leaves {to_ms:.4f} ms, event floor "
          f"{floor_ms:.4f} ms, bound {bound:.4f} ms ({by}); launches on "
          f"phase 9b {launches} [{_SMI}]")
    return dict(route="cuda", source="src/repro_torch/kernels/csrc/checksum.cu",
                replaces="src/repro/kernels/checksum.py:85", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, launches=launches)


def check_int8_triage(torch, cfg, cases, label):
    """9b: rung 0 and the ladder on an int8-moment state at full width:
    after 6 functional steps each case flips one bit of a copy of the
    state, the K=1 canary names the leaf, and the runtime with triage
    either tolerates it in place (0 bytes, 0 steps, the next check quiet)
    or escalates to replay, bitwise the clean state.  ``cases``: (leaf
    chooser, element chooser, bit, expected rung)."""
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.faults import flip_bit
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.launch.train import cuda_numerics
    from repro_torch.train.loop import make_train_state, make_train_step
    from repro_torch.tree import flatten_with_path, leaf_key, tree_map

    _, bfn = _mode_tools(torch, cfg)
    n = 6
    with cuda_numerics(torch.device("cuda")):
        step_fn = make_train_step(cfg, global_batch=T_BATCH)
        state = make_train_state(cfg, 0, global_batch=T_BATCH,
                                 device="cuda")
        micro = MicroCheckpointer(T_SNAP)
        for s in range(n):
            micro.maybe_snapshot(s, state)
            micro.record_iv(s, state["iv"])
            state, _ = step_fn(state, bfn(s))
        canary = ChecksumCanary(state, n_slices=1)
        rt = RecoveryRuntime(step_fn=step_fn, batch_fn=bfn,
                             iv_registry=promote(cfg, T_BATCH), micro=micro,
                             canary=canary, triage=True)
        flat = {leaf_key(p): t for p, t in flatten_with_path(state)}
        for pick, elem, bit, want in cases:
            where = pick(flat)
            bad = tree_map(torch.clone, state)
            leaf = {leaf_key(p): t for p, t in flatten_with_path(bad)}[where]
            j = elem(flat, where)
            flip_bit(leaf, j, bit)
            report = canary.check(n, bad)
            assert report is not None and report.leaves == [where], report
            fixed, ev = rt.recover(bad, report, n)
            assert ev.attempted[0] == "triage", ev
            if want == "triage":
                assert ev.rung == "triage" and ev.bytes_moved == 0 \
                    and ev.steps_replayed == 0, ev
                assert _same_state(torch, fixed, bad)
                assert canary.check(n + 1, fixed) is None
            else:
                assert ev.rung == want, ev
                assert _same_state(torch, fixed, state)
            print(f"[int8-triage] {label}: {where} element {j} of "
                  f"{leaf.numel()} bit {bit}: {ev.attempted} -> {ev.rung} in "
                  f"{ev.wall_seconds * 1e3:.3f} ms, {ev.bytes_moved} B, "
                  f"{ev.steps_replayed} steps replayed"
                  + (" (state untouched, next check quiet)"
                     if ev.rung == "triage" else ", == clean, bitwise"))
            canary.refresh(state)


def _q_leaf(padded: bool):
    """A chooser of an ``opt/m/.../q`` leaf (one with a pad tail)."""
    def pick(flat):
        for k, t in flat.items():
            if k.startswith("opt/m/") and k.endswith("/q"):
                n = flat["params/" + k[len("opt/m/"):-len("/q")]].numel()
                if not padded or n % t.shape[-1]:
                    return k
        raise AssertionError("no such q leaf")
    return pick


def _param_numel(flat, key):
    return flat["params/" + key[len("opt/m/"):-len("/q")]].numel()


def train_int8(torch, flush):
    """9b: iterpro-100m with int8 AdamW moments at phase 7's settings
    (K=1, 20 steps, a snapshot every 4, a disk checkpoint every 10):
    clean and under the params storm, detected == injected == recovered,
    final states bitwise equal; a live ``q`` byte flipped and recovered
    by replay; with triage, a flip in a ``q`` pad tail tolerated by the
    dead-region certificate.  Returns (9a's timed entry, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    cfg = _int8(get_config("iterpro-100m"))
    _phase_start(torch)
    clean, clean_state = train_run(torch, cfg, "int8 clean")
    storm, state = train_run(torch, cfg, "int8 params storm",
                             inject_every=T_INJECT)
    assert clean["faults_detected"] == 0 and clean["steps"] == T_STEPS
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_detected"] == f, storm
    assert storm["faults_recovered"] == f, storm
    assert _same_state(torch, state, clean_state), \
        "int8 params storm final state differs from the clean run's"
    assert clean_state["opt"]["m"]["embed"]["table"]["q"].dtype == torch.int8
    del state
    shutil.rmtree(WORK, ignore_errors=True)
    launches = _phase_end(torch, "train-int8")
    for kernel in ("pack_rows", "row_checksums", "checksum_tiles"):
        assert launches.get(kernel, 0) > 0, (kernel, launches)
    print(f"[train-int8] params storm final state == clean final state, "
          f"bitwise (int8 q + f32 scale moments)")
    entry = time_pack_bytes(torch, flush, clean_state,
                            launches.get("pack_rows", 0))
    del clean_state
    mid = lambda flat, k: _param_numel(flat, k) // 2 + 1
    check_int8_triage(torch, cfg, [(_q_leaf(False), mid, 3, "replay")],
                      "iterpro-100m, a live q byte")
    tail = lambda flat, k: flat[k].numel() - 1
    check_int8_triage(
        torch, _int8(get_config("iterpro-100m"), d_model=PAD_D),
        [(_q_leaf(True), tail, 3, "triage"),
         (_q_leaf(True), mid, 3, "replay")],
        f"iterpro-100m at d_model {PAD_D} (at 768 every leaf is whole "
        f"256-element blocks: no q pad tail)")
    _build.LAUNCHES.clear()
    return entry, launches


def _strict_steady(torch, eng, name: str, steps: int = 8) -> None:
    """9c/9d: ``steps`` more steady engine steps on the engine
    ``_steady_busy`` left with every slot decoding, profiled: one
    ``cudaGraphLaunch`` and no kernel launched from the host a step,
    ``digest.STATS`` 1 launch + 1 fetch a step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import digest as kd
    torch.cuda.synchronize()
    kd.STATS.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            assert eng.engine_step()[2] is None
        torch.cuda.synchronize()
    stats = kd.STATS.snapshot()
    api = _api_counts(prof)
    assert stats == (steps, steps), stats
    assert api.get("cudaGraphLaunch", 0) == steps, api
    assert api.get("cudaLaunchKernel", 0) + api.get("cuLaunchKernel", 0) \
        == 0, api
    print(f"[{name}] {steps} steady steps: host API {api}, digest.STATS "
          f"{stats[0]} launches {stats[1]} fetches")


def serve_moe(torch, name, arch, seed_reqs: int, chunked: bool):
    """9c/9d: ``arch`` at full width and ``MOE_LAYERS`` layers, served
    paged through the captured step (phase 5's traffic) clean and under
    the storm (``serve_full_width``), then the strict steady profile and
    the graph pool's size; with ``chunked``, ``prefill_chunk=CHUNK``
    captured against the same engine uncaptured.  Returns launches."""
    from repro_torch.kernels import paged_kv as pkv
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import leaves
    import numpy as np

    cfg = _full_width(arch, n_layers=MOE_LAYERS)
    m = cfg.model
    print(f"[{name}] {arch} at full width (d {m.d_model}, "
          f"{m.n_heads}/{m.n_kv_heads} heads of {m.resolved_head_dim}, "
          f"{m.n_experts} experts of {m.moe_d_ff}, top-{m.top_k}, "
          f"{m.n_shared_experts} shared, {m.first_dense_layers} dense "
          f"first, vocab {m.vocab_size}, untied head), depth cut to "
          f"{MOE_LAYERS} of its {_full_width(arch).model.n_layers} layers "
          f"(the whole model needs the mesh)")

    def reqs():
        return make_requests(cfg, N_REQUESTS, PROMPT, GEN,
                             np.random.default_rng(seed_reqs))

    common = dict(n_slots=SLOTS, max_len=PROMPT + GEN + 1, block_size=BLOCK)
    _phase_start(torch)
    pool0 = _graph_pool_bytes(torch)
    eng, clean, launches = serve_full_width(torch, cfg, name, reqs,
                                            paged=True, **common)
    pool_mib = (_graph_pool_bytes(torch) - pool0) / 2**20
    _strict_steady(torch, eng, name)
    leaf = eng.pool["groups"][-1][0]["k"]
    err = _max_err(torch, pkv.gather_blocks(leaf, eng.bt).view(torch.int16),
                   ref.gather_blocks_ref(leaf, eng.bt).view(torch.int16))
    assert err == 0, f"{name}: gather_blocks differs on the pool ({err})"
    print(f"[{name}] {sum(t.numel() for t in leaves(eng.params))} params, "
          f"graph pools {pool_mib:.1f} MiB (both engines' 8 graphs); "
          f"gather_blocks on the bf16 pool leaf {tuple(leaf.shape)} (head "
          f"dim {leaf.shape[-1]}) bitwise equal to plain; launches "
          f"{launches} [{_SMI}]")
    if chunked:
        kw = dict(canary_slices=K, max_replays=10**6, device="cuda",
                  prefill_chunk=CHUNK, **common)
        toks = []
        for captured in (True, False):
            ch = ServingEngine(cfg, params=eng.params, **kw)
            if not captured:
                ch._replay = False
            rep = ch.run(reqs())
            assert rep.summary()["dropped"] == 0
            toks.append({r: v["tokens"] for r, v in rep.per_request.items()})
            del ch
        assert toks[0] == toks[1], f"{name}: chunked captured != uncaptured"
        same = toks[0] == {r: v["tokens"]
                           for r, v in clean.per_request.items()}
        print(f"[{name}] prefill_chunk={CHUNK}: captured tokens == the same "
              f"chunked engine uncaptured for all {N_REQUESTS} requests "
              f"(== monolithic: {same}; capacity is per call, so a chunk "
              f"may drop other rows than the whole prompt)")
    del eng
    return launches


def _train_moe(torch, cfg, name, **kw):
    """One 9e run of the training entry point (global batch T_BATCH x
    T_SEQ, donated, K=M_SLICES, one host snapshot at step 0); returns
    (summary, final state, steady peak GiB)."""
    from repro_torch.launch.train import train
    d = WORK / name.replace(" ", "_")
    shutil.rmtree(d, ignore_errors=True)
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, state = train(cfg, steps=M_STEPS, global_batch=T_BATCH,
                       seq_len=T_SEQ, seed=0, snapshot_interval=G_INTERVAL,
                       canary_slices=M_SLICES, donate=True, verbose=False,
                       device="cuda", return_state=True, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    shutil.rmtree(d, ignore_errors=True)
    rec, snap = out["recovery"], out["snapshots"]
    ck = out.get("checkpoints")
    print(f"[{name}] {out['steps']} steps in {time.perf_counter() - t0:.1f}"
          f" s, final loss {out['final_loss']:.6f}, host step p50 "
          f"{out['p50_step_ms']:.3f} ms, faults injected "
          f"{out['faults_injected']} detected {out['faults_detected']} "
          f"recovered {out['faults_recovered']}, rungs {rec['by_rung']}, "
          f"recovery p50 {out['p50_recovery_ms']:.3f} ms; {snap['count']} "
          f"host snapshot {snap['seconds']:.2f} s"
          + (f", {ck['count']} disk checkpoint {ck['blocking_seconds']:.2f} "
             f"s on the step path + {ck['write_seconds']:.2f} s written"
             if ck else "")
          + f"; peak memory {peak:.3f} GiB [{_SMI}]")
    return out, state, peak


def train_grok(torch):
    """9e: grok-1-314b trained at full width and 1 of its 64 layers with
    Adafactor (bf16 factored stats), its microbatch 8 (global batch 8 x
    128), K=4, ``--donate``, 4 steps, clean (no disk checkpoint since
    PR 25: the time cut).
    Then ``--donate --fused-detect`` under flips in the slice checked at
    their step (replay only; no fused clean run: the time cut, the storm
    holds its checks), bitwise the donated clean run, when the donated
    peak (which holds the plan's packing ring, the
    fused step's only packing buffer; the factory adopts the loop's
    state) fits 97 % of the card; else the arithmetic is printed and the
    storm runs donated, unfused.  Returns the phase's launches."""
    from repro_torch.core.detect import rotating_slice
    from repro_torch.kernels import digest as kd
    from repro_torch.kernels.checksum import LANES
    from repro_torch.tree import leaves
    cfg = _full_width(GROK, n_layers=GROK_TRAIN_LAYERS)
    assert cfg.train.optimizer == "adafactor" and cfg.train.microbatch == 8
    assert cfg.train.moment_dtype == "bfloat16"
    _phase_start(torch)
    held = torch.cuda.memory_allocated()
    # no disk checkpoint since PR 25, the time cut (a 12 GiB state: 12c
    # holds a checkpoint round trip at 8.4 GiB, 7b the checkpoint rung)
    clean, state, peak = _train_moe(torch, cfg, "train-grok clean")
    clean_host = _host(torch, state)
    del state
    assert clean["faults_detected"] == 0 and clean["steps"] == M_STEPS
    assert int(clean_host["iv"]["micro_count"]) == 8 * M_STEPS
    assert clean_host["opt"]["stats"]["groups"][0][0]["ffn"]["gate"][
        "vr"].shape == (1, 8, 6144)
    shutil.rmtree(WORK, ignore_errors=True)
    launches = _phase_end(torch, "train-grok")
    for kernel in ("pack_rows", "row_checksums"):
        assert launches.get(kernel, 0) > 0, (kernel, launches)
    n_params = sum(t.numel() for t in leaves(clean_host["params"]))
    print(f"[train-grok] {n_params} params (bf16), Adafactor bf16 stats, "
          f"microbatch {cfg.train.microbatch}: donated host step p50 "
          f"{clean['p50_step_ms']:.3f} ms, peak {peak:.3f} GiB (no device "
          f"profile of this step: the time cut) [{_SMI}]")

    def storm_run(name, **kw):
        out, state, _ = _train_moe(torch, cfg, name, inject_every=M_INJECT,
                                   inject_armed_only=True, **kw)
        f = out["faults_injected"]
        assert f > 0 and out["faults_detected"] == f, out
        assert out["faults_recovered"] == f, out
        assert set(out["recovery"]["by_rung"]) <= {"replay"}, out
        assert _same_state(torch, state, clean_host), \
            f"{name} final state differs from the donated clean run's"
        return out

    # the fused capture's packing buffers: the plan's ring, which the
    # donated pair already packs into (so the donated peak holds it);
    # before the ring each rotation's check+arm union had its own buffer
    _phase_start(torch)
    plan = kd.plan_for(clean_host)
    can_k = [tuple(rotating_slice(r, M_SLICES, plan.n_leaves))
             for r in range(M_SLICES)]
    words = lambda idx: plan.layout(idx).padded_rows * LANES * 4
    slices = sum(words(c) for c in can_k)
    unions = sum(words(can_k[r] + can_k[(r + 1) % M_SLICES])
                 for r in range(M_SLICES))
    ring = slices + min(words(c) for c in can_k)
    # donated, the fused factory adopts the loop's state as its graphs'
    # storage; the step's temporaries, counted in the donated peak, move
    # into the graphs' private pool
    copy = sum(t.numel() * t.element_size() for t in leaves(clean_host))
    total = torch.cuda.mem_get_info()[1]
    need = peak * 2**30
    print(f"[train-grok] --donate --fused-detect packs into the plan's "
          f"ring of {M_SLICES}+1 slices, {ring / 2**30:.3f} GiB (held in "
          f"the donated peak {peak:.3f} GiB, {held / 2**30:.3f} GiB of it "
          f"held before the phase), where the per-rotation unions held "
          f"{unions / 2**30:.3f} GiB beside the pair's "
          f"{slices / 2**30:.3f}; the factory adopts the loop's state "
          f"({copy / 2**30:.3f} GiB, no second version), so it needs "
          f"about that peak, {need / 2**30:.3f} GiB, of the card's "
          f"{total / 2**30:.3f} GiB (97 %: {0.97 * total / 2**30:.3f})")
    if need > 0.97 * total:
        print(f"[train-grok] --donate --fused-detect does not fit one card "
              f"at this width and was not run; the storm runs donated "
              f"[{_SMI}]")
        storm_run("train-grok params storm")
        print("[train-grok] donated params storm final state == clean "
              "final state, bitwise")
        return launches
    # the donate+fused clean run is the time cut: the storm holds its
    # checks (its first 2K captures, its final state == donated clean)
    fstorm = storm_run("train-grok donate+fused storm", fused_detect=True)
    fused = fstorm
    pool = fused["fused"]["pool_bytes"] / 2**30
    assert fused["fused"]["captures"] >= 2 * M_SLICES, fused
    f = fstorm["faults_injected"]
    print(f"[train-grok] donate+fused (graphs captured in "
          f"{fused['fused']['seconds']:.1f} s, graph pool {pool:.3f} GiB; "
          f"no clean run: the time cut) armed-slice storm ({f} flips, rungs "
          f"{fstorm['recovery']['by_rung']}; {fstorm['fused']['captures']} "
          f"captures: "
          + ("the graphs dropped for the eager replay, which needs their "
             "pool's room, and captured again"
             if fstorm["fused"]["captures"] > 2 * M_SLICES else
             "none dropped")
          + ") == "
          f"donated clean, bitwise; host step p50 "
          f"{fused['p50_step_ms']:.3f} ms [{_SMI}]")
    return launches


# -- phases 10-12: the recurrent and enc-dec families at full width ---------

XLSTM = "xlstm-350m"
ZAMBA = "zamba2-7b"
SEAMLESS = "seamless-m4t-large-v2"
R_LONG = 600                  # 10b/11b: three 256-token chunks, one padded
S_LONG = 4160                 # 12b: source frames, above FLASH_THRESHOLD
S_LAYERS = 6                  # 12a-12c: 6 of its 24 encoder + 6 of 24 decoder
R_STEPS, R_INJECT = 4, 2      # 10c/11c: steps, storm period (1 flip a run)
R_SLICES = 4                  # 10c/11c: the donated fused runs' canary K
X_LAYERS = 8                  # 10: xlstm-350m 8 of its 24 layers (7m + 1s)
Z_SERVE_LAYERS = 13           # 11a/11b: zamba2-7b 13 of its 81 (2 x (5m + A) + m)
Z_TRAIN_LAYERS = 7            # 11c: zamba2-7b 7 of its 81 layers
QWEN = "qwen2-vl-7b"
Q_GRID = 8                    # 13a: an 8 x 8 image a request (64 patches)
Q_LONG_GRID = 64              # 13b: a 64 x 64 image, 4,224 keys with the prompt
Q_TRAIN_LAYERS = 1            # 13c: qwen2-vl-7b 1 of its 28 layers
# 13c's --parity storm: at K=1 the functional step's two state versions,
# the ring and the parity's stream scratch do not fit the card; donated,
# the parity is rebuilt (``xor_fold_tiles``) and ``xor_update_tiles``,
# a kernel of the path, is never launched
Q_PARITY = dict(canary_slices=R_SLICES, inject_armed_only=True)
R_SERVE_MODES = (("dense", dict()), ("dense, no donation", dict(donate=False)))
R_PATH = ("pack_rows", "row_checksums", "checksum_tiles",
          "xor_update_tiles", "xor_fold_tiles")


_T_RUN = [0.0]                # the perf_counter at the build's start


def _stamp(what: str) -> None:
    """A ``[time]`` line: the seconds since the build began."""
    print(f"[time] {what} done, {time.perf_counter() - _T_RUN[0]:.1f} s "
          f"since the build began")


def _shape_of(model, m) -> str:
    """The stack a family walks: its pattern, enc-dec's two stacks, or
    the VLM's layers and patch width."""
    if m.family == "encdec":
        return (f"({m.n_enc_layers} encoder + {m.n_layers} decoder layers, "
                f"{m.frontend_dim}-wide source frames)")
    if m.family == "vlm":
        return (f"({m.n_layers} layers, m-rope, {m.patch_dim}-wide patches, "
                f"{m.n_kv_heads} KV heads of {m.resolved_head_dim})")
    return str(model.module.derive_pattern(m))


def serve_recurrent(torch, arch: str, label: str, model_kw: dict, long,
                    requests=None, patch_rows: int = 0):
    """10a, 11a, 12a, 13a: ``arch`` at full width, its model fields
    changed by ``model_kw`` (the depth cut; empty: all its layers; bf16,
    random params from seed 0) served on the dense slot-major engine (the
    family has no ``prefill_chunk``, or m-rope, which is not paged) with
    phase 5's traffic (an enc-dec request carries ``max_len`` source
    frames; ``requests`` makes the requests, as ``make_requests`` does,
    and ``patch_rows`` adds a VLM request's patch rows to ``max_len``):
    the step's body uncaptured (the reference tokens, clean only), then
    captured donated and ping-pong (``serve_modes``: clean == uncaptured,
    in the donated mode an armed-slice storm over the decode state's
    leaves == clean with the flips by leaf (phase 5d storms ping-pong), 1
    ``cudaGraphLaunch`` + STATS (1, 1) a steady step, decode p50 / p99,
    device busy, kernels a step, graph pool); then ``long(torch, cfg,
    params, common, label)`` (10b, 11b, 12b, 13b).  Returns the phase's
    launches."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import get_model
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import leaves
    import numpy as np

    cfg = _full_width(arch, **model_kw)
    m = cfg.model
    _phase_start(torch)
    model = get_model(m)
    params = model.init(m, 0, "cuda")
    max_len = PROMPT + GEN + 1 + patch_rows
    cache = model.make_decode_cache(m, 1, max_len, "meta")
    state = [t for k, v in cache.items() if k != "pos" for t in leaves(v)]
    depth = f"{m.n_layers} of its layers (the depth cut)" if model_kw \
        else "full depth"
    print(f"[{label}] {arch} at full width and {depth} "
          f"{_shape_of(model, m)}, d {m.d_model}, {m.n_heads} "
          f"heads, vocab {m.vocab_size}, "
          f"{sum(t.numel() for t in leaves(params))} params "
          f"({leaves(params)[0].dtype}), untied head; one slot's decode "
          f"state at max_len {max_len}: {len(state)} leaves, "
          f"{sum(t.numel() * t.element_size() for t in state)} bytes")
    common = dict(n_slots=SLOTS, max_len=max_len, canary_slices=K,
                  max_replays=10**6, device="cuda")
    make = requests or make_requests

    def reqs():
        return make(cfg, N_REQUESTS, PROMPT, GEN, np.random.default_rng(5))

    _build.LAUNCHES.clear()
    eng = ServingEngine(cfg, params=params, **common)
    assert not eng.paged
    eng._replay = False                  # the step's body run eagerly
    rep = eng.run(reqs())
    assert rep.summary()["dropped"] == 0
    tokens = {rid: r["tokens"] for rid, r in rep.per_request.items()}
    print(f"[{label}] uncaptured (the reference tokens): decode p50 "
          f"{rep.summary()['p50_decode_ms']:.3f} ms; launches "
          f"{dict(_build.LAUNCHES)} [{_SMI}]")
    del eng
    launches = serve_modes(torch, cfg, params, common, reqs, tokens,
                           modes=R_SERVE_MODES, label=label,
                           storms=(R_SERVE_MODES[0][0],))
    long(torch, cfg, params, common, f"{label}-long")
    end = _phase_end(torch, label)
    for k, v in end.items():
        launches[k] = max(launches.get(k, 0), v)
    return launches


def long_recurrent(torch, cfg, params, common, label: str) -> None:
    """10b / 11b: one prompt of ``R_LONG`` tokens; its first decoded
    token == the argmax of a prefill one token longer."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving import ServingEngine
    import numpy as np
    eng = ServingEngine(cfg, params=params, **dict(
        common, n_slots=1, max_len=R_LONG + 2 + 1))
    assert not eng.paged
    rq = make_requests(cfg, 1, R_LONG, 2, np.random.default_rng(6))[0]
    rep = eng.run([rq])
    check_first_token(torch, eng, make_requests(
        cfg, 1, R_LONG, 2, np.random.default_rng(6))[0],
        rep.per_request[0]["tokens"], label, tol=None)


def long_encdec(torch, cfg, params, common, label: str) -> None:
    """12b: one request whose source has ``S_LONG`` frames, above
    ``FLASH_THRESHOLD``: the encoder's non-causal self-attention takes
    ``attention_flash`` (counted: once per encoder layer) and the decode
    stays direct.  The slot's memory K/V after the run (read only by the
    decodes) and the BOS logits of the same prefill outside the engine
    (before the engine's run and after it) within
    ``BF16_TOL`` of that prefill through ``attention_direct`` (the
    threshold lifted), scaled by the largest entry; the first token (the
    BOS logits' argmax, ``rq.log[0]``) == the flash prefill's argmax, and
    its logit on the direct path within twice that tolerance of the
    direct path's largest (random weights leave the largest logits of
    256,206 within a bf16 rounding of one another), the argmaxes and
    top-2 gaps printed."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import layers as L
    from repro_torch.serving import ServingEngine
    import numpy as np

    def request():
        return make_requests(cfg, 1, S_LONG - 3, 2,
                             np.random.default_rng(6))[0]
    rq = request()
    assert rq.features["src_embeds"].shape[1] == S_LONG > L.FLASH_THRESHOLD
    eng = ServingEngine(cfg, params=params, **dict(
        common, n_slots=1, max_len=S_LONG))
    m = cfg.model
    batch = {"src_embeds": torch.from_numpy(
        request().features["src_embeds"]).cuda()}
    before, _ = eng.model.prefill(eng.params, m, batch, max_len=S_LONG)
    flash = L.attention_flash
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape[1])
        return flash(*a, **kw)
    L.attention_flash = counted
    try:
        rep = eng.run([rq])
    finally:
        L.attention_flash = flash
    assert len(rep.per_request[0]["tokens"]) == 2
    first = rq.log[0]
    assert len(calls) == m.n_enc_layers and set(calls) == {S_LONG}, calls
    flash_logits, _ = eng.model.prefill(eng.params, m, batch,
                                        max_len=S_LONG)
    threshold = L.FLASH_THRESHOLD
    L.FLASH_THRESHOLD = 1 << 30
    try:
        logits, direct = eng.model.prefill(eng.params, m, batch,
                                           max_len=S_LONG)
    finally:
        L.FLASH_THRESHOLD = threshold
    errs = {}
    for k in ("mem_k", "mem_v"):
        ours = eng.cache[k][0, :, 0].float()
        ref = direct[k][:, 0].float()
        errs[k] = (float((ours - ref).abs().max()),
                   float(ref.abs().max()))
    for name, lg in (("logits before the run", before),
                     ("logits after the run", flash_logits)):
        errs[name] = (float((lg - logits).abs().max()),
                      float(logits.abs().max()))
    want = int(logits[0].argmax())
    tol = BF16_TOL * max(1.0, float(logits.abs().max()))
    short = float(logits[0, want] - logits[0, first])

    def gap(lg):
        top2 = lg[0].topk(2).values
        return (f"argmax {int(lg[0].argmax())}, top-2 gap "
                f"{float(top2[0] - top2[1]):.4f}")
    print(f"[{label}] {S_LONG} source frames (FLASH_THRESHOLD "
          f"{threshold}): attention_flash taken by {len(calls)} encoder "
          f"layers, decode direct; vs the direct path's max |diff| "
          + ", ".join(f"{k} {e:.5f} (largest |entry| {r:.4f})"
                      for k, (e, r) in errs.items())
          + f"; first token {first}, its direct logit {short:.4f} "
          f"below the direct path's largest (tolerance {2 * tol:.4f}); "
          f"flash before the run: {gap(before)}, after: "
          f"{gap(flash_logits)} (bitwise equal: "
          f"{bool(torch.equal(before, flash_logits))}); direct: "
          f"{gap(logits)} [{_SMI}]")
    for k, (e, r) in errs.items():
        assert e <= BF16_TOL * max(1.0, r), (k, e, r)
    assert first == int(before[0].argmax()), (first, gap(before))
    assert short <= 2 * tol, (first, want, short, tol)
    del eng, direct


def grid_positions(grid: int, n_text: int):
    """Qwen2-VL's (t, h, w) positions of one ``grid x grid`` image and
    ``n_text`` tokens after it: patch (row, col) at (0, row, col), the
    text at ``grid``, ``grid + 1``, ... on all three streams; (1, grid^2
    + n_text, 3) int32."""
    import numpy as np
    r, c = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    img = np.stack([np.zeros(grid * grid, np.int64), r.ravel(), c.ravel()],
                   -1)
    text = np.repeat((grid + np.arange(n_text))[:, None], 3, axis=1)
    return np.concatenate([img, text]).astype(np.int32)[None]


def vlm_requests(grid: int):
    """A request factory like ``make_requests`` whose requests each carry
    one ``grid x grid`` image: ``patch_embeds`` (1, grid^2, patch_dim)
    float32 standard normals from the same generator and the grid's
    ``positions``."""
    from repro_torch.launch.serve import make_requests
    import numpy as np

    def make(cfg, n, prompt_len, gen, nprng):
        reqs = make_requests(cfg, n, prompt_len, gen, nprng)
        for rq in reqs:
            rq.features = {
                "patch_embeds": nprng.standard_normal(
                    (1, grid * grid, cfg.model.patch_dim), dtype=np.float32),
                "positions": grid_positions(grid, prompt_len)}
        return reqs
    return make


def long_vlm(torch, cfg, params, common, label: str) -> None:
    """13b, after the admission rule: one request with Np + P + 1 + new =
    ``max_len`` + 1 is refused with ``AdmissionError`` (the reference
    admits it and overwrites its cache's last row).  Then one request of
    a ``Q_LONG_GRID`` x ``Q_LONG_GRID`` image (4,096 patches) and a
    ``PROMPT``-token prompt: 4,224 keys, above ``FLASH_THRESHOLD``, so
    every layer's attention takes ``attention_flash`` (counted) with the t
    stream 0 over the patches, while the decode stays direct.  The slot's
    K/V rows and the last-position logits of the same prefill outside the
    engine are held against two other prefills of the same inputs: the
    bf16 one through ``attention_direct`` (the threshold lifted) and an
    f32 one (the params cast to f32, compute in f32; in f32 the flash and
    direct paths agree within 2e-5), the oracle.  Through 28 bf16 layers
    each bf16 path lies 3.5-4.6 % of the largest entry from the oracle,
    above ``BF16_TOL``, and the two part by 3.3-4.4 %: so the flash path
    must differ from the direct path by no more than the direct path
    differs from the oracle (its own bf16 rounding), in max |diff| of
    each of K, V and the logits.  The first token (``rq.log[0]``) == the
    flash prefill's argmax, and its logit on the direct path within
    twice ``BF16_TOL`` of the direct path's largest."""
    import dataclasses
    from repro_torch.models import layers as L
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.paged import AdmissionError
    from repro_torch.tree import tree_map
    import numpy as np

    eng = ServingEngine(cfg, params=params, **common)
    rq = vlm_requests(Q_GRID)(cfg, 1, PROMPT, 0, np.random.default_rng(7))[0]
    rq.max_new_tokens = eng.max_len - Q_GRID ** 2 - PROMPT
    msg = _expect(AdmissionError, lambda: eng.admit(rq, 0),
                  "an overflowing VLM request")
    assert eng.slot_rid == [None] * SLOTS
    print(f"[{label}] a request of {Q_GRID ** 2} patches + {PROMPT} tokens "
          f"+ 1 + {rq.max_new_tokens} new = max_len {eng.max_len} + 1 "
          f"refused: {msg}")
    del eng

    def request():
        return vlm_requests(Q_LONG_GRID)(cfg, 1, PROMPT, 2,
                                         np.random.default_rng(6))[0]
    rq = request()
    keys = Q_LONG_GRID ** 2 + PROMPT
    assert keys > L.FLASH_THRESHOLD
    eng = ServingEngine(cfg, params=params, **dict(
        common, n_slots=1, max_len=keys + 2 + 1))
    m = cfg.model
    batch = eng._batch(request())
    flash = L.attention_flash
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape[1])
        return flash(*a, **kw)
    L.attention_flash = counted
    try:
        rep = eng.run([rq])
    finally:
        L.attention_flash = flash
    assert len(rep.per_request[0]["tokens"]) == 2
    assert len(calls) == m.n_layers and set(calls) == {keys}, calls
    first = rq.log[0]
    flash_logits, _ = eng.model.prefill(eng.params, m, batch,
                                        max_len=eng.max_len)
    threshold = L.FLASH_THRESHOLD
    L.FLASH_THRESHOLD = 1 << 30
    try:
        logits, direct = eng.model.prefill(eng.params, m, batch,
                                           max_len=eng.max_len)
    finally:
        L.FLASH_THRESHOLD = threshold
    kv = {k: (eng.cache["groups"][0][0][k][0, :, 0, :keys],
              direct["groups"][0][0][k][:, 0, :keys]) for k in ("k", "v")}
    del direct
    _release(torch)
    m32 = dataclasses.replace(m, param_dtype="float32",
                              compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), eng.params)
    logits32, exact = eng.model.prefill(p32, m32, batch,
                                        max_len=eng.max_len)
    del p32
    pairs = dict(kv, **{"last logits": (flash_logits, logits)})
    errs = {}
    for k, (ours, theirs) in pairs.items():
        ref = logits32 if k == "last logits" else \
            exact["groups"][0][0][k][:, 0, :keys]
        errs[k] = tuple(float((a.float() - b.float()).abs().max())
                        for a, b in ((ours, theirs), (ours, ref),
                                     (theirs, ref))) + (
            float(ref.abs().max()),)
    del exact
    want = int(logits[0].argmax())
    tol = BF16_TOL * max(1.0, float(logits.abs().max()))
    short = float(logits[0, want] - logits[0, first])

    def gap(lg):
        top2 = lg[0].topk(2).values
        return (f"argmax {int(lg[0].argmax())}, top-2 gap "
                f"{float(top2[0] - top2[1]):.4f}")
    print(f"[{label}] {Q_LONG_GRID}x{Q_LONG_GRID} image ({Q_LONG_GRID ** 2} "
          f"patches) + {PROMPT} tokens = {keys} keys (FLASH_THRESHOLD "
          f"{threshold}): attention_flash taken by {len(calls)} layers, "
          f"decode direct; max |diff| flash vs direct, flash vs f32, direct "
          f"vs f32 (largest |f32 entry|): "
          + ", ".join(f"{k} {a:.5f}, {b:.5f}, {c:.5f} ({r:.4f})"
                      for k, (a, b, c, r) in errs.items())
          + f"; first token {first}, its direct logit {short:.4f} "
          f"below the direct path's largest (tolerance {2 * tol:.4f}); "
          f"flash: {gap(flash_logits)}; direct: {gap(logits)}; f32: "
          f"{gap(logits32)} [{_SMI}]")
    for k, (apart, _, direct_err, _) in errs.items():
        assert apart <= direct_err, (k, errs[k])
    assert first == int(flash_logits[0].argmax()), (first,
                                                    gap(flash_logits))
    assert short <= 2 * tol, (first, want, short, tol)
    del eng


def _reckon_train(torch, cfg, label: str, parity_kw: dict) -> None:
    """10c-13c: the training runs' memory reckoned from shapes before they
    run (as 9e reckons its fused runs): the state, a second version of it
    (the functional step's output), the canary's packing ring at K = 1
    and at ``R_SLICES`` (K slices + the smallest once more), the bf16
    gradient accumulator of a microbatched step, and the ``--parity``
    run's parity and its stream scratch (every covered word once, as
    int32) with its settings ``parity_kw`` (canary K, donation)."""
    from repro_torch.core import parity as cp
    from repro_torch.core.detect import rotating_slice
    from repro_torch.kernels import digest as kd
    from repro_torch.kernels.checksum import LANES
    from repro_torch.train.loop import make_train_state
    from repro_torch.tree import leaves
    meta = make_train_state(cfg, 0, global_batch=T_BATCH, device="meta")
    plan = kd.plan_for(meta)
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in leaves(tree))

    def ring(k):
        words = lambda idx: plan.layout(idx).padded_rows * LANES * 4
        sl = [tuple(rotating_slice(r, k, plan.n_leaves)) for r in range(k)]
        return sum(words(c) for c in sl) + min(words(c) for c in sl)
    state, acc = nbytes(meta), 2 * sum(t.numel()
                                       for t in leaves(meta["params"]))
    pplan = cp.parity_plan_for(meta)
    parity = pplan.memory_bytes * (1 + pplan.n_shards)
    pk = parity_kw.get("canary_slices", 1)
    pv = 1 if parity_kw.get("donate") else 2
    total = torch.cuda.mem_get_info()[1]
    gib = lambda b: f"{b / 2**30:.3f} GiB"
    print(f"[{label}] held before the runs: "
          f"{gib(torch.cuda.memory_allocated())}; reckoned: state "
          f"{gib(state)}; K=1 "
          f"functional: 2 state versions + ring {gib(ring(1))} + bf16 "
          f"gradient accumulator {gib(acc)} = "
          f"{gib(2 * state + ring(1) + acc)}; --parity at K={pk}: {pv} "
          f"version(s) + ring {gib(ring(pk))} + accumulator + parity and "
          f"its stream scratch {gib(parity)} = "
          f"{gib(pv * state + ring(pk) + acc + parity)}; "
          f"K={R_SLICES} donate+fused: "
          f"1 version (adopted by the graphs) + ring {gib(ring(R_SLICES))}"
          f" + accumulator = {gib(state + ring(R_SLICES) + acc)}; "
          f"activations (remat), the optimizer's f32 temporaries and graph "
          f"pools besides, of the card's {gib(total)}")
    _drop_plans(torch)


def _drop_plans(torch) -> None:
    """Drop the cached digest plans (their packing rings) and parity
    plans (their stream scratch) and return the memory to the card."""
    from repro_torch.core import parity as cp
    from repro_torch.kernels import digest as kd
    kd._PLAN_CACHE.clear()
    cp._PARITY_PLAN_CACHE.clear()
    _release(torch)


R_STORMS = ("parity", "iv", "fused")


def train_recurrent(torch, arch: str, label: str, model_kw: dict, *,
                    storms=R_STORMS, checkpoint: bool = True,
                    profile: bool = True, parity_kw=None,
                    fused_clean: bool = True):
    """10c-13c: ``arch`` trained at full width (bf16 params, the config's
    optimizer, microbatch and remat; global batch 8 x 128, an enc-dec
    batch with 64 source frames, a VLM batch with 16 patches), its model
    fields changed by ``model_kw`` (the depth cut), one flip a storm,
    each run after the cached plans are dropped: K=1 functional clean;
    the ``storms`` named: ``parity``, a params storm under ``--parity``
    (``parity_xor``; final state == clean, bitwise), K=1 functional unless
    ``parity_kw`` says otherwise (13c: K=4, the flip in the slice
    checked at its step: the smaller ring makes room for the parity's
    stream scratch), ``iv``, an iv storm (``eq1``); ``--donate
    --fused-detect`` at K=4 clean (8 graphs, == the functional clean
    run) and, with ``fused``, under an
    armed-slice storm (replay; == clean); with ``checkpoint`` a
    checkpoint of the final state written and read back, bitwise; with
    ``profile`` the donate+fused hot path (``profile_modes``; the runs
    print the functional host p50).  Without ``fused_clean`` the
    donate+fused clean run is dropped and the storm (``fused`` in
    ``storms``) holds its checks: its graphs, its final state == the
    functional clean run's.  Each storm dropped and the three flags
    are the script's time cuts (each path is held in full by one phase;
    the ``--parity`` storm runs in every phase: it launches the parity
    kernels).  Returns the phase's launches."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    cfg = _full_width(arch, **model_kw)
    assert cfg.train.optimizer == "adamw" and cfg.train.remat != "none"
    _phase_start(torch)
    # cuBLAS keeps a workspace per (handle, stream) in the caching
    # allocator, and every earlier phase's captures used streams of their
    # own (1.5-1.9 GiB by phase 13); no graph is alive here to read them
    held = torch.cuda.memory_allocated()
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    _release(torch)
    print(f"[{label}] cuBLAS workspaces of the earlier phases dropped: "
          f"{held / 2**30:.3f} -> "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB held")
    parity_kw = dict(parity_kw or {}, parity=True)
    _reckon_train(torch, cfg, label, parity_kw)
    kw = dict(steps=R_STEPS, canary_slices=1, disk=False)
    clean, state = train_full_width(torch, cfg, f"{label} clean", **kw)
    assert clean["faults_detected"] == 0 and clean["steps"] == R_STEPS
    clean_host = _host(torch, state)
    del state
    runs = {"parity": ("params storm --parity", parity_kw, "parity_xor"),
            "iv": ("iv storm", dict(inject_target="iv"), "eq1")}
    for name, extra, rung in (runs[k] for k in storms if k in runs):
        _drop_plans(torch)
        out, state = train_full_width(torch, cfg, f"{label} {name}",
                                      inject_every=R_INJECT,
                                      **dict(kw, **extra))
        f = out["faults_injected"]
        assert f > 0 and out["faults_detected"] == f, out
        assert out["faults_recovered"] == f, out
        assert out["recovery"]["by_rung"] == {rung: f}, (name, out)
        assert _same_state(torch, state, clean_host), \
            f"{arch} {name} final state differs from the clean run's"
        del state
        print(f"[{label}] {name}: rungs {out['recovery']['by_rung']}, "
              f"final state == clean, bitwise")
    kw4 = dict(steps=R_STEPS, canary_slices=R_SLICES, donate=True,
               fused_detect=True, disk=False)
    _drop_plans(torch)
    assert fused_clean or "fused" in storms
    state = None
    if fused_clean:
        fused, state = train_full_width(torch, cfg, f"{label} donate+fused "
                                        f"K={R_SLICES} clean", **kw4)
        assert fused["fused"]["captures"] == 2 * R_SLICES, fused
        assert _same_state(torch, state, clean_host), \
            f"{arch} donate+fused clean final state differs from functional"
    stormed = "no armed-slice storm (the time cut)"
    if "fused" in storms:
        del state
        storm, state = train_full_width(
            torch, cfg, f"{label} donate+fused K={R_SLICES} storm",
            inject_every=R_INJECT, inject_armed_only=True, **kw4)
        f = storm["faults_injected"]
        assert f > 0 and storm["faults_detected"] == f, storm
        assert storm["faults_recovered"] == f, storm
        assert set(storm["recovery"]["by_rung"]) <= {"replay"}, storm
        assert _same_state(torch, state, clean_host), \
            f"{arch} donate+fused storm final state differs from clean"
        stormed = f"armed-slice storm ({f} flip, replay) == clean"
        if not fused_clean:
            # the storm holds the clean run's checks (the time cut)
            assert storm["fused"]["captures"] >= 2 * R_SLICES, storm
            fused = storm
            stormed += " (no clean run: the time cut)"
    ckpt = "no checkpoint (the time cut)"
    if checkpoint:
        d = WORK / f"{label}_ckpt"
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(str(d), state, R_STEPS)
        t1 = time.perf_counter()
        back, step = load_checkpoint(str(d), state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        assert step == R_STEPS and _same_state(torch, back, state)
        shutil.rmtree(d, ignore_errors=True)
        del back
        ckpt = (f"checkpoint of the final state written in {t1 - t0:.2f} s"
                f" and read back (digest-verified) in {t2 - t1:.2f} s, "
                f"bitwise")
    print(f"[{label}] donate+fused K={R_SLICES}: "
          f"{fused['fused']['captures']} graphs (their pool "
          f"{fused['fused']['pool_bytes'] / 2**30:.3f} GiB), "
          f"{'clean == functional clean, ' if fused_clean else ''}"
          f"{stormed}, bitwise; {ckpt} [{_SMI}]")
    launches = _phase_end(torch, label)
    if profile:
        # the profile starts from a card holding only this state (the
        # plans' rings and the parity scratch of the runs above go)
        _phase_start(torch)
        profile_modes(torch, cfg, state, steps=2, start=R_STEPS,
                      label=label, modes=("donate+fused",), prof_steps=1)
    del state, clean_host
    return launches


def recurrent_phase(torch, phase: int, arch: str, serve_kw: dict,
                    train_kw: dict, long=long_recurrent, requests=None,
                    patch_rows: int = 0, **cuts):
    """Phase 10 (xLSTM), 11 (the hybrid), 12 (enc-dec) or 13 (the VLM):
    serving (with ``long`` its long-input check; ``requests`` and
    ``patch_rows`` as ``serve_recurrent`` takes them), then training
    (``cuts``: the flags of ``train_recurrent``), each with the config's
    model fields changed by ``*_kw`` (the depth cuts); each of
    ``R_PATH``'s kernels launched on the phase's paths."""
    t0 = time.perf_counter()
    name = arch.split("-")[0]
    lc = {f"{phase}a/{phase}b": serve_recurrent(
        torch, arch, f"serve-{name}", serve_kw, long, requests=requests,
        patch_rows=patch_rows)}
    _stamp(f"phases {phase}a-{phase}b")
    lc[f"{phase}c"] = train_recurrent(torch, arch, f"train-{name}",
                                      train_kw, **cuts)
    for kernel in R_PATH:
        assert sum(c.get(kernel, 0) for c in lc.values()) > 0, (kernel, lc)
    print(f"[phase {phase}] launches of " + ", ".join(R_PATH) + " by path: "
          + "; ".join(f"{p}: " + ", ".join(f"{k} {c.get(k, 0)}"
                                           for k in R_PATH)
                      for p, c in lc.items())
          + f"; {time.perf_counter() - t0:.1f} s [{_SMI}]")


MESH, MESH_STEPS = "2,2", 3    # phase 14: 4 ranks share the one card
MESH_K = 2                     # 14b: the fused run's canary K
#: 14-14c and 14e's (e2) run 4 of iterpro-100m's 12 layers (a time
#: cut); 14d and 14e's (e1) run all 12
MESH_LAYERS = 4
#: 14e: the mesh serving runs' traffic, (requests, new tokens each, a
#: flip every N accepted tokens, in the slice the next step checks):
#: prompts of 32 tokens through 4 slots, K=4; (e2) is shrunk first (the
#: time cut)
MS_PROMPT, MS_SLOTS, MS_K = 32, 4, 4
MS_TRAFFIC = {"e1": (4, 6, 4), "e2": (2, 4, 4)}
#: 14e (e2): the shard whose replica alone takes the dense run's flips
MS_ONE_RANK = 1
#: 14d: 4 steps, row 1 (ranks 2-3) dies before step 2
ELASTIC_STEPS, ELASTIC_KILL = 4, 2
#: the byte a rank of the lost row writes over its blocks once the
#: drill's oracle has read them
ELASTIC_POISON = 0x5A
#: 14c: the triage and parity flips, in an ``opt/v`` FFN leaf (its blocks
#: split over ``model``, replicated over ``data``: 2 holders each)
MESH_FLIP_LEAF = "groups/0/0/ffn/up/w"
MESH_FLIP_ELEMENT = 1000


def _mesh_pair_rungs(cfg, seq: int, dev) -> dict:
    """14c, in a rank: the donated pair (``arm_current`` / ``check``,
    K=1) with triage and the mesh parity, as ``train(mesh=..., donate=,
    triage=, parity=)`` composes them, driven by hand to place its two
    flips on the initial state (no step loop: 14b's ``train()`` run
    steps triage and the mesh parity with the fused donated step): bit 30 of an ``opt/v`` FFN
    word (triage refuses it; ``parity_xor`` or ``replay`` repairs it;
    the state must come back to its bits before the flip), then bit 2 of
    another word of the same leaf (tolerated)."""
    import torch
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.faults import InjectionPlan, inject
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.parity import ParityStore
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.core.recovery_table import RecoveryTable
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import parity as pk
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_context
    from repro_torch.launch.specs import bind_state
    from repro_torch.launch.train import batch_for, cuda_numerics
    from repro_torch.train.loop import make_train_state, make_train_step
    from repro_torch.tree import leaves as leaves_of

    ctx = make_context(MESH, dev)
    key = "opt/v/" + MESH_FLIP_LEAF
    out = {"events": []}
    with cuda_numerics(dev):
        pipe = TokenPipeline(cfg.model.vocab_size, seq, T_BATCH, seed=0)
        state, step, bfn, sh = bind_state(
            ctx, cfg, make_train_state(cfg, 0, global_batch=T_BATCH,
                                       device=dev),
            make_train_step(cfg, global_batch=T_BATCH, donate=True),
            lambda s: batch_for(cfg, pipe, s))
        ivs = promote(cfg, T_BATCH)
        canary = ChecksumCanary(state, n_slices=1, ctx=ctx)
        pstore = ParityStore(state, ctx=ctx, shardings=sh)
        pstore.build(state)
        canary.attach_parity(pstore)
        micro = MicroCheckpointer(interval=2, ctx=ctx, shardings=sh)
        rt = RecoveryRuntime(
            step_fn=step, batch_fn=bfn, iv_registry=ivs, micro=micro,
            parity=pstore, canary=canary, triage=True, donated=True,
            shardings=sh, reuse_state=True,
            table=RecoveryTable.build(
                state, sharded=True, triage=True, parity=True,
                opt_ivs=tuple(k for k in (*ivs.specs, *ivs.derived)
                              if k.startswith("opt/"))))
        ptrs = [t.data_ptr() for t in leaves_of(state)]

        def recover(s, rep):
            rep.resolve()
            t0 = time.perf_counter()
            new, ev = rt.recover(state, rep, s)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out["events"].append({
                "rung": ev.rung, "attempted": ev.attempted,
                "bytes": ev.bytes_moved,
                "ms": 1e3 * (time.perf_counter() - t0),
                "shards": rep.shards})
            return new

        canary.arm_current(0, state)
        micro.record_iv(0, state["iv"])
        micro.maybe_snapshot(0, state)
        truth = {k: t.clone() for k, t in zip(canary.plan.keys,
                                              canary.plan.leaves(state))}
        inject(state, InjectionPlan("v/" + MESH_FLIP_LEAF,
                                    MESH_FLIP_ELEMENT, 30, 0, "opt"),
               shardings=sh)
        state = recover(0, canary.check(0, state))
        canary.refresh(state)
        pstore.rebuild(state, 0)
        out["same"] = _same_state(torch, dict(zip(
            canary.plan.keys, canary.plan.leaves(state))), truth)
        del truth
        out["ptrs_kept"] = ptrs == [t.data_ptr() for t in leaves_of(state)]
        steps = 1

        # the parity row over the state against its plain version: the
        # fold of the rank's exchanged stream, and a gated update of it
        canary.arm_current(steps, state)
        pp = pstore.plan
        recv = pp.exchange(pp.stream_mat(pp.leaves(state)))
        out["fold_err"] = _max_err(torch, pstore.parity,
                                   ref.xor_fold_tiles_ref(recv))
        before = dict(_build.LAUNCHES)
        upd = pk.xor_update_tiles(recv, pstore.parity.clone())
        out["update_err"] = _max_err(
            torch, upd, ref.xor_update_tiles_ref(recv,
                                                 pstore.parity.clone()))
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(before)
        out["parity_words"] = pp.row_words

        # bit 2 of another word of the same leaf: tolerated
        inject(state, InjectionPlan("v/" + MESH_FLIP_LEAF,
                                    MESH_FLIP_ELEMENT + 7, 2, steps, "opt"),
               shardings=sh)
        rep = canary.check(steps, state)
        out["tolerated_detected"] = rep is not None
        tiles0 = _build.LAUNCHES.get("checksum_tiles", 0)
        state = recover(steps, rep)
        out["triage_tiles"] = _build.LAUNCHES.get("checksum_tiles",
                                                  0) - tiles0
        out["full_clean"] = canary.check_full(steps, state) is None
        # checksum_tiles on the rank's block of the leaf, against its
        # plain version
        blk = {k: t for k, t in zip(canary.plan.keys,
                                    canary.plan.leaves(state))}[key]
        before = dict(_build.LAUNCHES)
        words = ref.to_i32(blk)
        out["tiles_err"] = _max_err(
            torch, ck.checksum_tiles(words),
            ref.checksum_tiles_ref(words))
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(before)
    return out


def _mesh_serve(dev, device: str, smoke: bool) -> dict:
    """14e, in a rank, before 14d: ``serve --mesh`` — the serving engine on
    the 2 x 2 mesh (``ServingEngine(ctx=...)``: tensor-parallel, the model
    reads the rank's param blocks in place, with no params gather; the
    replicated covered state; each step two graphs a rotation and read
    table around the eager model and its model-axis collectives; the
    shard-local canary whose flag is all-reduced after the tail graph's
    replay), iterpro-100m at full width,
    f32, seed 0, prompts of ``MS_PROMPT`` tokens through 4 slots, K=4,
    the traffic and the flips' cadence of ``MS_TRAFFIC`` (the flips in
    the slice the next step checks):

    * (e1) all 12 layers, paged, donated, ``parity``; after the run
      ``corrupt_param`` + ``scrub_params``;
    * (e2) ``MESH_LAYERS`` layers, dense, ping-pong, the storm's flips
      in rank ``MS_ONE_RANK``'s replica only.

    Each run's token logs must equal those of a single-device engine on
    shard 0 over the same params (the blocks gathered once after the
    run; clean, no canary), gathered to every rank.  Returns what
    ``check_mesh_serve`` asserts and prints: the summary, the faults as
    this rank saw them, graphs and pointers, the params gathers of the
    run (none), a steady step's STATS and model-axis collectives, the
    launches of the run (with the scrub), the flag all-reduce and scrub
    times, and (e1) the path's kernels against their plain versions on
    the rank's own data."""
    import random
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import parity as cp
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import GATHERS, gather_tree
    from repro_torch.kernels import _build
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import digest as kd
    from repro_torch.kernels import paged_kv as pkv
    from repro_torch.kernels import parity as pk
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_context
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import leaves as leaves_of

    ctx = make_context(MESH, dev)
    group = ctx.group(ctx.axis_names)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def timed(fn, n):
        """Median host ms of ``fn`` over ``n`` calls, every rank entering
        each call together (synchronised)."""
        ms = []
        for _ in range(n):
            sync()
            coll.barrier(ctx.device, group)
            t0 = time.perf_counter()
            fn()
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(ms))

    def same_bits(a, b):
        return torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))

    runs = {"e1": (None, dict(donate=True, parity=True), None),
            "e2": (MESH_LAYERS, dict(donate=False, paged=False),
                   [MS_ONE_RANK])}
    out = {}
    for name, (layers, kw, ranks) in runs.items():
        cfg = _full_width("iterpro-100m", **(
            {} if layers is None else dict(n_layers=layers)))
        if smoke:
            cfg = get_config("iterpro-100m").smoke()

        n_req, n_gen, every = MS_TRAFFIC[name]

        def reqs():
            return make_requests(cfg, n_req, MS_PROMPT, n_gen,
                                 np.random.default_rng(0))
        _build.LAUNCHES.clear()
        sync()
        t0 = time.perf_counter()
        eng = ServingEngine(cfg, ctx=ctx, n_slots=MS_SLOTS,
                            max_len=MS_PROMPT + n_gen + 1,
                            canary_slices=MS_K, max_replays=10**6, seed=0,
                            **kw)
        faults = []

        def spy(report, finite, now, queue, _h=eng.handle_fault):
            victims = _h(report, finite, now, queue)
            faults.append((None if report is None else report.shards,
                           list(victims)))
            return victims
        eng.handle_fault = spy
        if ranks is not None:
            def confined(rng, _f=eng.corrupt_slot, **k):
                return _f(rng, ranks=ranks, **k)
            eng.corrupt_slot = confined
        rng = random.Random(0)
        eng.warm()
        ptrs = [t.data_ptr() for t in (*leaves_of(eng.params),
                                       *leaves_of(eng.blocks))]
        GATHERS.clear()
        rep = eng.run(reqs(), inject_every=every, inject_rng=rng)
        sync()
        r = {"summary": rep.summary(), "secs": time.perf_counter() - t0,
             "faults": faults, "graphs": eng.n_graphs,
             "gathers": dict(GATHERS), "tp": eng.params is eng.blocks,
             "layers": cfg.model.n_layers,
             "logs": {q: w["tokens"] for q, w in rep.per_request.items()}}
        kd.STATS.reset()
        TP.CALLS.clear()
        eng.engine_step()
        r["stats"] = kd.STATS.snapshot()
        r["tp_calls"] = dict(TP.CALLS)
        if kw.get("parity"):
            pst = eng.parity_store
            before = [t.clone() for t in leaves_of(eng.blocks)]
            key, _ = eng.corrupt_param(rng)
            sync()
            t1 = time.perf_counter()
            r["scrub"] = eng.scrub_params()
            sync()
            r["scrub_ms"] = 1e3 * (time.perf_counter() - t1)
            r["healed"] = all(same_bits(a, b) for a, b in
                              zip(leaves_of(eng.blocks), before))
            del before
            sh = dict(zip(pst.plan.keys, pst.plan.leaves(eng._psh)))[key]
            r["expect_moved"] = sh.nbytes_local * len(
                pst.plan.block_devices(key,
                                       pst.plan.device_block[key][
                                           ctx.shard_id]))
            r["flip_key"] = key
        r["ptrs_kept"] = ptrs == [t.data_ptr() for t in (
            *leaves_of(eng.params), *leaves_of(eng.blocks))]
        r["launches"] = dict(_build.LAUNCHES)
        saved = dict(_build.LAUNCHES)
        # what a step's part costs alone: the flag's all-reduce
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        r["allreduce_ms"] = timed(lambda: coll.flag_max(flag, group), 5)
        # the reference tokens: one device, the same params (the blocks
        # gathered once, here, by every rank)
        full = gather_tree(eng.blocks, eng._psh)
        single = None
        if ctx.shard_id == 0:
            one = ServingEngine(
                cfg, device=dev, n_slots=MS_SLOTS,
                max_len=MS_PROMPT + n_gen + 1, canary_slices=0,
                params=full,
                **{k: v for k, v in kw.items() if k in ("donate", "paged")})
            single = {q: w["tokens"] for q, w in
                      one.run(reqs()).per_request.items()}
            del one
        del full
        r["single"] = coll.gather_objects(single, group)[0]
        if name == "e1":
            # the path's kernels against their plain versions, on this
            # rank's own replica, pool and blocks (launches not counted)
            plan = eng.canary.plan
            lay = plan.layout(tuple(range(plan.n_leaves)))
            lv = plan.leaves(eng._view())
            bk = torch.zeros(lay.padded_rows * ck.LANES, dtype=torch.int32,
                             device=dev)
            bp = bk.clone()
            ck.pack_rows(bk, lv, lay.starts)
            ref.pack_rows_ref(bp, lv, lay.starts)
            rows = bk.view(-1, ck.LANES)
            r["pack_err"] = _max_err(torch, bk, bp)
            r["rows_err"] = _max_err(torch, ck.row_checksums(rows),
                                     ref.row_checksums_ref(rows))
            pool = leaves_of(eng.pool)[0]
            tbl = (torch.arange(eng.S * eng.max_blocks, dtype=torch.int32,
                                device=dev) % eng.n_blocks).view(
                eng.S, eng.max_blocks)
            r["gather_err"] = _max_err(
                torch, ref.to_i32(pkv.gather_blocks(pool, tbl)),
                ref.to_i32(ref.gather_blocks_ref(pool, tbl)))
            blk = dict(zip(pst.plan.keys, pst.plan.leaves(eng.blocks)))[key]
            words = ref.to_i32(blk)
            r["tiles_err"] = _max_err(torch, ck.checksum_tiles(words),
                                      ref.checksum_tiles_ref(words))
            pp = pst.plan
            recv = pp.exchange(pp.stream_mat(pp.leaves(eng.blocks)))
            fold = pk.xor_fold_tiles(recv)
            r["fold_err"] = _max_err(torch, fold,
                                     ref.xor_fold_tiles_ref(recv))
            r["fold_is_parity"] = _max_err(torch, fold, pst.parity) == 0
            r["words"] = int(rows.numel())
            del bk, bp, rows, recv, fold
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)
        out[name] = r
        eng.close()
        del eng
        # the mesh's plans go with the runs (14d builds its own)
        kd._PLAN_CACHE.clear()
        cp._PARITY_PLAN_CACHE.clear()
        if device == "cuda":
            _release(torch)
    return out


#: 14f: the MoE mesh schedules at full width, one layer call each:
#: (config, mesh, fsdp, the schedules, capacity factor; 0 = the
#: config's).  kimi's calls run at capacity 8 (nothing drops), so its
#: token-a2a output, whose two capacity stages drop otherwise than the
#: local math, is held against ep_a2a's and one device's
MOE_CALLS = {"grok": ("grok-1-314b", "2,2", True, ("tp_ragged",), 0.0),
             "kimi": ("kimi-k2-1t-a32b", "1,4", False,
                      ("ep_a2a", "ep_token_a2a"), 8.0)}
MOE_TOKENS = 256              # tokens a data row (a batch of 2 x 128)
MOE_SEED = 7


def _moe_mesh_calls(dev, device: str, smoke: bool) -> dict:
    """14f, in a rank, before 14e: each MoE layer of ``MOE_CALLS`` at full
    width (bf16) on a context the four ranks make anew (its own groups),
    the rank building only its blocks of the expert stacks (every matrix
    drawn, so the stream is one device's; ``moe.moe_init(boxes=)``), then
    one ``moe_apply`` per schedule on its data row's ``MOE_TOKENS`` tokens
    (drawn from ``MOE_SEED``): grok-1-314b on 2 x 2 with fsdp
    (``tp_ragged``; the ZeRO gather of its expert blocks over ``data``
    timed alone first), kimi-k2-1t-a32b on 1 x 4 (``ep_a2a`` and
    ``ep_token_a2a``, 96 experts a rank, its shared expert
    tensor-parallel).  When every rank has freed its blocks, shard 0
    builds the whole layer and runs one device's ``_moe_local_math``
    (and shared expert) over each data row's tokens: every rank's output
    and ``lb_loss`` must hold it within the bf16 bound 3e-2 of the
    largest entry.  Returns (on shard 0) what ``check_moe_mesh``
    prints."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import P, LeafSharding
    from repro_torch.launch.mesh import make_context
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.tree import tree_map

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    release = (lambda: _release(torch)) if device == "cuda" else \
        (lambda: None)
    out = {}
    for name, (arch, mesh, fsdp, impls, cf) in MOE_CALLS.items():
        m = (get_config(arch).smoke() if smoke else _full_width(arch)).model
        if cf:
            m = dataclasses.replace(m, moe_capacity=cf)
        ctx = make_context(mesh, dev, fsdp=fsdp)
        world = ctx.group(ctx.axis_names)
        tp = TP.TensorParallel(ctx)

        def timed(fn):
            sync()
            coll.barrier(ctx.device, world)
            t0 = time.perf_counter()
            got = fn()
            sync()
            return got, 1e3 * (time.perf_counter() - t0)

        E, d = m.n_experts, m.d_model
        ff = m.moe_d_ff or m.d_ff
        dt = getattr(torch, m.param_dtype)
        ep = M.use_ep(dataclasses.replace(m, moe_impl=impls[0]), ctx)
        data = "data" if fsdp else None
        specs = {"gate": P(None, "model", data, None) if ep else
                 P(None, None, data, "model"),
                 "down": P(None, "model", None, data) if ep else
                 P(None, None, "model", data)}
        specs["up"] = specs["gate"]
        shapes = {"gate": (1, E, d, ff), "up": (1, E, d, ff),
                  "down": (1, E, ff, d)}
        boxes = {k: LeafSharding(ctx, specs[k], shapes[k], dt).box(
            ctx.shard_id) for k in specs}
        (p, init_ms) = timed(lambda: M.moe_init(
            torch.Generator(device=dev).manual_seed(MOE_SEED), m, dt, dev,
            1, boxes=boxes))
        p = tree_map(lambda t: t[0], p)
        if "shared" in p:           # its columns / rows over the model axis
            fs = p["shared"]["gate"]["w"].shape[1]
            lo, hi = tp.span(fs // tp.size)
            p["shared"] = {"gate": {"w": p["shared"]["gate"]["w"][:, lo:hi]
                                    .contiguous()},
                           "up": {"w": p["shared"]["up"]["w"][:, lo:hi]
                                  .contiguous()},
                           "down": {"w": p["shared"]["down"]["w"][lo:hi]
                                    .contiguous()}}
        block_gb = sum(p[k].numel() * p[k].element_size()
                       for k in specs) / 1e9
        rows = ctx.dp_size
        x_all = torch.randn((rows * MOE_TOKENS, d), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(MOE_SEED + 1)).to(dt)
        row = ctx.coords(ctx.shard_id).get("data", 0)
        x = x_all[row * MOE_TOKENS:(row + 1) * MOE_TOKENS]
        r = {"mesh": mesh, "E_local": int(p["gate"].shape[0]),
             "block_gb": block_gb, "init_ms": init_ms, "calls": {}}
        if fsdp:
            # the ZeRO-3 gather of the layer's expert blocks over data,
            # alone; the schedule then finds them whole
            (g, u, dn), r["gather_ms"] = timed(lambda: (
                M._zero_gather(p["gate"], 1, ctx),
                M._zero_gather(p["up"], 1, ctx),
                M._zero_gather(p["down"], 2, ctx)))
            r["gather_gb"] = block_gb * (ctx.dp_size - 1)
            p.update(gate=g, up=u, down=dn)
            del g, u, dn
        ys = {}
        for impl in impls:
            c = dataclasses.replace(m, moe_impl=impl)
            TP.CALLS.clear()
            with torch.no_grad():
                (y, aux), ms = timed(lambda: M.moe_apply(p, c, x[None],
                                                         tp=tp))
            ys[impl] = y[0].float().cpu()
            r["calls"][impl] = {"ms": ms, "lb": float(aux["lb_loss"]),
                                "collectives": dict(TP.CALLS)}
        del p, y
        release()
        mine = coll.gather_objects((row, ys, {k: v["lb"] for k, v in
                                              r["calls"].items()}), world)
        if ctx.shard_id == 0:
            # one device, the whole layer, after the ranks freed theirs
            full = tree_map(lambda t: t[0], M.moe_init(
                torch.Generator(device=dev).manual_seed(MOE_SEED), m, dt,
                dev, 1))
            for impl in impls:
                c = dataclasses.replace(m, moe_impl=impl)
                worst, lbw, peer = 0.0, 0.0, 0.0
                with torch.no_grad():
                    want = {}
                    for q in range(rows):
                        xq = x_all[q * MOE_TOKENS:(q + 1) * MOE_TOKENS]
                        y1, a1 = M._moe_local_math(xq, full, c)
                        if "shared" in full:
                            y1 = y1 + L.mlp_apply(full["shared"], xq)
                        lb = a1["lb_loss"]
                        if impl == "ep_token_a2a":
                            lb = sum(M._moe_local_math(h, full, c)[1][
                                "lb_loss"] for h in xq.chunk(tp.size)) \
                                / tp.size
                        want[q] = (y1.float().cpu(), float(lb))
                lbs = [sum(want[q][1] for q in range(rows)) / rows]
                for q, got, lbg in mine:
                    y1 = want[q][0]
                    scale = float(y1.abs().max())
                    worst = max(worst, float((got[impl] - y1).abs().max())
                                / scale)
                    lbw = max(lbw, abs(lbg[impl] - lbs[0]))
                    if impl != impls[0]:
                        peer = max(peer, float(
                            (got[impl] - got[impls[0]]).abs().max())
                            / scale)
                r["calls"][impl].update(err=worst, lb_err=lbw,
                                        vs_first=peer)
            del full
            release()
        coll.barrier(ctx.device, world)
        out[name] = r
    return out


def check_moe_mesh(ranks, device: str) -> None:
    """14f's asserts and ``[mesh-moe]`` lines (shard 0 held every rank's
    output against one device's)."""
    first = ranks[0]["moe"]
    for name, r in first.items():
        arch, mesh, fsdp, impls, cf = MOE_CALLS[name]
        for impl in impls:
            c = r["calls"][impl]
            assert c["err"] <= 3e-2 and c["lb_err"] <= 3e-2, (name, impl, c)
            assert c["vs_first"] <= 3e-2, (name, impl, c)
        gather = (f"; the ZeRO gather of its expert blocks over data alone "
                  f"{r['gather_ms']:.1f} ms ({r['gather_gb']:.2f} GB a rank "
                  f"received)" if fsdp else "")
        calls = "; ".join(
            f"{i}: {c['ms']:.1f} ms, |y - one device| / max "
            f"{c['err']:.2e}, lb_loss off by {c['lb_err']:.2e}"
            + (f", vs {impls[0]} {c['vs_first']:.2e}" if i != impls[0]
               else "") + f", collectives {c['collectives']}"
            for i, c in r["calls"].items())
        print(f"[mesh-moe] {arch} MoE layer (bf16) on {mesh} "
              f"({'fsdp, ' if fsdp else ''}capacity "
              f"{cf or 'of the config'}), {MOE_TOKENS} tokens a data row: "
              f"{r['E_local']} experts a rank, {r['block_gb']:.2f} GB of "
              f"expert blocks a rank built in {r['init_ms']:.0f} ms{gather};"
              f" {calls} [{_SMI}]")


#: 14g: the ssm, hybrid, encdec and vlm families, tensor-parallel, at
#: full width (bf16, seed 0), each at the smallest depth that holds every
#: kind of block it has: (config, the model's fields changed; the smoke
#: dry run's pattern fields)
MF_CONFIGS = {
    "xlstm": ("xlstm-350m", dict(n_layers=8), dict(mlstm_ratio=1)),
    "zamba2": ("zamba2-7b", dict(n_layers=6), dict(hybrid_ratio=1)),
    "seamless": ("seamless-m4t-large-v2", dict(n_layers=1, n_enc_layers=1),
                 {}),
    "qwen2-vl": ("qwen2-vl-7b", dict(n_layers=1), {})}
MF_BATCH, MF_SEQ, MF_STEPS = 4, 32, 2   # 14g's training: 2 steps a run
MF_PROMPT, MF_GEN, MF_SLOTS, MF_K = 32, 4, 4, 4
MF_FLIP_EVERY = 8             # one flip in the serving storm's 16 tokens
MF_IMAGE = 8                  # a VLM request's 8 x 8 patch image
MF_PARITY = "xlstm"           # its serving run keeps the params' parity


def _mf_requests(cfg, base: int):
    """14g's serving requests (rids from ``base``): ``MF_SLOTS`` prompts
    of ``MF_PROMPT`` tokens; an enc-dec request's source of max_len
    frames (``make_requests``), a VLM request's 8 x 8 image of patches at
    (t, h, w) = (0, row, col) and its text from ``MF_IMAGE`` on all three
    streams."""
    import numpy as np
    from repro_torch.launch.serve import make_requests
    rng = np.random.default_rng(0)
    reqs = make_requests(cfg, MF_SLOTS, MF_PROMPT, MF_GEN, rng)
    m = cfg.model
    for rq in reqs:
        rq.rid += base
        if m.patch_dim:
            n = MF_IMAGE * MF_IMAGE
            pos = np.zeros((1, n + MF_PROMPT, 3), np.int32)
            pos[0, :n, 1] = np.arange(n) // MF_IMAGE
            pos[0, :n, 2] = np.arange(n) % MF_IMAGE
            pos[0, n:, :] = (MF_IMAGE + np.arange(MF_PROMPT))[:, None]
            rq.features = {"patch_embeds": rng.standard_normal(
                (1, n, m.patch_dim), dtype=np.float32), "positions": pos}
    return reqs


def _mf_max_len(cfg) -> int:
    rows = MF_PROMPT + MF_GEN + 1
    return rows + MF_IMAGE * MF_IMAGE if cfg.model.patch_dim else rows


def _peers_bits(torch, ctx, tensors) -> bool:
    """The tensors hold the same bits on every model-axis peer
    (collective: their bytes gathered over the model axis)."""
    from repro_torch.distributed import collectives as coll
    if not tensors:
        return True
    mine = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    rows = coll.all_gather(mine, ctx.group(ctx.model_axis))
    return all(torch.equal(rows[0], r) for r in rows[1:])


def _mesh_families(dev, device: str, smoke: bool) -> dict:
    """14g, in a rank, after 14e and before 14d: each family of
    ``MF_CONFIGS`` on the 2 x 2 mesh, tensor-parallel from the rank's
    blocks in place.  Training (``train(mesh=...)``, ``MF_STEPS`` steps
    of ``MF_BATCH`` x ``MF_SEQ``, donated, K=``MF_K``, a snapshot every
    2): clean, then a params flip every step in the slice its step
    checks, whose final state must be the clean run's bits; the
    ``gather_tree`` calls of the runs (the fsdp leaves' over ``data``
    only), the model axis's collectives and bytes, and the leaves
    replicated over the model axis bitwise on the peers.  Serving
    (dense, donated, K=4, ``MF_SLOTS`` slots, prompts of ``MF_PROMPT``,
    ``MF_GEN`` new tokens; xlstm with ``parity``): a clean run, then the
    same requests with one flip in a slot (at ``MF_FLIP_EVERY`` tokens),
    whose tokens must be the clean run's; the recurrent and cross caches
    bitwise on the peers; a steady step's STATS, collectives and bytes;
    decode p50 / p99; for xlstm ``corrupt_param`` + ``scrub_params``.
    Then the mesh's first loss (batch 0, the data rows' mean) and first
    decode logits (request 0: its prefill's argmax decoded; in bf16, and
    in f32 from the same blocks cast), the model's own functions on the
    blocks; when every rank has freed its blocks, shard 0 builds the
    whole model (the same seed) and computes them on one device.
    Returns what ``check_mesh_families`` asserts and prints."""
    import random
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import parity as cp
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import GATHERS
    from repro_torch.kernels import _build
    from repro_torch.kernels import digest as kd
    from repro_torch.launch.mesh import make_context
    from repro_torch.launch.specs import state_shardings
    from repro_torch.launch.train import batch_for, train
    from repro_torch.models.registry import get_model
    from repro_torch.serving import ServingEngine
    from repro_torch.train.loop import make_train_state
    from repro_torch.tree import leaves as leaves_of
    from repro_torch.tree import tree_map

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    release = (lambda: _release(torch)) if device == "cuda" else \
        (lambda: None)
    out = {}
    for name, (arch, full_kw, smoke_kw) in MF_CONFIGS.items():
        if smoke:
            cfg = get_config(arch).smoke()
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, **smoke_kw))
        else:
            cfg = _full_width(arch, **full_kw)
        # the config's microbatch slices a data row's 2 sequences no
        # further (the cut is listed in PERF.md)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, microbatch=0))
        m = cfg.model
        model = get_model(m)
        ctx = make_context(MESH, dev, fsdp=cfg.sharding.fsdp)
        world = ctx.group(ctx.axis_names)
        release()
        r = {"layers": m.n_layers, "secs": {}, "launches": {},
             "free_gib": torch.cuda.mem_get_info()[0] / 2**30
             if device == "cuda" else 0.0}
        # donated (one state version) at K=MF_K (a ring of 1.25x the
        # rank's state, not K=1's 2x): four ranks share the card's 80 GB
        common = dict(steps=MF_STEPS, global_batch=MF_BATCH,
                      seq_len=MF_SEQ, canary_slices=MF_K,
                      snapshot_interval=2, donate=True, mesh=MESH,
                      device=device, verbose=False, return_state=True)
        runs = {}
        for run, kw in (("clean", {}), ("params", dict(
                inject_every=1, inject_armed_only=True))):
            _build.LAUNCHES.clear()
            GATHERS.clear()
            TP.CALLS.clear()
            TP.BYTES.clear()
            sync()
            t0 = time.perf_counter()
            out_, st = train(cfg, **{**common, **kw})
            sync()
            # the clean blocks wait on the host; the storm's are compared
            # on the card (``_same_state`` copies a leaf at a time)
            runs[run] = (out_, tree_map(lambda t: t.cpu(), st)
                         if run == "clean" else st)
            del st
            kd._PLAN_CACHE.clear()
            release()
            r["secs"]["train " + run] = time.perf_counter() - t0
            r["launches"]["train " + run] = dict(_build.LAUNCHES)
            r.setdefault("gathers", {})[run] = dict(GATHERS)
            if run == "clean":
                r["train_calls"] = dict(TP.CALLS)
                r["train_bytes"] = dict(TP.BYTES)
        r["train"] = {n: v[0] for n, v in runs.items()}
        r["same"] = _same_state(torch, runs["params"][1], runs["clean"][1])
        sh, _ = state_shardings(ctx, cfg, make_train_state(
            cfg, 0, global_batch=MF_BATCH, device="meta"))
        local = runs["params"][1]
        r["peers"] = _peers_bits(torch, ctx, [
            t for t, s in zip(leaves_of(local), leaves_of(sh))
            if ctx.model_axis not in s.axes])
        del runs, local
        kd._PLAN_CACHE.clear()
        cp._PARITY_PLAN_CACHE.clear()
        release()

        # serving: clean, then the same requests with one flip
        _build.LAUNCHES.clear()
        sync()
        t0 = time.perf_counter()
        eng = ServingEngine(cfg, ctx=ctx, n_slots=MF_SLOTS,
                            max_len=_mf_max_len(cfg), canary_slices=MF_K,
                            donate=True, seed=0, max_replays=10**6,
                            parity=name == MF_PARITY)
        eng.warm()
        r["secs"]["serve build + warm"] = time.perf_counter() - t0
        GATHERS.clear()
        logs = {}
        for run, every in (("clean", 0), ("storm", MF_FLIP_EVERY)):
            base = 0 if run == "clean" else 100
            n0 = len(eng.report.decode_ms)
            t0 = time.perf_counter()
            rep = eng.run(_mf_requests(cfg, base), inject_every=every,
                          inject_rng=random.Random(0))
            sync()
            r["secs"]["serve " + run] = time.perf_counter() - t0
            logs[run] = {q - base: w["tokens"] for q, w in
                         rep.per_request.items() if q >= base
                         and (run == "storm" or q < 100)}
            if run == "clean":
                ms = rep.decode_ms[n0:]
                r["decode_ms"] = (float(np.percentile(ms, 50)),
                                  float(np.percentile(ms, 99)))
        r["serve_logs"] = logs
        r["serve_summary"] = eng.report.summary()
        r["serve_gathers"] = dict(GATHERS)
        r["tp"] = eng.params is eng.blocks
        r["graphs"] = eng.n_graphs
        r["cache_peers"] = _peers_bits(torch, ctx, leaves_of(eng.cache))
        kd.STATS.reset()
        TP.CALLS.clear()
        TP.BYTES.clear()
        eng.engine_step()
        sync()
        r["stats"] = kd.STATS.snapshot()
        r["step_calls"] = dict(TP.CALLS)
        r["step_bytes"] = dict(TP.BYTES)
        if eng.parity_store is not None:
            rng = random.Random(1)
            before = [t.clone() for t in leaves_of(eng.blocks)]
            r["flip"] = eng.corrupt_param(rng)
            r["scrub"] = eng.scrub_params()
            r["healed"] = all(torch.equal(a.reshape(-1).view(torch.uint8),
                                          b.reshape(-1).view(torch.uint8))
                              for a, b in zip(leaves_of(eng.blocks),
                                              before))
            del before
        r["launches"]["serve"] = dict(_build.LAUNCHES)

        # the mesh's first loss and first decode logits, from the blocks
        pipe = TokenPipeline(m.vocab_size, MF_SEQ, MF_BATCH, seed=0)
        batch0 = batch_for(cfg, pipe, 0)
        rows = MF_BATCH // ctx.dp_size
        row = ctx.coords(ctx.shard_id).get("data", 0)
        mine = {k: v[row * rows:(row + 1) * rows].to(dev)
                for k, v in batch0.items()}
        rq = _mf_requests(cfg, 0)[0]
        rqb = {k: torch.as_tensor(v).to(dev) for k, v in
               rq.features.items()}
        rqb["tokens"] = torch.as_tensor(rq.prompt[None]).to(dev)
        m32 = dataclasses.replace(m, param_dtype="float32",
                                  compute_dtype="float32")

        def first_logits(params, mc, tp=None, tok=None):
            """Request 0's prefill, then one decode of ``tok`` (default:
            the prefill's argmax): (token, logits on the host)."""
            lg, cache = model.prefill(params, mc, rqb,
                                      max_len=_mf_max_len(cfg), tp=tp)
            if tok is None:
                tok = lg.argmax(-1).to(torch.int32)
            dl = model.decode_step(params, mc, cache, tok, tp=tp)[0]
            return tok, dl[0].float().cpu()

        with torch.no_grad():
            read = eng._read()
            loss = model.train_loss(read, m, mine, remat=False,
                                    tp=eng._tp)[0]
            tok, dl = first_logits(read, m, eng._tp)
            # the same blocks in f32: the parallel compute without bf16's
            # rounding (one device's bf16 decode of a deep recurrent
            # model lies far from its own f32 one)
            read32 = tree_map(lambda t: t.float(), read)
            _, dl32 = first_logits(read32, m32, eng._tp, tok)
            mesh_out = (row, float(loss), int(tok[0]), dl, dl32)
            del read, read32
        eng.close()
        del eng
        kd._PLAN_CACHE.clear()
        cp._PARITY_PLAN_CACHE.clear()
        release()
        got = coll.gather_objects((mesh_out, r["train_calls"],
                                   r["serve_logs"]), world)
        r["calls_alike"] = all(g[1] == got[0][1] for g in got)
        if ctx.shard_id == 0:
            # one device, the whole model, after the ranks freed theirs
            full = model.init(m, 0, dev)
            with torch.no_grad():
                batch = {k: v.to(dev) for k, v in batch0.items()}
                one_loss = float(model.train_loss(full, m, batch,
                                                  remat=False)[0])
                tok = torch.tensor([got[0][0][2]], dtype=torch.int32,
                                   device=dev)
                _, want = first_logits(full, m, tok=tok)
                full = tree_map(lambda t: t.float(), full)
                _, want32 = first_logits(full, m32, tok=tok)
            losses = {}
            for g in got:
                losses.setdefault(g[0][0], g[0][1])
            mesh_loss = sum(losses[k] for k in sorted(losses)) / len(losses)
            scale = float(want32.abs().max())
            r["vs_one"] = {
                "loss": abs(mesh_loss - one_loss) / abs(one_loss),
                "logits": max(float((g[0][3] - want).abs().max())
                              for g in got) / scale,
                "logits_f32": max(float((g[0][4] - want32).abs().max())
                                  for g in got) / scale,
                "bf16_vs_f32": float((want - want32).abs().max()) / scale,
                "mesh_loss": mesh_loss, "one_loss": one_loss}
            del full
            release()
        coll.barrier(ctx.device, world)
        out[name] = r
    return out


def check_mesh_families(ranks, device: str) -> None:
    """14g's asserts and ``[mesh-fam]`` lines: per family, on every
    rank, the params storm's final state the clean run's bits, no
    ``gather_tree`` but the fsdp leaves' over ``data``, the model-axis
    collectives alike on every rank, the replicated leaves and the caches
    bitwise on the peers, the serving storm's tokens the clean run's with
    detected == injected == recovered, a steady step 1 launch + 1 fetch,
    the kernels of the path launched on the card; on shard 0 the mesh's
    first loss within 3e-2 of one device's, its first decode logits in
    f32 within 1e-3 and in bf16 within 3e-2 or within one device's own
    bf16-to-f32 distance (a deep recurrent model's bf16 logits part from
    its f32 ones by more than 3e-2 on one device already)."""
    for name, (arch, _, _) in MF_CONFIGS.items():
        first = ranks[0]["families"][name]
        _print_family(arch, first)
        for rr in ranks:
            r = rr["families"][name]
            tf = r["train"]["params"]
            assert tf["faults_injected"] > 0, (name, tf)
            assert tf["faults_detected"] == tf["faults_injected"] == \
                tf["faults_recovered"], (name, tf)
            assert r["same"], f"14g {name}: storm != clean on rank " \
                              f"{rr['shard']}"
            for g in (*r["gathers"].values(), r["serve_gathers"]):
                assert set(g) <= {"data"}, (name, r["gathers"])
            assert r["calls_alike"] and r["peers"], name
            assert r["tp"] and r["cache_peers"], name
            sm = r["serve_summary"]
            f = sm["faults"]
            assert f["injected"] == f["detected"] == f["recovered"] == 1, \
                (name, f)
            assert sm["dropped"] == 0, (name, sm)
            assert r["serve_logs"]["storm"] == r["serve_logs"]["clean"] \
                == first["serve_logs"]["clean"], name
            assert tuple(r["stats"]) == (1, 1), (name, r["stats"])
            if "scrub" in r:
                assert r["scrub"]["repaired"] == 1 and r["healed"], \
                    (name, r["scrub"])
            lc = _launch_total(r)
            if device == "cuda":
                assert lc.get("pack_rows", 0) > 0 and \
                    lc.get("row_checksums", 0) > 0, (name, lc)
                if "scrub" in r:
                    assert lc.get("checksum_tiles", 0) > 0 and \
                        lc.get("xor_fold_tiles", 0) > 0, (name, lc)
        vs = first["vs_one"]
        # the mesh's bf16 logits: within 3e-2 of one device's, or no
        # further from them than one device's bf16 logits are from its
        # own f32 ones; in f32 within 1e-3 (the parallel compute itself)
        assert vs["loss"] <= 3e-2 and vs["logits_f32"] <= 1e-3, (name, vs)
        assert vs["logits"] <= max(3e-2, vs["bf16_vs_f32"]), (name, vs)


def _launch_total(r) -> dict:
    lc = {}
    for v in r["launches"].values():
        for k, n in v.items():
            lc[k] = lc.get(k, 0) + n
    return lc


def _print_family(arch, r) -> None:
    """A ``[mesh-fam]`` line: shard 0's numbers of one 14g config."""
    vs = r["vs_one"]
    step_b = sum(r["step_bytes"].values())
    print(f"[mesh-fam] {arch} ({r['layers']} layers, full width, bf16) "
          f"on 2 x 2, tensor-parallel: train {MF_STEPS} steps of "
          f"{MF_BATCH} x {MF_SEQ} donated, K={MF_K}, clean / params storm "
          f"{r['secs']['train clean']:.1f} / "
          f"{r['secs']['train params']:.1f} s (host p50 "
          f"{r['train']['clean']['p50_step_ms']:.1f} ms a step; storm "
          f"{r['train']['params']['faults_injected']} flips, rungs "
          f"{r['train']['params']['recovery']['by_rung']}; same "
          f"{r['same']}), gathers {r['gathers']}, model-axis collectives "
          f"a run {r['train_calls']} ({sum(r['train_bytes'].values())} B "
          f"a rank received); serving: decode p50 {r['decode_ms'][0]:.1f}"
          f" / p99 {r['decode_ms'][1]:.1f} ms, a steady step's model-axis "
          f"collectives {r['step_calls']} ({step_b} B a rank received), "
          f"STATS {r['stats']}, {r['graphs']} graphs, faults "
          f"{r['serve_summary']['faults']}, tokens == clean "
          f"{r['serve_logs']['storm'] == r['serve_logs']['clean']}, "
          f"caches on the peers {r['cache_peers']}"
          + (f", scrub {r['scrub']}" if "scrub" in r else "")
          + f"; first loss {vs['mesh_loss']:.5f} vs one device "
          f"{vs['one_loss']:.5f} (rel {vs['loss']:.2e}), first decode "
          f"logits |mesh - one| / max: bf16 {vs['logits']:.2e} (one "
          f"device's bf16 vs its f32 {vs['bf16_vs_f32']:.2e}), f32 "
          f"{vs['logits_f32']:.2e}; launches rank 0 {_launch_total(r)}; "
          f"the card {r['free_gib']:.2f} GiB free at the start; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in r["secs"].items())
          + f" [{_SMI}]")


def _elastic_drill(seq: int, dev, device: str, smoke: bool) -> dict:
    """14d, in a rank, last of phase 14 (a rank of the lost row leaves):
    iterpro-100m at full width and depth with ``fsdp`` (the row-safe
    parity then covers the data-sharded leaves), ``train(parity,
    elastic, kill_row_at=2, donate, fused_detect)``, 4 steps at K=1.
    At the kill point every rank gathers the whole state (the drill's
    oracle: the only read of the dead row's blocks, kept away from the
    recovery), then the dead row's ranks overwrite their blocks with
    ``ELASTIC_POISON`` and return.  A survivor checks its resumed blocks
    against the oracle's, its losses and final blocks against a clean
    functional run on the 1 x 2 mesh from the oracle, and counts the
    path's kernel launches; a dead rank counts its launches after the
    loss (0)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import gather_tree, local_tree
    from repro_torch.kernels import _build
    from repro_torch.launch.specs import bind_state
    from repro_torch.launch.train import batch_for, cuda_numerics, train
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import leaves as leaves_of

    cfg = get_config("iterpro-100m")
    if smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, fsdp=True))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    box = {}

    def on_kill(ctx, state, sh, rows):
        box.update(ctx=ctx, rows=rows, oracle=gather_tree(state, sh))
        if ctx.coords(ctx.shard_id)[ctx.data_axis] in rows:
            for t in leaves_of(state):
                t.reshape(-1).view(torch.uint8).fill_(ELASTIC_POISON)
            del box["oracle"]              # a dead rank keeps nothing
            sync()
            box["at_kill"] = dict(_build.LAUNCHES)
        return on_resume

    def on_resume(ctx, state, sh):
        box["resumed_same"] = _same_state(torch, state,
                                          local_tree(box["oracle"], sh))

    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    summary, st = train(cfg, steps=ELASTIC_STEPS, global_batch=T_BATCH,
                        seq_len=seq, canary_slices=1, snapshot_interval=2,
                        mesh=MESH, device=device, verbose=False,
                        return_state=True, parity=True, elastic=True,
                        kill_row_at=ELASTIC_KILL, donate=True,
                        fused_detect=True, on_kill=on_kill)
    sync()
    out = {"secs": time.perf_counter() - t0, "summary": summary,
           "launches": dict(_build.LAUNCHES)}
    if summary.get("dead"):
        out["after_kill"] = {k: v - box["at_kill"].get(k, 0)
                             for k, v in out["launches"].items()
                             if v != box["at_kill"].get(k, 0)}
        return out
    out["resumed_same"] = box["resumed_same"]
    dctx = box["ctx"].degrade(box["rows"])
    pipe = TokenPipeline(cfg.model.vocab_size, seq, T_BATCH, seed=0)
    with cuda_numerics(dev):
        clean, step, bfn, _ = bind_state(
            dctx, cfg, box.pop("oracle"),
            make_train_step(cfg, global_batch=T_BATCH),
            lambda s: batch_for(cfg, pipe, s))
        losses = []
        for s in range(ELASTIC_KILL, ELASTIC_STEPS):
            clean, m = step(clean, bfn(s))
            losses.append(float(m["loss"]))
    out["clean_losses"] = losses
    out["same"] = _same_state(torch, st, clean)
    return out


def _mesh_rank(steps: int, work: str, device: str = "cuda",
               smoke: bool = False) -> dict:
    """One rank of phase 14, a spawned process on ``cuda:0`` beside the
    other three: at ``MESH_LAYERS`` of iterpro-100m's 12 layers, four
    runs of ``train(mesh=...)`` (clean; a params flip every step: the odd
    steps have no version-matched snapshot and replay, the even ones take
    shard_patch; an iv storm, with a disk checkpoint at step 0; 14b's
    modes) and 14c's placed flips (``_mesh_pair_rungs``) with the launch
    counts of their kernels, then this rank's ``pack_rows`` and
    ``row_checksums`` against their plain versions on its own blocks and
    one steady check's STATS; then 14e, the serving engine on the mesh
    (``_mesh_serve``); last, 14d at all 12 layers (``_elastic_drill``),
    after which the ranks of the lost row are out.
    ``device="cpu"`` and ``smoke`` dry-run it on the CPU at the smoke
    size."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.kernels import _build
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import digest as kd
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_context
    from repro_torch.launch.specs import state_shardings
    from repro_torch.launch.train import train
    from repro_torch.train.loop import make_train_state
    from repro_torch.tree import flatten_with_path, leaf_key
    from repro_torch.tree import leaves as leaves_of

    entered = time.time()
    cfg = _full_width("iterpro-100m", n_layers=MESH_LAYERS)
    seq = T_SEQ
    if smoke:
        cfg, seq = get_config("iterpro-100m").smoke(), 32
    common = dict(steps=steps, global_batch=T_BATCH, seq_len=seq,
                  canary_slices=1, snapshot_interval=2, mesh=MESH,
                  device=device, verbose=False, return_state=True)
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    fused = dict(donate=True, fused_detect=True, canary_slices=MESH_K)
    plans = {"clean": {}, "params": dict(inject_every=1),
             "iv": dict(inject_every=2, inject_target="iv",
                        checkpoint_dir=work, checkpoint_interval=2 * steps),
             # 14b (and the checks of the clean fused run 14a was, and
             # of 14c's run through the entry point: triage in the
             # composition): the flip lands in the slice checked at its
             # step (one flip, at step 2: the time cut)
             "donate+fused+parity storm": dict(
                 fused, parity=True, triage=True, inject_every=2,
                 inject_armed_only=True)}
    sync()
    runs, secs, by_run = {}, {}, {}
    for name, kw in plans.items():
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        runs[name] = train(cfg, **{**common, **kw})
        sync()
        secs[name] = time.perf_counter() - t0
        by_run[name] = dict(_build.LAUNCHES)
    summaries = {n: r[0] for n, r in runs.items()}
    clean = runs["clean"][1]
    same = {name: _same_state(torch, clean, st)
            for name, (_, st) in runs.items() if name != "clean"}
    del runs
    # 14c's placed flips: the donated pair with triage and the mesh
    # parity, driven by hand
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    pair = _mesh_pair_rungs(cfg, seq, dev)
    sync()
    secs["donate+triage+parity flips"] = time.perf_counter() - t0
    by_run["donate+triage+parity flips"] = dict(_build.LAUNCHES)
    launches = {}
    for lc in by_run.values():
        for k, v in lc.items():
            launches[k] = launches.get(k, 0) + v

    # the clean run's final state: this rank's blocks
    local = clean
    ctx = make_context(MESH, dev)
    shardings, _ = state_shardings(ctx, cfg, make_train_state(
        cfg, 0, global_batch=T_BATCH, device="meta"))
    nbytes = {leaf_key(p): sh.nbytes_local
              for p, sh in flatten_with_path(shardings)}
    patches = summaries["params"]["recovery"]["shard_patches"]
    patch_exact = bool(patches) and all(
        e["bytes_moved"] == sum(nbytes[k] * len(ids)
                                for k, ids in e["shards"].items())
        for e in patches)
    plan = kd.sharded_plan_for(local, ctx)
    lay = plan.layout(tuple(range(plan.n_leaves)))
    leaves = plan.leaves(local)
    bk = torch.zeros(lay.padded_rows * ck.LANES, dtype=torch.int32,
                     device=dev)
    bp = bk.clone()
    ck.pack_rows(bk, leaves, lay.starts)
    ref.pack_rows_ref(bp, leaves, lay.starts)
    rows = bk.view(-1, ck.LANES)
    kernels = {"words": int(rows.numel()),
               "pack_err": _max_err(torch, bk, bp),
               "rows_err": _max_err(torch, ck.row_checksums(rows),
                                    ref.row_checksums_ref(rows))}
    canary = ChecksumCanary(local, n_slices=1, ctx=ctx)
    kd.STATS.reset()
    steady = canary.check_and_arm(0, local, local) is None
    stats = kd.STATS.snapshot()
    del canary, plan, bk, bp, rows

    # where a mesh step's time goes: its three parts, each timed alone
    # (host clock, synchronised; every rank in lockstep): the forward and
    # backward with the model axis's collectives (tensor-parallel: no
    # params gather), the grads' exchange, the norm's all-gather
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import GATHERS, gather_tree
    from repro_torch.train.loop import make_train_step
    pipe = TokenPipeline(cfg.model.vocab_size, seq, T_BATCH, seed=0)
    rows_of = pipe.batch_at(0)["tokens"].shape[0] // ctx.dp_size
    lo = (ctx.shard_id // ctx.tp_size) * rows_of
    batch = {k: v[lo:lo + rows_of].to(ctx.device)
             for k, v in pipe.batch_at(0).items()}
    raw = make_train_step(cfg, global_batch=T_BATCH)

    def timed(fn):
        sync()
        coll.barrier(ctx.device, ctx.group(ctx.axis_names))
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, 1e3 * (time.perf_counter() - t0)

    tp = TP.for_model(ctx, cfg.model)
    GATHERS.clear()
    read = gather_tree(local["params"], shardings["params"],
                       axes=ctx.batch_axes)
    no_gather = not GATHERS         # no fsdp leaf: the blocks themselves
    TP.CALLS.clear()
    (_, _, grads), grad_ms = timed(lambda: raw.loss_and_grads(read, batch,
                                                              tp=tp))
    tp_calls = dict(TP.CALLS)
    flat = torch.cat([g.reshape(-1) for g in leaves_of(grads)])
    # the same bytes cross as in the step: each peer's half of the grads
    _, mean_ms = timed(lambda: coll.sum_rows(coll.all_to_all(
        flat, ctx.group(ctx.batch_axes))))
    sums = torch.stack([torch.sum(torch.square(g.float()))
                        for g in leaves_of(grads)])
    _, norm_ms = timed(lambda: coll.all_gather(sums, ctx.group(
        ctx.axis_names)))
    del read, grads, flat, local, clean, sums
    # 14f: the MoE mesh schedules at full width, one layer call each
    t0 = time.perf_counter()
    moe = _moe_mesh_calls(dev, device, smoke)
    secs["14f"] = time.perf_counter() - t0
    # 14e: the serving engine on the mesh (before 14d: after it only the
    # surviving row's two ranks are left)
    t0 = time.perf_counter()
    serving = _mesh_serve(dev, device, smoke)
    secs["14e"] = time.perf_counter() - t0
    # 14g: the ssm, hybrid, encdec and vlm families on the mesh
    t0 = time.perf_counter()
    families = _mesh_families(dev, device, smoke)
    secs["14g"] = time.perf_counter() - t0
    # 14d, last: the ranks of the lost row leave
    elastic = _elastic_drill(seq, dev, device, smoke)
    return {"elastic": elastic, "serving": serving, "moe": moe,
        "families": families,
        "tp_calls": tp_calls, "no_gather": no_gather,
        "shard": ctx.shard_id, "device": str(ctx.device),
        "name": torch.cuda.get_device_name(ctx.device)
        if device == "cuda" else "cpu",
        "launches": launches, "by_run": by_run, "secs": secs,
        "same": same, "pair": pair,
        "summaries": summaries, "entered": entered,
        "patch_exact": patch_exact,
        "local_bytes": sum(nbytes.values()), **kernels,
        "steady": steady, "stats": stats,
        "parts_ms": {"forward+backward (model-axis sums)": grad_ms,
                     "grads' exchange": mean_ms, "norm": norm_ms},
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30
        if device == "cuda" else 0.0}


def check_mesh_serve(ranks, device: str) -> None:
    """14e's asserts and ``[mesh-serve]`` lines: in both runs every rank's
    logs == the single-device engine's (storm == clean), detected ==
    injected == recovered, nothing dropped, every rank the same faults
    and victims, a steady step 1 launch + 1 fetch, 2K graphs a rank with
    every pointer kept; (e1) the scrub repairs one leaf in place, moving
    its block once per holder, the blocks back to their bits, and the
    path's five kernels launched on every rank and bitwise their plain
    versions on the rank's data; (e2) every report names shard
    ``MS_ONE_RANK`` alone.  Tensor-parallel: no params gather in the run,
    two graphs a rotation and read table (4K a rank), the model axis's
    collectives a steady step printed."""
    for name in ("e1", "e2"):
        first = ranks[0]["serving"][name]
        for r in ranks:
            e = r["serving"][name]
            sm, f = e["summary"], e["summary"]["faults"]
            assert e["logs"] == first["single"], (name, r["shard"])
            n_req, n_gen, every = MS_TRAFFIC[name]
            assert sm["completed"] == n_req and sm["dropped"] == 0, sm
            assert f["injected"] > 0, (name, f)
            assert f["detected"] == f["injected"] == f["recovered"], f
            assert e["faults"] == first["faults"], (name, r["shard"])
            assert tuple(e["stats"]) == (1, 1), (name, e["stats"])
            assert e["ptrs_kept"], (name, r["shard"])
            assert e["tp"] and e["gathers"] == {}, (name, e["gathers"])
            assert e["tp_calls"].get("reduce_sum", 0) > 0, e["tp_calls"]
            lc = e["launches"]
            if device == "cuda":
                assert e["graphs"] == 4 * MS_K, (name, e["graphs"])
                for k in ("pack_rows", "row_checksums"):
                    assert lc.get(k, 0) > 0, (name, k, lc)
            extra = ""
            if name == "e1":
                sc = e["scrub"]
                assert sc["repaired"] == 1 and sc["failed"] == [], sc
                assert sc["bytes_moved"] == e["expect_moved"], sc
                assert sc == first["scrub"], (sc, first["scrub"])
                assert e["healed"] and e["fold_is_parity"], r["shard"]
                for k in ("pack_err", "rows_err", "gather_err",
                          "tiles_err", "fold_err"):
                    assert e[k] == 0, (k, e[k])
                if device == "cuda":
                    for k in ("gather_blocks", "checksum_tiles",
                              "xor_fold_tiles"):
                        assert lc.get(k, 0) > 0, (k, lc)
                extra = (f"; scrub of a flip in {e['flip_key']}: "
                         f"checked {sc['checked']}, repaired "
                         f"{sc['repaired']}, {sc['bytes_moved']} B moved "
                         f"(the block x its holders), parity "
                         f"{sc['memory_bytes']} B, {e['scrub_ms']:.1f} ms, "
                         f"blocks == their bits before the flip; "
                         f"pack_rows, row_checksums ({e['words']} words), "
                         f"gather_blocks, checksum_tiles, xor_fold_tiles "
                         f"bitwise their plain versions on the rank's data")
            else:
                for shards, victims in e["faults"]:
                    assert shards and victims, e["faults"]
                    assert all(v == [MS_ONE_RANK] for v in
                               shards.values()), shards
                extra = (f"; every report names shard {MS_ONE_RANK} "
                         f"alone, every rank evicts the same slots")
            print(f"[mesh-serve] rank {r['shard']} ({name}): iterpro-100m "
                  f"({e['layers']} of 12 layers, d 768, f32) "
                  f"{'paged donated --parity' if name == 'e1' else 'dense ping-pong'}"
                  f" on the 2 x 2 mesh, K={MS_K}, {n_req} requests x "
                  f"{MS_PROMPT} + {n_gen}, a flip every {every} tokens: "
                  f"logs == one device's; faults "
                  f"{f}, {sm['engine_steps']} steps; decode p50 "
                  f"{sm['p50_decode_ms']:.1f} ms, p99 "
                  f"{sm['p99_decode_ms']:.1f} ms (tensor-parallel, no "
                  f"params gather in the run: gather_tree calls "
                  f"{e['gathers']}); model-axis collectives a steady step "
                  f"{e['tp_calls']}; the flag's "
                  f"all-reduce {e['allreduce_ms']:.2f} ms; STATS a steady "
                  f"step {tuple(e['stats'])}, {e['graphs']} graphs (head "
                  f"and tail a rotation and read table), every "
                  f"pointer kept; launches {lc}{extra}; run "
                  f"{e['secs']:.1f} s [{_SMI}]")


def check_mesh_modes(r: dict, device: str) -> None:
    """Phase 14's mode runs in one rank's result: asserts and its
    ``[mesh-modes]`` line."""
    sm = r["summaries"]
    b, c = sm["donate+fused+parity storm"], r["pair"]
    assert r["same"]["donate+fused+parity storm"], \
        f"14b != clean on rank {r['shard']}"
    assert b["pointers_kept"], b
    # every fused report under donation is consumed: replay, never the
    # in-place rungs (the parity and triage are in the ladder)
    assert set(b["recovery"]["by_rung"]) == {"replay"}, b["recovery"]
    assert b["digest_per_step"] == [[1, 1]], b
    if device == "cuda":
        # the head and the tail of each rotation and read table
        assert b["fused"]["captures"] == 4 * MESH_K, b["fused"]
    first, tol = c["events"]
    assert first["attempted"][0] == "triage", first
    assert first["rung"] in ("parity_xor", "replay"), first
    assert c["same"] and c["ptrs_kept"], c
    assert c["fold_err"] == 0 and c["update_err"] == 0, c
    assert c["tolerated_detected"] and tol["rung"] == "triage", tol
    assert tol["bytes"] == 0 and c["full_clean"], (tol, c)
    holders = tol["shards"]["opt/v/" + MESH_FLIP_LEAF]
    if device == "cuda":
        assert (c["triage_tiles"] > 0) == (r["shard"] in holders), (
            r["shard"], holders, c["triage_tiles"])
        for k in ("xor_fold_tiles", "xor_update_tiles", "checksum_tiles"):
            assert r["launches"].get(k, 0) > 0, (k, r["launches"])
    assert c["tiles_err"] == 0, c
    print(f"[mesh-modes] rank {r['shard']}: (b) --donate --fused-detect "
          f"--triage --parity K={MESH_K}, a flip at step 2 in the checked "
          f"slice: "
          f"final blocks == clean bitwise, every data_ptr kept, STATS a "
          f"step {b['digest_per_step']}, "
          f"{b['fused'].get('captures', b['fused'].get('builds'))} graphs "
          f"(pool {b['fused'].get('pool_bytes', 0) / 2**20:.1f} MiB), "
          f"{b['faults_detected']} "
          f"consumed reports -> {b['recovery']['by_rung']}, recovery p50 "
          f"{b['p50_recovery_ms']:.1f} ms, host p50 "
          f"{b['p50_step_ms']:.1f} ms, == clean bitwise, run "
          f"{r['secs']['donate+fused+parity storm']:.1f} s; (c) the "
          f"donated pair with triage and the mesh parity, its placed "
          f"flips by hand on the initial state: bit 30 -> "
          f"{first['attempted']} -> {first['rung']} ({first['bytes']} B, "
          f"{first['ms']:.1f} ms), state == its bits before the flip, "
          f"parity row ({c['parity_words']} "
          f"words) == its plain fold, update == plain; bit 2 -> triage "
          f"({tol['bytes']} B, {tol['ms']:.1f} ms, shards {holders}), "
          f"checksum_tiles {c['triage_tiles']} (bitwise plain), next full "
          f"check clean, run "
          f"{r['secs']['donate+triage+parity flips']:.1f} s; "
          f"launches by run {r['by_run']} [{_SMI}]")


def mesh_phase(torch, device: str = "cuda", smoke: bool = False) -> None:
    """Phase 14: iterpro-100m at full width and depth (f32, seed 0) on a
    2 x 2 mesh of 4 ranks sharing the card over gloo; batch 8 x 128, K=1,
    a snapshot every 2 steps.  Every storm ends bitwise equal to the clean
    run on every rank; shard_patch moves exactly the injured blocks'
    bytes and an odd-step flip replays; every rank launches ``pack_rows``
    and ``row_checksums`` (rank 0
    also ``checksum_tiles``, the checkpoint's) and holds the first two
    bitwise against their plain versions on its own blocks; 14e serves
    on the mesh (``check_mesh_serve``) and 14d loses a row
    (``check_elastic``).  ``device="cpu"`` and ``smoke`` dry-run it on
    the CPU."""
    from repro_torch.launch.mesh import spawn
    if device == "cuda":
        _phase_start(torch)
        # the earlier phases' captures left cuBLAS workspaces (as 10c-13c
        # drop them): four ranks need the card's memory
        getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
        _release(torch)
        free, total = torch.cuda.mem_get_info()
        print(f"[mesh] before the spawn: this process holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; "
              f"the card {free / 2**30:.2f} of {total / 2**30:.2f} GiB free "
              f"[{_SMI}]")
    work = WORK / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    t0, t0_wall = time.perf_counter(), time.time()
    ranks = spawn(_mesh_rank, (2, 2), (MESH_STEPS, str(work), device, smoke),
                  device=device)
    wall = time.perf_counter() - t0
    up = max(r["entered"] for r in ranks) - t0_wall
    shutil.rmtree(work, ignore_errors=True)
    assert [r["shard"] for r in ranks] == [0, 1, 2, 3], ranks
    assert all(r["device"] == ("cuda:0" if device == "cuda" else device)
               for r in ranks), ranks
    print(f"[mesh] iterpro-100m ({MESH_LAYERS} of 12 layers, d 768, f32) "
          f"on a 2 x 2 mesh: {len(ranks)} ranks on {ranks[0]['name']} "
          f"({ranks[0]['device']}) over gloo, batch {T_BATCH} x {T_SEQ}, "
          f"{MESH_STEPS} steps a run, K=1, snapshot every 2; spawn + 4 "
          f"runs + checks + 14e (mesh serving) + 14d (12 layers) "
          f"{wall:.1f} s "
          f"(the last rank started {up:.1f} s after the spawn) [{_SMI}]")
    for r in ranks:
        sm = r["summaries"]
        assert sm["clean"]["faults_injected"] == 0, sm["clean"]
        for name in ("params", "iv", "donate+fused+parity storm"):
            f = sm[name]
            assert f["faults_injected"] > 0, (name, f)
            assert f["faults_detected"] == f["faults_injected"], (name, f)
            assert f["faults_recovered"] == f["faults_detected"], (name, f)
            assert r["same"][name], f"{name} storm != clean on rank " \
                                    f"{r['shard']}"
        rung = {n: sm[n]["recovery"]["by_rung"] for n in sm}
        # MESH_STEPS = 3: flips at 1 (no snapshot of version 1: replay) and
        # 2 (the snapshot of version 2: shard_patch)
        assert rung["params"] == {"replay": 1, "shard_patch": 1}, rung
        assert rung["iv"] == {"eq1": 1}, rung
        assert r["patch_exact"], sm["params"]["recovery"]["shard_patches"]
        lc = r["launches"]
        if device == "cuda":     # the CPU runs the plain versions
            assert lc.get("pack_rows", 0) > 0 \
                and lc.get("row_checksums", 0) > 0, lc
            assert r["shard"] != 0 or lc.get("checksum_tiles", 0) > 0, lc
        assert r["pack_err"] == 0 and r["rows_err"] == 0, r
        assert r["steady"] and tuple(r["stats"]) == (1, 1), r
        # tensor-parallel: no params gather before the forward
        assert r["no_gather"], r["shard"]
        assert r["tp_calls"].get("reduce_sum", 0) > 0, r["tp_calls"]
        ms = {n: {k: round(v, 3) for k, v in
                  sm[n]["recovery"]["p50_wall_ms_by_rung"].items()}
              for n in ("params", "iv")}
        moved = [e["bytes_moved"] for e in
                 sm["params"]["recovery"]["shard_patches"]]
        check_mesh_modes(r, device)
        print(f"[mesh] rank {r['shard']}: mesh step host p50 "
              f"{sm['clean']['p50_step_ms']:.1f} ms (clean), runs "
              + ", ".join(f"{n} {v:.1f} s" for n, v in r["secs"].items())
              + f"; recovery p50 ms by rung {ms}; shard_patch bytes "
              f"{moved} of {r['local_bytes']} local state bytes; storms == "
              f"clean bitwise; launches {lc}; pack_rows and row_checksums "
              f"bitwise their plain versions on the rank's blocks "
              f"({r['words']} words); steady check STATS {r['stats']}; "
              f"tensor-parallel, no params gather: model-axis collectives "
              f"a forward + backward {r['tp_calls']}; "
              f"a step's parts alone: "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in
                          r["parts_ms"].items())
              + f"; peak {r['peak_gib']:.2f} GiB [{_SMI}]")
    verdicts = [[(e["rung"], e["attempted"], e["bytes"])
                 for e in r["pair"]["events"]] for r in ranks]
    assert all(v == verdicts[0] for v in verdicts), verdicts
    check_mesh_serve(ranks, device)
    check_moe_mesh(ranks, device)
    check_mesh_families(ranks, device)
    check_elastic(ranks, device)


def check_elastic(ranks, device: str) -> None:
    """14d's asserts and ``[mesh-elastic]`` lines: row 1 (ranks 2-3) died
    before step 2; the survivors took one ``remesh`` and nothing else, no
    disk restore, rebuilt blocks from the parity and certified theirs,
    resumed bitwise on the oracle's blocks, finished 4 steps at 1 x 2 on
    the losses and blocks of a clean 1 x 2 run from the oracle, 1 launch
    + 1 fetch a step, the graphs captured again on the new context; the
    dead ranks launched nothing after the loss."""
    params = ranks[0]["summaries"]["params"]["recovery"]
    ckpt = ranks[0]["summaries"]["iv"].get("checkpoints", {})
    for r in ranks:
        e = r["elastic"]
        sm = e["summary"]
        if r["shard"] in (2, 3):
            assert sm.get("dead"), (r["shard"], sm)
            assert e["after_kill"] == {}, e["after_kill"]
            print(f"[mesh-elastic] rank {r['shard']} (row 1, lost before "
                  f"step {ELASTIC_KILL}): blocks overwritten with "
                  f"{ELASTIC_POISON:#x} after the oracle read them, "
                  f"kernel launches after the loss {e['after_kill']} "
                  f"[{_SMI}]")
            continue
        rec = sm["recovery"]
        assert rec["by_rung"] == {"remesh": 1}, rec
        assert sm["steps"] == ELASTIC_STEPS, sm
        assert sm["faults_detected"] == sm["faults_recovered"] == 1, sm
        [ev] = sm["elastic_events"]
        assert tuple(ev["lost_rows"]) == (1,), ev
        assert ev["disk_restores"] == 0 and ev["uncertified_blocks"] == 0, ev
        assert ev["blocks_reconstructed"] > 0 < ev["certified_blocks"], ev
        assert sm["mesh"]["shape"] == {"data": 1, "model": 2}, sm["mesh"]
        assert e["resumed_same"], "resumed blocks != the oracle's"
        assert sm["losses"][ELASTIC_KILL:] == e["clean_losses"], (
            sm["losses"], e["clean_losses"])
        assert e["same"], "final blocks != the clean 1 x 2 run's"
        assert sm["digest_per_step"] == [[1, 1]], sm["digest_per_step"]
        assert sm["pointers_kept"], sm
        lc = e["launches"]
        if device == "cuda":
            # 4 = the head and tail of the one rotation, each read table
            assert sm["fused"]["captures"] == 4, sm["fused"]
            for k in ("xor_fold_tiles", "xor_update_tiles", "pack_rows",
                      "row_checksums", "checksum_tiles"):
                assert lc.get(k, 0) > 0, (k, lc)
        print(f"[mesh-elastic] rank {r['shard']}: iterpro-100m (12 layers, "
              f"fsdp) 2 x 2 -> {sm['mesh']['shape']} before step "
              f"{ELASTIC_KILL} of {ELASTIC_STEPS}, --donate --fused-detect "
              f"--parity --elastic K=1: rungs {rec['by_rung']}, downtime "
              f"{ev['downtime_seconds']:.3f} s (reconstruct "
              f"{ev['reconstruct_seconds']:.3f} s, re-bind + re-capture "
              f"{ev['relower_seconds']:.3f} s), {ev['blocks_reconstructed']}"
              f" blocks ({ev['bytes_reconstructed']} B) rebuilt from the "
              f"parity, {ev['bytes_regathered']} B re-gathered "
              f"({ev['leaves_regathered']} leaves), {ev['certified_blocks']}"
              f" blocks certified, 0 disk restores; resumed blocks == "
              f"oracle bitwise, losses {sm['losses']} (after the loss == a "
              f"clean 1 x 2 run's), final blocks == its; STATS a step "
              f"{sm['digest_per_step']}, {sm['fused']} graphs re-captured; "
              f"launches {lc}; beside phase 14's replay p50 "
              f"{params['p50_wall_ms_by_rung'].get('replay', 0):.1f} ms and "
              f"checkpoint save {ckpt.get('blocking_seconds', 0):.3f} s "
              f"blocking + {ckpt.get('write_seconds', 0):.3f} s written; "
              f"run {e['secs']:.1f} s [{_SMI}]")


def dryrun_phase(torch, cfg, p50_ms: float) -> None:
    """Phase 15: the dry-run cell of ``cfg``'s train step at phase 7's
    shape on one device, against one real functional step on the card."""
    import math
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeSpec
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import cuda_numerics
    from repro_torch.train.loop import make_train_state, make_train_step
    shape = ShapeSpec("phase7_train", T_SEQ, T_BATCH, "train")
    t0 = time.perf_counter()
    rec, _ = trace_cell(cfg, shape, make_mesh((1, 1), ("data", "model")))
    traced_s = time.perf_counter() - t0
    state = make_train_state(cfg, 0, global_batch=T_BATCH, device="cuda")
    pipe = TokenPipeline(cfg.model.vocab_size, T_SEQ, T_BATCH, seed=0)
    batch = {k: v.cuda() for k, v in pipe.batch_at(0).items()}
    with cuda_numerics(torch.device("cuda")):
        step = make_train_step(cfg, global_batch=T_BATCH)
        with FlopCounterMode(display=False) as fc:
            _, m = step(state, batch)
        loss = float(m["loss"])
    card = fc.get_total_flops()
    meta = rec["op_cost"]["flops_per_device"]
    assert rec["status"] == "ok" and meta == card > 0, (meta, card)
    assert math.isfinite(loss), loss
    r = rec["roofline"]
    bound_ms = 1e3 * max(r["t_compute_s"], r["t_memory_s"],
                         r["t_collective_s"])
    print(f"[dryrun] {cfg.arch_id} train {T_BATCH} x {T_SEQ} on one "
          f"device, traced on meta in {traced_s:.2f} s ({rec['ops']} ops): "
          f"flops_per_device {meta:.0f} == FlopCounterMode on the card "
          f"{card:.0f}")
    print(f"[dryrun] roofline bound {bound_ms:.4f} ms ({r['bottleneck']}; "
          f"compute {1e3 * r['t_compute_s']:.4f} ms at "
          f"{rec['hardware']['peak_flops'] / 1e12:.1f} TFLOP/s, memory "
          f"{1e3 * r['t_memory_s']:.4f} ms for "
          f"{rec['op_cost']['hbm_bytes_per_device'] / 1e9:.3f} GB) against "
          f"phase 7's measured functional step p50 {p50_ms:.3f} ms "
          f"[{_SMI}]")
    del state, batch


def main() -> int:
    # deterministic cuBLAS for the training phase: read when the first
    # cuBLAS workspace is made, so before anything touches the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import digest as kd
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import leaves
    import numpy as np

    global _SMI
    smi = _SMI = _smi()
    print(f"[card] {smi}")
    _T_RUN[0] = time.perf_counter()
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"[build] {len(_build.sources())} CUDA sources -> {lib_path.name} "
          f"in {time.perf_counter() - t0:.1f} s")
    kernel = "?"
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_label(line.split("'")[1])
        elif "Used" in line or "spill" in line:
            print(f"[build] {kernel}: {line.strip()}")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)],
                          capture_output=True, text=True,
                          check=True).stdout
    hgmma = {}
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = _kernel_label(line.split(":", 1)[1].strip())
        elif "HGMMA" in line:
            hgmma[kernel] = hgmma.get(kernel, 0) + 1
    for kernel, n in hgmma.items():
        print(f"[build] {kernel}: {n} HGMMA in its SASS")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("iterpro-100m")
    common = dict(n_slots=SLOTS, max_len=PROMPT + GEN + 1, canary_slices=K,
                  block_size=BLOCK, max_replays=10**6, device="cuda")
    clean_eng = ServingEngine(cfg, seed=0, **common)
    storm_eng = ServingEngine(cfg, params=clean_eng.params, **common)
    print(f"[engine] iterpro-100m: {clean_eng.n_blocks} pool blocks of "
          f"{BLOCK}, {clean_eng.plan.n_leaves} canary units, "
          f"{sum(t.numel() for t in leaves(clean_eng.params))} params")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernels = check_kernels(torch, clean_eng, flush)
    check_reference(torch)

    def reqs():
        return make_requests(cfg, N_REQUESTS, PROMPT, GEN,
                             np.random.default_rng(0))

    for eng in (clean_eng, storm_eng):
        warm_s = eng.warm()
        assert eng.n_captures == 2 * K, eng.n_captures
    torch.cuda.synchronize()
    print(f"[serve] the engine step captured as {storm_eng.n_captures} CUDA "
          f"graphs (K={K} rotations x 2 read tables) in "
          f"{storm_eng.capture_seconds:.3f} s (warm-up and capture "
          f"{warm_s:.3f} s)")
    _build.LAUNCHES.clear()
    kd.STATS.reset()
    clean = clean_eng.run(reqs())
    storm = storm_eng.run(reqs(), inject_every=INJECT,
                          inject_rng=random.Random(0))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)

    cs, ss = clean.summary(), storm.summary()
    f = ss["faults"]
    print(f"[serve] clean: {cs['completed']}/{cs['requests']} completed, "
          f"{cs['engine_steps']} steps, decode p50 {cs['p50_decode_ms']:.3f}"
          f" ms p99 {cs['p99_decode_ms']:.3f} ms")
    print(f"[serve] storm: {ss['completed']}/{ss['requests']} completed, "
          f"{ss['engine_steps']} steps, faults {f}, dropped "
          f"{ss['dropped']}, replay tokens {ss['replay_tokens']}, decode "
          f"p50 {ss['p50_decode_ms']:.3f} ms p99 {ss['p99_decode_ms']:.3f} "
          f"ms, recovery p50 {ss['p50_recovery_ms']:.3f} ms")
    assert cs["completed"] == N_REQUESTS and cs["dropped"] == 0, cs
    assert f["injected"] > 0 and f["detected"] == f["injected"], f
    assert f["recovered"] == f["detected"], f
    assert ss["dropped"] == 0 and ss["completed"] == N_REQUESTS, ss
    for rid, rec in clean.per_request.items():
        toks = rec["tokens"]
        assert len(toks) == GEN and all(0 <= t < cfg.model.vocab_size
                                        for t in toks), (rid, toks)
        assert storm.per_request[rid]["tokens"] == toks, (
            f"rid {rid}: storm tokens differ from clean tokens")
    print(f"[serve] storm tokens == clean tokens for all {N_REQUESTS} "
          f"requests; launches on the main path: {launches}")
    for name in kernels:
        assert launches.get(name, 0) > 0, f"{name} never launched"
    check_serving_parity(torch, cfg, clean_eng, common)
    # 4 profiled steady steps a mode (the time cut; 9c-13a profile 8)
    serve_modes(torch, cfg, clean_eng.params, common, reqs,
                {rid: r["tokens"] for rid, r in clean.per_request.items()},
                steps=4, storms=STORM_MODES)
    del clean_eng, storm_eng
    torch.cuda.empty_cache()
    _stamp("phases 1-5")

    # -- training path ----------------------------------------------------
    from repro_torch.train.loop import make_train_state
    fresh = make_train_state(cfg, 0, global_batch=T_BATCH, device="cuda")
    train_kernels = check_train_kernels(torch, flush, fresh)
    parity_kernels = check_parity_kernels(torch, flush, fresh,
                                          fresh["params"])
    del fresh
    torch.cuda.empty_cache()
    flash_kernels, flash_launches = check_flash(torch, flush, cfg.model)
    torch.cuda.empty_cache()
    _stamp("phase 6")
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    runs = run_training(torch, cfg)
    p50_7 = runs["clean"][0]["p50_step_ms"]
    clean_state = runs["clean"][1]
    recover_on_card(torch, cfg, clean_state)
    torch.cuda.synchronize()
    train_launches = dict(_build.LAUNCHES)
    print(f"[train] launches on the training path (3 runs + recovery "
          f"phase): {train_launches}")
    for name in ("pack_rows", "row_checksums", *train_kernels):
        assert train_launches.get(name, 0) > 0, f"{name} never launched"
    check_pack_training(torch, flush, clean_state)

    # -- parity path (train --parity) --------------------------------------
    _build.LAUNCHES.clear()
    par = run_parity_storm(torch, cfg, runs)
    torch.cuda.synchronize()
    parity_launches = dict(_build.LAUNCHES)
    attempts = par["steps"] + par["faults_detected"]
    print(f"[parity] launches on the parity path ({attempts} step attempts "
          f"+ {par['faults_recovered']} recoveries): {parity_launches}; per "
          f"step attempt: " + ", ".join(
              f"{k} {v / attempts:.2f}"
              for k, v in sorted(parity_launches.items())))
    for name in ("pack_rows", "row_checksums", *parity_kernels):
        assert parity_launches.get(name, 0) > 0, f"{name} never launched"
    shutil.rmtree(WORK, ignore_errors=True)
    check_parity_recovery(torch, cfg, clean_state)
    # no profile of the parity step here since PR 25, the time cut: 7j
    # profiles the fused donated parity step, xor_update_tiles timed
    profile_train(torch, cfg, clean_state)
    _stamp("phases 7a-7e")

    # -- the modes: --donate, --fused-detect, both; triage -----------------
    _build.LAUNCHES.clear()
    run_modes(torch, cfg, runs)
    check_fused_path(torch, cfg, clean_state)
    torch.cuda.synchronize()
    modes_launches = dict(_build.LAUNCHES)
    print(f"[modes] launches on the modes path (6 runs + the fused path; "
          f"a graph replay counts the kernels captured in it): "
          f"{modes_launches}")
    for name in ("pack_rows", "row_checksums", "xor_update_tiles",
                 "xor_fold_tiles"):
        assert modes_launches.get(name, 0) > 0, f"{name} never launched"
    check_donated_rungs(torch, cfg, clean_state)
    check_triage(torch, cfg)
    for name in list(runs):
        if name != "clean":
            del runs[name]
    profile_modes(torch, cfg, clean_state)
    del runs, clean_state
    _stamp("phases 6-7")

    # -- phase 8: the dense configurations at full width ------------------
    common8 = dict(n_slots=SLOTS, max_len=PROMPT + GEN + 1,
                   block_size=BLOCK)
    gcfg = _full_width(GEMMA)

    def g_reqs():
        return make_requests(gcfg, N_REQUESTS, PROMPT, GEN,
                             np.random.default_rng(0))

    def ring_reqs():
        return make_requests(gcfg, 2, RING_PROMPT, RING_GEN,
                             np.random.default_rng(1))

    g_eng, _, l8a = serve_full_width(torch, gcfg, "serve-gemma", g_reqs,
                                     paged=True, **common8)
    print(f"[serve-ring] gemma3-1b at {G_CUT_LAYERS} of its 26 layers (the "
          f"depth cut keeps the whole script within its time limit)")
    r_eng, r_rep, l8b = serve_full_width(
        torch, _full_width(GEMMA, n_layers=G_CUT_LAYERS), "serve-ring",
        ring_reqs, paged=False, n_slots=2,
        max_len=RING_PROMPT + RING_GEN + 1, block_size=BLOCK)
    check_first_token(torch, r_eng, ring_reqs()[0],
                           r_rep.per_request[0]["tokens"])
    del r_eng
    ccfg = _full_width(COMMAND_R, n_layers=CMD_LAYERS)
    print(f"[serve-command-r] {COMMAND_R} at full width (d "
          f"{ccfg.model.d_model}, d_ff {ccfg.model.d_ff}, "
          f"{ccfg.model.n_heads}/{ccfg.model.n_kv_heads} heads, vocab "
          f"{ccfg.model.vocab_size}, parallel blocks), depth cut to "
          f"{CMD_LAYERS} of its 40 layers")
    c_eng, _, _ = serve_full_width(
        torch, ccfg, "serve-command-r",
        lambda: make_requests(ccfg, N_REQUESTS, PROMPT, GEN,
                              np.random.default_rng(2)),
        paged=True, **common8)
    del c_eng
    l8d = train_gemma(torch)
    wide_launches = sum(lc.get("pack_rows", 0) for lc in (l8a, l8b, l8d))
    print(f"[pack-wide] pack_rows launches on phases 8a, 8b, 8d (bf16 "
          f"leaves in every one): {l8a.get('pack_rows', 0)}, "
          f"{l8b.get('pack_rows', 0)}, {l8d.get('pack_rows', 0)}")
    _phase_start(torch)
    g_state = _stepped_state(torch, gcfg)
    wide = check_pack_wide(torch, flush, g_state, g_eng, wide_launches)
    del g_eng, g_state
    train_danube(torch)
    _stamp("phase 8")

    # -- phase 9: the optimizers and the MoE family at full width ---------
    t9 = time.perf_counter()
    check_pack_bytes(torch, flush)
    bytes_entry, l9b = train_int8(torch, flush)
    _stamp("phases 9a-9b")
    l9c = serve_moe(torch, "serve-grok", GROK, 3, chunked=True)
    l9d = serve_moe(torch, "serve-kimi", KIMI, 4, chunked=False)
    _stamp("phases 9c-9d")
    l9e = train_grok(torch)
    l9 = {"9b": l9b, "9c": l9c, "9d": l9d, "9e": l9e}
    for kernel in ("pack_rows", "row_checksums", "gather_blocks",
                   "checksum_tiles"):
        assert sum(lc.get(kernel, 0) for lc in l9.values()) > 0, (kernel, l9)
    print(f"[phase 9] launches by path: {l9}; {time.perf_counter() - t9:.1f}"
          f" s [{_SMI}]")
    _stamp("phase 9")
    label = "pack_rows (iterpro-100m int8-moment training canary, 1-byte q)"
    kernels[label] = bytes_entry
    launches[label] = bytes_entry["launches"]

    # -- phases 10 and 11: the xLSTM and hybrid families at full width ----
    # no donate+fused clean run (the time cut: the fused storm holds its
    # checks, as 13c's does)
    recurrent_phase(torch, 10, XLSTM, dict(n_layers=X_LAYERS),
                    dict(n_layers=X_LAYERS), storms=("parity", "fused"),
                    checkpoint=False, profile=False, fused_clean=False)
    _stamp("phase 10")
    recurrent_phase(torch, 11, ZAMBA, dict(n_layers=Z_SERVE_LAYERS),
                    dict(n_layers=Z_TRAIN_LAYERS), storms=("parity",),
                    checkpoint=False, profile=False)
    _stamp("phase 11")

    # -- phase 12: the enc-dec family at full width -----------------------
    s_layers = dict(n_layers=S_LAYERS, n_enc_layers=S_LAYERS)
    # no checkpoint round trip since PR 25, the time cut (7a-7b hold the
    # checkpoint: saved every 10 steps, loaded digest-verified by the
    # rung, a corrupted one refused; 14 the mesh checkpoint)
    # no donate+fused profile (the time cut: 7j holds the hot-path one)
    recurrent_phase(torch, 12, SEAMLESS, s_layers, s_layers,
                    storms=("parity",), long=long_encdec, checkpoint=False,
                    profile=False)
    _stamp("phase 12")

    # -- phase 13: the VLM family at full width ---------------------------
    # no iv storm (the time cut: phase 14's iv storm takes eq1 through
    # train() on the card)
    recurrent_phase(torch, 13, QWEN, {}, dict(n_layers=Q_TRAIN_LAYERS),
                    long=long_vlm, requests=vlm_requests(Q_GRID),
                    patch_rows=Q_GRID ** 2, checkpoint=False, profile=False,
                    parity_kw=Q_PARITY, fused_clean=False,
                    storms=("parity", "fused"))
    _stamp("phase 13")

    # -- phase 14: resilient training on a 2 x 2 mesh ---------------------
    mesh_phase(torch)
    _stamp("phase 14")

    # -- phase 15: the dry-run cell against the card ----------------------
    dryrun_phase(torch, cfg, p50_7)
    _stamp("phase 15")

    for name, r in train_kernels.items():
        kernels[name] = r
        launches[name] = train_launches[name]
    for name, r in parity_kernels.items():
        kernels[name] = r
        launches[name] = parity_launches[name]
    for name, r in flash_kernels.items():
        kernels[name] = r
        launches[name] = flash_launches[name]
    for name, r in wide.items():
        kernels[name] = r
        launches[name] = r["launches"]
    print(json.dumps({"kernels": [
        {"name": name, "route": r["route"], "source": r["source"],
         "replaces": r["replaces"], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
