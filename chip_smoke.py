#!/usr/bin/env python3
"""Full-width run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, agrees with its plain
versions, serves and trains.

    python3 chip_smoke.py

Phases, one JSON line each (several for the case phases):
  build        build every CUDA kernel from ``src/repro_torch/kernels/*/csrc``
  hold_check   time_ms's gap test must fire on a host-bound call and stay
               quiet on a device-bound one
  kernels      the decode kernels against their plain PyTorch versions on
               the card, f32 and bf16, each case twice (bitwise equal) on
               the route its alignment gives: decode attention at LLaMA-7B
               width, 12/4 GQA, h2o-danube-3-4b's heads (32/8, hd 120) over
               a 4,096 ring and recurrentgemma-2b's (10/1, hd 256) over
               2,048 (split route), ragged with masked rows; the GEMV at
               1, 8, 17, 20, 40 rows, K=11008, ragged K/N and W as an
               unaligned column slice (scalar route); then their times at
               the serving shapes beside the plain versions, one PyTorch
               call (SDPA; x@W, a floor) and the card's bound, and decode
               attention at the long ring (danube heads, ring 4,096)
  flash_cases  the flash forward (out, lse) and backward (dq, dk, dv)
               kernels against the plain version: f32/bf16, causal /
               window 64 and 96 / non-causal, GQA 12/4, 32/32, 32/8, 8/1,
               16/1 (MQA), 10/1 and 8/2, hd 64/120/128/256, S 256/512 and
               ragged 77/200/1000; the
               forward and the backward twice (bitwise equal; the
               forward's SHA-256 printed), on the 16-byte routes; a hd-128
               and a hd-120 case again on unaligned views (scalar routes);
               h2o-danube-3-4b's heads at h2o_train's shape (1x8192, hd
               120, window 4096) in bf16, held to the plain version one KV
               head at a time, and recurrentgemma-2b's at rg_train's shape
               (1x4096, hd 256, 10 on 1, window 2048) in bf16; a hd-256
               case on unaligned views.  Every case is held twice:
               elementwise (TOL)
               and, against the plain version in f32 on the same inputs,
               in every 64-row tile of out, dq, dk and dv (RMS of the error
               within FLASH_REL_TOL of the tile's RMS, max error within it
               of the largest entry); at the 1x8192 shape two stand-ins
               for a faulty kernel (the band one tile short, channels
               96-119 lost) must fail that second hold; then the SHA-256
               of the forward and the
               backward at one hd-64, hd-128, hd-120 and hd-256 shape, f32
               and bf16 (``tools/time_flash.py --digest`` prints the same
               for another tree)
  flash_timing forward, dq, dk/dv, the backward as the model runs it
               (softmax_delta + dq + dk/dv) and forward+backward at the
               train shape (B=8, S=256, H=12, K=4, hd=64, f32), at S=512,
               at h2o-danube-3-4b's heads (32/8, hd 120) over 1x8192 bf16
               with window 4096 (h2o_train's shape) and 4x256 f32, at
               recurrentgemma-2b's heads (10/1, hd 256) over 1x4096 bf16
               with window 2048 (rg_train's shape), beside
               the window-aware bound, the plain version and
               scaled_dot_product_attention (forward; backward, the
               library time of dq and dk/dv; the band as a boolean mask
               under a window)
  serve        multi-tenant LLaMA-7B decode at full width and depth (bf16,
               random weights): 16 requests from 8 users through 8 slots;
               every request must finish and every step must launch both
               kernels, all on their 16-byte routes
  profile      device time by kernel and device idle share over a few steps
               (the engine's captured decode program), and the decode
               kernels' shares of it
  decode_graph the serve job again under ``jit_cache.disable_jit()`` (every
               step op by op) against its default run, whose every step
               replayed the engine's captured decode program with the K/V
               donated: the same tokens, launches and steps, one replay a
               step; step ms, warm-up / capture seconds and peaks captured
               against eager, and the profile's idle share eager beside
               captured.  h2o_serve, rwkv_decode and rg_decode emit the same
               ``decode_graph`` line for their jobs (``generate`` there)
  oracle       the same width in f32 at 2 layers: ServeEngine tokens must
               equal the merged-weights serve_naive tokens request for
               request
  tri_lora_cases  the tri-LoRA forward, dx and dW kernels and the rank-r
               grads through autograd against the plain forward and the
               analytic backward: f32/bf16, the JAX kernel-test shapes, the
               training shapes (2048x768x768 and x256, r=8), ragged
               77x100x130 r=16, dW in clusters of 7 and 3 splits, decode
               M=1 and 8 at K=N=4096 (bf16); then
               the bf16 forward at rwkv6-1.6b width with f32 adapters on
               the prefill's strided (B,T,5,D) views and the decode rows
               (wgmma route) and on a view TMA cannot read (SIMT route);
               each line names the forward's route
  tri_lora_timing each kernel beside the bound, the plain version and one
               torch call (addmm / x.T@g): at the training shapes of wq
               (forward, dx, dW; x@w alone as a floor) and wk/wv (forward,
               dx, dW), f32, and the forward at the rwkv6-1.6b prefill
               (M=4096) and decode (M=8) shapes, bf16 with f32 adapters;
               each output held to the plain version's (gradients with the
               absolute part scaled), dx and dW bitwise the same on a
               second call, and the host time of a decode-shape call
  (tri_lora_cases, grouped) the grouped forward and dx (one adapter per
               client, the factors strided views of a stacked state) and
               the rank-r grads against the plain grouped forward and
               backward: f32/bf16 at the train_vmap shapes, 100 rows a
               client (tiles straddle two clients), masked (-1) groups,
               one row a group; a bf16 case on the wgmma route
  (tri_lora_timing, grouped) the grouped forward and dx at the train_vmap
               shapes beside the bound, the plain version and mm + baddbmm
  train        CE-LoRA ``run_federated`` on fed-100m at full width and
               depth (f32, random backbone): 4 clients, 3 rounds of 5 local
               steps of batch 8 at sequence 256, attn_impl="flash"; exact
               flash and tri-LoRA launch counts (every flash launch on its
               16-byte route), a profile window, and the
               same job with attn_impl="ref" on the card as its reference
  train_vmap   the train job with client_parallelism="vmap": the 4
               clients as one batch of 32 sequences, exact grouped
               tri-LoRA and flash launches (one per projection per local
               step for all clients), ledgers equal to the loop run's, loss
               within 1e-3 + 1e-3·|loss| and accuracies within 0.05 of it,
               a falling loss, and profile windows of the same lora_loc
               work (4 clients, 3 steps) on the loop and the vmap path
  lm_train     the causal-LM driver ``launch.train.run`` on fed-100m at full
               width and depth: 4 clients, 3 rounds of 5 local steps of
               8x256, celora, int8 uplink, flash; exact launch counts, a
               falling loss, the byte ledger, a checkpoint that verifies and
               restores, and a profile window of train.local_fit; then the
               same job with client_parallelism="vmap" (grouped kernels):
               exact launches, the same ledger, checkpoint and falling
               loss, round 0's loss within 1e-3 + 1e-3·|loss| of the loop
               run's (later rounds amplify rounding at this job's lr)
  train_graph  the train (loop), train_vmap and lm_train (loop) jobs again
               under ``jit_cache.disable_jit()``, op by op: their default
               runs, whose fits and evals ran as captured CUDA graphs
               (``core/jit_cache.py``), bitwise these (every record but the
               times, the final states, the launches), with graphs
               captured and one replay per fit and eval call; captured
               against eager: wall per round, warm-up and capture seconds,
               peak memory, the entries per cache, and train_profile's
               idle share on loop and vmap
  pretrain     ``FedTask.create`` with two 8x256 warm-up batches: the
               backbone trains, so every projection runs the dW kernel too
  card_vs_cpu  one loss and its adapter gradients at full width and depth
               on the card (all kernels) and on the CPU (plain versions)
  wkv6_cases   the wkv6 kernel (y and final state) against the plain scan:
               the JAX kernel-test shapes, T = 1, ragged T, hd 17/48/64 at
               T 1/15/17/513, extreme decay, the rwkv6-1.6b prefill shape
               in bf16/f32, strided views of one (B,T,3D) buffer; one
               launch per call on the route ops.route names (hd 17 takes
               the scalar route, the rest the 16-byte one), each case
               twice (bitwise equal)
  wkv6_timing  the kernel at B=8 T=512 H=32 hd=64 beside the corrected
               bound and the plain versions (no PyTorch call computes it),
               and at B=1, 8 and 32
  rwkv_prefill rwkv6-1.6b at full width and depth (bf16, random weights):
               model.forward over 8x512 tokens with use_rwkv_kernel=True,
               exactly 24 wkv6 launches (all on the 16-byte route) and 96
               tri-LoRA forward launches (all 96 on the wgmma route),
               every wkv6 call against wkv6_ref on its own
               inputs, the same weights in f32 within 2e-2 of the plain
               path's logits, and a profile window with the tri-LoRA and
               wkv6 kernels' shares of device time
  rwkv_decode  serve.generate at full width and depth: 8 prompts of 32
               tokens and 32 new ones through the captured decode program,
               twice, and under disable_jit with every step counted (96
               tri-LoRA forward launches on the wgmma route and 0 wkv6
               launches a step): the same tokens (``decode_graph``)
  rwkv_oracle  the same width in f32 at 2 layers (B=2, T=200): card vs CPU
               logits within 1e-4 of the largest, token-by-token decode on
               the card vs the forward at 2e-3
  train_faults (after train_vmap) ``run_federated`` on fed-100m at full
               width and depth, f32, flash, under the seeded fault storm
               (seed 11: crashes, a lost upload, corrupted and divergent
               uploads), int8 uplink with bit flips on the wire and the
               norm gate: 4 clients, 3 rounds of 3 local steps of 8x256,
               on loop and on vmap; the same failed / rejected lists and
               ledgers, loss within 1e-3 + 1e-3·|loss| up to the first round
               that admits a corrupted upload (1e-3 + 1e-2·|loss| after
               it), accuracies within 0.05, everything finite, exactly the
               fault-free job's launches; then one NaN-corruption round on
               vmap (seed 5, rate 0.5) that the gate must cut, finite
  train_scan   (after train_faults) ``run_federated`` with engine="scan" on
               fed-100m at full width and depth: the train_vmap job in
               chunks of 2 (an odd tail), held to the eager vmap run
               (ledgers, loss within 1e-3 + 1e-3·|loss|, accuracies within
               0.05, exactly its launches on the same routes); the
               train_faults storm on scan (the vmap run's failed / rejected
               lists and ledgers, all finite); 4 rounds at participation
               0.5 with int8 and the norm gate killed after 2 (the
               checkpoint verifies) and resumed, history and states
               bitwise the uninterrupted run's; the synchronizing calls of
               2 rounds in one chunk equal to 4 rounds in one chunk in the
               run's own code (``torch.cuda.set_sync_debug_mode("warn")``;
               each run's one chunk program syncs inside torch); wall per
               round, host_s, device_s, tokens/s and peak memory beside the
               eager vmap run's
  train_host   (after train_scan) ``run_federated`` with
               client_store="host" on fed-100m at full width and depth:
               64 clients, 8 a round (participation 0.125), celora, int8,
               S^data off, 3 rounds of 2 local steps of 4x64, eager, on
               each store: the JAX contract between them (ledgers equal,
               loss 1e-4, accuracies 1e-3, states 5e-4), exactly the same
               grouped launches (the 8-client cohort fit against the
               device store's all-64 fit), the host population pinned
               host memory and its device-resident bytes below the device
               store's, a second host run bitwise the first; the host store
               on the scan engine killed after round 2 and resumed,
               bitwise; device-resident bytes, peak memory, host_s and
               device_s per round of each store
  train_async  ``run_federated`` with engine="async", 8 clients: (a) the
               zero-staleness limit (uniform latency, K = k = 8, int8)
               held to the eager vmap run within the same contract; (b) a
               storm (lognormal latency, K = 4, concurrency 8, staleness
               decay 0.5, crashes, lost and NaN-corrupted uploads, the
               norm gate, a dispatch timeout, retries: rejections, drops,
               stale uploads, fit groups of 1 to 6 clients) for 4
               flushes, twice, bitwise alike, exactly its fit groups'
               grouped launches; killed right after its flush-2
               checkpoint and resumed, bitwise; wall per flush, staleness,
               fit-group sizes and launches
  lm_scan      (after lm_train) ``launch.train.run`` with engine="scan":
               lm_train's job for 4 rounds in chunks of 2, exact grouped
               launches, the int8 ledger, round 0's loss within 1e-3 +
               1e-3·|loss| of the eager vmap run's, a falling loss, killed
               after 2 rounds and resumed, bitwise
  scan_graph   (after lm_scan) train_scan's main job and lm_scan's
               uninterrupted run again under ``jit_cache.disable_jit()``
               (every chunk op by op) against their default runs, whose
               every chunk replayed one captured CUDA graph with the carry
               donated: records, states and launches bitwise, one replay a
               chunk, the same synchronizing calls besides the builds';
               round wall, warm-up / capture seconds and peaks captured
               against eager
  lm_host / lm_async  (after lm_scan) ``launch.train.run`` on lm_train's
               job for 2 rounds with client_store="host", then with
               engine="async" at the zero-staleness limit: exact grouped
               launches, the int8 ledger, round 0's loss within 1e-3 +
               1e-3·|loss| of the eager vmap run's
  lm_rwkv      ``launch.train.run`` on rwkv6-1.6b at full width and depth
               (bf16 backbone, f32 adapters): 2 clients, 2 rounds of 2
               local steps of 2x128, loop then vmap (the default); the
               same ledger, round 0's loss within 1e-3 + 1e-3·|loss|,
               exact tri-LoRA launches (grouped on vmap, 96 projections a
               step) all on the wgmma routes, no wkv6 launch (training runs
               the plain recurrence)
  dense_configs qwen2.5-14b at full width and depth (bf16, ~28.0 GB of
               weights) serving 8 requests from 4 users through 4 slots
               (both decode kernels every step), then the oracle check at
               full width, 2 layers, f32 for qwen2.5-14b (QKV bias),
               qwen3-32b (qk RMSNorm) and starcoder2-7b (LayerNorm + GELU),
               head dim 128; each model freed before the next
  h2o_train    ``launch.train.run`` on h2o-danube-3-4b at full width and
               depth (bf16 backbone, f32 adapters, ``swa`` blocks, head dim
               120, window 4,096): 2 clients, 1 round of 1 local step of
               one 8192-token sequence each, flash, on vmap (both clients
               as one batch through the grouped tri-LoRA kernels) and then
               on loop: exact flash launches (48 forward, 24 of them the
               ``cfg.remat`` recompute, and 24 dq and dk/dv a step; every
               block swa at hd 120, so every one under the window; 16-byte
               routes)
               and tri-LoRA launches, their routes, a finite loss, the
               plain ledger, round 0's loss within 1e-3 + 1e-3·|loss|
               across the two, tokens/s and peak memory
  h2o_oracle   the same model at full width, 2 layers, f32, one 8192-token
               sequence: loss and adapter gradients through flash against
               the plain blockwise attention (loss within 1e-4·|loss|,
               gradients within 1e-3 of their largest entry)
  h2o_serve    h2o-danube-3-4b at full width and depth (bf16) serving 8
               requests of 64 + 16 tokens from 4 users through 4 slots
               (both decode kernels every layer of every step, 16-byte
               routes), ms a decode step and peak memory; then its f32
               2-layer oracle (ServeEngine tokens equal serve_naive's)
  steps_train  ``launch.steps.make_train_step`` on h2o-danube-3-4b at full
               width and depth (bf16 backbone, f32 adapters, flash) at
               train_4k's 4,096-token sequence, global batch 4 (of 256):
               microbatches 1 and 4 from the same params and optimizer
               state, exact flash and tri-LoRA launches, loss within 1e-3 +
               1e-3·|loss|, the accumulation bitwise the one-sequence
               gradients summed; the two runs' gradients at 2, 6 and 24
               layers in bf16 and on the same weights in f32 (f32 within
               1e-4 of each leaf's largest entry at 2 layers, 1e-3 at 24;
               the bf16 gaps reported, each bf16 run within twice the
               other's distance from f32), the updated adapters
               reported; loss
               and adapter gradients with ``cfg.remat`` on and off bitwise
               equal on fed-100m (f32, 8x256) and h2o (1x4096), both peaks;
               one qwen2.5-14b train step at 1x4096 through the chunked loss
               (16 checkpointed 512-token chunk calls) within 1e-5 relative
               of the unchunked loss, both peaks
  (flash_timing, prefill_32k) the flash forward at 1x32768, h2o heads, bf16,
               window 4096, beside its bound, blockwise_sdpa and SDPA,
               held to blockwise_sdpa in f32 elementwise and relatively
               (FLASH_REL_TOL); the band one tile short and lost
               channels must fail the relative hold
  steps_prefill ``make_prefill_step`` on h2o at full depth over 1x32,768
               tokens (prefill_32k's batch 32 cut to 1): exactly 24 flash
               forwards (16-byte route) and 96 tri-LoRA forwards, finite
               (1, padded vocab) logits, tok/s, peak memory, the flash
               forward's device time per call (profile); a 2-layer f32
               oracle of the same shape, flash vs ``attn_impl="blockwise"``,
               last-position logits within 1e-4 of the largest
  steps_decode ``make_serve_step`` on h2o at full depth: decode_32k at batch
               128 over full 4,096-slot rings (48.3 GB of bf16 K/V filled
               from a seeded generator) up to position 32,767, 24 decode
               attention and 96 tri-LoRA launches a step, every attention
               call of one step held to its plain version on its recorded
               operands (elementwise and, per batch row, relatively at
               FLASH_REL_TOL; the ring one 64-slot tile short must fail
               that); the next 3 steps eagerly, then from the same cache
               state through the step as a cached program with the cache
               donated: logits bitwise, one replay a step, no copy of the
               cache, the peak above the start within a quarter of the
               cache of the eager steps'; wall and device time a step,
               captured and eager; long_500k (the
               variant is h2o itself) at batch 1 from position 524,287
  bank_serve   ``run_federated`` on fed-100m (celora, 4 clients, 2 rounds,
               scan engine) on the device and on the host store, each
               checkpointed; ``export_bank`` of both (within 5e-4, B != 0,
               rows distinct); ServeEngine over the exported bank, exact
               grouped-GEMV and decode-attention launches, tokens equal to
               serve_naive's request for request
  privacy      ``run_dlg_experiment`` on the card, 300 attack steps, seeds
               0-4: F1 per method, the example's assertion at seed 0, the
               observed gradients of every payload within 1e-5 of the CPU's
  moe_train    ``launch.train.run`` on llama4-scout-17b-a16e at full width,
               8 of its 48 layers (~34 GB of bf16 weights, f32 adapters):
               2 clients, 1 round of 1 local step of one 4096-token
               sequence each (four 1024-token dispatch groups), flash, on
               vmap then loop: exact flash and tri-LoRA launches (the
               attention projections only: the experts are frozen), a
               finite loss, each client's aux > 0 and equal across the
               two (``LossTap``), round 0's loss within 1e-3 +
               1e-3·|loss|, the plain ledger, the share of routed picks
               dropped at capacity (``RouteTap``), tokens/s, peak memory
  moe_oracle   llama4-scout at full width, 2 layers, f32, 1x2048: loss and
               adapter gradients through flash against attn_impl="ref"
               (1e-4·|loss|, 1e-3 of the largest entry), and the tokens
               whose top-k expert set differs between the two runs
  moe_serve    grok-1-314b at full width, 2 of its 64 layers (~21 GB,
               bf16) serving 8 requests of 64 + 16 tokens from 4 users
               through 4 slots (both decode kernels every layer of every
               step; each decode token routes alone, capacity 1), ms a
               step and peak memory; then llama4-scout's oracle at full
               width, 2 layers, f32, capacity_factor = n_experts:
               ServeEngine tokens equal serve_naive's
  rg_train     ``launch.train.run`` on recurrentgemma-2b at full width and
               depth (26 layers: 8 x (rglru, rglru, swa) + 2 rglru; bf16
               backbone, f32 adapters, cfg.remat): 2 clients, 1 round of
               1 local step of one 4096-token sequence each, flash at hd
               256 under the 2,048 window, on vmap then loop: exact
               launches (16 flash forwards, 8 dq, 8 dk/dv a step; 132
               tri-LoRA forwards and 67 dx: 4 x 8 attention projections
               and w_in / w_out x 18, again for the 24 checkpointed group
               layers), a finite loss, round 0's loss within 1e-3 +
               1e-3·|loss|, tokens/s, peak memory
  rg_oracle    recurrentgemma-2b at full width, 3 layers, f32, 1x4096:
               loss and adapter gradients through flash at hd 256 against
               attn_impl="blockwise" (1e-4·|loss|, 1e-3 of the largest)
  rg_decode    ``serve.generate`` on recurrentgemma-2b at full depth, bf16:
               8 prompts of 32 tokens and 32 new ones through the captured
               decode program and eagerly, as rwkv_decode (the RG-LRU state
               a result copied back into the donated cache), 8
               decode-attention launches (hd 256) and 68 tri-LoRA forwards
               a step, ms a step; then 3 layers in f32, 2 x 64 tokens:
               decode against
               the forward's logits at rtol = atol = 2e-3
  whisper_train  ``steps.make_train_step`` on whisper-small whole (12 + 12
               layers, bf16, f32 adapters, flash): 4 x 4096 decoder tokens
               (train_4k's batch 256 cut to 4) over 1,500 stub frames, 3
               steps on one batch: a finite loss falling each step, exact
               launches (24 flash forwards, 12 dq, 12 dk/dv, 192 tri-LoRA
               forwards and 69 dx a step: self and cross q/k/v/o, the cross
               wk / wv on the 6,000 encoder rows with no dx; the encoder
               launches nothing), the tri-LoRA routes fwd_route predicts for
               each row count, the 16-byte flash routes
  flash_timing (whisper prefill)  the flash forward at 1 x 32768, 12 / 12
               heads of 64, causal, bf16, held to blockwise_sdpa as the
               prefill_32k row is (with its two stand-ins), beside its
               bound, SDPA and one call of the plain version
  whisper_prefill  ``make_prefill_step`` at 1 x 32768 and 1,500 frames: 12
               flash forwards, 96 tri-LoRA forwards, finite logits, tok/s
  whisper_decode  ``make_serve_step`` at decode_32k, batch 32 (its 128
               cut; 38.7 GB of rings, 1.8 GB of cross K/V filled from the
               encoder): 12 decode-attention and 48 tri-LoRA launches a
               step, every attention call of the first step held to its
               plain version (the ring one tile short must fail that), the
               donated program held to the eager steps as in steps_decode,
               ms a step
  whisper_oracle  whole width, 2 + 2 layers, f32: flash (cross-attention
               on the blockwise tiles) against ref over 1 x 4096 (loss
               1e-4·|loss|, gradients 1e-3 of the largest);
               12 decode steps from a filled cross cache against the
               forward at 2e-3, the adapters off zero but xattn's
  vlm_train    ``make_train_step`` on qwen2-vl-72b at full width, 8 of 80
               layers, 2 x (256 patches + 4096 text tokens) on Qwen2-VL
               position triplets, 3 steps: as whisper_train, with the
               chunked loss (8 chunks of 512 a pass) and flash at a GQA
               group of 8
  vlm_prefill  2 layers, 1 x (32768 + 256): 2 flash forwards, 8 tri-LoRA
               forwards, tok/s, a profile
  vlm_decode   2 layers, decode_32k at batch 128 (34.4 GB of rings),
               positions (t, t, t), as whisper_decode
  vlm_serve    2 layers bf16 through ServeEngine (8 requests of 64 + 16
               from 4 users, 4 slots); then the f32 oracle at 2 layers:
               ServeEngine tokens equal serve_naive's
  vlm_oracle   2 layers, f32, 1 x 4352 on Qwen2-VL triplets: loss and
               adapter gradients under flash and blockwise_cv against ref
  flash_timing also times flash at vlm_train's shape (1 x 4352, 64 / 8
               heads of 128, causal, bf16: rows "vlm train")
Every ``run_federated`` and ``launch.train.run`` job fits and evaluates
through the cached programs (a CUDA graph a signature, captured at first
use and replayed), every scan-engine chunk is one program with the carry
donated, and every ``ServeEngine`` / ``generate`` decode step one with
the KV cache donated; each phase starts with the program caches cleared,
and ``free`` clears them too.  A phase that taps ``loss_fn`` (``moe_train``,
``rg_train``) runs each job twice, captured and then eager under the taps,
and holds the two bitwise.
Every phase's wall seconds follow it on a ``{"phase": "wall"}`` line.
Then one ``{"kernels": [...]}`` line, the card's name and power limit, and
the result line.  Exits non-zero, printing no result, on any failure and
when no CUDA device is present.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2,
                                                               atol=2e-2)}
ATTN_SRC = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
GEMV_SRC = "src/repro_torch/kernels/decode_attention/csrc/grouped_gemv.cu"
ATTN_TPU = "src/repro/kernels/decode_attention/decode_attention.py:57"
GEMV_TPU = "src/repro/kernels/decode_attention/grouped.py:67"
FLASH_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_TPU = {name: f"src/repro/kernels/flash_attention/flash_attention.py:{n}"
             for name, n in (("flash_fwd", 124), ("flash_dq", 176),
                             ("flash_dkv", 214), ("flash_bwd", 255))}
#: (B, S, H, K, hd, causal, window) of the flash kernel cases
FLASH_CASES = (
    (4, 256, 12, 4, 64, True, 0),       # the train phase's shape
    (2, 512, 12, 4, 64, True, 64),      # sliding window
    (4, 200, 12, 4, 64, True, 0),       # ragged: no multiple of the tile
    (2, 256, 12, 4, 64, False, 0),      # non-causal
    (2, 200, 12, 4, 64, False, 0),      # non-causal ragged: keys masked
    (2, 256, 32, 32, 128, True, 0),     # LLaMA-7B heads
    (1, 512, 32, 32, 128, True, 64),
    (2, 200, 32, 32, 128, False, 0),
    (2, 200, 16, 1, 64, True, 0),       # MQA: 16 heads on one KV head
    (1, 512, 8, 1, 128, True, 96),      # a group of 8, window 96
    (2, 256, 32, 8, 120, True, 0),      # h2o-danube-3-4b heads: hd 120
    (2, 200, 32, 8, 120, True, 0),      # ragged
    (2, 200, 32, 8, 120, False, 0),     # non-causal ragged
    (1, 512, 32, 8, 120, True, 96),     # window
    (2, 256, 10, 1, 256, True, 0),      # recurrentgemma-2b heads: hd 256
    (1, 1000, 10, 1, 256, True, 96),    # ragged, window
    (2, 77, 10, 1, 256, False, 0),      # non-causal ragged
    (2, 256, 8, 2, 256, True, 0),       # a group of 4 at hd 256
)
#: the flash cases run again on unaligned views of the same values (the
#: scalar routes): a group of 8 at hd 128, hd 120, and hd 256 (10 on 1)
FLASH_SCALAR_CASES = ((1, 512, 8, 1, 128, True, 96),
                      (2, 200, 32, 8, 120, True, 0),
                      (1, 200, 10, 1, 256, True, 64))
#: flash cases in bf16 only: the h2o_train phase's attention (one 8192-token
#: sequence, window 4096), held to the plain version one KV head at a time,
#: and rg_train's (one 4096-token sequence, hd 256, 10 on 1, window 2048)
FLASH_BF16_CASES = ((1, 8192, 32, 8, 120, True, 4096),
                    (1, 4096, 10, 1, 256, True, 2048))
#: the flash outputs' relative hold: in every 64-row tile along the
#: sequence, RMS(got - want) <= FLASH_REL_TOL * RMS(want), and max |got -
#: want| <= FLASH_REL_TOL * max |want|, with want the plain version in f32
#: on the same inputs.  Under randn inputs a row that averages over 4,096
#: keys is ~0.03 in size, TOL's atol itself; this hold scales with it.
FLASH_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
#: (B, S, H, K, hd, dtype, window) of the timed flash shapes (causal): the
#: train phase's shape, the kernel table's bound shape, then h2o-danube-3-4b
#: heads at h2o_train's shape (bf16, window 4096) and at a 4x256 f32 batch,
#: and recurrentgemma-2b heads (hd 256, 10 on 1) at rg_train's shape (bf16,
#: window 2048)
FLASH_TIMED = ((8, 256, 12, 4, 64, "float32", 0),
               (8, 512, 12, 4, 64, "float32", 0),
               (1, 8192, 32, 8, 120, "bfloat16", 4096),
               (4, 256, 32, 8, 120, "float32", 0),
               (1, 4096, 10, 1, 256, "bfloat16", 2048),
               (1, 4352, 64, 8, 128, "bfloat16", 0))
#: the kernel-table rows of the long FLASH_TIMED shapes: (B, S, H, K, hd)
#: → (row shape, the note's description)
FLASH_TIMED_ROWS = {
    (1, 8192, 32, 8, 120): ("h2o train", "h2o-danube-3-4b heads, 1x8192 "
                            "bf16, window 4096"),
    (1, 4096, 10, 1, 256): ("rg train", "recurrentgemma-2b heads (hd 256, "
                            "10 on 1), 1x4096 bf16, window 2048"),
    (1, 4352, 64, 8, 128): ("vlm train", "qwen2-vl-72b heads (64 on 8, hd "
                            "128), 1x(4096 + 256) bf16, causal")}
#: (B, S, H, K, hd, dtype, seed) of the flash digest cases: hd 64, 128,
#: 120 and 256 cases whose forward and backward outputs' SHA-256 compare
#: two trees (the same seed gives every tree the same inputs; a tree whose
#: kernels refuse a head dim prints the refusal)
FLASH_DIGEST_CASES = ((2, 200, 12, 4, 64, "float32", 31),
                      (2, 200, 12, 4, 64, "bfloat16", 32),
                      (1, 300, 32, 32, 128, "float32", 33),
                      (1, 300, 32, 32, 128, "bfloat16", 34),
                      (2, 200, 32, 8, 120, "float32", 35),
                      (2, 200, 32, 8, 120, "bfloat16", 36),
                      (1, 300, 10, 1, 256, "float32", 37),
                      (1, 300, 10, 1, 256, "bfloat16", 38))
#: the flash kernels (all, then the backward's two) whose share of device
#: time the training profiles report
FLASH_SHARES = ("flash_", "bwd::flash_")
TRI_LORA_SRC = "src/repro_torch/kernels/tri_lora/csrc/tri_lora.cu"
TRI_LORA_TPU = {name: f"src/repro/kernels/tri_lora/tri_lora.py:{n}"
                for name, n in (("tri_lora_fwd", 55), ("tri_lora_dx", 107),
                                ("tri_lora_dw", 154))}
#: (M, K, N, r) of the tri-LoRA cases: the JAX package's kernel-test shapes,
#: the training shapes of fed-100m wq/wo and wk/wv, a ragged shape, and M
#: that dW splits into clusters of 7 (ragged last split) and 3 blocks; the
#: decode shapes (LLaMA-7B width, bf16 only) follow
TRI_LORA_CASES = ((64, 64, 64, 4), (96, 160, 130, 8), (32, 256, 64, 16),
                  (128, 64, 192, 2), (2048, 768, 768, 8),
                  (2048, 768, 256, 8), (77, 100, 130, 16),
                  (2000, 768, 512, 8), (800, 256, 192, 8))
TRI_LORA_DECODE = ((1, 4096, 4096, 8), (8, 4096, 4096, 8))
#: (label, kernel, M, K, N, r, dtype of x/W/g, dtype of the adapters) at
#: which the tri-LoRA kernels are timed: the training shapes of fed-100m
#: (wq/wo and wk/wv, f32) and the rwkv6-1.6b prefill (8x512
#: tokens) and decode (8 rows) shapes of the time mix (bf16, f32 adapters
#: as rwkv_params makes them)
TRI_LORA_TIMED = (
    ("wq", "tri_lora_fwd", 2048, 768, 768, 8, "float32", "float32"),
    ("wq", "tri_lora_dx", 2048, 768, 768, 8, "float32", "float32"),
    ("wq", "tri_lora_dw", 2048, 768, 768, 8, "float32", "float32"),
    ("wk/wv", "tri_lora_fwd", 2048, 768, 256, 8, "float32", "float32"),
    ("wk/wv", "tri_lora_dx", 2048, 768, 256, 8, "float32", "float32"),
    ("wk/wv", "tri_lora_dw", 2048, 768, 256, 8, "float32", "float32"),
    ("rwkv prefill", "tri_lora_fwd", 4096, 2048, 2048, 8, "bfloat16",
     "float32"),
    ("rwkv decode", "tri_lora_fwd", 8, 2048, 2048, 8, "bfloat16", "float32"),
)
#: (label, groups, rows per group index, K, N, r) of the grouped tri-LoRA
#: cases (one adapter per client; row i applies groups[i // rows]): the
#: train_vmap shapes (4 clients x 8 sequences of 256 tokens, fed-100m
#: wq/wo and wk/wv), 3 clients of 100 rows (tiles straddle two clients),
#: sequences of 40 tokens with repeated and masked (-1) groups, and one row
#: per group index
TRI_LORA_GROUPED = (
    ("train_vmap wq", [i // 8 for i in range(32)], 256, 768, 768, 8),
    ("train_vmap wk/wv", [i // 8 for i in range(32)], 256, 768, 256, 8),
    ("straddling", [0, 1, 2], 100, 96, 130, 8),
    ("masked", [0, 0, 1, -1, 2, 1], 40, 64, 72, 4),
    ("rows of one", [2, 0, 1, -1, 0, 2, 1, 1], 1, 128, 96, 8),
)
#: a bf16 grouped forward that the wgmma route takes (256 rows a client)
TRI_LORA_GROUPED_WGMMA = ("wgmma", [0, 1, 2, 3], 256, 512, 512, 8)
#: the grouped timing shapes: train_vmap's (4 clients, 32 sequences)
TRI_LORA_GROUPED_TIMED = (
    ("train_vmap wq", "tri_lora_fwd_grouped", 768, 768),
    ("train_vmap wq", "tri_lora_dx_grouped", 768, 768),
    ("train_vmap wk/wv", "tri_lora_fwd_grouped", 768, 256),
    ("train_vmap wk/wv", "tri_lora_dx_grouped", 768, 256),
)
#: the grouped tri-LoRA launch and route counts of a path that runs one
#: adapter per projection (none of them)
NO_GROUPED = {"tri_lora_fwd_grouped": 0, "tri_lora_dx_grouped": 0}
NO_GROUPED_ROUTES = {"fwd_grouped_wgmma": 0, "fwd_grouped_simt": 0}
WKV6_SRC = "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu"
WKV6_TPU = "src/repro/kernels/rwkv6/rwkv6.py:79"
#: (B, T, H, hd) of the wkv6 cases in f32 with a non-zero state: the JAX
#: package's kernel-test shapes (tests/test_kernels.py), T = 1, and hd 64
#: at a T that is no multiple of the 32-step chunk
WKV6_CASES = ((2, 64, 2, 16), (2, 80, 2, 16), (2, 33, 1, 8),
              (2, 128, 4, 32), (2, 1, 2, 64), (2, 77, 3, 64))
#: (B, T, H, hd) of the wkv6 cases in the model's types (bf16 r/k/v/u, f32
#: w): head dims that leave part of the kernel's 64 columns and keys empty
#: (17 on the scalar staging route) or none, at T of one step, within the
#: 32-step chunk and one past a multiple of it
WKV6_EDGE = tuple((2, t, 3, hd) for hd in (17, 48, 64)
                  for t in (1, 15, 17, 513))
#: the rwkv6-1.6b prefill shape (bf16 r/k/v/u, f32 w), at which the
#: kernel is checked and timed
WKV6_FULL = (8, 512, 32, 64)
#: the rwkv phases' jobs: a prefill of 8 sequences of 512 tokens, a decode
#: of 8 prompts of 32 tokens and 32 new ones, and the f32 oracle at 2
#: layers over 2 sequences of 200 tokens (ragged against 32 and 64)
RWKV_PREFILL = dict(batch=8, seq=512)
RWKV_DECODE = dict(batch=8, prompt_len=32, gen=32)
RWKV_ORACLE = dict(layers=2, batch=2, seq=200)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

#: the stream hold of time_ms, in clock cycles (~30 ms at H100 clocks), and
#: the most it is doubled to before a run that leaves the device a gap fails
HOLD_CYCLES = 60_000_000
HOLD_MAX_X = 16
#: [hold, calls] of each time_ms run since the last :func:`holds_used`, the
#: hold as a multiple of HOLD_CYCLES; negative where the device may have
#: waited for the host even at the largest hold (a plain version, its host
#: time included)
HOLDS: list = []


def time_ms(torch, fn, inputs, iters: int = 60, *,
            plain: bool = False) -> float:
    """Device time of one ``fn(*inputs[i])`` call, cycling through
    ``inputs`` (copies that together exceed the 50 MB L2, so each call reads
    its operands from device memory as the serving path does).  A sleep
    kernel holds the stream while the host enqueues the calls, so the
    events time the device and not the host's launch rate.  An event marks
    the end of each call on the stream; once a call is enqueued, the mark
    of the call before it (the hold's end, for the first) must still be
    pending.  If the device has reached it, the device may have waited for
    the host between the two calls: a gap.  The host may also block on the
    full launch queue before the hold ends (a call of many launches); the
    marks of the calls just before stay pending, so that is no gap.  On a
    gap the run is repeated with twice the hold and half the calls (at
    least 8), up to HOLD_MAX_X times HOLD_CYCLES, and fails beyond that.
    A ``plain`` version (a yardstick of correctness, not of speed) is timed
    all the same, its host time included, and its hold recorded as
    negative.  The hold and the calls used are appended to HOLDS."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    hold, calls = 1, iters
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        marks = [torch.cuda.Event() for _ in range(calls)]
        torch.cuda._sleep(HOLD_CYCLES * hold)
        start.record()
        gap, last = False, start
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
            gap = gap or last.query()       # the device got there first
            marks[i].record()
            last = marks[i]
        end.record()
        torch.cuda.synchronize()
        if not gap or (plain and hold == HOLD_MAX_X):
            HOLDS.append([-hold if gap else hold, calls])
            return start.elapsed_time(end) / calls
        require(hold < HOLD_MAX_X,
                f"the device reached the end of a call before the host had "
                f"enqueued the next, even behind a "
                f"{HOLD_MAX_X}x{HOLD_CYCLES}-cycle hold")
        hold, calls = 2 * hold, max(min(8, iters), calls // 2)


def holds_used() -> list:
    """The [hold, calls] of the time_ms runs since the last call,
    emptied."""
    used = list(HOLDS)
    HOLDS.clear()
    return used


def phase_hold_check(torch, dev) -> None:
    """time_ms's gap test on two calls of known kind: a small kernel and
    then 2 ms on the host (the device waits for the host, so the hold must
    grow), and a 4096x4096 f32 matmul (the host keeps ahead of the device
    at the first hold)."""
    x = torch.zeros(1 << 20, device=dev)
    a = torch.randn(4096, 4096, device=dev)

    def host_bound(x):
        x.add_(1)
        time.sleep(2e-3)
    host_ms = time_ms(torch, host_bound, [(x,)])
    device_ms = time_ms(torch, lambda a: a @ a, [(a,)])
    holds = holds_used()
    emit({"phase": "hold_check", "host_bound_ms": host_ms,
          "device_bound_ms": device_ms, "stream_hold_x": holds})
    require(holds[0][0] > 1, f"time_ms saw no gap in a host-bound run: "
                             f"{holds[0]}")
    require(holds[1] == [1, 60], f"time_ms saw a gap in a device-bound "
                                 f"run: {holds[1]}")


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(160e6 / max(nbytes, 1)))


def compare(torch, got, want, dtype_name):
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype_name]
    bad = err > tol["atol"] + tol["rtol"] * want.float().abs()
    return float(err.max()), int(bad.sum())


def compare_scaled(torch, got, want, dtype_name):
    """As :func:`compare`, with the absolute part scaled by the reference's
    largest entry (how tests/test_kernels.py holds a gradient)."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = TOL[dtype_name]["rtol"]
    scale = max(1.0, float(want.abs().max()))
    return float(err.max()), int((err > tol * scale + tol * want.abs()).sum())


def digest(torch, *ts) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes, in
    order: equal digests mean bitwise-equal outputs."""
    import hashlib
    h = hashlib.sha256()
    for x in ts:
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def moved_adapter(torch, adapter, gen):
    """C = I + 0.05·N, B = 0.01·N (as card_vs_cpu): every factor of the
    adapter then has a gradient."""
    from repro_torch.core.tri_lora import is_adapter
    from repro_torch.tree import tree_map

    def noise(t, scale):
        return scale * torch.randn(t.shape, generator=gen, device=t.device)
    return tree_map(lambda a: {"A": a["A"], "C": a["C"] + noise(a["C"], 0.05),
                               "B": noise(a["B"], 0.01)},
                    adapter, is_leaf=is_adapter)


def lm_batch(torch, vocab: int, b: int, s: int, seed: int, dev) -> dict:
    import numpy as np
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
            "labels": torch.as_tensor(toks[:, 1:], device=dev)}


def random_params(torch, model, cfg, dev, seed: int) -> dict:
    """Random params of ``cfg`` on the card, the adapters moved off their
    zero-delta init."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        params = model.init_params(cfg, gen)
        params["adapter"] = moved_adapter(torch, params["adapter"], gen)
    return params


def free(torch) -> None:
    """Drop every cached program (its anchors, static buffers and graph
    memory pool), collect garbage and return cached memory to the card."""
    from repro_torch.core import jit_cache
    jit_cache.clear_all()
    gc.collect()
    torch.cuda.empty_cache()


def grad_gaps(torch, got, want) -> dict:
    """Per leaf path of two gradient trees: the largest |difference| over
    the leaf's largest entry, worst first."""
    from repro_torch.tree import tree_leaves, tree_map_with_path
    paths = tree_leaves(tree_map_with_path(
        lambda p, _: "/".join(map(str, p)), want))
    gaps = {k: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for k, a, b in zip(paths, tree_leaves(got), tree_leaves(want),
                               strict=True)}
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def row_rel(torch, got, want) -> tuple:
    """(largest over rows (dim 0) of RMS(got - want) / RMS(want) in the
    row, max |got - want| / max |want|), against the f32 ``want``: a row
    whose reference is small is held as tightly as one whose reference is
    large."""
    want = want.float()
    err = got.float() - want
    e2 = err.reshape(err.shape[0], -1).pow(2).sum(1)
    w2 = want.reshape(want.shape[0], -1).pow(2).sum(1)
    row = (math.inf if bool(((w2 == 0) & (e2 > 0)).any())
           else float((e2 / w2.clamp_min(1e-30)).sqrt().max()))
    return row, float(err.abs().max()) / max(float(want.abs().max()), 1e-30)


def grad_rel(torch, got, want) -> float:
    """|got - want| / |want| over all leaves of two gradient trees (the
    2-norm of the whole tree)."""
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(got), tree_leaves(want)
    e2 = sum(float((a.float() - b.float()).pow(2).sum())
             for a, b in zip(la, lb, strict=True))
    w2 = sum(float(b.float().pow(2).sum()) for b in lb)
    return math.sqrt(e2 / max(w2, 1e-300))


def same_bits(torch, a, b) -> bool:
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(build):
    t0 = time.perf_counter()
    built = build.build_all()
    info = {}
    for name, b in built.items():
        regs = [ln.split("Used ")[1].split(",")[0] for ln in b.log.splitlines()
                if "Used " in ln]
        spills = [ln for ln in b.log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        info[name] = {"seconds": round(b.seconds, 3), "registers": regs,
                      "spill_lines": spills}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "kernels": info})


#: (B, H, K, hd, ring, idx) of the decode-attention cases: LLaMA-7B width
#: (ragged with a masked row and a wrapped ring; a scalar idx), 12/4 GQA,
#: then h2o-danube-3-4b's heads (32/8, hd 120) over its 4,096 ring and
#: recurrentgemma-2b's (10/1, hd 256) over 2,048 (the split route), each
#: ragged with a masked row
ATTN_CASES = (
    (8, 32, 32, 128, 160, [5, 200, -1, 159, 0, 77, 100, 158]),
    (8, 32, 32, 128, 160, 37),
    (4, 12, 4, 64, 100, [5, 140, -1, 99]),
    (8, 32, 8, 120, 4096, [5, 5000, -1, 4095, 0, 2047, 3000, 4094]),
    (8, 10, 1, 256, 2048, [2047, -1, 0, 100, 9000, 1500, 2046, 31]),
)


def attn_cases(torch, ops, ref, dev):
    """Kernel vs plain version on every ATTN_CASES case, f32 and bf16:
    masked rows exactly zero, a second call bitwise equal, the 16-byte
    route."""
    g = torch.Generator(device=dev).manual_seed(1)
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for (b, h, kh, hd, ring, idx) in ATTN_CASES:
            def rn(*s):
                return torch.randn(s, generator=g, device=dev).to(dt)
            q, k, v = rn(b, 1, h, hd), rn(b, ring, kh, hd), rn(b, ring, kh, hd)
            idx_t = torch.tensor(idx, dtype=torch.int32, device=dev)
            ops.reset_launches()
            got = ops.decode_attention(q, k, v, idx_t)
            again = ops.decode_attention(q, k, v, idx_t)
            torch.cuda.synchronize()
            routes = {k_: n for k_, n in ops.ROUTES.items() if n}
            want = ref.decode_attention_ref(q, k, v, idx_t)
            err, nbad = compare(torch, got, want, dt_name)
            masked = [i for i, x in enumerate(torch.atleast_1d(idx_t).tolist())
                      if x < 0]
            zero = all(bool((got[i] == 0).all()) for i in masked)
            same = bool(torch.equal(got, again))
            plan = ops.attn_plan(b, kh, h // kh, ops.attn_capacity(dev))
            case = dict(b=b, h=h, kh=kh, hd=hd, ring=ring,
                        idx=idx if isinstance(idx, int) else "ragged")
            emit({"phase": "kernels", "kernel": "decode_attention",
                  "dtype": dt_name, **case, "plan": plan, "routes": routes,
                  "max_abs_err": err, "n_out_of_tol": nbad,
                  "masked_rows_zero": zero, "bitwise_repeatable": same,
                  "tol": TOL[dt_name]})
            require(nbad == 0 and zero and same
                    and routes == {"attn_vec": 2},
                    f"decode_attention disagrees with its plain version: "
                    f"{case} {dt_name} err={err} bad={nbad} zero={zero} "
                    f"repeatable={same} routes={routes}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
            del q, k, v, want, got, again
    return worst


#: (K, N, rows, unaligned) of the grouped-GEMV cases, r=8 over m=8 bank
#: rows: the serving widths (K=N=4096 and K=11008), 1 and 17 rows, ragged
#: K/N (odd N, 20 rows), 40 rows (two 32-row groups), and W as a column
#: slice one element past a 16-byte boundary (the scalar route)
GEMV_CASES = (
    (4096, 4096, [0, 2, -1, 1, 7, 7, 3, 5], False),
    (11008, 4096, [0, 2, -1, 1, 7, 7, 3, 5], False),
    (4096, 4096, [6], False),
    (4096, 4096, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0, 1, 2, 3, 4, 5, 6, 7], False),
    (300, 71, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0] * 2, False),
    (4096, 4096, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0] * 4, False),
    (4096, 4096, [0, 2, -1, 1, 7, 7, 3, 5], True),
    (1000, 520, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0, 1, 2, 3, 4, 5, 6, 7], True),
)


def gemv_cases(torch, ops, ref, dev):
    """Kernel vs plain version on every GEMV_CASES case, f32 and bf16:
    masked rows exactly zero, a second call bitwise equal, the route the
    operands' alignment gives."""
    g = torch.Generator(device=dev).manual_seed(2)
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for (kk, n, rows, unaligned) in GEMV_CASES:
            m, r = 8, 8
            x = torch.randn((len(rows), kk), generator=g, device=dev).to(dt)
            w = (torch.randn((kk, n), generator=g, device=dev)
                 / math.sqrt(kk)).to(dt)
            if unaligned:                    # a column slice of a wider W
                wide = torch.zeros((kk, n + 9), dtype=dt, device=dev)
                wide[:, 1:n + 1] = w
                w = wide[:, 1:n + 1]
            a = torch.randn((m, kk, r), generator=g, device=dev) / math.sqrt(r)
            c = torch.eye(r, device=dev) + 0.1 * torch.randn(
                (m, r, r), generator=g, device=dev)
            bb = 0.02 * torch.randn((m, r, n), generator=g, device=dev)
            rows_t = torch.tensor(rows, dtype=torch.int32, device=dev)
            ops.reset_launches()
            got = ops.grouped_dense(rows_t, x, w, a, c, bb, scaling=2.0)
            again = ops.grouped_dense(rows_t, x, w, a, c, bb, scaling=2.0)
            torch.cuda.synchronize()
            routes = {k_: v for k_, v in ops.ROUTES.items() if v}
            want = ref.grouped_gemv_ref(rows_t, x, w, a, c, bb, scaling=2.0)
            err, nbad = compare(torch, got, want, dt_name)
            zero = bool((got[rows_t < 0] == 0).all())
            same = bool(torch.equal(got, again))
            size = x.element_size()
            route = ("gemv_vec" if not unaligned and kk * size % 16 == 0
                     and n * size % 16 == 0 else "gemv_scalar")
            plan = ops.gemv_plan(len(rows), kk, n, x.element_size(),
                                 ops._sms(dev.index or 0))
            case = dict(rows=len(rows), k=kk, n=n, r=r, m=m,
                        unaligned_w=unaligned)
            emit({"phase": "kernels", "kernel": "grouped_gemv",
                  "dtype": dt_name, **case, "plan": plan, "routes": routes,
                  "max_abs_err": err, "n_out_of_tol": nbad,
                  "masked_rows_zero": zero, "bitwise_repeatable": same,
                  "tol": TOL[dt_name]})
            require(nbad == 0 and zero and same and routes == {route: 2},
                    f"grouped_gemv disagrees with its plain version: {case} "
                    f"{dt_name} err={err} bad={nbad} zero={zero} "
                    f"repeatable={same} routes={routes}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
    return worst


#: (B, H, K, hd, ring) at which decode attention is timed: the serving
#: path's call (every ring of 160 full, the most a serve step reads), and
#: h2o-danube-3-4b's heads over full rings of 4,096 (the split route);
#: tools/time_decode.py also times recurrentgemma-2b's (10 on 1, hd 256)
ATTN_TIMED = {"serve": (8, 32, 32, 128, 160),
              "long ring": (8, 32, 8, 120, 4096),
              "decode 32k": (128, 32, 8, 120, 4096),
              "mqa hd 256": (8, 10, 1, 256, 2048)}


def attn_timed_sets(torch, dev, b, h, kh, hd, ring, gen):
    """bf16 (q, k, v, idx, mask) copies that together exceed the L2, every
    ring full; the mask is SDPA's."""
    sets = []
    for _ in range(copies_for(2 * b * ring * kh * hd * 2)):
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                   for s in ((b, 1, h, hd), (b, ring, kh, hd),
                             (b, ring, kh, hd)))
        idx = torch.full((b,), ring - 1, dtype=torch.int32, device=dev)
        valid = (torch.arange(ring, device=dev)[None, :] <= idx[:, None]) | \
            (idx[:, None] >= ring)
        sets.append((q, k, v, idx, valid[:, None, None, :]))
    return sets


def sdpa_decode(F, q, k, v, idx, mask):
    """The library yardstick: one SDPA call over the (B, H, R, hd) views."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=q.shape[2] != k.shape[2])


def time_attention(torch, F, ops, ref, bounds, dev, label: str = "serve"):
    """Decode attention at ``ATTN_TIMED[label]`` in bf16, beside its plain
    version, SDPA and the bound."""
    b, h, kh, hd, ring = ATTN_TIMED[label]
    sets = attn_timed_sets(torch, dev, b, h, kh, hd, ring,
                           torch.Generator(device=dev).manual_seed(3))
    q, k, v, idx, _ = sets[0]
    got = ops.decode_attention(q, k, v, idx)
    err, nbad = compare(torch, got, ref.decode_attention_ref(q, k, v, idx),
                        "bfloat16")
    require(nbad == 0, f"decode_attention at {label}: {nbad} out of "
                       f"tolerance (err {err})")
    n_valid = sum(min(int(i) + 1, ring) for i in idx.tolist())
    row = dict(
        name="decode_attention", route="cuda", source=ATTN_SRC,
        replaces=ATTN_TPU, max_abs_err=err,
        ms=time_ms(torch, lambda q, k, v, i, m: ops.decode_attention(
            q, k, v, i), sets),
        plain_ms=time_ms(torch, lambda q, k, v, i, m: ref.decode_attention_ref(
            q, k, v, i), sets, plain=True),
        library_ms=time_ms(torch, lambda *t: sdpa_decode(F, *t), sets),
        stream_hold_x=holds_used(), shape=f"{label} B={b} H={h} K={kh} "
        f"hd={hd} ring={ring}",
        plan=ops.attn_plan(b, kh, h // kh, ops.attn_capacity(dev)),
        **bound(bounds.decode_attention(b, h, kh, hd, n_valid, "bfloat16")))
    del sets
    torch.cuda.empty_cache()
    return row


def gemv_timed_sets(torch, dev, gen):
    """The serving path's call: the bank GEMV of ``wq`` at LLaMA-7B width —
    8 slots of 8 distinct users, K=N=4096 bf16, r=8, m=8; copies that
    together exceed the L2."""
    bsz, kk, n, r, m = GEMV_TIMED
    sets = []
    for _ in range(copies_for(kk * n * 2)):
        x = torch.randn((bsz, kk), generator=gen, device=dev).to(
            torch.bfloat16)
        w = (torch.randn((kk, n), generator=gen, device=dev)
             / math.sqrt(kk)).to(torch.bfloat16)
        a = torch.randn((m, kk, r), generator=gen, device=dev) / math.sqrt(r)
        c = torch.eye(r, device=dev) + 0.1 * torch.randn(
            (m, r, r), generator=gen, device=dev)
        b = 0.02 * torch.randn((m, r, n), generator=gen, device=dev)
        rows = torch.arange(bsz, dtype=torch.int32, device=dev)
        sets.append((rows, x, w, a, c, b))
    return sets


#: (rows, K, N, r, bank rows) of the timed grouped GEMV
GEMV_TIMED = (8, 4096, 4096, 8, 8)


def time_gemv(torch, ops, ref, bounds, dev):
    """The grouped GEMV at GEMV_TIMED beside its plain version, ``x@W``
    alone (a floor: no one PyTorch call computes the function) and the
    bound."""
    bsz, kk, n, r, m = GEMV_TIMED
    sets = gemv_timed_sets(torch, dev,
                           torch.Generator(device=dev).manual_seed(4))
    got = ops.grouped_dense(*sets[0], scaling=2.0)
    err, nbad = compare(torch, got, ref.grouped_gemv_ref(*sets[0],
                                                         scaling=2.0),
                        "bfloat16")
    require(nbad == 0, f"grouped_gemv at the serving shape: {nbad} out of "
                       f"tolerance (err {err})")
    users = len(set(sets[0][0].tolist()))
    return dict(
        name="grouped_gemv", route="cuda", source=GEMV_SRC,
        replaces=GEMV_TPU, max_abs_err=err,
        ms=time_ms(torch, lambda *t: ops.grouped_dense(*t, scaling=2.0), sets),
        plain_ms=time_ms(torch, lambda *t: ref.grouped_gemv_ref(
            *t, scaling=2.0), sets, plain=True),
        library_ms=time_ms(torch, lambda rows, x, w, *_: x @ w, sets),
        stream_hold_x=holds_used(),
        plan=ops.gemv_plan(bsz, kk, n, 2, ops._sms(dev.index or 0)),
        **bound(bounds.grouped_gemv(bsz, kk, n, r, users, "bfloat16")))


# ---------------------------------------------------------------------------
# flash attention: cases and timing
# ---------------------------------------------------------------------------

def flash_inputs(torch, dev, b, s, h, kh, hd, dtype, gen):
    return [torch.randn(sh, generator=gen, device=dev).to(dtype)
            for sh in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd),
                       (b, s, h, hd))]


def unaligned_view(torch, t):
    """t's values in a view whose rows start one element past a 16-byte
    boundary (the backward's scalar route)."""
    buf = torch.empty((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                      device=t.device)
    view = buf[..., 1:]
    view.copy_(t)
    return view


def flash_plain(torch, fa_ref, q, k, v, do, **kw):
    """The plain version's (out, lse) and (dq, dk, dv) in f32, on the
    inputs taken to f32 (the plain version on bf16 inputs gives these
    rounded to bf16); from 4,096 tokens on one KV head (and its query
    heads) at a time, which is the same function with a 1/K of its (S, S)
    intermediates alive at once."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    kh, g = k.shape[2], q.shape[2] // k.shape[2]
    if q.shape[1] < 4096:
        return (fa_ref.flash_attention_fwd_ref(q, k, v, **kw),
                fa_ref.flash_attention_bwd_ref(q, k, v, do, **kw))
    outs, lses, grads = [], [], []
    for j in range(kh):
        qs, ks = slice(j * g, (j + 1) * g), slice(j, j + 1)
        out, lse = fa_ref.flash_attention_fwd_ref(q[:, :, qs], k[:, :, ks],
                                                  v[:, :, ks], **kw)
        outs.append(out)
        lses.append(lse)
        grads.append(fa_ref.flash_attention_bwd_ref(
            q[:, :, qs], k[:, :, ks], v[:, :, ks], do[:, :, qs], **kw))
        torch.cuda.empty_cache()
    return ((torch.cat(outs, 2), torch.cat(lses, 1)),
            tuple(torch.cat(t, 2) for t in zip(*grads)))


def flash_rel(torch, got, want) -> float:
    """The largest, over 64-row tiles of the sequence axis (dim 1), of
    RMS(got - want) / RMS(want) within the tile: a tile whose reference is
    small is held as tightly as one whose reference is large."""
    s = want.shape[1]
    pad = (-s) % 64

    def sq_tiles(x):
        x = torch.nn.functional.pad(x.transpose(0, 1).reshape(s, -1),
                                    (0, 0, 0, pad))
        return x.reshape((s + pad) // 64, -1).pow(2).sum(1)

    want = want.float()
    e2, w2 = sq_tiles(got.float() - want), sq_tiles(want)
    if bool(((w2 == 0) & (e2 > 0)).any()):
        return math.inf
    return float((e2 / w2.clamp_min(1e-30)).sqrt().max())


def hold_flash(torch, got, want, dt_name):
    """(out, dq, dk, dv) against the plain version's f32 ``want``:
    elementwise at TOL against want rounded to the outputs' dtype (what the
    plain version on that dtype gives), and relatively at FLASH_REL_TOL
    (``flash_rel`` and max error over the largest entry).  Returns
    ({name: max_abs_err}, {name: (tile rel RMS, max err / max)}, number
    of failures)."""
    errs, rel, bad = {}, {}, 0
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        errs[name], nbad = compare(torch, g, w.to(g.dtype), dt_name)
        rel[name] = (flash_rel(torch, g, w),
                     float((g.float() - w).abs().max())
                     / max(float(w.abs().max()), 1e-30))
        bad += nbad + sum(x > FLASH_REL_TOL[dt_name] for x in rel[name])
    return errs, rel, bad


def flash_faults(torch, fa_ref, q, k, v, do, want, dt_name, *, causal,
                 window) -> dict:
    """Two stand-ins for a faulty kernel at a windowed shape, each the
    plain version with its outputs rounded to the inputs' dtype: the band
    one 64-key tile short, and channels 96 and up lost (a staging pass
    that skips them).  Each must fail hold_flash's relative hold on every
    one of out, dq, dk and dv; returns each one's (tile rel RMS) and its
    elementwise failures."""
    lost = [t.clone() for t in (q, k, v, do)]
    for t in lost:
        t[..., 96:] = 0
    runs = {"band_one_tile_short": ((q, k, v, do), window - 64),
            "channels_96_up_lost": (lost, window)}
    res = {}
    for name, (ins, win) in runs.items():
        (out, _), grads = flash_plain(torch, fa_ref, *ins, causal=causal,
                                      window=win)
        got = [t.to(q.dtype) for t in (out, *grads)]
        del out, grads
        _, rel, _ = hold_flash(torch, got, want, dt_name)
        res[name] = {"rel": {n: r[0] for n, r in rel.items()},
                     "n_out_of_tol": sum(compare(torch, g, w.to(g.dtype),
                                                 dt_name)[1]
                                         for g, w in zip(got, want))}
        require(all(r[0] > FLASH_REL_TOL[dt_name] for r in rel.values()),
                f"flash_cases: the stand-in {name} passes the relative "
                f"hold: {res[name]}")
        del got
        torch.cuda.empty_cache()
    return res


def flash_cases(torch, fa_ops, fa_ref, dev):
    """Kernels vs plain version: out and lse of the forward, dq/dk/dv of
    the backward, per case and dtype; the forward and the backward again
    on the same inputs, which must give bitwise the same outputs; the
    FLASH_SCALAR_CASES on unaligned views (the scalar routes), and the
    FLASH_BF16_CASES in bf16, where flash_faults shows that the relative
    hold (``hold_flash``) catches a band one tile short and lost channels.
    lse is f32 in both dtypes and is held to the f32 tolerance.  Then the
    SHA-256 of the FLASH_DIGEST_CASES."""
    gen = torch.Generator(device=dev).manual_seed(6)
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        cases = ([(c, "vec") for c in FLASH_CASES]
                 + [(c, "scalar") for c in FLASH_SCALAR_CASES]
                 + [(c, "vec") for c in FLASH_BF16_CASES
                    if dt_name == "bfloat16"])
        for (b, s, h, kh, hd, causal, window), route in cases:
            q, k, v, do = flash_inputs(torch, dev, b, s, h, kh, hd, dt, gen)
            if route == "scalar":
                q, k, v, do = (unaligned_view(torch, t) for t in (q, k, v, do))
            kw = dict(causal=causal, window=window)
            fa_ops.reset_launches()
            out, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
            fwd_sha = [digest(torch, out, lse),
                       digest(torch, *fa_ops.flash_attention_fwd(q, k, v,
                                                                 **kw))]
            grads = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            again = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            routes = dict(fa_ops.ROUTES)
            same = all(torch.equal(x, y) for x, y in zip(grads, again))
            del again
            (want_out, want_lse), want_grads = flash_plain(
                torch, fa_ref, q, k, v, do, **kw)
            want = (want_out, *want_grads)
            errs, rel, bad = hold_flash(torch, (out, *grads), want, dt_name)
            errs["lse"], nbad = compare(torch, lse, want_lse, "float32")
            bad += nbad
            case = dict(b=b, s=s, h=h, kh=kh, hd=hd, causal=causal,
                        window=window)
            faults = (flash_faults(torch, fa_ref, q, k, v, do, want,
                                   dt_name, **kw)
                      if (b, s, h, kh, hd, causal, window) in
                      FLASH_BF16_CASES and dt_name == "bfloat16" else None)
            emit({"phase": "flash_cases", "dtype": dt_name, **case,
                  "routes": routes, "fwd_sha256": fwd_sha[0],
                  "fwd_bitwise_repeatable": fwd_sha[0] == fwd_sha[1],
                  "bwd_bitwise_repeatable": same,
                  "max_abs_err": errs, "rel_err": rel, "n_out_of_tol": bad,
                  "tol": TOL[dt_name], "lse_tol": TOL["float32"],
                  "rel_tol": FLASH_REL_TOL[dt_name],
                  **({"faults": faults} if faults else {})})
            require(bad == 0, f"flash kernels disagree with the plain "
                    f"version: {case} {dt_name} errors {errs}, relative "
                    f"(tile RMS, max over max) {rel}")
            require(fwd_sha[0] == fwd_sha[1], f"flash forward not bitwise "
                    f"repeatable: {case} {dt_name}")
            require(same, f"flash backward not bitwise repeatable: {case} "
                    f"{dt_name}")
            want_routes = {"fwd_vec": 0, "fwd_scalar": 0, "bwd_vec": 0,
                           "bwd_scalar": 0}
            want_routes[f"fwd_{route}"] = 2
            want_routes[f"bwd_{route}"] = 4
            require(routes == want_routes, f"flash routes {routes}, "
                    f"expected {want_routes}: {case} {dt_name}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), *errs.values())
            del q, k, v, do, out, lse, grads, want, want_out, want_lse
            del want_grads
        torch.cuda.empty_cache()
    emit({"phase": "flash_cases", "digests": flash_digests(torch, fa_ops,
                                                           dev)})
    return worst


def flash_digests(torch, fa_ops, dev) -> list:
    """For each FLASH_DIGEST_CASES case (causal, from its own seed): the
    SHA-256 of the forward's (out, lse) and of the backward's (dq, dk, dv),
    so that two trees' kernels can be compared bitwise in one run."""
    lines = []
    for b, s, h, kh, hd, dt_name, seed in FLASH_DIGEST_CASES:
        if hd not in getattr(fa_ops, "HEAD_DIMS", (hd,)):
            lines.append({"hd": hd, "dtype": dt_name, "refused":
                          f"head_dim {hd} not in {fa_ops.HEAD_DIMS}"})
            continue
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = flash_inputs(torch, dev, b, s, h, kh, hd,
                                   getattr(torch, dt_name), gen)
        out, lse = fa_ops.flash_attention_fwd(q, k, v)
        grads = fa_ops.flash_attention_bwd(q, k, v, out, lse, do)
        lines.append({"b": b, "s": s, "h": h, "kh": kh, "hd": hd,
                      "dtype": dt_name, "fwd_sha256": digest(torch, out, lse),
                      "bwd_sha256": digest(torch, *grads)})
    return lines


def flash_timed_sets(torch, fa_ops, dev, b, s, h, kh, hd, gen,
                     dtype: str = "float32", window: int = 0):
    """Copies of (q, k, v, dO, out, lse, delta), causal with ``window``,
    that together exceed the L2, at one FLASH_TIMED shape."""
    one = getattr(torch, dtype).itemsize * (2 * b * s * h * hd
                                            + 2 * b * s * kh * hd)
    sets = []
    for _ in range(copies_for(one)):
        q, k, v, do = flash_inputs(torch, dev, b, s, h, kh, hd,
                                   getattr(torch, dtype), gen)
        out, lse = fa_ops.flash_attention_fwd(q, k, v, window=window)
        sets.append((q, k, v, do, out, lse, fa_ops.softmax_delta(out, do)))
    return sets


def flash_bwd_calls(fa_ops, window: int = 0):
    """The backward as timed, each a function of one set: the dq kernel,
    the dk/dv kernel, and ``flash_attention_bwd`` as the model runs it
    (``softmax_delta``, dq, dk/dv); causal with ``window``."""
    kw = dict(window=window)
    return {
        "flash_dq": lambda q, k, v, do, o, lse, delta:
            fa_ops.flash_attention_dq(q, k, v, do, lse, delta, **kw),
        "flash_dkv": lambda q, k, v, do, o, lse, delta:
            fa_ops.flash_attention_dkv(q, k, v, do, lse, delta, **kw),
        "flash_bwd": lambda q, k, v, do, o, lse, delta:
            fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)}


def sdpa_causal(F, q, k, v, window: int = 0):
    """scaled_dot_product_attention on the model-layout tensors (transposed
    views), causal, grouped-query; with a window, the band as a boolean
    mask (True: attended)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if not window:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    import torch
    pos = torch.arange(q.shape[1], device=q.device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                          enable_gqa=True)


def sdpa_bwd_graphs(torch, F, sets, window: int = 0):
    """One SDPA forward graph per set, and the call that runs its backward
    (all three gradients) again and again."""
    def graph(q, k, v, do, *_):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        return leaves, sdpa_causal(F, *leaves, window), do.transpose(1, 2)
    return [graph(*t) for t in sets], grad_again(torch)


def grad_again(torch):
    """The call that runs a graph's backward again and again."""
    def run(leaves, y, dy):
        torch.autograd.grad(y, leaves, dy, retain_graph=True)
    return run


def time_flash(torch, F, fa_ops, fa_ref, bounds, dev):
    """Causal attention at each FLASH_TIMED shape: each kernel, the
    forward, the backward as the model runs it (``flash_attention_bwd``:
    ``softmax_delta`` + dq + dk/dv) and forward+backward, the plain
    version and SDPA (``enable_gqa=True`` on the model-layout tensors,
    transposed views; ``is_causal=True``, or the band as a boolean mask
    with a window), beside the window-aware bound.  Returns the
    kernel-table rows at the train shape, then at h2o_train's (the keys
    name the shape); dq's and dk/dv's library time is SDPA's backward,
    which computes all three gradients.  At 4,096 tokens and more the
    plain version and SDPA keep one or two sets of (S, S) intermediates
    alive, and every call runs fewer times."""
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for (b, s, h, kh, hd, dt_name, window) in FLASH_TIMED:
        long = s >= 4096
        kw = dict(window=window)
        bwd = flash_bwd_calls(fa_ops, window)
        sets = flash_timed_sets(torch, fa_ops, dev, b, s, h, kh, hd, gen,
                                dt_name, window)
        q, k, v, do, out, lse, delta = sets[0]
        (want_out, _), want = flash_plain(torch, fa_ref, q, k, v, do,
                                          causal=True, **kw)
        fa_ops.reset_launches()
        dq = bwd["flash_dq"](*sets[0])
        dk, dv = bwd["flash_dkv"](*sets[0])
        routes = dict(fa_ops.ROUTES)
        checked, rel, bad = hold_flash(torch, (out, dq, dk, dv),
                                       (want_out, *want), dt_name)
        require(bad == 0, f"the timed kernels disagree with the plain "
                f"version at S={s} hd={hd} {dt_name}: {checked}, relative "
                f"{rel}")
        err = {"flash_fwd": checked["out"], "flash_dq": checked["dq"],
               "flash_dkv": max(checked["dk"], checked["dv"])}
        err["flash_bwd"] = max(err["flash_dq"], err["flash_dkv"])
        del dq, dk, dv, want_out, want
        torch.cuda.empty_cache()

        def plain_graph(q, k, v, do, *_):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            return leaves, fa_ref.flash_attention_ref(*leaves, **kw), do

        iters, plain_iters = (10, 5) if long else (60, 20)
        t = {"flash_fwd": time_ms(torch, lambda q, k, v, *_:
                                  fa_ops.flash_attention_fwd(q, k, v, **kw),
                                  sets, iters),
             **{n: time_ms(torch, fn, sets, iters) for n, fn in bwd.items()},
             "fwd_bwd": time_ms(torch, lambda q, k, v, do, *_:
                                fa_ops.flash_attention_bwd(
                                    q, k, v, *fa_ops.flash_attention_fwd(
                                        q, k, v, **kw), do, **kw), sets,
                                iters),
             "plain_fwd": time_ms(torch, lambda q, k, v, *_:
                                  fa_ref.flash_attention_fwd_ref(q, k, v,
                                                                 **kw),
                                  sets[:1] if long else sets, plain_iters,
                                  plain=True)}
        graphs = [plain_graph(*x) for x in sets[:1 if long else 4]]
        t["plain_bwd"] = time_ms(torch, grad_again(torch), graphs,
                                 plain_iters, plain=True)
        del graphs
        torch.cuda.empty_cache()
        t["plain_fwd_bwd"] = time_ms(torch, lambda q, k, v, do, *_:
                                     fa_ref.flash_attention_bwd_ref(
                                         q, k, v, do, **kw),
                                     sets[:1] if long else sets, plain_iters,
                                     plain=True)
        torch.cuda.empty_cache()
        t["sdpa_fwd"] = time_ms(torch, lambda q, k, v, *_:
                                sdpa_causal(F, q, k, v, window), sets, iters)
        graphs, sdpa_bwd = sdpa_bwd_graphs(torch, F,
                                           sets[:2] if long else sets,
                                           window)
        t["sdpa_bwd"] = time_ms(torch, sdpa_bwd, graphs, iters)
        del graphs
        bd = {"flash_fwd": bounds.flash_fwd(b, h, kh, s, hd, dt_name,
                                            window),
              "flash_dq": bounds.flash_dq(b, h, kh, s, hd, dt_name, window),
              "flash_dkv": bounds.flash_dkv(b, h, kh, s, hd, dt_name,
                                            window),
              "flash_bwd": bounds.flash_bwd(b, h, kh, s, hd, dt_name,
                                            window)}
        bd_ms = {n: x.ms for n, x in bd.items()} | {
            "fwd_bwd": bd["flash_fwd"].ms + bd["flash_bwd"].ms}
        emit({"phase": "flash_timing", "b": b, "s": s, "h": h, "kh": kh,
              "hd": hd, "dtype": dt_name, "causal": True, "window": window,
              "kernel_ms": {n: t[n] for n in ("flash_fwd", "flash_dq",
                                              "flash_dkv", "flash_bwd",
                                              "fwd_bwd")},
              "bound_ms": bd_ms,
              "plain_ms": {"fwd": t["plain_fwd"], "bwd": t["plain_bwd"],
                           "fwd_bwd": t["plain_fwd_bwd"]},
              "sdpa_ms": {"fwd": t["sdpa_fwd"], "bwd": t["sdpa_bwd"]},
              "fwd_over_sdpa_fwd": t["flash_fwd"] / t["sdpa_fwd"],
              "bwd_over_sdpa_bwd": t["flash_bwd"] / t["sdpa_bwd"],
              "routes": routes, "max_abs_err": err, "rel_err": rel,
              "stream_hold_x": holds_used()})
        require(routes == {"fwd_vec": 0, "fwd_scalar": 0, "bwd_vec": 2,
                           "bwd_scalar": 0},
                f"the timed backward took routes {routes}")
        table = (b, s, h, kh, hd) == (8, 256, 12, 4, 64)   # the train shape
        if table or long:
            shape, desc = FLASH_TIMED_ROWS.get((b, s, h, kh, hd),
                                               (None, None))
            new = [dict(name=n, route="cuda", source=FLASH_SRC,
                        replaces=FLASH_TPU[n], max_abs_err=err[n], ms=t[n],
                        plain_ms=t["plain_fwd" if n == "flash_fwd"
                                   else "plain_bwd"],
                        library_ms=t["sdpa_fwd" if n == "flash_fwd"
                                     else "sdpa_bwd"], **bound(bd[n]))
                   for n in ("flash_fwd", "flash_dq", "flash_dkv",
                             "flash_bwd")]
            for r in new[1:3]:
                r["note"] = ("library_ms is SDPA's whole backward (dq, dk "
                             "and dv); compare it with flash_bwd")
            new[3].update(launch_key="flash_dq", note=(
                "softmax_delta + flash_dq + flash_dkv as the model runs "
                "them; launches counts its calls (one dq and one dk/dv "
                "launch each)"))
            if shape:
                for r in new:
                    r["shape"] = shape
                    r["note"] = (r.get("note", "") + "; " + desc).lstrip(
                        "; ")
            rows += new
        del sets
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# tri-LoRA projection: cases and timing
# ---------------------------------------------------------------------------

def tri_lora_inputs(torch, dev, m, k, n, r, dtype, gen):
    """x, W, A, C, B and the cotangent at the JAX package's kernel-test
    scales (tests/test_kernels.py)."""
    def rn(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)
    return (rn((m, k)), rn((k, n), 0.05), rn((k, r), 0.2), rn((r, r), 0.2),
            rn((r, n), 0.2), rn((m, n)))


def tri_lora_cases(torch, tl_ops, tl_ref, dev):
    """The op on the card (forward kernel; dx and dW kernels and the rank-r
    grads through autograd) against the plain forward and the analytic
    backward on the same inputs.  The forward is held to the kernel
    tolerance; each gradient to it with the absolute part scaled by the
    gradient's largest entry (tests/test_kernels.py)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    s = 2.0
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for (m, k, n, r) in TRI_LORA_CASES + (
                TRI_LORA_DECODE if dt_name == "bfloat16" else ()):
            x, w, a, c, b, ct = tri_lora_inputs(torch, dev, m, k, n, r, dt,
                                                gen)
            leaves = [t.detach().requires_grad_(True) for t in (x, w, a, c, b)]
            before = {**tl_ops.LAUNCHES, **tl_ops.ROUTES}
            y = tl_ops.tri_lora_matmul(*leaves, s)
            grads = torch.autograd.grad(y, leaves, ct)
            torch.cuda.synchronize()
            launched = {key: tl_ops.LAUNCHES[key] - before[key]
                        for key in tl_ops.LAUNCHES}
            route = [key for key in tl_ops.ROUTES
                     if tl_ops.ROUTES[key] > before[key]]
            want_y = tl_ref.tri_lora_matmul_ref(x, w, a, c, b, s)
            want = tl_ref.tri_lora_bwd_ref(x, w, a, c, b, ct, s)
            errs, bad = {}, 0
            errs["y"], bad = compare(torch, y.detach(), want_y, dt_name)
            tol = TOL[dt_name]["rtol"]
            for name, got, ref_g in zip(("dx", "dw", "da", "dc", "db"),
                                        grads, want):
                errs[name], out = compare_scaled(torch, got, ref_g, dt_name)
                bad += out
            case = dict(m=m, k=k, n=n, r=r)
            emit({"phase": "tri_lora_cases", "dtype": dt_name, **case,
                  "max_abs_err": errs, "n_out_of_tol": bad, "tol": tol,
                  "launches": launched, "route": route,
                  "dw_splits": tl_ops.dw_plan(m, k, n,
                                              tl_ops.dw_capacity(dev))[0]})
            require(bad == 0, f"tri-LoRA kernels disagree with the plain "
                    f"version: {case} {dt_name} errors {errs}")
            require(launched == {"tri_lora_fwd": 1, "tri_lora_dx": 1,
                                 "tri_lora_dw": 1, **NO_GROUPED},
                    f"tri-LoRA launches {launched} for one forward and "
                    f"backward")
            worst[dt_name] = max(worst.get(dt_name, 0.0), *errs.values())
    for name, x, w, a, c, b, want_route in tri_lora_route_inputs(torch, dev,
                                                                 gen):
        before = dict(tl_ops.ROUTES)
        y = tl_ops.tri_lora_matmul(x, w, a, c, b, s)
        torch.cuda.synchronize()
        route = [key for key in before if tl_ops.ROUTES[key] > before[key]]
        err, bad = compare(torch, y, tl_ref.tri_lora_matmul_ref(
            x, w, a, c, b, s), "bfloat16")
        emit({"phase": "tri_lora_cases", "case": name, "dtype": "bfloat16",
              "m": x.shape[0] * (x.shape[1] if x.dim() == 3 else 1),
              "k": w.shape[0], "n": w.shape[1], "r": b.shape[0],
              "adapter_dtype": str(b.dtype).split(".")[-1],
              "max_abs_err": {"y": err}, "n_out_of_tol": bad,
              "tol": TOL["bfloat16"]["rtol"], "route": route})
        require(bad == 0, f"tri-LoRA forward disagrees with the plain "
                f"version: {name}, error {err}")
        require(route == [want_route], f"{name} took the route {route}, "
                f"not {want_route}")
        worst["bfloat16"] = max(worst["bfloat16"], err)
    return worst


def tri_lora_grouped_inputs(torch, dev, groups, rows, k, n, r, dtype, gen):
    """x, W, the stacked factors A (G,K,r), C, B as strided views of a
    (G, 2, …) stack (a stacked client state's layer 1: client stride
    2·K·r), the cotangent and the int32 groups; at the scales of
    :func:`tri_lora_inputs`."""
    g_n = max(groups) + 1
    m = len(groups) * rows

    def rn(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)
    a, c, b = (rn((g_n, 2) + shape, 0.2)[:, 1]
               for shape in ((k, r), (r, r), (r, n)))
    return (rn((m, k)), rn((k, n), 0.05), a, c, b, rn((m, n)),
            torch.tensor(groups, dtype=torch.int32, device=dev))


def tri_lora_grouped_cases(torch, tl_ops, tl_ref, dev):
    """The grouped op on the card (grouped forward and dx kernels, the dW
    kernel over all rows, the rank-r grads through autograd) against the
    plain grouped forward and backward on the same inputs, f32 and bf16,
    each case's forward on the route ``fwd_route`` names; the tolerances
    of :func:`tri_lora_cases`."""
    gen = torch.Generator(device=dev).manual_seed(18)
    s = 2.0
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        cases = TRI_LORA_GROUPED + ((TRI_LORA_GROUPED_WGMMA,)
                                    if dt_name == "bfloat16" else ())
        for label, groups, rows, k, n, r in cases:
            x, w, a, c, b, ct, gi = tri_lora_grouped_inputs(
                torch, dev, groups, rows, k, n, r, dt, gen)
            leaves = [t.detach().requires_grad_(True) for t in (x, w, a, c, b)]
            before = {**tl_ops.LAUNCHES, **tl_ops.ROUTES}
            y = tl_ops.grouped_tri_lora_matmul(
                leaves[0].reshape(len(groups), rows, k), *leaves[1:], gi, s)
            grads = torch.autograd.grad(y, leaves, ct.reshape(y.shape))
            torch.cuda.synchronize()
            launched = {key: tl_ops.LAUNCHES[key] - before[key]
                        for key in tl_ops.LAUNCHES}
            route = [key for key in tl_ops.ROUTES
                     if tl_ops.ROUTES[key] > before[key]]
            want_route = "fwd_grouped_" + tl_ops.fwd_route(x, w, rows)
            want_y = tl_ref.grouped_tri_lora_matmul_ref(x, w, a, c, b, gi,
                                                        rows, s)
            want = tl_ref.grouped_tri_lora_bwd_ref(x, w, a, c, b, gi, ct,
                                                   rows, s)
            errs = {}
            errs["y"], bad = compare(torch, y.detach().reshape(want_y.shape),
                                     want_y, dt_name)
            for name, got, ref_g in zip(("dx", "dw", "da", "dc", "db"),
                                        grads, want):
                errs[name], out = compare_scaled(torch, got, ref_g, dt_name)
                bad += out
            case = dict(case=label, groups=len(groups), rows=rows, k=k, n=n,
                        r=r)
            emit({"phase": "tri_lora_cases", "grouped": True,
                  "dtype": dt_name, **case, "max_abs_err": errs,
                  "n_out_of_tol": bad, "tol": TOL[dt_name]["rtol"],
                  "launches": launched, "route": route})
            require(bad == 0, f"grouped tri-LoRA kernels disagree with the "
                    f"plain version: {case} {dt_name} errors {errs}")
            require(launched == {"tri_lora_fwd": 0, "tri_lora_dx": 0,
                                 "tri_lora_dw": 1, "tri_lora_fwd_grouped": 1,
                                 "tri_lora_dx_grouped": 1},
                    f"grouped launches {launched} for one forward and "
                    f"backward")
            require(route == [want_route] and (
                label != "wgmma" or want_route == "fwd_grouped_wgmma"),
                    f"{label} took the route {route}, not {want_route}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), *errs.values())
    return worst


def grouped_timed_sets(torch, dev, k, n, gen):
    """Enough copies of (x, w, a, b, p, q, g, groups) at a train_vmap
    projection (f32, r = 8, 4 clients x 8 sequences x 256 tokens) to
    exceed the L2 cache; P and Q as the op makes them (s = 2)."""
    groups = [i // 8 for i in range(32)]
    rows, r, sets = 256, 8, []
    m = len(groups) * rows
    for _ in range(copies_for(4 * (m * k + k * n + m * n))):
        x, w, a, c, b, g, gi = tri_lora_grouped_inputs(
            torch, dev, groups, rows, k, n, r, torch.float32, gen)
        sel = gi.long()
        p = 2.0 * ((x.reshape(32, rows, k) @ a[sel]) @ c[sel])
        q = 2.0 * ((g.reshape(32, rows, n) @ b[sel].transpose(1, 2))
                   @ c[sel].transpose(1, 2))
        sets.append((x, w, a, b, p.reshape(m, r), q.reshape(m, r), g, gi))
    return sets, rows


def time_tri_lora_grouped(torch, tl_ops, bounds, dev):
    """The grouped forward and dx at the train_vmap shapes beside the plain
    version (the per-entry products in f32), the library yardstick (two
    calls: ``mm`` for the big product, ``baddbmm`` adding each client's
    rank-r term) and the bound; each output held to the plain version's.
    Returns the kernel-table rows."""
    gen = torch.Generator(device=dev).manual_seed(19)
    rows_out = []
    for label, name, k, n in TRI_LORA_GROUPED_TIMED:
        sets, rows = grouped_timed_sets(torch, dev, k, n, gen)
        clients = 4
        kernel = {
            "tri_lora_fwd_grouped": lambda x, w, a, b, p, q, g, gi:
                tl_ops.tri_lora_fwd_grouped(x, w, p, b, gi, rows),
            "tri_lora_dx_grouped": lambda x, w, a, b, p, q, g, gi:
                tl_ops.tri_lora_dx_grouped(g, w, q, a, gi, rows)}[name]
        plain = {
            "tri_lora_fwd_grouped": lambda x, w, a, b, p, q, g, gi:
                x @ w + (p.reshape(gi.numel(), rows, -1) @ b[gi.long()])
                .reshape(x.shape[0], -1),
            "tri_lora_dx_grouped": lambda x, w, a, b, p, q, g, gi:
                g @ w.T + (q.reshape(gi.numel(), rows, -1)
                           @ a[gi.long()].transpose(1, 2))
                .reshape(g.shape[0], -1)}[name]
        library = {
            "tri_lora_fwd_grouped": lambda x, w, a, b, p, q, g, gi:
                torch.baddbmm((x @ w).view(clients, -1, w.shape[1]),
                              p.view(clients, -1, p.shape[1]), b),
            "tri_lora_dx_grouped": lambda x, w, a, b, p, q, g, gi:
                torch.baddbmm((g @ w.T).view(clients, -1, w.shape[0]),
                              q.view(clients, -1, q.shape[1]),
                              a.transpose(1, 2))}[name]
        before = dict(tl_ops.ROUTES)
        got = kernel(*sets[0])
        route = [key for key in before if tl_ops.ROUTES[key] > before[key]]
        check = compare if name == "tri_lora_fwd_grouped" else compare_scaled
        err, bad = check(torch, got, plain(*sets[0]), "float32")
        require(bad == 0, f"{name} at the {label} shape disagrees with the "
                f"plain version: {bad} entries out of tolerance, error {err}")
        t = {"kernel": time_ms(torch, kernel, sets),
             "plain": time_ms(torch, plain, sets, plain=True),
             "library": time_ms(torch, library, sets)}
        m, r = sets[0][0].shape[0], 8
        bd = (bounds.tri_lora_matmul_grouped if name == "tri_lora_fwd_grouped"
              else bounds.tri_lora_dx_grouped)(m, k, n, r, clients, 32,
                                               "float32")
        emit({"phase": "tri_lora_timing", "kernel": name, "shape": label,
              "m": m, "k": k, "n": n, "r": r, "clients": clients,
              "sequences": 32, "dtype": "float32", "route": route,
              **{f"{key}_us": 1e3 * v for key, v in t.items()},
              "library": "mm + baddbmm", "bound_us": 1e3 * bd.ms,
              "bound_by": bd.by, "max_abs_err": err, "n_out_of_tol": bad,
              "tol": TOL["float32"]["rtol"],
              "stream_hold_x": holds_used()})
        rows_out.append(dict(name=name, route="cuda", source=TRI_LORA_SRC,
                             replaces=TRI_LORA_TPU[name[:-len("_grouped")]],
                             max_abs_err=err, ms=t["kernel"],
                             plain_ms=t["plain"], library_ms=t["library"],
                             shape=label, **bound(bd)))
        del sets, got
        torch.cuda.empty_cache()
    return rows_out


def tri_lora_route_inputs(torch, dev, gen):
    """Forward cases of the RWKV time mix at rwkv6-1.6b width (bf16, f32
    adapters): the prefill's strided views of one (B,T,5,D) buffer at the
    prefill's 8x512 tokens (M = 4096, row stride 5·D, read in place by
    TMA), the decode rows, and the same values one bf16 element past a
    16-byte boundary (the SIMT route)."""
    d, r = 2048, 8
    mixed = torch.randn((8, 512, 5, d), generator=gen, device=dev).to(
        torch.bfloat16)
    _, w, a, c, b, _ = tri_lora_inputs(torch, dev, 8, d, d, r,
                                       torch.bfloat16, gen)
    a, c, b = a.float(), c.float(), b.float()
    shifted = torch.empty((8 * 512, d + 8), dtype=torch.bfloat16,
                          device=dev)[:, 1:d + 1]
    shifted.copy_(mixed[..., 1, :].reshape(-1, d))
    return (("rwkv_prefill_view", mixed[..., 1, :], w, a, c, b, "fwd_wgmma"),
            ("rwkv_decode_rows", mixed[:, -1, 2, :], w, a, c, b,
             "fwd_wgmma"),
            ("unaligned_view", shifted, w, a, c, b, "fwd_simt"))


def tri_lora_timed_sets(torch, dev, m, k, n, r, dtype, small, gen):
    """Enough copies of (x, w, a, b, p, q, g) to exceed the L2 cache: x, W
    and g in ``dtype``, the adapters in ``small``, P and Q as the op makes
    them (s = 2, rounded to ``dtype``)."""
    dt, st = getattr(torch, dtype), getattr(torch, small)
    sets = []
    for _ in range(copies_for(torch.finfo(dt).bits // 8
                              * (m * k + k * n + m * n))):
        x, w, a, c, b, g = tri_lora_inputs(torch, dev, m, k, n, r, dt, gen)
        a, c, b = (t.float().to(st) for t in (a, c, b))
        p = (2.0 * (x.float() @ a.float()) @ c.float()).to(dt)
        q = (2.0 * (g.float() @ b.float().T) @ c.float().T).to(dt)
        sets.append((x, w, a, b, p, q, g))
    return sets


def tri_lora_calls(torch, tl_ops):
    """The kernel, its plain version (the same products in f32) and one
    PyTorch call computing the same function, per kernel name."""
    def f32(t):
        return t.float()
    kernel = {
        "tri_lora_fwd": lambda x, w, a, b, p, q, g: tl_ops.tri_lora_fwd(
            x, w, p, b),
        "tri_lora_dx": lambda x, w, a, b, p, q, g: tl_ops.tri_lora_dx(
            g, w, q, a),
        "tri_lora_dw": lambda x, w, a, b, p, q, g: tl_ops.tri_lora_dw(x, g)}
    plain = {
        "tri_lora_fwd": lambda x, w, a, b, p, q, g: (
            f32(x) @ f32(w) + f32(p) @ f32(b)).to(x.dtype),
        "tri_lora_dx": lambda x, w, a, b, p, q, g: (
            f32(g) @ f32(w).T + f32(q) @ f32(a).T).to(g.dtype),
        "tri_lora_dw": lambda x, w, a, b, p, q, g: (
            f32(x).T @ f32(g)).to(x.dtype)}
    library = {
        "tri_lora_fwd": lambda x, w, a, b, p, q, g: torch.addmm(
            p @ b.to(p.dtype), x, w),
        "tri_lora_dx": lambda x, w, a, b, p, q, g: torch.addmm(
            q @ a.T.to(q.dtype), g, w.T),
        "tri_lora_dw": lambda x, w, a, b, p, q, g: x.T @ g}
    return kernel, plain, library


def host_us(torch, fn, args, calls: int = 200) -> float:
    """Host time of one enqueued call (no synchronisation inside)."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def time_tri_lora(torch, tl_ops, bounds, dev):
    """Each kernel at each TRI_LORA_TIMED shape beside its plain version,
    one PyTorch library call and the bound, with the route the forward
    took; at the wq shape ``x@w`` alone as a floor; at the decode shape the
    host time of one call (the wgmma route encodes two tensor maps a call).
    Each output is held to the plain version's on the same inputs: the
    forward to the kernel tolerance, dx and dW with its absolute part
    scaled by the largest entry, as in ``tri_lora_cases``; dx and dW must
    give the same bits on a second call.  Returns the kernel-table
    rows."""
    gen = torch.Generator(device=dev).manual_seed(9)
    kernel, plain, library = tri_lora_calls(torch, tl_ops)
    rows = []
    for label, name, m, k, n, r, dtype, small in TRI_LORA_TIMED:
        sets = tri_lora_timed_sets(torch, dev, m, k, n, r, dtype, small, gen)
        before = dict(tl_ops.ROUTES)
        got = kernel[name](*sets[0])
        route = [key for key in before if tl_ops.ROUTES[key] > before[key]]
        check = compare if name == "tri_lora_fwd" else compare_scaled
        err, bad = check(torch, got, plain[name](*sets[0]), dtype)
        require(bad == 0, f"{name} at the {label} shape disagrees with the "
                f"plain version: {bad} entries out of tolerance, error {err}")
        same = name == "tri_lora_fwd" or torch.equal(got,
                                                      kernel[name](*sets[0]))
        require(same, f"{name} at the {label} shape is not bitwise "
                f"repeatable")
        t = {"kernel": time_ms(torch, kernel[name], sets),
             "plain": time_ms(torch, plain[name], sets, plain=True),
             "library": time_ms(torch, library[name], sets)}
        bd = {"tri_lora_fwd": bounds.tri_lora_matmul(m, k, n, r, dtype),
              "tri_lora_dx": bounds.tri_lora_dx(m, k, n, r, dtype),
              "tri_lora_dw": bounds.tri_lora_dw(m, k, n, dtype)}[name]
        line = {"phase": "tri_lora_timing", "kernel": name, "shape": label,
                "m": m, "k": k, "n": n, "r": r, "dtype": dtype,
                "adapter_dtype": small, "route": route,
                **{f"{key}_us": 1e3 * v for key, v in t.items()},
                "bound_us": 1e3 * bd.ms, "bound_by": bd.by,
                "max_abs_err": err, "n_out_of_tol": bad,
                "tol": TOL[dtype]["rtol"], "bitwise_repeatable": same}
        if name == "tri_lora_dw":
            line["splits"] = tl_ops.dw_plan(m, k, n,
                                            tl_ops.dw_capacity(dev))[0]
            line["dw_capacity"] = tl_ops.dw_capacity(dev)
        if label == "wq" and name == "tri_lora_fwd":
            line["x_at_w_floor_us"] = 1e3 * time_ms(
                torch, lambda x, w, *_: x @ w, sets)
        if dtype == "bfloat16" and m <= 64:
            line["host_us"] = host_us(torch, kernel[name], sets[0])
        line["stream_hold_x"] = holds_used()
        emit(line)
        rows.append(dict(name=name, route="cuda", source=TRI_LORA_SRC,
                         replaces=TRI_LORA_TPU[name], max_abs_err=err,
                         ms=t["kernel"], plain_ms=t["plain"],
                         library_ms=t["library"], shape=label, **bound(bd)))
        del sets, got
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# wkv6: cases and timing
# ---------------------------------------------------------------------------

def wkv6_inputs(torch, dev, b, t, h, hd, dtype, gen, s_scale=0.1):
    """r, k, v, u in ``dtype``; w = sigmoid(2·N) in f32; state 0.1·N f32
    (the JAX package's kernel-test distributions)."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    r, k, v = (rn(b, t, h, hd).to(dtype) for _ in range(3))
    w = torch.sigmoid(2 * rn(b, t, h, hd))
    u = (0.5 * rn(h, hd)).to(dtype)
    return r, k, v, w, u, s_scale * rn(b, h, hd, hd)


def wkv6_check(torch, wkv_ops, wkv_ref, ins, plain_ins=None):
    """One op call against ``wkv6_ref`` (on ``plain_ins`` if given: the
    same values laid out contiguously): errors of y and the final state,
    each held to rtol = atol = 1e-4 with the absolute part scaled by the
    reference's largest entry, the launches of the call, and the digests
    of (y, state) from it and from a second call."""
    n0 = wkv_ops.LAUNCHES["wkv6"]
    y, s = wkv_ops.wkv6(*ins)
    torch.cuda.synchronize()
    launched = wkv_ops.LAUNCHES["wkv6"] - n0
    sha = [digest(torch, y, s), digest(torch, *wkv_ops.wkv6(*ins))]
    want = wkv_ref.wkv6_ref(*(plain_ins or ins))
    errs, bad = {}, 0
    for name, got, ref_t in (("y", y, want[0]), ("state", s, want[1])):
        scale = max(1.0, float(ref_t.abs().max()))
        err = (got - ref_t).abs()
        errs[name] = float(err.max())
        bad += int((err > 1e-4 * scale + 1e-4 * ref_t.abs()).sum())
    finite = bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    return errs, bad, launched, finite, sha


def wkv6_cases(torch, wkv_ops, wkv_ref, dev):
    """The kernel against the plain scan on the card: the JAX test shapes,
    T = 1 and a ragged T in f32 with a non-zero state; head dims 17, 48
    and 64 at ragged T in the model's types; extreme decay (w = 1e-6); the
    full prefill shape in the model's types; r, k and v as strided views of
    one (B, T, 3·D) buffer.  Each case twice, bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(14)
    cases = [(f"f32 B={b} T={t} H={h} hd={hd}",
              wkv6_inputs(torch, dev, b, t, h, hd, torch.float32, gen), None)
             for (b, t, h, hd) in WKV6_CASES]
    cases += [(f"bf16 r/k/v/u, f32 w: B={b} T={t} H={h} hd={hd}",
               wkv6_inputs(torch, dev, b, t, h, hd, torch.bfloat16, gen),
               None) for (b, t, h, hd) in WKV6_EDGE]
    b, t, h, hd = 1, 64, 1, 8
    cases.append(("extreme decay w=1e-6", (
        torch.full((b, t, h, hd), 0.5, device=dev),
        torch.full((b, t, h, hd), 0.5, device=dev),
        torch.ones((b, t, h, hd), device=dev),
        torch.full((b, t, h, hd), 1e-6, device=dev),
        torch.zeros((h, hd), device=dev),
        torch.zeros((b, h, hd, hd), device=dev)), None))
    b, t, h, hd = WKV6_FULL
    cases.append((f"bf16 r/k/v/u, f32 w: B={b} T={t} H={h} hd={hd}",
                  wkv6_inputs(torch, dev, b, t, h, hd, torch.bfloat16, gen),
                  None))
    b, t, h, hd = 2, 100, 4, 64
    wide = torch.randn((b, t, 3 * h * hd), generator=gen, device=dev).to(
        torch.bfloat16)
    r, k, v = (wide[..., i * h * hd:(i + 1) * h * hd].view(b, t, h, hd)
               for i in range(3))
    _, _, _, w, u, s0 = wkv6_inputs(torch, dev, b, t, h, hd, torch.bfloat16,
                                    gen)
    cases.append(("strided views of a (B,T,3D) bf16 buffer",
                  (r, k, v, w, u, s0),
                  (r.contiguous(), k.contiguous(), v.contiguous(), w, u, s0)))
    worst, taken = 0.0, set()
    for name, ins, plain in cases:
        before = dict(wkv_ops.ROUTES)
        errs, bad, launched, finite, sha = wkv6_check(torch, wkv_ops,
                                                      wkv_ref, ins, plain)
        route = [key for key in before if wkv_ops.ROUTES[key] > before[key]]
        taken.update(route)
        emit({"phase": "wkv6_cases", "case": name, "route": route,
              "strides": list(ins[0].stride()), "max_abs_err": errs,
              "n_out_of_tol": bad, "launches": launched, "finite": finite,
              "sha256": sha[0], "bitwise_repeatable": sha[0] == sha[1],
              "tol": "rtol=atol=1e-4, atol scaled by the largest entry"})
        require(bad == 0 and finite, f"wkv6 disagrees with wkv6_ref: {name} "
                f"errors {errs}, {bad} out of tolerance, finite={finite}")
        require(sha[0] == sha[1], f"wkv6 not bitwise repeatable: {name}")
        require(launched == 1, f"wkv6 launched {launched} kernels in one "
                f"call ({name})")
        require(route == [f"wkv6_{wkv_ops.route(*ins[:4])}"],
                f"wkv6 took routes {route} ({name})")
        worst = max(worst, *errs.values())
    require(taken == set(wkv_ops.ROUTES),
            f"the wkv6 cases took only the routes {sorted(taken)}")
    return worst


def wkv6_by_batch(torch, wkv_ops, dev, gen) -> dict:
    """The kernel's time in µs at the prefill's T, H and hd for B = 1, 8
    and 32, keyed by B and the launch's block count (one block per
    (b, h))."""
    _, t, h, hd = WKV6_FULL
    out = {}
    for bb in (1, 8, 32):
        ins = wkv6_inputs(torch, dev, bb, t, h, hd, torch.bfloat16, gen)
        out[f"b{bb}_blocks{bb * h}_us"] = 1e3 * time_ms(
            torch, wkv_ops.wkv6, [ins])
    return out


def time_wkv6(torch, wkv_ops, wkv_ref, rwkv, bounds, dev, card: str):
    """The kernel at the rwkv6-1.6b prefill shape (B=8, T=512, H=32,
    hd=64; bf16 r/k/v/u, f32 w and state) beside the corrected bound, the
    op's plain version (the chunk-32 log-space recurrence, what the CPU
    runs) and the plain scan it is held to.  No single PyTorch call
    computes WKV6.  Returns the kernel-table row."""
    b, t, h, hd = WKV6_FULL
    gen = torch.Generator(device=dev).manual_seed(15)
    bd = bounds.wkv6(b, h, t, hd, "bfloat16")
    sets = [wkv6_inputs(torch, dev, b, t, h, hd, torch.bfloat16, gen)
            for _ in range(copies_for(bd.nbytes))]
    y, _ = wkv_ops.wkv6(*sets[0])
    err = float((y - wkv_ref.wkv6_ref(*sets[0])[0]).abs().max())
    ms = time_ms(torch, wkv_ops.wkv6, sets)
    chunked_ms = time_ms(torch, lambda *a: rwkv.wkv_chunked(*a, chunk=32),
                         sets, iters=5, plain=True)
    scan_ms = time_ms(torch, wkv_ref.wkv6_ref, sets, iters=3, plain=True)
    scaling = wkv6_by_batch(torch, wkv_ops, dev, gen)
    emit({"phase": "wkv6_timing", "card": card, "b": b, "t": t, "h": h,
          "hd": hd, "dtypes": "r/k/v/u bf16, w/state/y f32",
          "kernel_us": 1e3 * ms, "bound_us": 1e3 * bd.ms,
          "bound_by": bd.by, "x_bound": ms / bd.ms,
          "plain_chunked32_us": 1e3 * chunked_ms,
          "plain_scan_us": 1e3 * scan_ms, "kernel_by_batch": scaling,
          "library": "no single PyTorch call computes WKV6",
          "max_abs_err": err, "stream_hold_x": holds_used()})
    del sets
    torch.cuda.empty_cache()
    return dict(name="wkv6", route="cuda", source=WKV6_SRC,
                replaces=WKV6_TPU, max_abs_err=err, ms=ms,
                plain_ms=chunked_ms, library_ms=None, **bound(bd))


# ---------------------------------------------------------------------------
# the RWKV-6 family: prefill, decode, oracle
# ---------------------------------------------------------------------------

def rwkv_params(torch, model, cfg, dev, seed, *, perturb_base: bool):
    """Random params drawn on the card from a seeded generator, with the
    adapters moved off their zero-delta init (B = 0.01·N, C = I + 0.05·N).
    With ``perturb_base`` every backbone parameter JAX initialises to zero
    or a constant is moved off it too: the ddlerp lerps and low-rank B,
    the decay base and its low-rank B, the bonus u, so the data-dependent
    decay and the bonus term run."""
    from repro_torch.tree import tree_map_with_path

    gen = torch.Generator(device=dev).manual_seed(seed)

    def noise(t, scale):
        return (scale * torch.randn(t.shape, generator=gen, device=dev)).to(
            t.dtype)

    def move(path, t):
        name = path[-1]
        if name == "B":
            return noise(t, 0.01)
        if name == "C":
            return t + noise(t, 0.05)
        if not perturb_base:
            return t
        if name in ("mu_x", "mu", "u", "mu_k", "mu_r"):
            return t + noise(t, 0.5)
        if name in ("mix_b", "w_b"):
            return t + noise(t, 0.1)
        if name == "w0":
            return (torch.rand(t.shape, generator=gen, device=dev) * 4.5
                    - 4.0).to(t.dtype)
        return t

    with torch.inference_mode():
        params = model.init_params(cfg, gen)
        return tree_map_with_path(move, params)


def phase_rwkv_prefill(torch, wkv_ops, wkv_ref, tl_ops, model, get_config,
                       dev):
    """rwkv6-1.6b at full width and depth, bf16, random weights with
    adapters B ≠ 0: ``model.forward`` over 8×512 tokens with
    ``use_rwkv_kernel=True`` (24 wkv6 and 96 tri-LoRA forward launches),
    the plain path (``wkv_chunked``) on the same tokens, and a profile
    window of one kernel forward.

    Checks: the launches; every wkv6 call of that forward against
    ``wkv6_ref`` on its own inputs (the real activations of all 24
    layers), y and state within 1e-4 with the absolute part scaled by the
    largest entry; and the same weights in f32, where the kernel path's
    logits must match the plain path's within 2e-2 of the largest logit.
    The bf16 logits of the two paths are reported but not held to each
    other: the random bf16 model turns any difference of an f32 sum's
    order into bf16 rounding flips that grow over 24 layers (the plain
    scan and the plain chunked recurrence part by ~50 % of the largest
    logit in bf16, and each bf16 path by ~60 % from the f32 logits).  To
    show that spread on every run, the plain scan also runs the forward
    (``wkv_scan`` in place of ``wkv_chunked``) in f32 and bf16, and its
    distance from the chunked path is reported beside the kernel's."""
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from repro_torch.models import rwkv
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("rwkv6-1.6b")
    job = RWKV_PREFILL
    t0 = time.perf_counter()
    params = rwkv_params(torch, model, cfg, dev, 16, perturb_base=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_weights = sum(t.numel() for t in tree_leaves(params["base"]))
    toks = torch.as_tensor(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (job["batch"], job["seq"])), device=dev)

    def fwd(kernel, p=params, c=cfg):
        return model.forward(c, p["base"], p["adapter"], {"tokens": toks},
                             use_rwkv_kernel=kernel)[0]

    def scan_fwd(p, c):
        """The plain path with the per-step scan in place of the chunked
        recurrence (both plain versions of the same function)."""
        chunked = rwkv.wkv_chunked
        rwkv.wkv_chunked = lambda *a, chunk=64: rwkv.wkv_scan(*a)
        try:
            return fwd(False, p, c)
        finally:
            rwkv.wkv_chunked = chunked

    calls, kernel = [], wkv_ops.wkv6

    def recorded(*ins):                       # keep each call's operands
        out = kernel(*ins)
        calls.append((ins, out))
        return out

    with torch.inference_mode():
        wkv_ops.reset_launches()              # counts of the main path only
        tl_ops.reset_launches()
        wkv_ops.wkv6 = recorded
        try:
            t0 = time.perf_counter()
            logits = fwd(True)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        finally:
            wkv_ops.wkv6 = kernel
        launches = {**wkv_ops.LAUNCHES, **tl_ops.LAUNCHES}
        routes = dict(tl_ops.ROUTES)
        wkv_routes = dict(wkv_ops.ROUTES)
        call_errs, call_bad = [], 0
        for ins, out in calls:
            want = wkv_ref.wkv6_ref(*ins)
            for got, ref_t in zip(out, want):
                scale_c = max(1.0, float(ref_t.abs().max()))
                e = (got - ref_t).abs()
                call_errs.append(float(e.max()) / scale_c)
                call_bad += int((e > 1e-4 * scale_c + 1e-4 * ref_t.abs()).sum())
        del calls, ins, out, want, got, ref_t, e
        torch.cuda.reset_peak_memory_stats()  # without the recorded calls
        t0 = time.perf_counter()
        fwd(True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        wkv_ops.reset_launches()
        plain = fwd(False)
        torch.cuda.synchronize()
        plain_launches = dict(wkv_ops.LAUNCHES)
        t0 = time.perf_counter()
        fwd(False)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd(True)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        cfg32 = cfg.with_overrides(param_dtype="float32")
        p32 = tree_map(lambda a: a.float(), params)
        ref32 = fwd(False, p32, cfg32)
        kern32 = fwd(True, p32, cfg32)
        scan32 = scan_fwd(p32, cfg32)
        del p32
        scan16 = scan_fwd(params, cfg)
    scale = float(ref32.abs().max())
    err32 = float((kern32 - ref32).abs().max())
    scan_err32 = float((scan32 - ref32).abs().max())
    scan_err16 = float((scan16 - plain).abs().max())
    err = float((logits - ref32).abs().max())
    plain_err = float((plain - ref32).abs().max())
    del kern32, ref32, scan32, scan16
    finite = bool(torch.isfinite(logits).all())
    tokens = job["batch"] * job["seq"]
    expected = {"wkv6": cfg.n_layers, "tri_lora_fwd": 4 * cfg.n_layers,
                "tri_lora_dx": 0, "tri_lora_dw": 0, **NO_GROUPED}
    emit({"phase": "rwkv_prefill", "arch": cfg.name, "dtype": cfg.param_dtype,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "hd": cfg.hd, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "weights": n_weights,
          "weight_gb": n_weights * 2 / 1e9, **job, "init_s": init_s,
          "first_wall_s": first_s, "wall_s": wall, "tok_per_s": tokens / wall,
          "plain_wall_s": plain_wall, "plain_tok_per_s": tokens / plain_wall,
          "peak_mem_gb": peak, "launches": launches,
          "expected_launches": expected, "routes": routes,
          "wkv6_routes": wkv_routes,
          "plain_wkv6_launches": plain_launches,
          "wkv6_calls_checked": len(call_errs) // 2,
          "wkv6_calls_max_err_over_max": max(call_errs),
          "wkv6_calls_n_out_of_tol": call_bad,
          "logits_max_abs": scale,
          "f32_kernel_vs_plain_over_max": err32 / scale,
          "f32_scan_vs_plain_over_max": scan_err32 / scale,
          "bf16_scan_vs_plain_over_max": scan_err16 / scale,
          "bf16_kernel_vs_f32_over_max": err / scale,
          "bf16_plain_vs_f32_over_max": plain_err / scale,
          "bf16_kernel_vs_bf16_plain_over_max":
              float((logits - plain).abs().max()) / scale,
          "finite": finite,
          "profile": {"window": "one forward, use_rwkv_kernel=True",
                      **device_split(prof, window_us, 12,
                                     shares=("tri_lora", "wkv6"))}})
    require(launches == expected,
            f"rwkv_prefill launches {launches} != expected {expected}")
    require(routes == {"fwd_wgmma": 4 * cfg.n_layers, "fwd_simt": 0,
                       **NO_GROUPED_ROUTES},
            f"rwkv_prefill forward routes {routes}: every tri-LoRA forward "
            f"of the bf16 prefill must take the wgmma route")
    require(wkv_routes == {"wkv6_vec": cfg.n_layers, "wkv6_scalar": 0},
            f"rwkv_prefill wkv6 routes {wkv_routes}: every wkv6 launch of "
            f"the prefill must take the 16-byte route")
    require(plain_launches == {"wkv6": 0},
            f"the plain path launched {plain_launches}")
    require(finite and tuple(logits.shape) == (job["batch"], job["seq"],
                                               cfg.vocab_size),
            f"prefill logits {tuple(logits.shape)}, finite={finite}")
    require(len(call_errs) == 2 * cfg.n_layers and call_bad == 0,
            f"wkv6 disagrees with wkv6_ref on the forward's own inputs: "
            f"{call_bad} entries out of tolerance over {len(call_errs) // 2} "
            f"calls, worst {max(call_errs)} of the largest entry")
    require(err32 <= 2e-2 * scale, f"f32 kernel and plain logits differ by "
            f"{err32} (largest logit {scale})")
    return launches, params


def generate_graph(torch, serve, cfg, params, prompts, gen: int, counters,
                   dev, job: str) -> dict:
    """``serve.generate`` on ``prompts`` through its cached decode program
    (the main path: the cache donated, one replay a step), then once more
    (the same graph replays on the cache the program holds, zeroed: no
    leaf copied in, and its peak above its start stays under its two live
    logits' bytes plus half a cache, so no second cache is ever alive),
    then under
    ``disable_jit`` with ``model.decode_step`` wrapped to count and time
    every step; held by ``decode_graph`` (the three token tensors equal).
    ``counters`` are the launch counters to read (each reset first).
    Returns the captured run (its ``launches``, ``out``; ``ms_per_step``
    from the second call) and the eager run's ``per_step`` launches and
    ``step_ms``."""
    from repro_torch.core import jit_cache
    from repro_torch.tree import tree_leaves

    def counts():
        return {k: v for c in counters for k, v in c.items()}

    def reset():
        for c in counters:
            for k in c:
                c[k] = 0

    def timed_generate():
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset()
        before = dict(jit_cache.STATS)
        t0 = time.perf_counter()
        out = serve.generate(cfg, params, prompts, gen, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        return {"out": out, "wall": wall, "launches": counts(),
                "steps": prompts.shape[1] + gen - 1, "step_ms": [],
                "programs": program_stats(before), "peak": peak / 1e9,
                "peak_above_start": (peak - start) / 1e9}

    got = timed_generate()
    again = timed_generate()
    per_step, step_ms = [], []
    decode_step = serve.model.decode_step

    def counted(*args, **kw):
        before = counts()
        t = time.perf_counter()
        out = decode_step(*args, **kw)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        per_step.append({k: v - before[k] for k, v in counts().items()})
        return out

    serve.model.decode_step = counted
    try:
        with jit_cache.disable_jit():
            eager = timed_generate()
    finally:
        serve.model.decode_step = decode_step
    eager["step_ms"] = step_ms
    decode_graph(job, got, eager, torch.equal(got["out"], eager["out"])
                 and torch.equal(again["out"], eager["out"]))
    require(again["programs"]["graphs"] == 0
            and again["programs"]["replays"] == again["steps"]
            and again["programs"]["donated_in"] == 0
            and again["launches"] == got["launches"],
            f"{job}: a second generate call did {again['programs']} with "
            f"launches {again['launches']} (one replay a step, no capture, "
            f"no cache copied in)")
    cache_gb = sum(t.numel() * t.element_size() for t in tree_leaves(
        serve.model.init_decode_cache(cfg, prompts.shape[0],
                                      prompts.shape[1] + gen,
                                      device="meta"))) / 1e9
    # a step's replay clones its logits while the last step's are alive
    logits_gb = 2 * prompts.shape[0] * cfg.padded_vocab * 4 / 1e9
    emit({"phase": "decode_graph", "job": f"{job} second call",
          "cache_gb": cache_gb, "two_logits_gb": logits_gb,
          "peak_above_start_gb": {"first": got["peak_above_start"],
                                  "second": again["peak_above_start"]}})
    require(again["peak_above_start"] < logits_gb + 0.5 * cache_gb,
            f"{job}: the second generate call's peak rose "
            f"{again['peak_above_start']} GB above its start; two logits "
            f"take {logits_gb} GB, a cache {cache_gb} GB")
    return {**got, "ms_per_step": 1e3 * again["wall"] / again["steps"],
            "second_wall_s": again["wall"], "eager_wall_s": eager["wall"],
            "per_step": per_step, "eager_step_ms": step_ms}


def phase_rwkv_decode(torch, wkv_ops, tl_ops, serve, get_config, params,
                      dev):
    """``serve.generate`` at full width and depth, bf16: 8 prompts of 32
    tokens and 32 new ones, through the captured decode program (the
    recurrent state a result copied back into the donated cache), held to
    the eager run (``generate_graph``).  Every decode step must launch
    exactly 96 tri-LoRA forward kernels and no wkv6 kernel (decode runs
    the one-step recurrence)."""
    import numpy as np

    cfg = get_config("rwkv6-1.6b")
    job = RWKV_DECODE
    prompts = np.random.default_rng(17).integers(
        0, cfg.vocab_size, (job["batch"], job["prompt_len"]))
    run = generate_graph(torch, serve, cfg, params, prompts, job["gen"],
                         [wkv_ops.LAUNCHES, tl_ops.LAUNCHES, tl_ops.ROUTES],
                         dev, "rwkv_decode")
    out, wall, per_step = run["out"], run["wall"], run["per_step"]
    step_ms = run["eager_step_ms"]
    launches = {k: run["launches"][k] for k in (*wkv_ops.LAUNCHES,
                                                *tl_ops.LAUNCHES)}
    steps = len(per_step)
    want_step = {"wkv6": 0, "tri_lora_fwd": 4 * cfg.n_layers,
                 "tri_lora_dx": 0, "tri_lora_dw": 0,
                 "fwd_wgmma": 4 * cfg.n_layers, "fwd_simt": 0, **NO_GROUPED,
                 **NO_GROUPED_ROUTES}
    srt = sorted(step_ms)
    emit({"phase": "rwkv_decode", "arch": cfg.name, **job, "steps": steps,
          "out_shape": list(out.shape), "wall_s": wall,
          "ms_per_step": run["ms_per_step"],
          "eager_ms_per_step": 1e3 * run["eager_wall_s"] / steps,
          "eager_step_ms_p50": srt[steps // 2],
          "eager_step_ms_p95": srt[int(0.95 * (steps - 1))],
          "programs": run["programs"],
          "tok_per_s": job["batch"] * job["gen"] / run["second_wall_s"],
          "launches": launches, "launches_per_step": want_step,
          "sample": out[0, -8:].tolist()})
    require(tuple(out.shape) == (job["batch"], job["prompt_len"] + job["gen"])
            and steps == job["prompt_len"] + job["gen"] - 1,
            f"generate returned {tuple(out.shape)} after {steps} steps")
    require(all(p == want_step for p in per_step),
            f"decode steps launched {[p for p in per_step if p != want_step][:3]}"
            f" (each step must launch {want_step})")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            "token ids out of range")
    return launches


def phase_rwkv_oracle(torch, wkv_ops, model, get_config, dev):
    """rwkv6-1.6b's full width in f32 at 2 layers, B=2, T=200: the card's
    forward (wkv6 and tri-LoRA kernels) against the CPU's (plain versions)
    on the same parameters within 1e-4 of the largest logit, then
    token-by-token decode on the card against that forward at rtol = atol
    = 2e-3 (tests/test_decode_consistency.py)."""
    import numpy as np

    from repro_torch.tree import tree_map

    job = RWKV_ORACLE
    cfg = get_config("rwkv6-1.6b").with_overrides(n_layers=job["layers"],
                                                  param_dtype="float32")
    params = rwkv_params(torch, model, cfg, dev, 18, perturb_base=True)
    b, t = job["batch"], job["seq"]
    toks = np.random.default_rng(18).integers(0, cfg.vocab_size, (b, t))

    def fwd(where):
        p = tree_map(lambda a: a.to(where), params)
        with torch.inference_mode():
            return model.forward(cfg, p["base"], p["adapter"],
                                 {"tokens": torch.as_tensor(toks,
                                                            device=where)},
                                 use_rwkv_kernel=True)[0].cpu()

    wkv_ops.reset_launches()
    card = fwd(dev)
    card_launches = dict(wkv_ops.LAUNCHES)
    cpu = fwd(torch.device("cpu"))
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max())
    with torch.inference_mode():
        cache = model.init_decode_cache(cfg, b, t, device=dev)
        tok_d = torch.as_tensor(toks, device=dev)
        steps = []
        for i in range(t):
            lg, cache = model.decode_step(
                cfg, params["base"], params["adapter"], cache,
                {"token": tok_d[:, i:i + 1],
                 "positions": torch.full((b, 1), i, dtype=torch.int32,
                                         device=dev)})
            steps.append(lg[:, 0].cpu())
    dec = torch.stack(steps, dim=1)
    dec_err = (dec - card).abs()
    dec_bad = int((dec_err > 2e-3 + 2e-3 * card.abs()).sum())
    emit({"phase": "rwkv_oracle", "arch": cfg.name, "dtype": "float32",
          **job, "d_model": cfg.d_model, "card_wkv6_launches": card_launches,
          "card_vs_cpu_max_abs_err": err, "logits_max_abs": scale,
          "card_vs_cpu_over_max": err / scale,
          "decode_vs_forward_max_abs_err": float(dec_err.max()),
          "decode_n_out_of_tol": dec_bad, "decode_tol": "rtol=atol=2e-3"})
    require(card_launches == {"wkv6": job["layers"]},
            f"the card's forward launched {card_launches}")
    require(err <= 1e-4 * scale, f"card vs CPU logits differ by {err} "
            f"(largest logit {scale})")
    require(dec_bad == 0, f"decode differs from the forward: "
            f"{float(dec_err.max())}, {dec_bad} out of tolerance")


def bound(b) -> dict:
    """The card's least time for this run's inputs (kernels/bounds.py)."""
    return {"bound_ms": b.ms, "bound_by": b.by, "bytes": b.nbytes,
            "flops": b.flops}


def serve_engine(torch, serve, model, random_bank, get_config, dev):
    """LLaMA-7B at full width and depth, bf16, random weights (seed 0) and
    a random bank of 8 users, behind a ServeEngine of 8 slots of 160:
    (cfg, params, bank, engine, seconds to make the weights)."""
    cfg = get_config("celora-llama-7b")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = model.init_params(cfg, gen)
        bank = random_bank(cfg, 8, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = serve.ServeEngine(cfg, params["base"], bank, slots=8, max_len=160,
                            device=dev)
    return cfg, params, bank, eng, init_s


def engine_run(torch, ops, eng, reqs) -> dict:
    """``eng.run(reqs)`` with every decode kernel count set to 0 just
    before it and each step timed (the engine reads the tokens back every
    step anyway): the tokens, launches, routes, steps, wall, step ms, what
    the cached programs did (``program_stats``) and the peak allocation,
    also above the start."""
    from repro_torch.core import jit_cache
    step_ms = []
    step = eng._step

    def timed_step(*args):
        t = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        return out

    eng._step = timed_step
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                      # counts of the main path only
    before = dict(jit_cache.STATS)
    t0 = time.perf_counter()
    try:
        done = eng.run(reqs)
        torch.cuda.synchronize()
    finally:
        eng._step = step
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    srt = sorted(step_ms)
    return {"done": done, "launches": dict(ops.LAUNCHES),
            "routes": dict(ops.ROUTES), "steps": eng.steps, "wall": wall,
            "step_ms": step_ms, "p50": srt[len(srt) // 2],
            "p95": srt[int(0.95 * (len(srt) - 1))],
            "programs": program_stats(before), "peak": peak / 1e9,
            "peak_above_start": (peak - start) / 1e9}


def decode_graph(job: str, got: dict, want: dict, same_tokens: bool) -> None:
    """The decode_graph check of one job: its default run ``got`` (every
    step one replay of its captured decode program) against the same job
    under ``disable_jit`` (``want``, op by op): the same tokens, launches
    and steps, a graph captured and one replay a step, none eager.
    Emits one ``decode_graph`` line: step ms, warm-up and capture seconds
    and peaks, captured against eager."""
    def side(r):
        return {"steps": r["steps"], "wall_s": r["wall"],
                "ms_per_step": 1e3 * r["wall"] / r["steps"],
                "step_ms_p50": r.get("p50"), "step_ms_p95": r.get("p95"),
                "first_step_ms": (r["step_ms"] or [None])[0],
                "graphs": r["programs"]["graphs"],
                "replays": r["programs"]["replays"],
                "warmup_s": r["programs"]["warmup_s"],
                "capture_s": r["programs"]["capture_s"],
                "peak_mem_gb": r["peak"],
                "peak_above_start_gb": r["peak_above_start"]}
    emit({"phase": "decode_graph", "job": job, "tokens_identical": same_tokens,
          "launches_equal": got["launches"] == want["launches"],
          "launches": got["launches"], "captured": side(got),
          "eager": side(want)})
    require(same_tokens, f"decode_graph {job}: the captured run's tokens "
            f"differ from the eager run's")
    require(got["launches"] == want["launches"],
            f"decode_graph {job}: launches {got['launches']} captured, "
            f"{want['launches']} eager")
    require(got["steps"] == want["steps"] > 0
            and got["programs"]["graphs"] >= 1
            and got["programs"]["replays"] == got["steps"]
            and want["programs"]["graphs"] == want["programs"]["replays"]
            == 0,
            f"decode_graph {job}: {got['steps']} steps with "
            f"{got['programs']} captured, {want['steps']} with "
            f"{want['programs']} eager (one replay a step)")


def phase_serve(torch, ops, serve, model, random_bank, get_config, dev):
    """LLaMA-7B at full width and depth, bf16, random weights: every step
    replays the engine's captured decode program, the K/V donated."""
    cfg, params, bank, eng, init_s = serve_engine(torch, serve, model,
                                                  random_bank, get_config,
                                                  dev)
    from repro_torch.tree import tree_leaves
    n_weights = sum(t.numel() for t in tree_leaves(params["base"]))
    reqs = serve.make_requests(bank, 16, prompt_len=128, gen=32,
                               vocab=cfg.vocab_size, seed=0)
    run = engine_run(torch, ops, eng, reqs)
    GRAPH_RUNS["serve"] = dict(run, reqs=reqs)
    done, wall, step_ms = run["done"], run["wall"], run["step_ms"]
    srt = sorted(step_ms)
    launches, routes, steps = run["launches"], run["routes"], run["steps"]
    n_layers, n_targets = cfg.n_layers, len(cfg.lora_targets)
    lens = sorted({len(v) for v in done.values()})
    new_tokens = sum(r.gen for r in reqs)
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.param_dtype,
          "layers": n_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "weights": n_weights,
          "weight_gb": round(n_weights * 2 / 1e9, 3), "users": 8,
          "requests": len(reqs), "finished": len(done), "token_lengths": lens,
          "slots": 8, "prompt_len": 128, "gen": 32, "steps": steps,
          "wall_s": wall, "ms_per_step": 1e3 * wall / steps,
          "step_ms_p50": srt[len(srt) // 2],
          "step_ms_p95": srt[int(0.95 * (len(srt) - 1))],
          "step_ms_max": srt[-1], "first_step_ms": step_ms[0],
          "tok_per_s": new_tokens / wall,
          "slot_tokens_per_s": steps * 8 / wall, "init_s": init_s,
          "launches": launches, "routes": routes,
          "expected_launches": {"grouped_gemv": n_targets * n_layers * steps,
                                "decode_attention": n_layers * steps},
          "programs": run["programs"], "peak_mem_gb": run["peak"]})
    require(len(done) == len(reqs) and lens == [160],
            f"serve finished {len(done)}/{len(reqs)} requests, lengths {lens}")
    require(launches["grouped_gemv"] == n_targets * n_layers * steps
            and launches["decode_attention"] == n_layers * steps,
            f"launch counts {launches} over {steps} steps")
    require(routes["gemv_vec"] == launches["grouped_gemv"]
            and routes["attn_vec"] == launches["decode_attention"],
            f"the serve path left the 16-byte routes: {routes}")
    require(all(bool(((v >= 0) & (v < cfg.vocab_size)).all())
                for v in done.values()), "token ids out of range")
    return launches, (cfg, params, bank, eng)


def device_split(prof, wall_us: float, top: int, shares=()) -> dict:
    """Device time by kernel name over a profiled window, the window's
    wall time and the device's idle share in it; for each substring in
    ``shares``, the share of kernel time of the kernels whose names hold
    it.  ``device_us`` is the time some kernel ran (the union of their
    intervals: a kernel launched as a programmatic dependent overlaps the
    one before it), ``kernel_us_sum`` the sum of their durations."""
    by_name: dict = {}
    spans = []
    for e in prof.events():                   # device-side kernel events
        if getattr(e.device_type, "name", "") != "CUDA":
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        spans.append((e.time_range.start, e.time_range.end))
    rows_out = sorted(((k, us, n) for k, (us, n) in by_name.items()),
                      key=lambda r: -r[1])
    dev_total = sum(us for _, us, _ in rows_out)
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    share = {f"{key}_share": sum(us for k, us, _ in rows_out if key in k)
             / dev_total for key in shares if dev_total}
    return {**share, "wall_us": wall_us,
            "device_us": busy if rows_out else None,
            "kernel_us_sum": dev_total if rows_out else None,
            "device_idle_share": (1 - busy / wall_us)
            if rows_out else None,
            "top": [{"kernel": k[:80], "us": round(t, 1), "count": n}
                    for k, t, n in rows_out[:top]]}


#: the decode kernels whose shares of the serve profile's device time it
#: reports: the GEMV's two kernels (before: its main kernel and down
#: projection), decode attention
SERVE_SHARES = ("grouped_gemv_kernel", "grouped_gemv_combine_kernel",
                "lora_down_kernel",
                "decode_attention_kernel")


def profile_steps(torch, cfg, eng, dev) -> dict:
    """Device time by kernel over 3 steps of ``eng`` with all 8 slots
    active at position 120 (after 2 warm steps, which build the engine's
    program), and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model
    cache = model.init_decode_cache(cfg, 8, 160, device=dev)
    tok = torch.zeros((8, 1), dtype=torch.int32, device=dev)
    rows = torch.arange(8, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for p in range(118, 120):             # warm
            _, cache = eng._step(cache, tok, torch.full(
                (8,), p, dtype=torch.int32, device=dev), rows)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for p in range(120, 123):
                _, cache = eng._step(cache, tok, torch.full(
                    (8,), p, dtype=torch.int32, device=dev), rows)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    return device_split(prof, wall_us, 14, SERVE_SHARES)


def phase_profile(torch, state, dev) -> dict:
    """``profile_steps`` of the serve engine (its captured program);
    emitted and returned."""
    cfg, params, bank, eng = state[:4]
    line = {"phase": "profile", "steps": 3,
            **profile_steps(torch, cfg, eng, dev)}
    emit(line)
    GRAPH_RUNS["serve"]["profile"] = line
    return line


def phase_decode_graph(torch, ops, serve, state, dev) -> None:
    """The serve job again under ``jit_cache.disable_jit()`` (a fresh
    engine on the same weights and bank, every step op by op) against its
    default run (``decode_graph``), and ``profile_steps`` eager beside the
    profile phase's captured steps.  h2o_serve, rwkv_decode and rg_decode
    hold their jobs the same way."""
    from repro_torch.core import jit_cache

    cfg, params, bank, _ = state
    g = GRAPH_RUNS.pop("serve")
    reqs = g["reqs"]
    eng = serve.ServeEngine(cfg, params["base"], bank, slots=8, max_len=160,
                            device=dev)
    with jit_cache.disable_jit():
        eager = engine_run(torch, ops, eng, reqs)
        eager_profile = profile_steps(torch, cfg, eng, dev)
    emit({"phase": "decode_graph", "job": "serve profile",
          "captured": {k: v for k, v in g["profile"].items() if k != "top"},
          "eager": {k: v for k, v in eager_profile.items() if k != "top"}})
    decode_graph("serve", g, eager, sorted(g["done"]) == sorted(
        eager["done"]) and all(np_equal(g["done"][r.rid],
                                        eager["done"][r.rid]) for r in reqs))


def phase_oracle(torch, ops, serve, random_bank, get_config, model, dev):
    """f32, full width, 2 layers: ServeEngine ≡ serve_naive per request."""
    cfg = get_config("celora-llama-7b").with_overrides(
        n_layers=2, param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.inference_mode():
        params = model.init_params(cfg, gen)
        bank = random_bank(cfg, 4, gen)
    reqs = serve.make_requests(bank, 8, prompt_len=16, gen=8,
                               vocab=cfg.vocab_size, seed=1)
    ops.reset_launches()
    eng = serve.ServeEngine(cfg, params["base"], bank, slots=4, max_len=24,
                            device=dev)
    got = eng.run(reqs)
    engine_launches = dict(ops.LAUNCHES)
    want = serve.serve_naive(cfg, params["base"], bank, reqs, device=dev)
    same = [bool(np_equal(got[r.rid], want[r.rid])) for r in reqs]
    emit({"phase": "oracle", "arch": cfg.name, "dtype": "float32",
          "layers": 2, "d_model": cfg.d_model, "users": 4,
          "requests": len(reqs), "slots": 4, "prompt_len": 16, "gen": 8,
          "engine_steps": eng.steps, "engine_launches": engine_launches,
          "token_identical": sum(same),
          "sample": [int(t) for t in got[reqs[0].rid][-8:]]})
    require(all(same) and len(got) == len(reqs),
            f"ServeEngine diverged from serve_naive on "
            f"{[r.rid for r, s in zip(reqs, same) if not s]}")


# ---------------------------------------------------------------------------
# train: CE-LoRA federated rounds on fed-100m
# ---------------------------------------------------------------------------

#: the train phase's job: 4 clients, 3 rounds of 5 local steps of batch 8
#: at sequence 256, 64 train and 32 test sequences per client, 4 classes.
#: lr 1e-3: at 5e-3 AdamW's steps overshoot on the random full-width
#: backbone and the rounds amplify rounding differences (flash and ref then
#: part by ~0.1 in loss by round 1, on the card and with plain PyTorch on
#: both sides on the CPU alike)
TRAIN = dict(clients=4, rounds=3, local_steps=5, batch=8, seq=256,
             n_train=64, n_test=32, classes=4, lr=1e-3)


def train_job(torch, cfg, dev, attn_impl: str, job: dict = TRAIN,
              mode: str = "loop", **fed_kw):
    """``run_federated`` (celora, eager engine, client_parallelism
    ``mode``, the FedConfig fields ``fed_kw`` on top) on ``cfg`` with a
    random backbone; returns (result, wall seconds), the result with the
    run's ``program_stats`` under ``"programs"``."""
    from repro_torch.core import jit_cache
    from repro_torch.core.fed_model import FedTask
    from repro_torch.core.federated import FedConfig, run_federated
    from repro_torch.data import synthetic

    ctrain, ctest, _ = synthetic.make_federated_classification(
        0, job["clients"], job["n_train"], job["n_test"], job["seq"],
        cfg.vocab_size, job["classes"], drift=0.5)
    task = FedTask.create(torch.Generator(device=dev).manual_seed(0), cfg,
                          job["classes"])
    fed = FedConfig(**{**dict(
        method="celora", n_clients=job["clients"], rounds=job["rounds"],
        local_steps=job["local_steps"], batch_size=job["batch"],
        lr=job["lr"], seed=0, client_parallelism=mode,
        attn_impl=attn_impl), **fed_kw})
    before = dict(jit_cache.STATS)
    t0 = time.perf_counter()
    out = run_federated(task, fed, ctrain, ctest, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["programs"] = program_stats(before)
    return out, time.perf_counter() - t0


def train_profile(torch, cfg, dev, job: dict = TRAIN, clients: int = 1,
                  mode: str = "loop"):
    """Device time by kernel and the device's idle share over ``clients``
    clients' local fits of 3 steps and their eval batches (``lora_loc``:
    no server work), run through ``run_federated`` with attn_impl="flash"
    and client_parallelism ``mode``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fed_model import FedTask
    from repro_torch.core.federated import FedConfig, run_federated
    from repro_torch.data import synthetic

    ctrain, ctest, _ = synthetic.make_federated_classification(
        1, clients, job["n_train"], job["n_test"], job["seq"],
        cfg.vocab_size, job["classes"])
    task = FedTask.create(torch.Generator(device=dev).manual_seed(1), cfg,
                          job["classes"])
    fed = FedConfig(method="lora_loc", n_clients=clients, rounds=1,
                    local_steps=3, batch_size=job["batch"], attn_impl="flash",
                    client_parallelism=mode)
    # the same run first: the window holds replays of built programs (and
    # an eager run's warmed allocator), not their capture
    run_federated(task, fed, ctrain, ctest, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_federated(task, fed, ctrain, ctest, device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {"window": f"lora_loc, {clients} client(s), {mode}, 3 local "
                      f"steps + eval",
            **device_split(prof, wall_us, 12,
                           shares=FLASH_SHARES + ("tri_lora",))}


def recomputed(cfg) -> int:
    """The layers whose forward runs again in the backward of a training
    step: with ``cfg.remat`` every layer of the stacked groups
    (``transformer.run_stack`` checkpoints each group; the tail blocks are
    not wrapped), none without it."""
    q, pattern, _ = cfg.stack_plan()
    return q * len(pattern) if cfg.remat else 0


def adapted_per_layer(cfg, kind: str) -> int:
    """Tri-LoRA adapters of one block: the attention projections of
    ``cfg.lora_targets``, twice in an encoder-decoder's decoder block (its
    ``xattn`` takes the same targets), and the MLP's with ``lora_mlp`` on a
    dense MLP; rglru's w_in and w_out, rwkv6's four time-mix
    projections."""
    if kind == "rglru":
        return 2
    if kind == "rwkv6":
        return 4
    mlp = 3 if cfg.lora_mlp and not cfg.is_moe else 0
    return len([t for t in cfg.lora_targets
                if t in ("wq", "wk", "wv", "wo")]) * (
        2 if cfg.enc_dec else 1) + mlp


def step_launches(cfg, steps: int, evals: int = 0,
                  grouped: bool = False) -> dict:
    """The flash and tri-LoRA launches of ``steps`` training steps and
    ``evals`` forward-only passes of a stack of any block kinds: a step
    runs each layer's forward, the forward again for the checkpointed
    group layers (``recomputed``), and the backward.  Each attention layer
    launches flash; each adapted projection (``adapted_per_layer``) the
    tri-LoRA forward with its layer and dx in the backward, except layer
    0's projections that read the frozen embedding (attention's q/k/v,
    rwkv6's r/k/v, rglru's w_in; a vision prefix is frozen too) and every
    cross-attention wk / wv, which read the encoder's output (no adapter
    in the encoder, so no gradient): these need no input gradient; one
    adapter (``tri_lora_*``) or one per client (``grouped``:
    ``tri_lora_*_grouped``).  The encoder launches nothing (plain
    ``sdpa``, plain x@W)."""
    q, pattern, _ = cfg.stack_plan()
    kinds = cfg.kinds()
    again = [cfg.remat and i < q * len(pattern) for i in range(len(kinds))]
    attn = [k in ("attn", "swa") for k in kinds]
    per = [adapted_per_layer(cfg, k) for k in kinds]
    first = {"rglru": 1, "rwkv6": 3}.get(
        kinds[0], len({"wq", "wk", "wv"} & set(cfg.lora_targets)))
    if cfg.enc_dec:                     # xattn wk / wv of every layer
        first += len({"wk", "wv"} & set(cfg.lora_targets)) * len(kinds)
    key = "_grouped" if grouped else ""
    return {"flash_fwd": sum(a * (steps + evals + r * steps)
                             for a, r in zip(attn, again)),
            "flash_dq": sum(attn) * steps, "flash_dkv": sum(attn) * steps,
            "tri_lora_fwd": 0, "tri_lora_dx": 0, "tri_lora_dw": 0,
            **NO_GROUPED,
            f"tri_lora_fwd{key}": sum(p * (steps + evals + r * steps)
                                      for p, r in zip(per, again)),
            f"tri_lora_dx{key}": (sum(per) - first) * steps}


def fed_launches(cfg, hist, job: dict, mode: str) -> dict:
    """The flash and tri-LoRA launches of a ``run_federated`` celora job
    with S^data: the loop path launches per sampled client, the vmap path
    (all clients as one batch) once per projection per local step and one
    eval call per evaluated round.  The S^data feature batches (one per
    client) run the frozen backbone with no adapter: flash, but plain x@W
    projections."""
    if mode == "loop":
        steps = sum(len(r.sampled) for r in hist) * job["local_steps"]
        evals = sum(r.evaluated for r in hist) * job["clients"]
    else:
        steps = len(hist) * job["local_steps"]
        evals = sum(r.evaluated for r in hist)
    out = step_launches(cfg, steps, evals, grouped=mode == "vmap")
    out["flash_fwd"] += cfg.n_layers * job["clients"]
    return out


#: the default runs (through the captured programs) that train_graph holds
#: its eager runs to, by job: the result, launches, wall, peak memory and
#: what the programs did
GRAPH_RUNS: dict = {}


def program_stats(before: dict) -> dict:
    """What the cached programs did since ``before`` (a copy of
    ``jit_cache.STATS``): entries built, graphs captured, replays, warm-up
    and capture seconds; and the entries each program cache holds."""
    from repro_torch.core import fed_engine, federated, jit_cache
    from repro_torch.launch import serve, train
    return {**{k: v - before[k] for k, v in jit_cache.STATS.items()},
            "entries": {"run_federated fit": len(federated._LOCAL_FIT_CACHE),
                        "run_federated eval": len(federated._EVAL_CACHE),
                        "LM fit": len(train._FIT_CACHE),
                        "scan chunk": len(fed_engine._SCAN_CACHE),
                        "generate step": len(serve._DECODE_CACHE)}}


def program_counts(torch, start: int, before: dict) -> dict:
    """``program_stats(before)``, the peak of the memory the caching
    allocator reserved (graph pools included), and the peak allocation
    above ``start`` (the bytes allocated when the run began: what earlier
    phases left alive)."""
    peak = torch.cuda.max_memory_allocated()
    return {"programs": program_stats(before),
            "peak_reserved": torch.cuda.max_memory_reserved() / 1e9,
            "peak_above_start": (peak - start) / 1e9}


def phase_train(torch, fa_ops, tl_ops, get_config, dev):
    """fed-100m at full width and depth through the flash and tri-LoRA
    kernels, then the same job through the plain reference attention on
    the card (its projections still run the tri-LoRA kernels)."""
    from repro_torch.core import jit_cache

    cfg = get_config("fed-100m")
    job = TRAIN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    fa_ops.reset_launches()                   # counts of the main path only
    tl_ops.reset_launches()
    before = dict(jit_cache.STATS)
    out, wall = train_job(torch, cfg, dev, "flash")
    launches = {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
    flash_routes = dict(fa_ops.ROUTES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    GRAPH_RUNS["train"] = dict(out=out, launches=launches, wall=wall,
                               peak=peak,
                               **program_counts(torch, start, before))
    hist = out["history"]
    steps = sum(len(r.sampled) for r in hist) * job["local_steps"]
    layers = cfg.n_layers
    expected = fed_launches(cfg, hist, job, "loop")
    tokens = steps * job["batch"] * job["seq"]
    rounds = [{"round": r.round, "wall_s": r.wall_s,
               "train_loss": r.train_loss, "mean_acc": r.mean_acc,
               "uplink_bytes": r.uplink_bytes,
               "downlink_bytes": r.downlink_bytes} for r in hist]
    prof = train_profile(torch, cfg, dev, job)
    ref, ref_wall = train_job(torch, cfg, dev, "ref")
    emit({"phase": "train", "arch": cfg.name, "dtype": cfg.param_dtype,
          "layers": layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "lora_rank": cfg.lora_rank,
          "method": "celora", "attn_impl": "flash", **job,
          "rounds_detail": rounds, "wall_s": wall,
          "trained_tokens": tokens, "trained_tok_per_s": tokens / wall,
          "round_wall_s_sum": sum(r.wall_s for r in hist),
          "peak_mem_gb": peak, "launches": launches,
          "expected_launches": expected, "flash_routes": flash_routes,
          "profile": prof,
          "ref": {"attn_impl": "ref", "wall_s": ref_wall,
                  "train_loss": [r.train_loss for r in ref["history"]],
                  "mean_acc": [r.mean_acc for r in ref["history"]]}})
    require(launches == expected,
            f"train launches {launches} != expected {expected}")
    require(flash_routes == {"fwd_vec": expected["flash_fwd"],
                             "fwd_scalar": 0, "bwd_vec": 2 * layers * steps,
                             "bwd_scalar": 0},
            f"train flash routes {flash_routes}: every forward, dq and dk/dv "
            f"launch should take the 16-byte route")
    same_run("train flash vs ref", hist, ref["history"])
    losses = [r.train_loss for r in hist]
    require(all(b < a for a, b in zip(losses, losses[1:])),
            f"train loss did not decrease over the rounds: {losses}")
    return launches, out


def same_run(what: str, hist, ref_hist, loss_rtol: float = 1e-3) -> None:
    """Identical ledgers, loss within 1e-3 + loss_rtol·|loss| and
    accuracies within 0.05, round by round (RoundRecords)."""
    for a, b in zip(hist, ref_hist):
        require((a.sampled, a.participants, a.dropped, a.uplink_bytes,
                 a.downlink_bytes, a.uplink_elems)
                == (b.sampled, b.participants, b.dropped, b.uplink_bytes,
                    b.downlink_bytes, b.uplink_elems),
                f"{what} round {a.round}: the ledgers differ")
        require(abs(a.train_loss - b.train_loss)
                <= 1e-3 + loss_rtol * abs(b.train_loss),
                f"{what} round {a.round}: loss {a.train_loss} vs "
                f"{b.train_loss}")
        require(max(abs(x - y) for x, y in zip(a.accs, b.accs)) <= 0.05,
                f"{what} round {a.round}: accs {a.accs} vs {b.accs}")


def phase_train_vmap(torch, fa_ops, tl_ops, get_config, dev, loop_out):
    """The train phase's job with client_parallelism="vmap": the 4 clients
    train as one batch of 32 sequences, so every projection launches the
    grouped tri-LoRA kernels once per local step for all clients and the
    flash kernels run at batch 32; held to the loop run of the same job
    (``loop_out``, from the train phase) and profiled beside the loop path
    over the same work."""
    from repro_torch.core import jit_cache

    cfg = get_config("fed-100m")
    job = TRAIN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    fa_ops.reset_launches()                   # counts of the main path only
    tl_ops.reset_launches()
    before = dict(jit_cache.STATS)
    out, wall = train_job(torch, cfg, dev, "flash", mode="vmap")
    launches = {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
    flash_routes, routes = dict(fa_ops.ROUTES), dict(tl_ops.ROUTES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    GRAPH_RUNS["train_vmap"] = dict(out=out, launches=launches, wall=wall,
                                    peak=peak,
                                    **program_counts(torch, start, before))
    hist = out["history"]
    steps = len(hist) * job["local_steps"]
    layers = cfg.n_layers
    expected = fed_launches(cfg, hist, job, "vmap")
    tokens = (sum(len(r.sampled) for r in hist) * job["local_steps"]
              * job["batch"] * job["seq"])
    profiles = {mode: train_profile(torch, cfg, dev, job, job["clients"],
                                    mode) for mode in ("loop", "vmap")}
    GRAPH_RUNS["train_vmap"]["profiles"] = profiles
    emit({"phase": "train_vmap", "arch": cfg.name, "dtype": cfg.param_dtype,
          "method": "celora", "attn_impl": "flash",
          "client_parallelism": "vmap", **job,
          "rounds_detail": [{"round": r.round, "wall_s": r.wall_s,
                             "train_loss": r.train_loss,
                             "mean_acc": r.mean_acc,
                             "uplink_bytes": r.uplink_bytes,
                             "downlink_bytes": r.downlink_bytes}
                            for r in hist],
          "wall_s": wall, "trained_tokens": tokens,
          "trained_tok_per_s": tokens / wall,
          "round_wall_s_sum": sum(r.wall_s for r in hist),
          "peak_mem_gb": peak, "launches": launches,
          "expected_launches": expected, "routes": routes,
          "flash_routes": flash_routes, "profile": profiles["vmap"],
          "loop_profile": profiles["loop"],
          "loop": {"train_loss": [r.train_loss for r in loop_out["history"]],
                   "mean_acc": [r.mean_acc for r in loop_out["history"]]}})
    require(launches == expected,
            f"train_vmap launches {launches} != expected {expected}")
    require(routes == {"fwd_wgmma": 0, "fwd_simt": 0, "fwd_grouped_wgmma": 0,
                       "fwd_grouped_simt": expected["tri_lora_fwd_grouped"]},
            f"train_vmap forward routes {routes}: every f32 grouped forward "
            f"takes the SIMT route")
    require(flash_routes == {"fwd_vec": expected["flash_fwd"],
                             "fwd_scalar": 0, "bwd_vec": 2 * layers * steps,
                             "bwd_scalar": 0},
            f"train_vmap flash routes {flash_routes}: every launch should "
            f"take the 16-byte route")
    same_run("train_vmap vs loop", hist, loop_out["history"])
    losses = [r.train_loss for r in hist]
    require(all(b < a for a, b in zip(losses, losses[1:])),
            f"train_vmap loss did not decrease over the rounds: {losses}")
    return launches, {"history": hist, "launches": launches, "wall_s": wall,
                      "trained_tok_per_s": tokens / wall,
                      "peak_mem_gb": peak}


#: the lm_train phase's job: the causal-LM driver's call at full width and
#: depth, through the flash kernels, with the int8 uplink codec.  At the
#: driver's lr (3e-3) on the random backbone the rounds amplify rounding:
#: the loop path alone, run twice with only the CPU's thread count (its
#: sum order) changed, parts visibly in loss by round 2, so a vmap run is
#: held to the loop run's loss in round 0 alone (before any aggregation)
LM_TRAIN = dict(arch="fed-100m", clients=4, rounds=3, local_steps=5,
                batch=8, seq=256, method="celora", uplink_codec="int8",
                attn_impl="flash")


def phase_lm_train(torch, fa_ops, tl_ops, get_config, dev,
                   mode: str = "loop", loop_hist=None):
    """``launch.train.run`` on fed-100m with client_parallelism ``mode``:
    exact kernel launches, a falling loss, the int8 byte ledger, a
    checkpoint that verifies and restores; for "loop" then the device-time
    split of one client's local steps, for "vmap" the loop run's history
    (``loop_hist``) as the reference: the same participants and bytes each
    round, round 0's loss within 1e-3 + 1e-3·|loss| (see LM_TRAIN).
    Returns (launches, history)."""
    from repro_torch import checkpoint
    from repro_torch.core import jit_cache
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    job = dict(LM_TRAIN, client_parallelism=mode)
    cfg = get_config(job["arch"])
    path = ROOT / "build" / "chip_smoke" / f"lm_train_{mode}.npz"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    fa_ops.reset_launches()                   # counts of the main path only
    tl_ops.reset_launches()
    before = dict(jit_cache.STATS)
    t0 = time.perf_counter()
    out = train.run(**job, ckpt=str(path), verbose=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if mode == "loop":
        GRAPH_RUNS["lm_train"] = dict(
            out={k: out[k] for k in ("history", "adapters")},
            launches=launches, wall=wall, peak=peak,
            **program_counts(torch, start, before))
    hist = out["history"]
    steps = sum(len(r["participants"]) for r in hist) * job["local_steps"]
    layers = cfg.n_layers
    tokens = steps * job["batch"] * job["seq"]
    if mode == "vmap":          # all clients as one batch: one launch per
        steps = len(hist) * job["local_steps"]         # projection a step
    expected = step_launches(cfg, steps, grouped=mode == "vmap")
    restored = checkpoint.restore(str(path),
                                  {"adapter_client0": out["adapters"][0]})
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(restored["adapter_client0"]),
        tree_leaves(out["adapters"][0])))

    profile_line = {}
    if mode == "loop":
        profile_line = {"profile": lm_profile(torch, cfg, out, job, dev)}
    emit({"phase": "lm_train", **job, "layers": layers,
          "d_model": cfg.d_model, "rounds_detail": hist, "wall_s": wall,
          "round_wall_s": [r["wall_s"] for r in hist],
          "trained_tokens": tokens, "trained_tok_per_s": tokens / wall,
          "peak_mem_gb": peak, "launches": launches,
          "expected_launches": expected, "checkpoint_restored": same,
          "checkpoint_meta": checkpoint.metadata(str(path)), **profile_line})
    require(launches == expected,
            f"lm_train launches {launches} != expected {expected}")
    require(hist[-1]["loss"] < hist[0]["loss"],
            f"lm_train loss did not fall: {[r['loss'] for r in hist]}")
    # per client: 4 stacked C leaves of 8 layers x 8x8 = 512 int8 codes and
    # 8 bf16 tile scales (528 B) up, 512 f32 (2048 B) down
    require(all(r["uplink_bytes"] == 8448 and r["downlink_bytes"] == 32768
                for r in hist),
            f"lm_train bytes {[(r['uplink_bytes'], r['downlink_bytes']) for r in hist]}")
    require(same, "the checkpoint did not restore client 0's adapter")
    for a, b in zip(hist, loop_hist or ()):
        require((a["participants"], a["uplink_bytes"], a["downlink_bytes"],
                 a["uplink_floats"]) == (b["participants"], b["uplink_bytes"],
                                         b["downlink_bytes"],
                                         b["uplink_floats"]),
                f"lm_train {mode} round {a['round']}: the ledgers differ")
    if loop_hist:
        # round 0 only: at this job's lr the later rounds amplify rounding
        # (see LM_TRAIN)
        a, b = hist[0]["loss"], loop_hist[0]["loss"]
        require(abs(a - b) <= 1e-3 + 1e-3 * abs(b),
                f"lm_train {mode} round 0: loss {a} vs the loop run's {b}")
    return launches, hist


def lm_profile(torch, cfg, out, job, dev) -> dict:
    """The device-time split of ``train.local_fit`` of client 0, 3 steps,
    inside the profiler."""
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from repro_torch.data import synthetic
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    batches = synthetic.lm_batches(synthetic.make_lm_data(
        0, 20_000, cfg.vocab_size), job["batch"], job["seq"])
    drawn = [next(batches) for _ in range(3)]
    toks, labs = (torch.as_tensor(np.stack([b[k] for b in drawn]),
                                  device=dev) for k in ("tokens", "labels"))
    opt = adamw(lr=3e-3)
    args = (out["cfg"], out["base"], opt, out["adapters"][0], toks, labs)
    train.local_fit(*args)             # its program built outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        train.local_fit(*args)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t1) * 1e6
    return {"window": "train.local_fit, 1 client, 3 steps",
            **device_split(prof, window_us, 12, shares=FLASH_SHARES)}


def fit_eval_calls(hist, job: dict, mode: str) -> int:
    """The fit and eval calls of a ``run_federated`` job: the loop path
    fits each sampled client and evaluates each client on an eval round,
    the vmap path makes one of each a round (an eval round)."""
    evaluated = sum(r.evaluated for r in hist)
    if mode == "loop":
        return sum(len(r.sampled) for r in hist) + evaluated * job["clients"]
    return len(hist) + evaluated


def phase_train_graph(torch, fa_ops, tl_ops, get_config, dev):
    """The default runs of the ``train`` (loop), ``train_vmap`` and
    ``lm_train`` (loop) jobs went through the captured programs
    (``core/jit_cache.py``: a CUDA graph a fit or eval signature, replayed
    with no Python between launches); here the same jobs run under
    ``jit_cache.disable_jit()``, op by op, and the captured runs are held
    to them bitwise: every record but the times, the final client states
    and the launches.  The captured runs must have captured graphs and
    replayed one for every fit and eval they made.  Reported, captured
    against eager: wall per round, warm-up and capture seconds, peak
    memory, the entries each cache held, and the device's idle share over
    ``train_profile``'s window (lora_loc, 4 clients, 3 steps) on loop and
    vmap."""
    from repro_torch.core import jit_cache
    from repro_torch.launch import train

    cfg = get_config("fed-100m")
    report, checks = {}, []
    profiles = GRAPH_RUNS["train_vmap"]["profiles"]
    for name, mode in (("train", "loop"), ("train_vmap", "vmap")):
        g = GRAPH_RUNS.pop(name)
        free(torch)
        start = torch.cuda.memory_allocated()
        with jit_cache.disable_jit():
            eager, launches, wall, peak = run_counted(
                torch, fa_ops, tl_ops, lambda: train_job(
                    torch, cfg, dev, "flash", mode=mode)[0])
        reserved = torch.cuda.max_memory_reserved() / 1e9
        above = peak - start / 1e9
        hist, ref = g["out"]["history"], eager["history"]
        calls = fit_eval_calls(hist, TRAIN, mode)
        states = all(same_tensors(torch, a, b) for a, b in
                     zip(g["out"]["states"], eager["states"]))
        report[name] = {
            "captured": {"wall_s": g["wall"], "peak_mem_gb": g["peak"],
                         "peak_reserved_gb": g["peak_reserved"],
                         "peak_above_start_gb": g["peak_above_start"],
                         "round_wall_s": [r.wall_s for r in hist],
                         "programs": g["programs"],
                         "fit_and_eval_calls": calls},
            "eager": {"wall_s": wall, "peak_mem_gb": peak,
                      "peak_reserved_gb": reserved,
                      "peak_above_start_gb": above,
                      "round_wall_s": [r.wall_s for r in ref]},
            "states_bitwise": states, "launches_equal": g["launches"]
            == launches}
        checks += [
            (fed_records(hist) == fed_records(ref), f"train_graph {name}: "
             f"the captured run's records are not bitwise the eager run's"),
            (states, f"train_graph {name}: the captured run's final states "
             f"are not bitwise the eager run's"),
            (g["launches"] == launches, f"train_graph {name}: launches "
             f"{g['launches']} captured, {launches} eager"),
            (g["programs"]["graphs"] > 0
             and g["programs"]["replays"] == calls,
             f"train_graph {name}: {g['programs']} for {calls} fit and "
             f"eval calls")]
        del g, eager
    g = GRAPH_RUNS.pop("lm_train")
    free(torch)
    start = torch.cuda.memory_allocated()
    with jit_cache.disable_jit():
        eager, launches, wall, peak = run_counted(
            torch, fa_ops, tl_ops, lambda: train.run(
                **dict(LM_TRAIN, client_parallelism="loop"), verbose=False,
                device=dev))
    reserved = torch.cuda.max_memory_reserved() / 1e9
    above = peak - start / 1e9
    hist, ref = g["out"]["history"], eager["history"]
    calls = sum(len(r["participants"]) for r in hist)
    states = same_tensors(torch, g["out"]["adapters"], eager["adapters"])
    report["lm_train"] = {
        "captured": {"wall_s": g["wall"], "peak_mem_gb": g["peak"],
                     "peak_reserved_gb": g["peak_reserved"],
                     "peak_above_start_gb": g["peak_above_start"],
                     "round_wall_s": [r["wall_s"] for r in hist],
                     "programs": g["programs"], "fit_calls": calls},
        "eager": {"wall_s": wall, "peak_mem_gb": peak,
                  "peak_reserved_gb": reserved,
                  "peak_above_start_gb": above,
                  "round_wall_s": [r["wall_s"] for r in ref]},
        "states_bitwise": states, "launches_equal": g["launches"] == launches}
    del g
    free(torch)
    # train_vmap's profile windows ran the captured programs; the same
    # windows eager
    with jit_cache.disable_jit():
        eager_profiles = {mode: train_profile(torch, cfg, dev, TRAIN,
                                              TRAIN["clients"], mode)
                          for mode in ("loop", "vmap")}
    emit({"phase": "train_graph", "arch": cfg.name, **report,
          "profiles": {"captured": profiles, "eager": eager_profiles}})
    for cond, what in checks:
        require(cond, what)
    require(lm_records(hist) == lm_records(ref),
            "train_graph lm_train: the captured run's records are not "
            "bitwise the eager run's")
    require(states, "train_graph lm_train: the captured run's adapters are "
            "not bitwise the eager run's")
    require(report["lm_train"]["launches_equal"],
            f"train_graph lm_train: launches differ from the eager run's "
            f"{launches}")
    programs = report["lm_train"]["captured"]["programs"]
    require(programs["graphs"] > 0 and programs["replays"] == calls,
            f"train_graph lm_train: {programs} for {calls} fit calls")


# ---------------------------------------------------------------------------
# train_faults: the robust round (fault injection and admission control)
# ---------------------------------------------------------------------------

#: the train_faults job: the train job's shape with 3 local steps, the
#: int8 uplink, bit flips on the wire, the norm gate and the fault storm
#: of tests/test_faults.py.  Seed 11 fires every event in 3 rounds of 4
#: clients: crashes, a lost upload, corrupted and divergent ones.
TRAIN_FAULTS = dict(TRAIN, local_steps=3)
STORM = dict(fault_crash=0.15, fault_loss=0.2, fault_corrupt=0.25,
             fault_divergent=0.15, fault_corrupt_mode="bitflip",
             admission="norm", uplink_codec="int8", seed=11)
#: one NaN-corruption round on vmap: seed 5 corrupts clients 1 and 2
NAN_ROUND = dict(fault_corrupt=0.5, fault_corrupt_mode="nan",
                 admission="norm", seed=5, rounds=1)


def first_admitted_corrupt(draws, hist) -> int:
    """The first round in which a corrupted upload reached the server and
    passed the gate (the number of rounds if none did)."""
    for d, rec in zip(draws, hist):
        hit = d.corrupt & ~d.crash & ~d.loss
        if any(i not in rec.rejected for i in hit.nonzero()[0]):
            return rec.round
    return len(hist)


def finite_states(torch, out) -> bool:
    from repro_torch.tree import tree_leaves
    return all(bool(torch.isfinite(t).all()) for s in out["states"]
               for t in tree_leaves(s) if t.is_floating_point())


def phase_train_faults(torch, fa_ops, tl_ops, get_config, dev):
    """fed-100m at full width and depth through ``run_federated`` under
    the seeded fault storm with the int8 uplink, bit flips on the wire and
    the norm gate, on the loop and the vmap path: the same fault outcomes
    and ledgers on both, loss and accuracies within the train_vmap
    phase's tolerances up to the first round that admits a corrupted
    upload (the loss within 1e-2·|loss| after it), everything finite, and
    exactly the fault-free job's kernel launches (crashed and divergent
    clients still train).
    Then one NaN-corruption round on vmap, which the gate must cut."""
    import numpy as np

    from repro_torch.core import faults

    cfg = get_config("fed-100m")
    job = TRAIN_FAULTS
    fm = faults.FaultModel(crash=STORM["fault_crash"],
                           loss=STORM["fault_loss"],
                           corrupt=STORM["fault_corrupt"],
                           divergent=STORM["fault_divergent"])
    draws = [fm.draw(job["clients"], r, STORM["seed"])
             for r in range(job["rounds"])]
    fired = {ev: sum(int(getattr(d, ev).sum()) for d in draws)
             for ev in faults.FAULT_EVENTS}
    runs, lines = {}, {}
    for mode in ("loop", "vmap"):
        torch.cuda.reset_peak_memory_stats()
        fa_ops.reset_launches()               # counts of this path only
        tl_ops.reset_launches()
        out, wall = train_job(torch, cfg, dev, "flash", job, mode, **STORM)
        launches = {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
        hist = out["history"]
        runs[mode] = out
        lines[mode] = {
            "wall_s": wall, "peak_mem_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches,
            "expected_launches": fed_launches(cfg, hist, job, mode),
            "routes": dict(tl_ops.ROUTES),
            "rounds_detail": [{"round": r.round, "train_loss": r.train_loss,
                               "mean_acc": r.mean_acc, "failed": r.failed,
                               "rejected": r.rejected,
                               "participants": r.participants,
                               "uplink_bytes": r.uplink_bytes,
                               "downlink_bytes": r.downlink_bytes}
                              for r in hist]}
    tl_ops.reset_launches()
    fa_ops.reset_launches()
    nan_out, nan_wall = train_job(torch, cfg, dev, "flash", job, "vmap",
                                  **NAN_ROUND)
    nan_rec = nan_out["history"][0]
    gaps = [abs(a.train_loss - b.train_loss) for a, b in zip(
        runs["vmap"]["history"], runs["loop"]["history"])]
    emit({"phase": "train_faults", "arch": cfg.name, "dtype": cfg.param_dtype,
          "layers": cfg.n_layers, "method": "celora", "attn_impl": "flash",
          **job, **STORM, "events_fired": fired, **lines,
          "vmap_vs_loop_loss_gap": gaps,
          "nan_round": {**NAN_ROUND, "wall_s": nan_wall,
                        "rejected": nan_rec.rejected,
                        "train_loss": nan_rec.train_loss,
                        "mean_acc": nan_rec.mean_acc}})
    require(all(fired.values()), f"the storm fired {fired}: every event "
            f"must fire")
    for mode, line in lines.items():
        require(line["launches"] == line["expected_launches"],
                f"train_faults {mode} launches {line['launches']} != "
                f"expected {line['expected_launches']}")
    loop_h, vmap_h = runs["loop"]["history"], runs["vmap"]["history"]
    require(any(r.rejected for r in loop_h), "the gate rejected nothing")
    for a, b in zip(vmap_h, loop_h):
        require((a.failed, a.rejected) == (b.failed, b.rejected),
                f"train_faults round {a.round}: vmap failed/rejected "
                f"{a.failed}/{a.rejected}, loop {b.failed}/{b.rejected}")
    # a corrupted upload that passes the gate (a bit flip moves each int8
    # code by 64 quanta but may stay within the norm bound) is mixed into
    # every client's C; from the next round on, the float orders of the
    # two paths part by more than the train_vmap tolerance (4.1e-3 at round
    # 2 of this job, where the loop path's own flash and ref attention part
    # by 1.3e-3), so those rounds are held to 1e-2·|loss|
    k = first_admitted_corrupt(draws, loop_h) + 1
    same_run("train_faults vmap vs loop", vmap_h[:k], loop_h[:k])
    same_run("train_faults vmap vs loop (after an admitted corruption)",
             vmap_h[k:], loop_h[k:], loss_rtol=1e-2)
    for mode, out in runs.items():
        require(all(np.isfinite(r.train_loss) and np.all(np.isfinite(r.accs))
                    for r in out["history"]) and finite_states(torch, out),
                f"train_faults {mode}: a loss, accuracy or state is not "
                f"finite")
    require(nan_rec.rejected and np.isfinite(nan_rec.train_loss)
            and np.all(np.isfinite(nan_rec.accs))
            and finite_states(torch, nan_out),
            f"the NaN round rejected {nan_rec.rejected}, loss "
            f"{nan_rec.train_loss}; it must reject and stay finite")
    return vmap_h


# ---------------------------------------------------------------------------
# train_scan / lm_scan: the scan engine
# ---------------------------------------------------------------------------

#: the train_scan kill-and-resume and sync-count job: the train job at
#: participation 0.5 with the int8 uplink and the norm gate, on the scan
#: engine (4 rounds in chunks of 2, killed after 2 and resumed)
SCAN_RESUME = dict(participation=0.5, uplink_codec="int8", admission="norm",
                   engine="scan", chunk_rounds=2)
#: the RoundRecord fields that are times (all the others must repeat)
TIMES = ("wall_s", "host_s", "device_s")


def same_records(what: str, hist, ref_hist) -> None:
    """Every field of every round but the times, bitwise."""
    require(len(hist) == len(ref_hist), f"{what}: {len(hist)} rounds vs "
            f"{len(ref_hist)}")
    for a, b in zip(hist, ref_hist):
        fa = {k: v for k, v in vars(a).items() if k not in TIMES}
        fb = {k: v for k, v in vars(b).items() if k not in TIMES}
        require(fa == fb, f"{what} round {a.round}: {fa} != {fb}")


def same_tensors(torch, a, b) -> bool:
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def sync_sites(torch, fn):
    """The synchronizing CUDA calls ``fn()`` makes, from the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``, counted by the innermost
    Python line outside torch that led to each (a ``collections.Counter``):
    a sync made inside one of torch's helpers (a stream's ``synchronize``,
    a graph capture, the pinned-memory cache) counts at the line of the
    port, or of this script, that called the helper.  Only the warning of
    a sync counts, not the notice that the first ``set_sync_debug_mode``
    of a process gives."""
    import collections
    import os
    import sys
    import warnings
    skip = (str(Path(torch.__file__).parent) + os.sep, warnings.__file__)
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename.startswith(skip):
            f = f.f_back
        sites[f"{Path(f.f_code.co_filename).name}:{f.f_lineno}"
              if f is not None else f"{Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def scan_times(hist) -> dict:
    """Per-round wall, host and device seconds of a scan run."""
    return {k: [getattr(r, k) for r in hist] for k in TIMES}


def phase_train_scan(torch, fa_ops, tl_ops, get_config, dev, vmap_run,
                     storm_hist):
    """``run_federated`` with ``engine="scan"`` on fed-100m at full width
    and depth: (a) the train_vmap job in chunks of 2 (an odd tail), held
    to the eager vmap run (``vmap_run``): the same ledgers, loss within
    1e-3 + 1e-3·|loss|, accuracies within 0.05, exactly its launches, all
    on the 16-byte / SIMT routes; (b) the train_faults storm on scan: the
    vmap run's failed / rejected lists and ledgers (``storm_hist``), all
    finite; (c) 4 rounds at participation 0.5 with int8 and the norm gate,
    killed after 2 (the checkpoint verifies) and resumed: history and
    states bitwise the uninterrupted run's; (d) the same job at 2 rounds
    in one chunk and at 4 in one chunk make the same number of
    synchronizing calls (each run's one chunk-program build included).  The
    main run's sync sites and results are kept for ``scan_graph``."""
    import numpy as np

    from repro_torch import checkpoint

    cfg = get_config("fed-100m")
    job = TRAIN
    layers = cfg.n_layers
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()                   # counts of the main path only
    tl_ops.reset_launches()
    ran = {}
    main_sites = sync_sites(torch, lambda: ran.update(zip(
        ("out", "wall"), train_job(torch, cfg, dev, "flash", job, "vmap",
                                   engine="scan", chunk_rounds=2))))
    out, wall = ran["out"], ran["wall"]
    launches = {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
    flash_routes, routes = dict(fa_ops.ROUTES), dict(tl_ops.ROUTES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist, programs = out["history"], out["programs"]
    GRAPH_RUNS["train_scan"] = dict(
        out=out, launches=launches, wall=wall, peak=peak, sites=main_sites,
        peak_above_start=peak - start / 1e9,
        peak_reserved=torch.cuda.max_memory_reserved() / 1e9)
    steps = len(hist) * job["local_steps"]
    tokens = (sum(len(r.sampled) for r in hist) * job["local_steps"]
              * job["batch"] * job["seq"])
    del out

    fa_ops.reset_launches()
    tl_ops.reset_launches()
    storm, storm_wall = train_job(torch, cfg, dev, "flash", TRAIN_FAULTS,
                                  "vmap", **STORM, engine="scan",
                                  chunk_rounds=2)
    storm_launches = {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
    storm_finite = (all(np.isfinite(r.train_loss)
                        and np.all(np.isfinite(r.accs))
                        for r in storm["history"])
                    and finite_states(torch, storm))

    path = ROOT / "build" / "chip_smoke" / "train_scan.npz"
    if path.exists():
        path.unlink()
    four, two = dict(job, rounds=4), dict(job, rounds=2)
    full, full_wall = train_job(torch, cfg, dev, "flash", four, "vmap",
                                **SCAN_RESUME)
    killed, _ = train_job(torch, cfg, dev, "flash", two, "vmap",
                          **SCAN_RESUME, checkpoint_path=str(path))
    checkpoint.verify(str(path))
    meta = checkpoint.metadata(str(path))
    resumed, _ = train_job(torch, cfg, dev, "flash", four, "vmap",
                           **SCAN_RESUME, checkpoint_path=str(path),
                           resume=True)
    states_equal = all(same_tensors(torch, a, b) for a, b in
                       zip(resumed["states"], full["states"]))

    def one_chunk(rounds: int):
        return lambda: train_job(torch, cfg, dev, "flash",
                                 dict(job, rounds=rounds), "vmap",
                                 **dict(SCAN_RESUME, chunk_rounds=rounds))
    # a warm-up job first: what the first run of a configuration syncs
    # once (a first allocation of a size, a lazy initialization) is no
    # round's (its extra sites are printed)
    warm = sync_sites(torch, one_chunk(2))
    sites = {rounds: sync_sites(torch, one_chunk(rounds))
             for rounds in (2, 4)}
    syncs = {f"{rounds} rounds, one chunk": sum(c.values())
             for rounds, c in sites.items()}
    eager = {k: v for k, v in SCAN_RESUME.items()
             if k not in ("engine", "chunk_rounds")}
    eager_syncs = sum(sync_sites(torch, lambda: train_job(
        torch, cfg, dev, "flash", dict(job, rounds=2), "vmap",
        **eager)).values())

    emit({"phase": "train_scan", "arch": cfg.name, "dtype": cfg.param_dtype,
          "layers": layers, "method": "celora", "attn_impl": "flash",
          "engine": "scan", "chunk_rounds": 2, **job,
          "rounds_detail": [{"round": r.round, "train_loss": r.train_loss,
                             "mean_acc": r.mean_acc, "wall_s": r.wall_s,
                             "host_s": r.host_s, "device_s": r.device_s,
                             "uplink_bytes": r.uplink_bytes,
                             "downlink_bytes": r.downlink_bytes}
                            for r in hist],
          "wall_s": wall, "trained_tokens": tokens,
          "trained_tok_per_s": tokens / wall, "peak_mem_gb": peak,
          "launches": launches, "routes": routes,
          "flash_routes": flash_routes, "programs": programs,
          "vmap": {"wall_s": vmap_run["wall_s"],
                   "round_wall_s": [r.wall_s for r in vmap_run["history"]],
                   "trained_tok_per_s": vmap_run["trained_tok_per_s"],
                   "peak_mem_gb": vmap_run["peak_mem_gb"],
                   "train_loss": [r.train_loss
                                  for r in vmap_run["history"]]},
          "storm": {**STORM, "wall_s": storm_wall, "launches": storm_launches,
                    "failed": [r.failed for r in storm["history"]],
                    "rejected": [r.rejected for r in storm["history"]],
                    "train_loss": [r.train_loss for r in storm["history"]],
                    "finite": storm_finite},
          "resume": {**SCAN_RESUME, "rounds": 4, "killed_after": 2,
                     "wall_s": full_wall, **scan_times(full["history"]),
                     "train_loss": [r.train_loss for r in full["history"]],
                     "rejected": [r.rejected for r in full["history"]],
                     "checkpoint_meta": meta, "states_equal": states_equal},
          "syncs": syncs, "sync_sites": dict(sites[4]),
          "build_sync_sites": {r: dict(program_sites(c)[0])
                               for r, c in sites.items()},
          "warmup_syncs": sum(warm.values()),
          "warmup_extra_sites": dict(warm - sites[2]),
          "eager_vmap_syncs_2_rounds": eager_syncs,
          "phase_s": time.perf_counter() - t_phase})
    require(launches == vmap_run["launches"],
            f"train_scan launches {launches} != the eager vmap run's "
            f"{vmap_run['launches']}")
    require(routes == {"fwd_wgmma": 0, "fwd_simt": 0, "fwd_grouped_wgmma": 0,
                       "fwd_grouped_simt": launches["tri_lora_fwd_grouped"]},
            f"train_scan forward routes {routes}: every f32 grouped forward "
            f"takes the SIMT route")
    require(flash_routes == {"fwd_vec": launches["flash_fwd"],
                             "fwd_scalar": 0, "bwd_vec": 2 * layers * steps,
                             "bwd_scalar": 0},
            f"train_scan flash routes {flash_routes}: every launch should "
            f"take the 16-byte route")
    same_run("train_scan vs train_vmap", hist, vmap_run["history"])
    require(storm_launches == fed_launches(cfg, storm["history"],
                                           TRAIN_FAULTS, "vmap"),
            f"train_scan storm launches {storm_launches}")
    for a, b in zip(storm["history"], storm_hist):
        require((a.failed, a.rejected, a.sampled, a.participants,
                 a.uplink_bytes, a.downlink_bytes, a.uplink_elems)
                == (b.failed, b.rejected, b.sampled, b.participants,
                    b.uplink_bytes, b.downlink_bytes, b.uplink_elems),
                f"train_scan storm round {a.round}: failed/rejected "
                f"{a.failed}/{a.rejected} or ledger differ from the vmap "
                f"run's {b.failed}/{b.rejected}")
    require(storm_finite, "train_scan storm: a loss, accuracy or state is "
            "not finite")
    require(meta.get("rounds_done") == 2 and meta.get("engine") == "scan",
            f"train_scan checkpoint metadata {meta}")
    same_records("train_scan resumed vs uninterrupted", resumed["history"],
                 full["history"])
    same_records("train_scan killed vs uninterrupted", killed["history"],
                 full["history"][:2])
    require(states_equal, "train_scan: the resumed states are not bitwise "
            "the uninterrupted run's")
    require(len(set(syncs.values())) == 1,
            f"train_scan host syncs {syncs} (sites {sites}): the rounds "
            f"inside a chunk must add none")


#: the lm_scan job: lm_train's job on the scan engine, 4 rounds in chunks
#: of 2 (killed after 2 and resumed)
LM_SCAN = dict(LM_TRAIN, rounds=4, client_parallelism="vmap", engine="scan",
               chunk_rounds=2)


def phase_lm_scan(torch, fa_ops, tl_ops, get_config, dev, vmap_hist):
    """``launch.train.run`` with ``engine="scan"`` on fed-100m at full width
    and depth: exact grouped launches, lm_train's byte ledger, round 0's
    loss within 1e-3 + 1e-3·|loss| of the eager vmap run's (``vmap_hist``,
    see LM_TRAIN), a falling loss; killed after 2 rounds (the state file
    verifies) and resumed to 4, bitwise the uninterrupted run."""
    from repro_torch import checkpoint
    from repro_torch.launch import train

    job = LM_SCAN
    cfg = get_config(job["arch"])
    t_phase = time.perf_counter()
    path = ROOT / "build" / "chip_smoke" / "lm_scan.npz"
    if path.exists():
        path.unlink()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()                   # counts of the main path only
    tl_ops.reset_launches()
    from repro_torch.core import jit_cache
    before = dict(jit_cache.STATS)
    ran = {}
    t0 = time.perf_counter()
    main_sites = sync_sites(torch, lambda: ran.update(
        full=train.run(**job, verbose=False, device=dev)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    full = ran["full"]
    launches = {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 1e9
    GRAPH_RUNS["lm_scan"] = dict(
        out=full, launches=launches, wall=wall, peak=peak, sites=main_sites,
        programs=program_stats(before), peak_above_start=peak - start / 1e9,
        peak_reserved=torch.cuda.max_memory_reserved() / 1e9)
    hist = full["history"]
    layers = cfg.n_layers
    steps = len(hist) * job["local_steps"]
    expected = step_launches(cfg, steps, grouped=True)
    tokens = (sum(len(r["participants"]) for r in hist) * job["local_steps"]
              * job["batch"] * job["seq"])
    killed = train.run(**dict(job, rounds=2), ckpt=str(path), verbose=False,
                       device=dev)
    checkpoint.verify(str(path))
    meta = checkpoint.metadata(str(path))
    resumed = train.run(**job, ckpt=str(path), resume=True, verbose=False,
                        device=dev)
    adapters_equal = all(same_tensors(torch, a, b) for a, b in
                         zip(resumed["adapters"], full["adapters"]))
    vmap_tokens = (sum(len(r["participants"]) for r in vmap_hist)
                   * job["local_steps"] * job["batch"] * job["seq"])
    emit({"phase": "lm_scan", **job, "layers": layers,
          "d_model": cfg.d_model, "rounds_detail": hist, "wall_s": wall,
          "trained_tokens": tokens, "trained_tok_per_s": tokens / wall,
          "peak_mem_gb": peak, "launches": launches,
          "expected_launches": expected, "checkpoint_meta": meta,
          "adapters_equal": adapters_equal,
          "round_tok_per_s": tokens / sum(r["wall_s"] for r in hist),
          "vmap": {"round_wall_s": [r["wall_s"] for r in vmap_hist],
                   "round_tok_per_s": vmap_tokens / sum(
                       r["wall_s"] for r in vmap_hist),
                   "loss": [r["loss"] for r in vmap_hist]},
          "phase_s": time.perf_counter() - t_phase})
    require(launches == expected,
            f"lm_scan launches {launches} != expected {expected}")
    require(all(r["uplink_bytes"] == 8448 and r["downlink_bytes"] == 32768
                for r in hist),
            f"lm_scan bytes {[(r['uplink_bytes'], r['downlink_bytes']) for r in hist]}")
    for a, b in zip(hist, vmap_hist):
        require((a["participants"], a["uplink_bytes"], a["downlink_bytes"],
                 a["uplink_floats"]) == (b["participants"], b["uplink_bytes"],
                                         b["downlink_bytes"],
                                         b["uplink_floats"]),
                f"lm_scan round {a['round']}: the ledgers differ from the "
                f"eager vmap run's")
    a, b = hist[0]["loss"], vmap_hist[0]["loss"]
    require(abs(a - b) <= 1e-3 + 1e-3 * abs(b),
            f"lm_scan round 0: loss {a} vs the eager vmap run's {b}")
    require(hist[-1]["loss"] < hist[0]["loss"],
            f"lm_scan loss did not fall: {[r['loss'] for r in hist]}")
    require(meta.get("rounds_done") == 2 and meta.get("engine") == "scan",
            f"lm_scan checkpoint metadata {meta}")
    for what, run, ref in (("resumed", resumed["history"], hist),
                           ("killed", killed["history"], hist[:2])):
        require([{k: v for k, v in r.items() if k not in TIMES} for r in run]
                == [{k: v for k, v in r.items() if k not in TIMES}
                    for r in ref],
                f"lm_scan {what} history is not bitwise the uninterrupted "
                f"run's")
    require(adapters_equal, "lm_scan: the resumed adapters are not bitwise "
            "the uninterrupted run's")


def warmup_site() -> str:
    """The line of ``core/jit_cache.py`` that ends a build's warm-up (its
    side stream's ``synchronize``, once a build), as a ``sync_sites``
    key."""
    from repro_torch.core import jit_cache
    lines = Path(jit_cache.__file__).read_text().splitlines()
    (n,) = [i + 1 for i, ln in enumerate(lines)
            if ln.strip() == "side.synchronize()"]
    return f"jit_cache.py:{n}"


def program_sites(sites) -> tuple:
    """A ``sync_sites`` count split into the syncs made in
    ``core/jit_cache.py`` (the programs' builds) and the rest."""
    import collections
    build = collections.Counter({k: v for k, v in sites.items()
                                 if k.startswith("jit_cache.py:")})
    return build, sites - build


def phase_scan_graph(torch, fa_ops, tl_ops, get_config, dev):
    """The train_scan phase's main job (train_vmap's job on the scan engine
    in chunks of 2: an odd last chunk) and lm_scan's uninterrupted run
    (4 rounds in chunks of 2) again under ``jit_cache.disable_jit()``,
    every chunk op by op, against their default runs, whose every chunk
    replayed one captured CUDA graph (``fed_engine._SCAN_CACHE`` / the LM
    run's own chunk programs, the carry donated): every record but the
    times, the final states and the launches bitwise; graphs captured and
    one replay a chunk; the same synchronizing calls at every site but the
    builds' (``program_sites``), and exactly one at the end of each build's
    warm-up, none elsewhere in ``core/jit_cache.py``.  Reported, captured against eager: round wall,
    warm-up and capture seconds, peak memory (above each run's start: one
    chunk's graph holds about one round's peak, as the allocator reuses
    blocks within a capture) and the builds' syncs."""
    from repro_torch.core import jit_cache
    from repro_torch.launch import train

    cfg = get_config("fed-100m")
    report, checks = {}, []
    jobs = (("train_scan", lambda: train_job(
                torch, cfg, dev, "flash", TRAIN, "vmap", engine="scan",
                chunk_rounds=2)[0],
             lambda out: fed_records(out["history"]),
             lambda out: out["states"], -(-TRAIN["rounds"] // 2)),
            ("lm_scan", lambda: train.run(**LM_SCAN, verbose=False,
                                          device=dev),
             lambda out: lm_records(out["history"]),
             lambda out: out["adapters"], -(-LM_SCAN["rounds"]
                                            // LM_SCAN["chunk_rounds"])))
    for name, run, records, states_of, chunks in jobs:
        g = GRAPH_RUNS.pop(name)
        free(torch)
        start = torch.cuda.memory_allocated()
        ran = {}
        with jit_cache.disable_jit():
            sites = sync_sites(torch, lambda: ran.update(run=run_counted(
                torch, fa_ops, tl_ops, run)))
        eager, launches, wall, peak = ran["run"]
        if "programs" not in g:
            g["programs"] = g["out"]["programs"]
        build, rest = program_sites(g["sites"])
        _, eager_rest = program_sites(sites)
        warm_site = warmup_site()
        graphs = g["programs"]["graphs"]
        builds_ok = build == {warm_site: graphs}
        states = all(same_tensors(torch, a, b) for a, b in
                     zip(states_of(g["out"]), states_of(eager)))
        walls = [r["wall_s"] if isinstance(r, dict) else r.wall_s
                 for r in g["out"]["history"]]
        eager_walls = [r["wall_s"] if isinstance(r, dict) else r.wall_s
                       for r in eager["history"]]
        report[name] = {
            "captured": {"wall_s": g["wall"], "round_wall_s": walls,
                         "peak_mem_gb": g["peak"],
                         "peak_above_start_gb": g["peak_above_start"],
                         "peak_reserved_gb": g["peak_reserved"],
                         "programs": g["programs"],
                         "syncs": sum(rest.values()),
                         "build_syncs": dict(build)},
            "eager": {"wall_s": wall, "round_wall_s": eager_walls,
                      "peak_mem_gb": peak,
                      "peak_above_start_gb": peak - start / 1e9,
                      "peak_reserved_gb":
                          torch.cuda.max_memory_reserved() / 1e9,
                      "syncs": sum(eager_rest.values())},
            "chunks": chunks, "states_bitwise": states,
            "launches_equal": g["launches"] == launches}
        checks += [
            (records(g["out"]) == records(eager), f"scan_graph {name}: the "
             f"captured run's records are not bitwise the eager run's"),
            (states, f"scan_graph {name}: the captured run's final states "
             f"are not bitwise the eager run's"),
            (g["launches"] == launches, f"scan_graph {name}: launches "
             f"{g['launches']} captured, {launches} eager"),
            (g["programs"]["graphs"] > 0
             and g["programs"]["replays"] == chunks,
             f"scan_graph {name}: {g['programs']} for {chunks} chunks"),
            (rest == eager_rest and builds_ok, f"scan_graph {name}: "
             f"synchronizing calls {dict(rest)} captured, besides the "
             f"builds' {dict(build)} ({graphs} graphs; warm-up "
             f"{warm_site}); {dict(eager_rest)} "
             f"eager")]
        del g, eager
    emit({"phase": "scan_graph", "arch": cfg.name, **report})
    for cond, what in checks:
        require(cond, what)


# ---------------------------------------------------------------------------
# train_host / train_async / lm_host / lm_async: the host client store and
# the async engine
# ---------------------------------------------------------------------------

#: the train_host job: 64 clients of which 8 train a round (participation
#: 0.125), celora, int8, S^data off (with S^data on the JAX package's host
#: and device stores part, ROADMAP Queue 3), short sequences so that the
#: device store's all-m fit (256 sequences a step) stays small
TRAIN_HOST = dict(clients=64, rounds=3, local_steps=2, batch=4, seq=64,
                  n_train=16, n_test=8, classes=4, lr=1e-3)
HOST_FED = dict(participation=0.125, uplink_codec="int8", use_data_sim=False,
                eval_every=2)
#: the train_async jobs: 8 clients; (a) the zero-staleness limit (uniform
#: latency, K = k = 8) beside the eager vmap run, (b) the storm: lognormal
#: latency, K = 4, concurrency 8, staleness decay 0.5, crashes, lost and
#: NaN-corrupted uploads, the norm gate, a dispatch timeout and retries;
#: seed 15 drops 2 uploads for good, re-sends 2, rejects 3, and dispatches
#: fit groups of 1, 2, 3, 4 and 6 clients
TRAIN_ASYNC = dict(TRAIN_HOST, clients=8, rounds=3)
ASYNC_STORM = dict(engine="async", uplink_codec="int8", latency="lognormal",
                   latency_sigma=1.0, buffer_size=4, async_concurrency=8,
                   staleness_decay=0.5, fault_crash=0.15, fault_loss=0.2,
                   fault_corrupt=0.25, fault_corrupt_mode="nan",
                   admission="norm", dispatch_timeout=3.0,
                   retry_backoff=0.5, retry_cap=2, seed=15, rounds=4,
                   chunk_rounds=1, use_data_sim=False)
GROUPED = ("tri_lora_fwd_grouped", "tri_lora_dx_grouped")


def grouped_launches(cfg, steps: int, evals: int) -> dict:
    """The flash and grouped tri-LoRA launches of ``steps`` stacked local
    steps and ``evals`` stacked eval calls of a celora job with S^data off
    (``step_launches``)."""
    return step_launches(cfg, steps, evals, grouped=True)


def state_gaps(out, ref) -> dict:
    """Per state leaf name (the path's first and last key, over clients,
    layers and targets): the largest |difference| between two runs'
    final states and the number of entries beyond 5e-4."""
    gaps: dict = {}

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, (tuple, list)):
            for x, y in zip(a, b):
                walk(x, y, path)
        elif a is not None:
            d = (a.to(b.device).float() - b.float()).abs()
            key = f"{path[0]}/{path[-1]}"
            big, n = gaps.get(key, (0.0, 0))
            gaps[key] = (max(big, float(d.max())), n + int((d > 5e-4).sum()))
    for sa, sb in zip(out["states"], ref["states"], strict=True):
        walk(sa, sb, ())
    return gaps


def held_to(what: str, torch, out, ref, states: bool = True) -> None:
    """The JAX package's engine contract between two runs on the card:
    identical sampled / participant / dropped / failed / rejected lists
    and byte and element ledgers, loss within 1e-4, accuracies within
    1e-3, and (``states``) every state entry within 5e-4."""
    keys = ("sampled", "participants", "dropped", "failed", "rejected",
            "uplink_bytes", "downlink_bytes", "uplink_elems")
    require(len(out["history"]) == len(ref["history"]),
            f"{what}: {len(out['history'])} rounds vs {len(ref['history'])}")
    for a, b in zip(out["history"], ref["history"]):
        require([getattr(a, k) for k in keys] == [getattr(b, k) for k in keys],
                f"{what} round {a.round}: the ledgers differ")
        require(abs(a.train_loss - b.train_loss) <= 1e-4,
                f"{what} round {a.round}: loss {a.train_loss} vs "
                f"{b.train_loss}")
        require(max(abs(x - y) for x, y in zip(a.accs, b.accs)) <= 1e-3,
                f"{what} round {a.round}: accs {a.accs} vs {b.accs}")
    if states:
        gaps = state_gaps(out, ref)
        require(all(big <= 5e-4 for big, _ in gaps.values()),
                f"{what}: states differ: {gaps}")


def fed_records(hist) -> list:
    """``run_federated``'s RoundRecords as dicts without their times."""
    return [{k: v for k, v in vars(r).items() if k not in TIMES}
            for r in hist]


def lm_records(hist) -> list:
    """The LM driver's history rows without their times."""
    return [{k: v for k, v in r.items() if k not in TIMES} for r in hist]


def run_counted(torch, fa_ops, tl_ops, fn):
    """``fn()`` with every kernel count set to 0 just before it; returns
    (result, launches, wall seconds, peak GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()                   # counts of the main path only
    tl_ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}, wall,
            torch.cuda.max_memory_allocated() / 1e9)


def per_round(hist) -> dict:
    return {k: [getattr(r, k) for r in hist] for k in TIMES}


def phase_train_host(torch, fa_ops, tl_ops, get_config, dev):
    """``run_federated`` with ``client_store="host"`` on fed-100m at full
    width and depth: 64 clients, 8 a round, celora, int8, eager, once on
    each store (the device store's run is returned: ``train_shard``'s
    reference) — the same ledgers, loss within 1e-4, accuracies within
    1e-3, the aggregated C and the head within 5e-4, the same launches
    (the host store fits the 8-client cohort: one grouped launch a
    projection a step, as the device store's all-64 fit), the host
    store's population pinned on the host and its device-resident bytes
    below the device store's; a second host run bitwise the first (the
    pinned write-back's ordering); then the host store on the scan engine
    killed after round 2 and resumed, bitwise its uninterrupted run.

    The local factors A and B and the EF residual (the locally fitted C
    less its code) are reported, not held to 5e-4: the device store fits
    256 sequences a step and the host store 32, cuBLAS orders the MLP's
    sums differently for the two, and AdamW's normalized step turns that
    float-order noise in a near-zero gradient entry into ±lr (on one
    H100: 3.5e-3 at lr 1e-3 in 459 of 12.6 M entries of A; PERF.md)."""
    from repro_torch import checkpoint
    from repro_torch.tree import tree_leaves

    cfg = get_config("fed-100m")
    job = TRAIN_HOST
    t_phase = time.perf_counter()
    runs = {}
    for store in ("device", "host", "host again"):
        runs[store] = run_counted(torch, fa_ops, tl_ops, lambda: train_job(
            torch, cfg, dev, "flash", job, "vmap", **HOST_FED,
            client_store=store.split()[0])[0])
    dev_out, host_out = runs["device"][0], runs["host"][0]
    steps = job["rounds"] * job["local_steps"]
    evals = sum(r.evaluated for r in host_out["history"])
    expected = grouped_launches(cfg, steps, evals)
    pop_leaves = [t for s in host_out["states"] for t in tree_leaves(s)]
    device_bytes = sum(t.numel() * t.element_size()
                       for s in dev_out["states"] for t in tree_leaves(s))

    # every round evaluated: a run killed after round 2 evaluates its last
    # round, so the uninterrupted run must too for the records to match
    gaps = state_gaps(host_out, dev_out)
    # every round evaluated: a run killed after round 2 evaluates its last
    # round, so the uninterrupted run must too for the records to match
    scan = dict(HOST_FED, eval_every=1, client_store="host", engine="scan",
                chunk_rounds=2)
    path = ROOT / "build" / "chip_smoke" / "train_host.npz"
    if path.exists():
        path.unlink()
    full, _ = train_job(torch, cfg, dev, "flash", job, "vmap", **scan)
    killed, _ = train_job(torch, cfg, dev, "flash", dict(job, rounds=2),
                          "vmap", **scan, checkpoint_path=str(path))
    checkpoint.verify(str(path))
    meta = checkpoint.metadata(str(path))
    resumed, _ = train_job(torch, cfg, dev, "flash", job, "vmap", **scan,
                           checkpoint_path=str(path), resume=True)
    emit({"phase": "train_host", "arch": cfg.name, "dtype": cfg.param_dtype,
          "method": "celora", "attn_impl": "flash", **job, **HOST_FED,
          "stores": {store: {
              "wall_s": wall, "peak_mem_gb": peak, "launches": launches,
              "device_resident_bytes": out.get("device_resident_bytes",
                                               device_bytes),
              **per_round(out["history"]),
              "train_loss": [r.train_loss for r in out["history"]],
              "sampled": [r.sampled for r in out["history"]],
              "programs": out["programs"]}
              for store, (out, launches, wall, peak) in runs.items()},
          "expected_launches": expected,
          "state_gaps": gaps,
          "scan_resume": {"checkpoint_meta": meta,
                          **per_round(resumed["history"])},
          "phase_s": time.perf_counter() - t_phase})
    for store, (_, launches, _, _) in runs.items():
        require(launches == expected,
                f"train_host {store} launches {launches} != {expected}")
    held_to("train_host host vs device", torch, host_out, dev_out,
            states=False)
    require(all(gaps[k][0] <= 5e-4 for k in gaps
                if k.endswith("/C") and k.startswith("adapter")
                or k.startswith("head")),
            f"train_host: the aggregated C or the head differ: {gaps}")
    same_records("train_host host twice", runs["host again"][0]["history"],
                 host_out["history"])
    require(all(same_tensors(torch, a, b) for a, b in zip(
        runs["host again"][0]["states"], host_out["states"])),
        "train_host: two host-store runs are not bitwise alike")
    require(all(t.device.type == "cpu" and t.is_pinned()
                for t in pop_leaves),
            "train_host: the host store's population is not pinned host "
            "memory")
    require(host_out["device_resident_bytes"] < device_bytes,
            f"train_host: {host_out['device_resident_bytes']} B resident on "
            f"the device for the host store, {device_bytes} B for the "
            f"device store")
    require(meta.get("rounds_done") == 2 and meta.get("client_store") == "host",
            f"train_host checkpoint metadata {meta}")
    same_records("train_host scan resumed vs uninterrupted",
                 resumed["history"], full["history"])
    same_records("train_host scan killed vs uninterrupted",
                 killed["history"], full["history"][:2])
    require(all(same_tensors(torch, a, b) for a, b in zip(
        resumed["states"], full["states"])),
        "train_host: the resumed states are not bitwise the uninterrupted "
        "run's")
    return runs["device"]


def phase_train_shard(torch, fa_ops, tl_ops, get_config, dev, device_run,
                      lm_vmap_hist):
    """The client axis over the ``("clients",)`` mesh
    (``launch.mesh.make_client_mesh``) at ``train_host``'s job on
    fed-100m at full width and depth (64 clients, 8 a round, celora, int8):
    ``run_federated`` with ``client_parallelism="shard"`` (the device
    store's placement) and with ``client_store="sharded"`` on the eager
    engine, each bitwise the device store's eager run of ``train_host``
    (``device_run``, not run again): records, states and launches; then
    the device and the sharded store on the scan engine (chunks of 2),
    sharded bitwise device, the scan device run held to the eager one as
    ``train_scan`` holds scan to eager.  The rounds compute on the run's
    device whatever d is, so the bitwise holds stand at any d; on one card
    d = 1 and the shard path is the vmap path.  Then the LM driver at
    ``lm_train``'s job with ``client_store="sharded"``: its launches, and
    round 0 bitwise the eager vmap run's (``lm_vmap_hist``)."""
    from repro_torch.launch import mesh
    from repro_torch.launch import train

    cfg = get_config("fed-100m")
    job = TRAIN_HOST
    d = mesh.make_client_mesh(job["clients"]).size
    dev_out, dev_launches = device_run[0], device_run[1]
    steps = job["rounds"] * job["local_steps"]
    evals = sum(r.evaluated for r in dev_out["history"])
    expected = grouped_launches(cfg, steps, evals)
    scan = dict(engine="scan", chunk_rounds=2)
    cases = {"shard": ("shard", {}),
             "sharded": ("vmap", {"client_store": "sharded"}),
             "device scan": ("vmap", scan),
             "sharded scan": ("vmap", dict(scan, client_store="sharded"))}
    runs = {}
    for name, (mode, kw) in cases.items():
        runs[name] = run_counted(torch, fa_ops, tl_ops, lambda: train_job(
            torch, cfg, dev, "flash", job, mode, **{**HOST_FED, **kw})[0])

    lm_job = dict(LM_TRAIN, client_parallelism="vmap", client_store="sharded")
    lm_out, lm_launches, lm_wall, lm_peak = run_counted(
        torch, fa_ops, tl_ops, lambda: train.run(**lm_job, verbose=False,
                                                 device=dev))
    lm_hist = lm_out["history"]
    lm_expected = step_launches(get_config(lm_job["arch"]),
                                len(lm_hist) * lm_job["local_steps"],
                                grouped=True)

    def bitwise(out, ref):
        same = [a == b for a, b in zip(
            [{k: v for k, v in vars(r).items() if k not in TIMES}
             for r in out["history"]],
            [{k: v for k, v in vars(r).items() if k not in TIMES}
             for r in ref["history"]])]
        return (len(same) == len(ref["history"]) and all(same)
                and all(same_tensors(torch, a, b)
                        for a, b in zip(out["states"], ref["states"])))

    refs = {"shard": dev_out, "sharded": dev_out,
            "device scan": dev_out, "sharded scan": runs["device scan"][0]}
    emit({"phase": "train_shard", "arch": cfg.name, "method": "celora",
          "attn_impl": "flash", **job, **HOST_FED,
          "client_mesh_d": d, "device_count": torch.cuda.device_count(),
          "runs": {name: {
              "wall_s": wall, "peak_mem_gb": peak, "launches": launches,
              "bitwise_reference": bitwise(out, refs[name]),
              **per_round(out["history"]),
              "train_loss": [r.train_loss for r in out["history"]]}
              for name, (out, launches, wall, peak) in runs.items()},
          "expected_launches": expected,
          "device_eager_launches": dev_launches,
          "lm": {**lm_job, "wall_s": lm_wall, "peak_mem_gb": lm_peak,
                 "launches": lm_launches, "expected_launches": lm_expected,
                 "loss": [r["loss"] for r in lm_hist],
                 "vmap_loss": [r["loss"] for r in lm_vmap_hist],
                 "rounds_bitwise": [a["loss"] == b["loss"] for a, b in
                                    zip(lm_hist, lm_vmap_hist)]}})
    require(dev_launches == expected,
            f"train_shard: the device run launched {dev_launches} != "
            f"{expected}")
    for name, (out, launches, _, _) in runs.items():
        require(launches == expected,
                f"train_shard {name} launches {launches} != {expected}")
    for name in ("shard", "sharded"):
        same_records(f"train_shard {name} vs device",
                     runs[name][0]["history"], dev_out["history"])
        require(all(same_tensors(torch, a, b) for a, b in zip(
            runs[name][0]["states"], dev_out["states"])),
            f"train_shard: the {name} states are not bitwise the device "
            f"store's")
    same_records("train_shard sharded scan vs device scan",
                 runs["sharded scan"][0]["history"],
                 runs["device scan"][0]["history"])
    require(all(same_tensors(torch, a, b) for a, b in zip(
        runs["sharded scan"][0]["states"], runs["device scan"][0]["states"])),
        "train_shard: the sharded scan states are not bitwise the device "
        "store's")
    for a, b in zip(runs["device scan"][0]["history"], dev_out["history"]):
        require((a.sampled, a.participants, a.uplink_bytes,
                 a.downlink_bytes) == (b.sampled, b.participants,
                                       b.uplink_bytes, b.downlink_bytes),
                f"train_shard scan round {a.round}: the ledgers differ")
        require(abs(a.train_loss - b.train_loss)
                <= 1e-3 + 1e-3 * abs(b.train_loss),
                f"train_shard scan round {a.round}: loss {a.train_loss} vs "
                f"eager {b.train_loss}")
        require(max(abs(x - y) for x, y in zip(a.accs, b.accs)) <= 0.05,
                f"train_shard scan round {a.round}: accs {a.accs} vs "
                f"{b.accs}")
    require(lm_launches == lm_expected,
            f"train_shard lm launches {lm_launches} != {lm_expected}")
    require(lm_hist[0]["loss"] == lm_vmap_hist[0]["loss"],
            f"train_shard lm round 0: loss {lm_hist[0]['loss']} vs the vmap "
            f"run's {lm_vmap_hist[0]['loss']}")
    for a, b in zip(lm_hist, lm_vmap_hist):
        require((a["participants"], a["uplink_bytes"], a["downlink_bytes"])
                == (b["participants"], b["uplink_bytes"],
                    b["downlink_bytes"]),
                f"train_shard lm round {a['round']}: the ledgers differ")


#: fed_round_step: fed-100m at full width and depth, 2 pods; the timed bf16
#: micro-round takes 4 sequences of 512 tokens a pod, the f32 oracle 2 of
#: 256 a pod (its plain reference runs on the CPU)
FED_ROUND = dict(pods=2, batch=4, seq=512, oracle_batch=2, oracle_seq=256,
                 lr=1e-3)


def phase_fed_round_step(torch, fa_ops, tl_ops, model, get_config, dev):
    """``steps.make_fed_round_step`` on fed-100m at full width and depth,
    each of 2 pods one federated client (``FED_ROUND``): one micro-round in
    bf16 (timed, its peak) and in f32, both through the grouped tri-LoRA
    and the flash kernels with exact launches.  The f32 round is held to
    the plain path: the same round with ``attn_impl="ref"`` on the card
    and the whole round on the CPU (plain tri-LoRA and attention), losses
    within 1e-3 + 1e-3·|loss| and C̄ within 1e-3 of each leaf's largest
    entry (``steps_train``'s tolerances).  With W = I the returned C's are
    the pods' own; the W round's C̄ must equal W·C recomputed in f64 from
    them (to f32 rounding).  Pod-locality: with W = I, pod 0's adapter,
    optimizer moments and loss are bitwise the same when pod 1's batch and
    adapter are replaced.  A one-pod round on pod 0's half of the batch
    gives pod 0's loss bitwise and its first moments (0.1 × the gradients)
    within 1e-3 of each leaf's largest entry: cuBLAS orders the frozen
    projections' sums by the batch's row count, so those gradients part in
    their last bits, and AdamW's normalized first step turns that into up
    to 2·lr in near-zero-gradient entries of A and B (reported)."""
    import numpy as np

    from repro_torch.core import client_batch
    from repro_torch.launch import mesh, steps
    from repro_torch.tree import tree_leaves, tree_map

    job = FED_ROUND
    n = job["pods"]
    pod_mesh = mesh.make_production_mesh(multi_pod=True)
    require(pod_mesh.shape["pod"] == n, f"the production mesh has "
            f"{pod_mesh.shape['pod']} pods, not {n}")
    one_pod = mesh.Mesh(np.full((1, 1, 1), None, dtype=object),
                        ("pod", "data", "model"))
    w_mix = torch.tensor([[0.75, 0.25], [0.4, 0.6]], dtype=torch.float32)
    out = {}

    def pods(cfg, seed):
        params = random_params(torch, model, cfg, dev, seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        with torch.no_grad():
            other = moved_adapter(torch, params["adapter"], gen)
        return params, client_batch.stack_states([params["adapter"], other])

    def payload_gap(got, want) -> float:
        from repro_torch.core import tri_lora
        return max(float((a.cpu().double() - b.cpu().double()).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(tree_leaves(tri_lora.tree_payload(got)),
                                   tree_leaves(tri_lora.tree_payload(want))))

    # ---- bf16, timed
    cfg16 = get_config("fed-100m").with_overrides(param_dtype="bfloat16")
    params, ad_p = pods(cfg16, 28)
    batch = lm_batch(torch, cfg16.vocab_size, n * job["batch"], job["seq"],
                     28, dev)
    step = steps.make_fed_round_step(cfg16, pod_mesh, job["lr"],
                                     attn_impl="flash")
    os_p = step.optimizer.init(ad_p)
    step(params, ad_p, os_p, batch, w_mix)            # warm (first launches)
    (ad16, _, l16), launches16, wall16, peak16 = run_counted(
        torch, fa_ops, tl_ops, lambda: step(params, ad_p, os_p, batch,
                                            w_mix))
    expected = step_launches(cfg16, 1, grouped=True)
    out["bf16"] = {"losses": l16.tolist(), "wall_s": wall16,
                   "peak_mem_gb": peak16, "launches": launches16,
                   "tokens": n * job["batch"] * job["seq"]}
    del params, ad_p, os_p, ad16
    free(torch)

    # ---- f32: kernels, then the plain path
    cfg = get_config("fed-100m")
    params, ad_p = pods(cfg, 29)
    batch = lm_batch(torch, cfg.vocab_size, n * job["oracle_batch"],
                     job["oracle_seq"], 29, dev)
    runs = {}
    for name, impl, where, w in (("flash", "flash", dev, w_mix),
                                 ("flash W=I", "flash", dev, torch.eye(n)),
                                 ("ref", "ref", dev, w_mix),
                                 ("cpu", "flash", torch.device("cpu"),
                                  w_mix)):
        st = steps.make_fed_round_step(cfg, pod_mesh, job["lr"],
                                       attn_impl=impl)
        p = tree_map(lambda t: t.to(where), params)
        a = tree_map(lambda t: t.to(where), ad_p)
        b = {k: v.to(where) for k, v in batch.items()}
        res = run_counted(torch, fa_ops, tl_ops, lambda: st(
            p, a, st.optimizer.init(a), b, w))
        runs[name] = res
    ad_k, _, l_k = runs["flash"][0]
    ad_i, os_i, l_i = runs["flash W=I"][0]
    half = job["oracle_batch"]
    # pod-locality: pod 1's batch rows and adapter replaced
    other = lm_batch(torch, cfg.vocab_size, half, job["oracle_seq"], 30, dev)
    batch_x = {k: torch.cat([v[:half], other[k]]) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(31)
    with torch.no_grad():
        ad_x = client_batch.stack_states([
            tree_map(lambda t: t[0], ad_p),
            moved_adapter(torch, tree_map(lambda t: t[1], ad_p), gen)])
    st = steps.make_fed_round_step(cfg, pod_mesh, job["lr"],
                                   attn_impl="flash")
    ad_ix, os_ix, l_ix = st(params, ad_x, st.optimizer.init(ad_x), batch_x,
                            torch.eye(n))
    local = (bool(l_ix[0] == l_i[0]) and all(
        torch.equal(x[0], y[0]) for x, y in zip(
            tree_leaves((ad_ix, os_ix["mu"], os_ix["nu"])),
            tree_leaves((ad_i, os_i["mu"], os_i["nu"])))))
    # one pod alone on pod 0's rows
    st1 = steps.make_fed_round_step(cfg, one_pod, job["lr"],
                                    attn_impl="flash")
    a0 = tree_map(lambda t: t[:1], ad_p)
    ad_1, os_1, l_1 = st1(params, a0, st1.optimizer.init(a0),
                          {k: v[:half] for k, v in batch.items()},
                          torch.ones((1, 1)))
    mu_gap = max(float((x[0] - y[0]).abs().max())
                 / max(float(y[0].abs().max()), 1e-30)
                 for x, y in zip(tree_leaves(os_i["mu"]),
                                 tree_leaves(os_1["mu"])))

    from repro_torch.core import tri_lora
    c_i = [c.double().cpu() for c in
           tree_leaves(tri_lora.tree_payload(ad_i))]
    c_k = [c.double().cpu() for c in
           tree_leaves(tri_lora.tree_payload(ad_k))]
    w64 = w_mix.double()
    mix_gap = max(float((ck - torch.einsum("ij,j...->i...", w64, ci))
                        .abs().max()) / max(float(ci.abs().max()), 1e-30)
                  for ck, ci in zip(c_k, c_i))
    pairs = list(zip(
        [t for ad in tree_leaves(ad_i, is_leaf=tri_lora.is_adapter)
         for t in (ad["A"], ad["B"])],
        [t for ad in tree_leaves(ad_1, is_leaf=tri_lora.is_adapter)
         for t in (ad["A"], ad["B"])]))
    a_b_bitwise = all(torch.equal(x[0], y[0]) for x, y in pairs)
    a_b_gap = max(float((x[0] - y[0]).abs().max()) for x, y in pairs)
    f32 = {name: {"losses": r[0][2].tolist(), "wall_s": r[2],
                  "launches": r[1]} for name, r in runs.items()}
    holds = {name: {"loss_gap": max(abs(float(x) - float(y)) for x, y in
                                    zip(l_k.cpu(), runs[name][0][2].cpu())),
                    "c_bar_gap_over_max": payload_gap(ad_k,
                                                      runs[name][0][0])}
             for name in ("ref", "cpu")}
    emit({"phase": "fed_round_step", "arch": cfg.name, **job,
          "mesh": dict(pod_mesh.shape), "bf16": out["bf16"], "f32": f32,
          "expected_launches": expected, "plain_holds": holds,
          "c_bar_vs_f64_mix_over_max": mix_gap,
          "pod0_bitwise_when_pod1_replaced": local,
          "one_pod": {"a_b_bitwise": a_b_bitwise, "a_b_gap": a_b_gap,
                      "mu_gap_over_max": mu_gap},
          "one_pod_loss": float(l_1[0]),
          "w_identity_pod0_loss": float(l_i[0])})
    require(launches16 == expected,
            f"fed_round_step bf16 launches {launches16} != {expected}")
    require(runs["flash"][1] == expected,
            f"fed_round_step f32 launches {runs['flash'][1]} != {expected}")
    require(bool(torch.isfinite(l16).all()) and l16.shape == (n,),
            f"fed_round_step bf16 losses {l16}")
    for name, h in holds.items():
        loss = max(abs(float(x)) for x in runs[name][0][2].cpu())
        require(h["loss_gap"] <= 1e-3 + 1e-3 * loss,
                f"fed_round_step f32 flash vs {name}: losses "
                f"{l_k.tolist()} vs {runs[name][0][2].tolist()}")
        require(h["c_bar_gap_over_max"] <= 1e-3,
                f"fed_round_step f32 flash vs {name}: C-bar differs by "
                f"{h['c_bar_gap_over_max']} of its largest entry")
    require(mix_gap <= 1e-6, f"fed_round_step: C-bar is not W.C (f64) from "
            f"the W = I round's C's: {mix_gap}")
    require(local, "fed_round_step: pod 0's round changed when pod 1's "
            "batch and adapter were replaced")
    require(float(l_1[0]) == float(l_i[0]),
            f"fed_round_step: the one-pod round's loss {float(l_1[0])} is "
            f"not pod 0's {float(l_i[0])}")
    require(mu_gap <= 1e-3, f"fed_round_step: the one-pod round's first "
            f"moments part from pod 0's by {mu_gap} of their largest entry")
    require(a_b_gap <= 2 * job["lr"], f"fed_round_step: the one-pod round's "
            f"A / B part from pod 0's by {a_b_gap}, beyond 2·lr")


class Killed(Exception):
    """Raised right after an async checkpoint to stand for a kill."""


def phase_train_async(torch, fa_ops, tl_ops, get_config, dev):
    """``run_federated`` with ``engine="async"`` on fed-100m at full width
    and depth, 8 clients: (a) the zero-staleness limit (uniform latency,
    K = k = 8, int8) held to the eager vmap run within the JAX contract,
    with its launches; (b) the storm (ASYNC_STORM) for 4 flushes, twice,
    bitwise alike, its launches those of its fit groups (1…8 clients
    each, grouped kernels) and evals, every value finite; then killed
    right after its flush-2 checkpoint and resumed, bitwise the
    uninterrupted run, virtual clock included."""
    import numpy as np

    from repro_torch import checkpoint
    from repro_torch.core import async_engine

    cfg = get_config("fed-100m")
    job = TRAIN_ASYNC
    t_phase = time.perf_counter()
    zero = dict(uplink_codec="int8", use_data_sim=False)
    eager = train_job(torch, cfg, dev, "flash", job, "vmap", **zero)[0]
    limit, limit_launches, limit_wall, _ = run_counted(
        torch, fa_ops, tl_ops, lambda: train_job(
            torch, cfg, dev, "flash", job, "vmap", **zero,
            engine="async")[0])
    storm_job = dict(job, rounds=ASYNC_STORM["rounds"])
    storm_kw = {k: v for k, v in ASYNC_STORM.items() if k != "rounds"}

    def storm(**kw):
        return train_job(torch, cfg, dev, "flash", storm_job, "vmap",
                         **storm_kw, **kw)[0]
    runs = [run_counted(torch, fa_ops, tl_ops, storm) for _ in range(2)]
    (a, launches, wall, peak), (b, _, _, _) = runs
    hist = a["history"]
    expected = grouped_launches(cfg, len(a["fit_groups"]) * job[
        "local_steps"], sum(r.evaluated for r in hist))

    path = ROOT / "build" / "chip_smoke" / "train_async.npz"
    if path.exists():
        path.unlink()
    save = async_engine._save_async

    def save_then_die(fed, sched, *args, **kw):
        save(fed, sched, *args, **kw)
        if sched.version == 2:
            raise Killed
    async_engine._save_async = save_then_die
    try:
        storm(checkpoint_path=str(path))
        killed_at = None
    except Killed:
        killed_at = 2
    finally:
        async_engine._save_async = save
    checkpoint.verify(str(path))
    meta = checkpoint.metadata(str(path))
    resumed = storm(checkpoint_path=str(path), resume=True)
    emit({"phase": "train_async", "arch": cfg.name, "dtype": cfg.param_dtype,
          "method": "celora", "attn_impl": "flash", **job,
          "limit": {"wall_s": limit_wall, "launches": limit_launches,
                    "flush_wall_s": [r.wall_s for r in limit["history"]],
                    "eager_round_wall_s": [r.wall_s
                                           for r in eager["history"]],
                    "train_loss": [r.train_loss for r in limit["history"]],
                    "staleness": limit["staleness_mean"],
                    "fit_groups": limit["fit_groups"],
                    "programs": limit["programs"]},
          "storm": {**ASYNC_STORM, "wall_s": wall, "peak_mem_gb": peak,
                    "flush_wall_s": [r.wall_s for r in hist],
                    "sim_times": a["sim_times"],
                    "staleness": a["staleness_mean"],
                    "fit_groups": a["fit_groups"], "launches": launches,
                    "programs": a["programs"],
                    "expected_launches": expected,
                    "train_loss": [r.train_loss for r in hist],
                    "participants": [r.participants for r in hist],
                    "rejected": [r.rejected for r in hist],
                    "failed": [r.failed for r in hist],
                    "uplink_bytes": [r.uplink_bytes for r in hist]},
          "resume": {"killed_after": killed_at, "checkpoint_meta": meta,
                     "sim_times": resumed["sim_times"]},
          "phase_s": time.perf_counter() - t_phase})
    held_to("train_async zero-staleness vs eager vmap", torch, limit, eager)
    require(limit_launches == grouped_launches(
        cfg, len(limit["fit_groups"]) * job["local_steps"],
        sum(r.evaluated for r in limit["history"])),
        f"train_async limit launches {limit_launches}")
    require(limit["fit_groups"] == [job["clients"]] * job["rounds"],
            f"train_async limit fit groups {limit['fit_groups']}")
    require(launches == expected,
            f"train_async storm launches {launches} != {expected}")
    require(any(r.rejected for r in hist) and any(r.failed for r in hist)
            and max(a["staleness_mean"]) > 0 and 1 in a["fit_groups"],
            "train_async: the storm did not fire (no rejection, drop, "
            "stale upload or group of one)")
    require(all(np.isfinite(r.train_loss) and np.all(np.isfinite(r.accs))
                for r in hist) and finite_states(torch, a),
            "train_async storm: a loss, accuracy or state is not finite")
    same_records("train_async storm twice", b["history"], hist)
    require(a["sim_times"] == b["sim_times"] and all(
        same_tensors(torch, x, y) for x, y in zip(a["states"], b["states"])),
        "train_async: two storm runs are not bitwise alike")
    require(killed_at == 2 and meta.get("rounds_done") == 2
            and meta.get("engine") == "async" and meta.get("n_pending", 0) > 0,
            f"train_async: the kill after flush 2 left {meta}")
    same_records("train_async resumed vs uninterrupted", resumed["history"],
                 hist)
    require(resumed["sim_times"] == a["sim_times"] and all(
        same_tensors(torch, x, y)
        for x, y in zip(resumed["states"], a["states"])),
        "train_async: the resumed run is not bitwise the uninterrupted one")


def phase_lm_host_async(torch, fa_ops, tl_ops, get_config, dev, vmap_hist):
    """``launch.train.run`` with ``client_store="host"`` and then with
    ``engine="async"`` (the zero-staleness limit) on lm_train's job for 2
    rounds: exact grouped launches, lm_train's ledger, round 0's loss
    within 1e-3 + 1e-3·|loss| of the eager vmap run's (``vmap_hist``), the
    host store's adapters back on the host."""
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    cfg = get_config(LM_TRAIN["arch"])
    for name, over in (("lm_host", dict(client_store="host")),
                       ("lm_async", dict(engine="async"))):
        job = dict(LM_TRAIN, rounds=2, client_parallelism="vmap", **over)
        out, launches, wall, peak = run_counted(
            torch, fa_ops, tl_ops,
            lambda: train.run(**job, verbose=False, device=dev))
        hist = out["history"]
        steps = len(hist) * job["local_steps"]
        expected = step_launches(cfg, steps, grouped=True)
        on_host = all(t.device.type == "cpu" for a in out["adapters"]
                      for t in tree_leaves(a))
        emit({"phase": name, **job, "rounds_detail": hist, "wall_s": wall,
              "peak_mem_gb": peak, "launches": launches,
              "expected_launches": expected, "adapters_on_host": on_host,
              "vmap_round0_loss": vmap_hist[0]["loss"]})
        require(launches == expected,
                f"{name} launches {launches} != expected {expected}")
        for a, b in zip(hist, vmap_hist):
            require((a["participants"], a["uplink_bytes"],
                     a["downlink_bytes"], a["uplink_floats"])
                    == (b["participants"], b["uplink_bytes"],
                        b["downlink_bytes"], b["uplink_floats"]),
                    f"{name} round {a['round']}: the ledgers differ from "
                    f"the eager vmap run's")
        a, b = hist[0]["loss"], vmap_hist[0]["loss"]
        require(abs(a - b) <= 1e-3 + 1e-3 * abs(b),
                f"{name} round 0: loss {a} vs the eager vmap run's {b}")
        require(on_host == (name == "lm_host"),
                f"{name}: adapters on the host: {on_host}")


# ---------------------------------------------------------------------------
# lm_rwkv: the LM driver on rwkv6-1.6b, loop and vmap
# ---------------------------------------------------------------------------

#: the lm_rwkv job: rwkv6-1.6b at full width and depth (bf16 backbone, f32
#: adapters) through ``launch.train.run``; 128 tokens a sequence, so that
#: a grouped tile (128 rows) lies in one sequence and the grouped forward
#: takes the wgmma route.  Training runs the plain recurrence (wkv6 is
#: forward-only), whose autograd graph holds ~3 (B,H,hd,hd) f32 states a
#: step a layer: ~10 GB at 2 sequences, ~19 GB for the vmap batch of 4.
LM_RWKV = dict(arch="rwkv6-1.6b", clients=2, rounds=2, local_steps=2,
               batch=2, seq=128, method="celora")


def phase_lm_rwkv(torch, wkv_ops, tl_ops, get_config, dev):
    """``launch.train.run`` on rwkv6-1.6b, loop then vmap (the default):
    the same ledger, round 0's loss within 1e-3 + 1e-3·|loss| (later rounds
    amplify bf16 rounding), every projection of the vmap run on the grouped
    tri-LoRA kernels with exact launch counts (the routes printed), and no
    wkv6 launch."""
    import numpy as np

    from repro_torch.launch import train

    cfg = get_config(LM_RWKV["arch"])
    proj = 4 * cfg.n_layers             # the time mix's r/k/v/o per layer
    out, lines = {}, {}
    for mode in ("loop", "vmap"):
        torch.cuda.reset_peak_memory_stats()
        wkv_ops.reset_launches()              # counts of this path only
        tl_ops.reset_launches()
        t0 = time.perf_counter()
        out[mode] = train.run(**LM_RWKV, client_parallelism=mode,
                              verbose=False, device=dev)
        torch.cuda.synchronize()
        hist = out[mode]["history"]
        steps = (sum(len(r["participants"]) for r in hist) if mode == "loop"
                 else len(hist)) * LM_RWKV["local_steps"]
        expected = {"wkv6": 0, **{
            k: v for k, v in step_launches(
                cfg, steps, grouped=mode == "vmap").items()
            if k.startswith("tri_lora")}}
        lines[mode] = {"wall_s": time.perf_counter() - t0,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": {**wkv_ops.LAUNCHES, **tl_ops.LAUNCHES},
                       "expected_launches": expected,
                       "routes": dict(tl_ops.ROUTES),
                       "rounds_detail": [{k: r[k] for k in (
                           "round", "loss", "uplink_bytes",
                           "downlink_bytes", "participants", "wall_s")}
                           for r in hist]}
    emit({"phase": "lm_rwkv", **LM_RWKV, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.param_dtype,
          "adapter_dtype": "float32", "projections": proj, **lines})
    for mode, line in lines.items():
        require(line["launches"] == line["expected_launches"],
                f"lm_rwkv {mode} launches {line['launches']} != expected "
                f"{line['expected_launches']}")
    for mode, key in (("loop", "fwd_wgmma"), ("vmap", "fwd_grouped_wgmma")):
        fwd = sum(v for k, v in lines[mode]["expected_launches"].items()
                  if k.startswith("tri_lora_fwd"))
        want = {**{k: 0 for k in tl_ops.ROUTES}, key: fwd}
        require(lines[mode]["routes"] == want,
                f"lm_rwkv {mode} routes {lines[mode]['routes']} != {want}: "
                f"every bf16 forward (128-token sequences when grouped) "
                f"takes the wgmma route")
    loop_h, vmap_h = out["loop"]["history"], out["vmap"]["history"]
    for a, b in zip(vmap_h, loop_h):
        require((a["participants"], a["uplink_bytes"], a["downlink_bytes"],
                 a["uplink_floats"]) == (b["participants"], b["uplink_bytes"],
                                         b["downlink_bytes"],
                                         b["uplink_floats"]),
                f"lm_rwkv round {a['round']}: the ledgers differ")
    a, b = vmap_h[0]["loss"], loop_h[0]["loss"]
    require(abs(a - b) <= 1e-3 + 1e-3 * abs(b),
            f"lm_rwkv round 0: vmap loss {a} vs loop {b}")
    require(all(np.isfinite(r["loss"]) for r in loop_h + vmap_h),
            "lm_rwkv: a loss is not finite")
    del out


# ---------------------------------------------------------------------------
# dense_configs: qwen2.5-14b, qwen3-32b, starcoder2-7b
# ---------------------------------------------------------------------------

DENSE_CONFIGS = ("qwen2.5-14b", "qwen3-32b", "starcoder2-7b")
#: qwen2.5-14b's serving job: 8 requests from 4 users through 4 slots
DENSE_SERVE = dict(arch="qwen2.5-14b", users=4, requests=8, slots=4,
                   prompt_len=64, gen=16)


def phase_dense_configs(torch, ops, serve, model, random_bank, get_config,
                        dev):
    """qwen2.5-14b at full width and depth (bf16, random weights) serving 8
    requests from 4 users through ServeEngine: every request finishes and
    every step launches both decode kernels.  Then each of the three dense
    configs at full width, 2 layers, f32 (the oracle phase's check):
    ServeEngine tokens equal serve_naive's, request for request — QKV bias
    (qwen2.5, starcoder2), qk RMSNorm (qwen3), LayerNorm + GELU
    (starcoder2), head dim 128.  Each model is freed before the next."""
    serve_job(torch, ops, serve, model, random_bank, get_config, dev,
              DENSE_SERVE, "dense_configs")
    for name in DENSE_CONFIGS:
        dense_oracle(torch, ops, serve, random_bank, get_config, model, dev,
                     name)
        gc.collect()
        torch.cuda.empty_cache()


def serve_job(torch, ops, serve, model, random_bank, get_config, dev,
              job: dict, phase: str, graph: bool = False) -> dict:
    """``job["arch"]`` at full width and depth (its own dtype, random
    weights) serving ``job["requests"]`` requests from ``job["users"]``
    users through a ServeEngine of ``job["slots"]`` slots: every request
    finishes, every step launches both decode kernels on every layer, all
    on their 16-byte routes.  With ``graph`` the job runs again under
    ``disable_jit`` and is held to the default (captured) run
    (``decode_graph``).  Emits one ``phase`` line, frees the model and
    returns the launches."""
    from repro_torch.core import jit_cache
    from repro_torch.tree import tree_leaves

    cfg = get_config(job["arch"])
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = model.init_params(cfg, gen)
        bank = random_bank(cfg, job["users"], gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_weights = sum(t.numel() for t in tree_leaves(params["base"]))
    max_len = job["prompt_len"] + job["gen"]
    eng = serve.ServeEngine(cfg, params["base"], bank, slots=job["slots"],
                            max_len=max_len, device=dev)
    reqs = serve.make_requests(bank, job["requests"],
                               prompt_len=job["prompt_len"], gen=job["gen"],
                               vocab=cfg.vocab_size, seed=0)
    run = engine_run(torch, ops, eng, reqs)
    done, wall = run["done"], run["wall"]
    launches, routes, steps = run["launches"], run["routes"], run["steps"]
    lens = sorted({len(v) for v in done.values()})
    n_targets = len(cfg.lora_targets)
    expected = {"grouped_gemv": n_targets * cfg.n_layers * steps,
                "decode_attention": cfg.n_layers * steps}
    ring = model.init_decode_cache(cfg, 1, max_len, device="meta")[
        "groups"]["0"]["k"].shape[2]              # (layers, B, ring, K, hd)
    emit({"phase": phase, "serve": {
        "arch": cfg.name, "dtype": cfg.param_dtype, "layers": cfg.n_layers,
        "kinds": sorted(set(cfg.kinds())), "window": cfg.window,
        "ring": ring, "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "weights": n_weights,
        "weight_gb": n_weights * 2 / 1e9, "init_s": init_s, **job,
        "finished": len(done), "token_lengths": lens, "steps": steps,
        "wall_s": wall, "ms_per_step": 1e3 * wall / steps,
        "tok_per_s": sum(r.gen for r in reqs) / wall, "launches": launches,
        "expected_launches": expected, "routes": routes,
        "programs": run["programs"], "peak_mem_gb": run["peak"]}})
    require(len(done) == len(reqs) and lens == [max_len],
            f"{cfg.name} finished {len(done)}/{len(reqs)} requests, lengths "
            f"{lens}")
    require(launches == expected, f"{cfg.name} serve launches {launches} "
            f"over {steps} steps != {expected}")
    require(routes["gemv_vec"] == launches["grouped_gemv"]
            and routes["attn_vec"] == launches["decode_attention"],
            f"{cfg.name}: the serve path left the 16-byte routes: {routes}")
    require(all(bool(((v >= 0) & (v < cfg.vocab_size)).all())
                for v in done.values()), "token ids out of range")
    if graph:
        eng = serve.ServeEngine(cfg, params["base"], bank,
                                slots=job["slots"], max_len=max_len,
                                device=dev)
        with jit_cache.disable_jit():
            eager = engine_run(torch, ops, eng, reqs)
        decode_graph(phase, run, eager, all(
            np_equal(done[r.rid], eager["done"][r.rid]) for r in reqs))
    del eng, params, bank, done, run
    free(torch)
    return launches


def dense_oracle(torch, ops, serve, random_bank, get_config, model, dev,
                 name: str, phase: str = "dense_configs",
                 **overrides) -> None:
    """The oracle phase's check on ``name`` at full width, 2 layers, f32
    (and the config fields ``overrides``): ServeEngine ≡ serve_naive per
    request."""
    cfg = get_config(name).with_overrides(n_layers=2, param_dtype="float32",
                                          **overrides)
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.inference_mode():
        params = model.init_params(cfg, gen)
        bank = random_bank(cfg, 4, gen)
    reqs = serve.make_requests(bank, 8, prompt_len=16, gen=8,
                               vocab=cfg.vocab_size, seed=1)
    ops.reset_launches()
    eng = serve.ServeEngine(cfg, params["base"], bank, slots=4, max_len=24,
                            device=dev)
    t0 = time.perf_counter()
    got = eng.run(reqs)
    torch.cuda.synchronize()
    engine_launches = dict(ops.LAUNCHES)
    wall = time.perf_counter() - t0
    want = serve.serve_naive(cfg, params["base"], bank, reqs, device=dev)
    same = [bool(np_equal(got[r.rid], want[r.rid])) for r in reqs]
    emit({"phase": phase, "oracle": {
        "arch": cfg.name, "dtype": "float32", "layers": 2,
        "d_model": cfg.d_model, "head_dim": cfg.hd,
        "attn_bias": cfg.attn_bias, "qk_norm": cfg.qk_norm,
        "norm": cfg.norm_type, "mlp": cfg.mlp_type,
        "kinds": sorted(set(cfg.kinds())), "overrides": overrides,
        "users": 4, "requests": len(reqs), "engine_steps": eng.steps,
        "engine_wall_s": wall, "engine_launches": engine_launches,
        "token_identical": sum(same),
        "sample": [int(t) for t in got[reqs[0].rid][-8:]]}})
    require(all(same) and len(got) == len(reqs),
            f"{cfg.name}: ServeEngine diverged from serve_naive on "
            f"{[r.rid for r, s in zip(reqs, same) if not s]}")
    require(engine_launches["grouped_gemv"] > 0
            and engine_launches["decode_attention"] > 0,
            f"{cfg.name}: the oracle's engine launched {engine_launches}")
    del eng, params, bank, got, want
    free(torch)            # the decode programs anchor the merged weights


# ---------------------------------------------------------------------------
# h2o-danube-3-4b: sliding-window attention at head dim 120
# ---------------------------------------------------------------------------

H2O = "h2o-danube-3-4b"
#: h2o_train's job: the LM driver on 2 clients, 1 round of 1 local step of
#: one 8192-token sequence each (twice the 4,096 window), full width and
#: depth, bf16 backbone, f32 adapters, no uplink codec (the plain ledger);
#: run on client_parallelism="vmap" (both clients as one batch of 2x8192
#: tokens; cfg.remat keeps each layer's input only and recomputes its
#: forward in the backward, where 70.0 GB was the peak without it), then
#: on "loop"
H2O_TRAIN = dict(arch=H2O, clients=2, rounds=1, local_steps=1, batch=1,
                 seq=8192, method="celora", attn_impl="flash")
#: h2o_serve's job: 8 requests of 64 + 16 tokens from 4 users, 4 slots
H2O_SERVE = dict(arch=H2O, users=4, requests=8, slots=4, prompt_len=64,
                 gen=16)


def phase_h2o_train(torch, fa_ops, tl_ops, get_config, dev) -> dict:
    """``launch.train.run`` on h2o-danube-3-4b at full width and depth
    (H2O_TRAIN) on client_parallelism="vmap", then "loop": exact flash
    launches (24 forward, dq and dk/dv a local step: for both clients at
    once on vmap, per client on loop; every block is ``swa`` at head dim
    120, so every one runs under the 4,096 window, on the 16-byte routes)
    and tri-LoRA launches (grouped on
    vmap) with their routes, a finite loss, the plain ledger; tokens/s,
    wall time, peak memory.  The loop run's round-0 loss (the forward on
    the initial adapters: one local step) within 1e-3 + 1e-3·|loss| of the
    vmap run's.  Returns the vmap run's launches."""
    import numpy as np

    from repro_torch.launch import train

    cfg = get_config(H2O)
    # every block is swa: every flash call is at hd 120 under the window
    require(set(cfg.kinds()) == {"swa"} and cfg.hd == 120
            and cfg.window == 4096, f"{H2O}: kinds {set(cfg.kinds())}, "
            f"hd {cfg.hd}, window {cfg.window}")
    layers = cfg.n_layers
    c_bytes = layers * len(cfg.lora_targets) * cfg.lora_rank ** 2 * 4
    out_launches, losses = None, {}
    for mode in ("vmap", "loop"):
        job = dict(H2O_TRAIN, client_parallelism=mode)
        torch.cuda.reset_peak_memory_stats()
        fa_ops.reset_launches()               # counts of the main path only
        tl_ops.reset_launches()
        t0 = time.perf_counter()
        out = train.run(**job, verbose=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
        flash_routes, tri_routes = dict(fa_ops.ROUTES), dict(tl_ops.ROUTES)
        hist = out["history"]
        steps = job["rounds"] * job["local_steps"] * (
            job["clients"] if mode == "loop" else 1)
        expected = step_launches(cfg, steps, grouped=mode == "vmap")
        tokens = job["rounds"] * job["local_steps"] * job["clients"] * \
            job["batch"] * job["seq"]
        round_wall = sum(r["wall_s"] for r in hist)
        emit({"phase": "h2o_train", **job, "layers": layers,
              "d_model": cfg.d_model, "heads": cfg.n_heads,
              "kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
              "window": cfg.window, "dtype": cfg.param_dtype,
              "rounds_detail": hist, "wall_s_with_init": wall,
              "round_wall_s": round_wall, "trained_tokens": tokens,
              "trained_tok_per_s": tokens / round_wall,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": launches, "expected_launches": expected,
              "flash_routes": flash_routes,
              "tri_lora_routes": tri_routes})
        require(launches == expected,
                f"h2o_train {mode} launches {launches} != {expected}")
        require(flash_routes == {"fwd_vec": expected["flash_fwd"],
                                 "fwd_scalar": 0,
                                 "bwd_vec": 2 * layers * steps,
                                 "bwd_scalar": 0},
                f"h2o_train {mode} flash routes {flash_routes}")
        require(all(np.isfinite(r["loss"]) for r in hist),
                f"h2o_train {mode}: loss {[r['loss'] for r in hist]}")
        n = job["clients"]
        require(all(r["uplink_bytes"] == n * c_bytes
                    and r["downlink_bytes"] == n * c_bytes for r in hist),
                f"h2o_train {mode} bytes "
                f"{[(r['uplink_bytes'], r['downlink_bytes']) for r in hist]}"
                f", expected {n * c_bytes} each way")
        out_launches = out_launches or launches
        losses[mode] = hist[0]["loss"]
        del out
        free(torch)
    require(abs(losses["loop"] - losses["vmap"])
            <= 1e-3 + 1e-3 * abs(losses["vmap"]),
            f"h2o_train round 0: loop loss {losses['loop']} vs vmap "
            f"{losses['vmap']}")
    return out_launches


def phase_h2o_oracle(torch, fa_ops, model, get_config, dev) -> None:
    """h2o-danube-3-4b at full width, 2 layers, f32, on one 8192-token
    sequence: the loss and the adapter gradients through the flash kernels
    against the plain blockwise attention (``ref`` would build 32 x 8192^2
    scores), both on the card.  C and B are moved off their zero-delta
    init, as in card_vs_cpu, so that every factor has a gradient."""
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(H2O).with_overrides(n_layers=2, param_dtype="float32")
    params = random_params(torch, model, cfg, dev, 13)
    batch = lm_batch(torch, cfg.vocab_size, 1, 8192, 13, dev)
    res = {}
    for impl in ("flash", "blockwise"):
        ad = tree_map(lambda t: t.detach().requires_grad_(True),
                      params["adapter"])
        fa_ops.reset_launches()
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(cfg, ad, params["base"], batch,
                                attn_impl=impl)
        grads = torch.autograd.grad(loss, tree_leaves(ad))
        torch.cuda.synchronize()
        res[impl] = (float(loss.detach()), grads, dict(fa_ops.LAUNCHES),
                     time.perf_counter() - t0)
        del loss, ad
    (lf, gf, nf, tf), (lb, gb, nb, tb) = res["flash"], res["blockwise"]
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(gf, gb)]
    rel = abs(lf - lb) / abs(lb)
    emit({"phase": "h2o_oracle", "arch": cfg.name, "dtype": "float32",
          "layers": 2, "seq": 8192, "window": cfg.window, "head_dim": cfg.hd,
          "loss_flash": lf, "loss_blockwise": lb, "loss_rel_err": rel,
          "grad_leaves": len(errs), "grad_max_err_over_max": max(errs),
          "launches_flash": nf, "launches_blockwise": nb,
          "wall_s": {"flash": tf, "blockwise": tb}})
    require(rel <= 1e-4, f"h2o_oracle loss flash {lf} vs blockwise {lb}")
    require(max(errs) <= 1e-3, f"h2o_oracle adapter gradients differ by "
            f"{max(errs)} of their largest entry")
    require(nf == {"flash_fwd": 2 + recomputed(cfg), "flash_dq": 2,
                   "flash_dkv": 2}
            and nb == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
            f"h2o_oracle launches: flash {nf}, blockwise {nb}")
    del params, res, gf, gb
    gc.collect()
    torch.cuda.empty_cache()


def phase_h2o_serve(torch, ops, serve, model, random_bank, get_config,
                    dev) -> None:
    """h2o-danube-3-4b at full width and depth (bf16) serving H2O_SERVE
    through ServeEngine (both decode kernels on every layer of every step,
    decode attention at head dim 120 and a group of 4), then the f32
    oracle at full width, 2 layers: ServeEngine tokens equal serve_naive's
    request for request."""
    serve_job(torch, ops, serve, model, random_bank, get_config, dev,
              H2O_SERVE, "h2o_serve", graph=True)
    dense_oracle(torch, ops, serve, random_bank, get_config, model, dev,
                 H2O, "h2o_serve")
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the MoE block (llama4-scout-17b-a16e, grok-1-314b) and the RG-LRU hybrid
# (recurrentgemma-2b, flash at head dim 256)
# ---------------------------------------------------------------------------

LLAMA4 = "llama4-scout-17b-a16e"
GROK = "grok-1-314b"
RG = "recurrentgemma-2b"
#: moe_train's job: the LM driver on llama4-scout at full width, 8 of its 48
#: layers (~34 GB of bf16 weights), bf16 backbone, f32 adapters; 2 clients,
#: 1 round of 1 local step of one 4096-token sequence each (four
#: 1024-token dispatch groups a sequence), the plain ledger; vmap, then loop
MOE_TRAIN = dict(arch=LLAMA4, layers=8, clients=2, rounds=1, local_steps=1,
                 batch=1, seq=4096, method="celora", attn_impl="flash")
#: moe_oracle: llama4-scout at full width, 2 layers, f32, one 2048-token
#: sequence: flash against attn_impl="ref"
MOE_ORACLE = dict(arch=LLAMA4, layers=2, seq=2048)
#: moe_serve's job: grok-1 at full width, 2 of its 64 layers (~21 GB of
#: bf16 weights): 8 requests of 64 + 16 tokens from 4 users, 4 slots
MOE_SERVE = dict(arch=GROK, layers=2, users=4, requests=8, slots=4,
                 prompt_len=64, gen=16)
#: rg_train's job: the LM driver on recurrentgemma-2b at full width and
#: depth (26 layers: 8 x (rglru, rglru, swa) + 2 rglru), bf16 backbone, f32
#: adapters; 2 clients, 1 round of 1 local step of one 4096-token sequence
#: each (past the 2,048 window, eight 512-step scan chunks); vmap, then loop
RG_TRAIN = dict(arch=RG, clients=2, rounds=1, local_steps=1, batch=1,
                seq=4096, method="celora", attn_impl="flash")
#: rg_oracle: full width, 3 layers (one pattern), f32, 1 x 4096: flash at
#: hd 256 against attn_impl="blockwise"
RG_ORACLE = dict(layers=3, seq=4096)
#: rg_decode: generate() at full depth, bf16: 8 prompts of 32 tokens and 32
#: new ones; then 3 layers in f32, 2 x 64 tokens, decode against the forward
RG_DECODE = dict(batch=8, prompt_len=32, gen=32)
RG_DECODE_ORACLE = dict(layers=3, batch=2, seq=64)


def cut_depth(get_config, name: str, layers: int) -> str:
    """The registered name of ``name`` at ``layers`` layers (registered on
    first use), so that the entry points that take an arch name build the
    depth a phase cuts to; every other field is the config's."""
    from repro_torch.models.config import register

    cut = f"{name}@{layers}-layers"
    try:
        get_config(cut)
    except KeyError:
        register(get_config(name).with_overrides(name=cut, n_layers=layers))
    return cut


class RouteTap:
    """Wraps ``moe._route`` while active: sums each call's router picks
    (B·S·top_k) and the picks inside capacity (the dispatch tensor's sum)
    on the device, and keeps each of the first ``keep`` calls' top-k
    expert sets (sorted indices, (B, S, k)) for a comparison of two runs.
    Calls repeated by activation checkpointing count again; the drop share
    is a ratio of the two sums, which they leave as it is."""

    def __init__(self, torch, keep: int = 0):
        from repro_torch.models import moe
        self.torch, self.moe, self.keep = torch, moe, keep
        self.picks, self.kept, self.sets = 0, [], []

    def __enter__(self):
        torch, orig = self.torch, self.moe._route

        def tapped(cfg, router_w, x):
            dispatch, combine, aux = orig(cfg, router_w, x)
            with torch.no_grad():
                self.picks += x.shape[0] * x.shape[1] * cfg.top_k
                self.kept.append(dispatch.sum())
                if len(self.sets) < self.keep:
                    self.sets.append(torch.topk(
                        x.float() @ router_w, cfg.top_k, dim=-1).indices
                        .sort(-1).values)
            return dispatch, combine, aux

        self._orig = orig
        self.moe._route = tapped
        return self

    def __exit__(self, *exc):
        self.moe._route = self._orig
        return False

    def drop_share(self) -> float:
        kept = float(self.torch.stack(self.kept).sum()) if self.kept else 0.0
        return 1.0 - kept / max(self.picks, 1)


class LossTap:
    """Wraps ``model.loss_fn`` while active and keeps every call's metrics
    (ce, aux, acc: scalars, or (m,) vectors under ``adapter_rows``) as
    floats: the per-client aux of a driver run, which its history does not
    carry."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def __enter__(self):
        orig = self.model.loss_fn

        def tapped(*args, **kw):
            loss, met = orig(*args, **kw)
            self.calls.append({k: v.detach().float().cpu().reshape(-1)
                               .tolist() for k, v in met.items()})
            return loss, met

        self._orig = orig
        self.model.loss_fn = tapped
        return self

    def __exit__(self, *exc):
        self.model.loss_fn = self._orig
        return False


def lm_job_phase(torch, fa_ops, tl_ops, model, get_config, dev, job: dict,
                 phase: str, arch: str, route_tap: bool = False) -> dict:
    """``launch.train.run`` on ``arch`` (job's shape) on
    client_parallelism="vmap", then "loop": exact flash and tri-LoRA
    launches (``step_launches``; grouped on vmap) on their routes (flash
    on the 16-byte routes, every tri-LoRA forward on the wgmma route), a
    finite loss, the plain ledger, tokens/s and
    peak memory; round 0's loss within 1e-3 + 1e-3·|loss| across the two
    and each client's aux (the loss_fn calls' metrics, ``LossTap``) too;
    with ``route_tap`` the share of routed picks dropped at capacity.
    Each run goes through the captured fit programs; the taps read every
    ``loss_fn`` call, which a replay does not make, so each mode runs
    again eagerly (``jit_cache.disable_jit``) under the taps, and the
    captured run must be bitwise that run (records but the times, and
    launches).  Returns the vmap run's launches."""
    import numpy as np

    from repro_torch.core import jit_cache
    from repro_torch.launch import train

    cfg = get_config(arch)
    n_adapters = sum(adapted_per_layer(cfg, k) for k in cfg.kinds())
    c_bytes = n_adapters * cfg.lora_rank ** 2 * 4
    run_kw = {k: v for k, v in job.items() if k not in ("arch", "layers")}
    out_launches, losses, auxes = None, {}, {}
    for mode in ("vmap", "loop"):
        steps = job["rounds"] * job["local_steps"] * (
            job["clients"] if mode == "loop" else 1)
        expected = step_launches(cfg, steps, grouped=mode == "vmap")

        def run():
            return train.run(arch=arch, **run_kw, client_parallelism=mode,
                             verbose=False, device=dev)
        out, launches, wall, peak = run_counted(torch, fa_ops, tl_ops, run)
        flash_routes = dict(fa_ops.ROUTES)
        tri_routes = dict(tl_ops.ROUTES)
        hist = out["history"]
        del out
        free(torch)
        # the taps read every loss_fn call, which a replay of the captured
        # fit does not make: the same run again, eager, under the taps,
        # and the captured run held to it bitwise
        with jit_cache.disable_jit(), LossTap(model) as lt, \
                RouteTap(torch) as rt:
            out, eager_launches, _, _ = run_counted(torch, fa_ops, tl_ops,
                                                    run)
        bitwise = (lm_records(hist) == lm_records(out["history"])
                   and eager_launches == launches)
        aux = ([a for c in lt.calls for a in c["aux"]] if mode == "loop"
               else lt.calls[0]["aux"])
        tokens = job["rounds"] * job["local_steps"] * job["clients"] * \
            job["batch"] * job["seq"]
        round_wall = sum(r["wall_s"] for r in hist)
        emit({"phase": phase, "arch": arch, **run_kw, "mode": mode,
              "layers": cfg.n_layers, "kinds": sorted(set(cfg.kinds())),
              "d_model": cfg.d_model, "heads": cfg.n_heads,
              "kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
              "window": cfg.window, "experts": cfg.n_experts,
              "top_k": cfg.top_k, "dtype": cfg.param_dtype,
              "rounds_detail": hist, "client_aux": aux,
              "loss_fn_calls": lt.calls,
              **({"routed_picks": rt.picks,
                  "dropped_share": rt.drop_share()} if route_tap else {}),
              "wall_s_with_init": wall, "round_wall_s": round_wall,
              "trained_tokens": tokens,
              "trained_tok_per_s": tokens / round_wall,
              "peak_mem_gb": peak, "launches": launches,
              "expected_launches": expected, "flash_routes": flash_routes,
              "tri_lora_routes": tri_routes,
              "eager": {"rounds_detail": out["history"],
                        "launches": eager_launches,
                        "bitwise_the_captured_run": bitwise}})
        require(bitwise, f"{phase} {mode}: the captured run is not bitwise "
                f"the eager run (records, launches)")
        require(launches == expected,
                f"{phase} {mode} launches {launches} != {expected}")
        require(flash_routes["fwd_scalar"] == 0
                and flash_routes["bwd_scalar"] == 0,
                f"{phase} {mode} flash routes {flash_routes}")
        wgmma = "fwd_grouped_wgmma" if mode == "vmap" else "fwd_wgmma"
        require(tri_routes == {**{k: 0 for k in tri_routes},
                               wgmma: sum(v for k, v in expected.items()
                                          if k.startswith("tri_lora_fwd"))},
                f"{phase} {mode} tri-LoRA routes {tri_routes}: every bf16 "
                f"forward of 4096-token sequences takes the wgmma route")
        require(all(np.isfinite(r["loss"]) for r in hist),
                f"{phase} {mode}: loss {[r['loss'] for r in hist]}")
        n = job["clients"]
        require(all(r["uplink_bytes"] == n * c_bytes
                    and r["downlink_bytes"] == n * c_bytes for r in hist),
                f"{phase} {mode} bytes "
                f"{[(r['uplink_bytes'], r['downlink_bytes']) for r in hist]}"
                f", expected {n * c_bytes} each way")
        require(len(aux) == n and all(np.isfinite(a) for a in aux),
                f"{phase} {mode}: per-client aux {aux}")
        if cfg.is_moe:
            require(all(a > 0 for a in aux),
                    f"{phase} {mode}: MoE aux {aux} not > 0")
        out_launches = out_launches or launches
        losses[mode], auxes[mode] = hist[0]["loss"], aux
        del out
        free(torch)
    require(abs(losses["loop"] - losses["vmap"])
            <= 1e-3 + 1e-3 * abs(losses["vmap"]),
            f"{phase} round 0: loop loss {losses['loop']} vs vmap "
            f"{losses['vmap']}")
    require(all(abs(a - b) <= 1e-3 + 1e-3 * abs(b)
                for a, b in zip(auxes["loop"], auxes["vmap"])),
            f"{phase} per-client aux: loop {auxes['loop']} vs vmap "
            f"{auxes['vmap']}")
    return out_launches


def phase_moe_train(torch, fa_ops, tl_ops, model, get_config, dev) -> dict:
    """llama4-scout at full width, MOE_TRAIN's depth, through the LM
    driver on vmap and loop (``lm_job_phase``): the tri-LoRA launches are
    the attention projections' only (the experts are frozen and take no
    adapter), each client's aux > 0 and the same on both paths."""
    arch = cut_depth(get_config, LLAMA4, MOE_TRAIN["layers"])
    cfg = get_config(arch)
    require(cfg.is_moe and cfg.top_k == 1 and cfg.n_experts == 16
            and set(cfg.kinds()) == {"attn"},
            f"{arch}: experts {cfg.n_experts}, top_k {cfg.top_k}")
    return lm_job_phase(torch, fa_ops, tl_ops, model, get_config, dev,
                        MOE_TRAIN, "moe_train", arch, route_tap=True)


def phase_moe_oracle(torch, fa_ops, model, get_config, dev) -> None:
    """llama4-scout at full width, 2 layers, f32, one 2048-token sequence:
    the loss and adapter gradients through flash against ``ref`` (loss
    within 1e-4·|loss|, gradients within 1e-3 of their largest entry), and
    the tokens whose top-k expert set differs between the two runs
    (``RouteTap``; reported, not re-drawn)."""
    from repro_torch.tree import tree_leaves, tree_map

    job = MOE_ORACLE
    cfg = get_config(LLAMA4).with_overrides(n_layers=job["layers"],
                                            param_dtype="float32")
    params = random_params(torch, model, cfg, dev, 21)
    batch = lm_batch(torch, cfg.vocab_size, 1, job["seq"], 21, dev)
    res = {}
    for impl in ("flash", "ref"):
        ad = tree_map(lambda t: t.detach().requires_grad_(True),
                      params["adapter"])
        fa_ops.reset_launches()
        t0 = time.perf_counter()
        with RouteTap(torch, keep=cfg.n_layers) as rt:
            loss, met = model.loss_fn(cfg, ad, params["base"], batch,
                                      attn_impl=impl)
            grads = torch.autograd.grad(loss, tree_leaves(ad))
        torch.cuda.synchronize()
        res[impl] = (float(loss.detach()), grads, dict(fa_ops.LAUNCHES),
                     time.perf_counter() - t0, float(met["aux"].detach()),
                     rt.sets, rt.drop_share())
        del loss, ad
    (lf, gf, nf, tf, af, sf, df), (lr, gr, nr, tr, ar, sr, dr) = \
        res["flash"], res["ref"]
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(gf, gr)]
    rel = abs(lf - lr) / abs(lr)
    flips = [int((a != b).any(-1).sum()) for a, b in zip(sf, sr)]
    emit({"phase": "moe_oracle", "arch": cfg.name, "dtype": "float32",
          "layers": cfg.n_layers, "seq": job["seq"], "experts": cfg.n_experts,
          "top_k": cfg.top_k, "loss_flash": lf, "loss_ref": lr,
          "loss_rel_err": rel, "aux_flash": af, "aux_ref": ar,
          "dropped_share": {"flash": df, "ref": dr},
          "grad_leaves": len(errs), "grad_max_err_over_max": max(errs),
          "routing_flips_per_layer": flips,
          "launches_flash": nf, "launches_ref": nr,
          "wall_s": {"flash": tf, "ref": tr}})
    require(len(flips) == cfg.n_layers, f"moe_oracle tapped {len(flips)} "
            f"routing calls, expected {cfg.n_layers}")
    require(rel <= 1e-4, f"moe_oracle loss flash {lf} vs ref {lr} "
            f"(routing flips per layer {flips})")
    require(max(errs) <= 1e-3, f"moe_oracle adapter gradients differ by "
            f"{max(errs)} of their largest entry (routing flips per layer "
            f"{flips})")
    require(nf == {"flash_fwd": 2 + recomputed(cfg), "flash_dq": 2,
                   "flash_dkv": 2}
            and nr == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
            f"moe_oracle launches: flash {nf}, ref {nr}")
    del params, res, gf, gr
    free(torch)


def phase_moe_serve(torch, ops, serve, model, random_bank, get_config,
                    dev) -> dict:
    """grok-1 at full width, MOE_SERVE's depth, bf16, serving through
    ServeEngine (``serve_job``: every request finishes, both decode kernels
    on every layer of every step on the 16-byte routes; the MoE MLP routes
    each token alone, capacity 1), then the oracle: llama4-scout at full
    width, 2 layers, f32, with capacity_factor = n_experts (no drops, as
    tests/test_decode_consistency.py sets it): ServeEngine tokens equal
    serve_naive's request for request."""
    arch = cut_depth(get_config, GROK, MOE_SERVE["layers"])
    from repro_torch.models import moe
    require(moe.capacity(get_config(arch), 1) == 1,
            "one decode token must route with capacity 1")
    job = {k: v for k, v in MOE_SERVE.items() if k != "layers"}
    launches = serve_job(torch, ops, serve, model, random_bank, get_config,
                         dev, dict(job, arch=arch), "moe_serve")
    cfg = get_config(LLAMA4)
    dense_oracle(torch, ops, serve, random_bank, get_config, model, dev,
                 LLAMA4, "moe_serve",
                 capacity_factor=float(cfg.n_experts))
    free(torch)
    return launches


def phase_rg_train(torch, fa_ops, tl_ops, model, get_config, dev) -> dict:
    """recurrentgemma-2b at full width and depth through the LM driver on
    vmap and loop (``lm_job_phase``): 8 swa layers at hd 256 under the
    2,048 window, each run's flash launches 8 forward + 8 recomputed (every
    swa layer sits in a checkpointed group), 8 dq and 8 dk/dv a step;
    tri-LoRA on the 4 attention projections of the 8 swa layers and on
    w_in / w_out of the 18 rglru layers (68 a pass, 64 again for the 24
    group layers, 67 dx: layer 0's w_in reads the frozen embedding)."""
    cfg = get_config(RG)
    require(cfg.kinds().count("swa") == 8 and cfg.kinds().count("rglru")
            == 18 and cfg.hd == 256 and cfg.window == 2048,
            f"{RG}: kinds {cfg.kinds()}, hd {cfg.hd}, window {cfg.window}")
    want = step_launches(cfg, 1)
    require(want["flash_fwd"] == 16 and want["tri_lora_fwd"] == 132
            and want["tri_lora_dx"] == 67, f"{RG} step launches {want}")
    return lm_job_phase(torch, fa_ops, tl_ops, model, get_config, dev,
                        RG_TRAIN, "rg_train", RG)


def phase_rg_oracle(torch, fa_ops, model, get_config, dev) -> None:
    """recurrentgemma-2b at full width, 3 layers (one pattern), f32, one
    4096-token sequence: the loss and adapter gradients through flash at
    hd 256 against the plain blockwise attention (loss within
    1e-4·|loss|, gradients within 1e-3 of their largest entry)."""
    from repro_torch.tree import tree_leaves, tree_map

    job = RG_ORACLE
    cfg = get_config(RG).with_overrides(n_layers=job["layers"],
                                        param_dtype="float32")
    params = random_params(torch, model, cfg, dev, 23)
    batch = lm_batch(torch, cfg.vocab_size, 1, job["seq"], 23, dev)
    res = {}
    for impl in ("flash", "blockwise"):
        ad = tree_map(lambda t: t.detach().requires_grad_(True),
                      params["adapter"])
        fa_ops.reset_launches()
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(cfg, ad, params["base"], batch,
                                attn_impl=impl)
        grads = torch.autograd.grad(loss, tree_leaves(ad))
        torch.cuda.synchronize()
        res[impl] = (float(loss.detach()), grads, dict(fa_ops.LAUNCHES),
                     time.perf_counter() - t0)
        del loss, ad
    (lf, gf, nf, tf), (lb, gb, nb, tb) = res["flash"], res["blockwise"]
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(gf, gb)]
    rel = abs(lf - lb) / abs(lb)
    emit({"phase": "rg_oracle", "arch": cfg.name, "dtype": "float32",
          "layers": cfg.n_layers, "kinds": list(cfg.kinds()),
          "seq": job["seq"], "window": cfg.window, "head_dim": cfg.hd,
          "loss_flash": lf, "loss_blockwise": lb, "loss_rel_err": rel,
          "grad_leaves": len(errs), "grad_max_err_over_max": max(errs),
          "launches_flash": nf, "launches_blockwise": nb,
          "wall_s": {"flash": tf, "blockwise": tb}})
    require(rel <= 1e-4, f"rg_oracle loss flash {lf} vs blockwise {lb}")
    require(max(errs) <= 1e-3, f"rg_oracle adapter gradients differ by "
            f"{max(errs)} of their largest entry")
    require(nf == {"flash_fwd": 2, "flash_dq": 1, "flash_dkv": 1}
            and nb == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
            f"rg_oracle launches: flash {nf}, blockwise {nb}")
    del params, res, gf, gb
    free(torch)


def phase_rg_decode(torch, ops, tl_ops, serve, model, get_config,
                    dev) -> dict:
    """``serve.generate`` on recurrentgemma-2b at full width and depth,
    bf16: 8 prompts of 32 tokens and 32 new ones; every step launches
    decode attention at hd 256 once per swa layer (8) and the tri-LoRA
    forward once per adapted projection (4 x 8 + 2 x 18 = 68); ms a step.
    Then 3 layers in f32 (RG_DECODE_ORACLE): token-by-token decode on the
    card against the forward's logits at rtol = atol = 2e-3
    (tests/test_decode_consistency.py)."""
    import numpy as np

    cfg = get_config(RG)
    job = RG_DECODE
    params = random_params(torch, model, cfg, dev, 25)
    prompts = np.random.default_rng(25).integers(
        0, cfg.vocab_size, (job["batch"], job["prompt_len"]))
    run = generate_graph(torch, serve, cfg, params, prompts, job["gen"],
                         [ops.LAUNCHES, tl_ops.LAUNCHES], dev,
                         "rg_decode generate")
    out, wall, per_step = run["out"], run["wall"], run["per_step"]
    step_ms = run["eager_step_ms"]
    launches = dict(run["launches"])
    routes = {"tri_lora": dict(tl_ops.ROUTES), "attn": dict(ops.ROUTES)}
    steps = len(per_step)
    n_swa = cfg.kinds().count("swa")
    adapted = sum(adapted_per_layer(cfg, k) for k in cfg.kinds())
    want_step = {"decode_attention": n_swa, "grouped_gemv": 0,
                 "tri_lora_fwd": adapted, "tri_lora_dx": 0,
                 "tri_lora_dw": 0, **NO_GROUPED}
    srt = sorted(step_ms)
    emit({"phase": "rg_decode", "arch": cfg.name, **job, "steps": steps,
          "layers": cfg.n_layers, "swa_layers": n_swa, "head_dim": cfg.hd,
          "out_shape": list(out.shape), "wall_s": wall,
          "ms_per_step": run["ms_per_step"],
          "eager_ms_per_step": 1e3 * run["eager_wall_s"] / steps,
          "eager_step_ms_p50": srt[steps // 2],
          "eager_step_ms_p95": srt[int(0.95 * (steps - 1))],
          "programs": run["programs"],
          "tok_per_s": job["batch"] * job["gen"] / run["second_wall_s"],
          "peak_mem_gb": run["peak"],
          "launches": launches, "launches_per_step": want_step,
          "tri_lora_routes": routes["tri_lora"],
          "attn_routes": routes["attn"],
          "sample": out[0, -8:].tolist()})
    require(tuple(out.shape) == (job["batch"], job["prompt_len"] + job["gen"])
            and steps == job["prompt_len"] + job["gen"] - 1,
            f"generate returned {tuple(out.shape)} after {steps} steps")
    odd = [p for p in per_step if p != want_step]
    require(not odd, f"decode steps launched {odd[:3]} (each step must "
            f"launch {want_step})")
    require(routes["attn"]["attn_scalar"] == 0, f"rg_decode attention left "
            f"the 16-byte route: {routes['attn']}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            "token ids out of range")
    del params, out
    free(torch)

    job = RG_DECODE_ORACLE
    cfg = get_config(RG).with_overrides(n_layers=job["layers"],
                                        param_dtype="float32")
    params = random_params(torch, model, cfg, dev, 26)
    b, t = job["batch"], job["seq"]
    toks = torch.as_tensor(np.random.default_rng(26).integers(
        0, cfg.vocab_size, (b, t)), device=dev)
    with torch.inference_mode():
        full, _ = model.forward(cfg, params["base"], params["adapter"],
                                {"tokens": toks})
        cache = model.init_decode_cache(cfg, b, t, device=dev)
        got = []
        for i in range(t):
            lg, cache = model.decode_step(
                cfg, params["base"], params["adapter"], cache,
                {"token": toks[:, i:i + 1],
                 "positions": torch.full((b, 1), i, dtype=torch.int32,
                                         device=dev)})
            got.append(lg[:, 0])
    dec_err = (torch.stack(got, 1) - full).abs()
    dec_bad = int((dec_err > 2e-3 + 2e-3 * full.abs()).sum())
    emit({"phase": "rg_decode", "oracle": {
        "arch": cfg.name, "dtype": "float32", **job,
        "kinds": list(cfg.kinds()),
        "decode_vs_forward_max_abs_err": float(dec_err.max()),
        "logits_max_abs": float(full.abs().max()),
        "decode_n_out_of_tol": dec_bad, "decode_tol": "rtol=atol=2e-3"}})
    require(dec_bad == 0, f"rg decode differs from the forward: "
            f"{float(dec_err.max())}, {dec_bad} out of tolerance")
    del params, full, got, cache
    free(torch)
    return launches


# ---------------------------------------------------------------------------
# the launch step factories at the assigned shapes, the exported bank, DLG
# ---------------------------------------------------------------------------

#: steps_train's h2o job: train_4k's 4,096-token sequences at a global batch
#: of 4 (train_4k's 256, cut so that the phase fits in the run), bf16
#: backbone, f32 adapters, flash; microbatches 1 and 4
STEPS_TRAIN = dict(arch=H2O, batch=4, seq=4096, lr=1e-4, microbatches=(1, 4))
#: the remat on/off pair: fed-100m (f32) at 8x256, h2o at 1x4096
REMAT_PAIRS = (("fed-100m", 8, 256), (H2O, 1, 4096))
#: the depths, beside the full 24, at which steps_train's gradients of
#: microbatches 4 and 1 are compared in bf16 and in f32 (fresh weights)
STEPS_DEPTHS = (2, 6)
#: the chunked loss on the card: qwen2.5-14b at 1x4096 (S·V = 6.2e8 > 2^28)
STEPS_CHUNKED = dict(arch="qwen2.5-14b", batch=1, seq=4096)
#: steps_prefill: prefill_32k's 32,768 tokens at batch 1 (its 32 cut)
STEPS_PREFILL = dict(arch=H2O, batch=1, seq=32768)
#: steps_decode: decode_32k at its own batch (128) for a few steps ending
#: at position 32,767, then long_500k's batch 1 at position 524,287
STEPS_DECODE = dict(arch=H2O, steps=4)
#: bank_serve: the train job for 2 rounds on the scan engine, once per
#: client store, checkpointed; then 8 requests of 16 + 8 tokens from its 4
#: clients through 4 slots
BANK_SERVE = dict(rounds=2, stores=("device", "host"), requests=8,
                  prompt_len=16, gen=8, slots=4)
#: privacy: the example's run (300 attack steps) at seeds 0-4
PRIVACY = dict(n_steps=300, seeds=(0, 1, 2, 3, 4))


def phase_steps_train(torch, fa_ops, tl_ops, model, get_config, dev):
    """``steps.make_train_step`` on h2o-danube-3-4b at full width and depth
    (bf16 backbone, f32 adapters, flash) at train_4k's sequence, global
    batch 4, microbatches 1 and 4 from the same params and optimizer
    state: exact flash and tri-LoRA launches (16-byte flash routes), the
    loss within 1e-3 + 1e-3·|loss|, AdamW on ``loss_and_grads``'s
    gradients bitwise each step's update, microbatches 4's gradients
    bitwise the four one-sequence gradients summed in f32 and divided by
    4; the updated adapters' gap reported.  The two runs' gradients by
    depth (2, 6 and 24 layers), each also on the same weights in f32: in
    f32 microbatches 4 and 1 within 1e-4 of each leaf's largest entry at 2
    layers and within 1e-3 at 24 (the gap grows with depth, as
    card_vs_cpu and h2o_oracle hold two f32 orders of one gradient;
    PERF.md §6, PR 25); the bf16 gaps reported, and the bf16 runs held
    through f32: at every depth each bf16 run's distance from its f32 run
    within twice the other's.  Then ``cfg.remat`` on and off: loss and
    gradients bitwise equal on fed-100m (f32, 8x256) and h2o (1x4096),
    with both peaks; and one train step of qwen2.5-14b at 1x4096 through
    the chunked loss, its loss within 1e-5 relative of the unchunked loss
    (the threshold raised), both peaks.
    Returns the microbatches-1 step's launches."""
    from repro_torch.launch import steps
    from repro_torch.optim import apply_updates
    from repro_torch.tree import tree_leaves, tree_map

    job = STEPS_TRAIN
    cfg = get_config(job["arch"])
    require(job["seq"] == steps.SHAPES["train_4k"].seq_len,
            "steps_train runs train_4k's sequence length")
    params = random_params(torch, model, cfg, dev, 25)
    batch = lm_batch(torch, cfg.vocab_size, job["batch"], job["seq"], 25,
                     dev)
    runs = {}
    for k in job["microbatches"]:
        step = steps.make_train_step(cfg, job["lr"], attn_impl="flash",
                                     microbatches=k)
        opt0 = step.optimizer.init(params["adapter"])
        (new, _, metrics), launches, wall, peak = run_counted(
            torch, fa_ops, tl_ops, lambda: step(params, opt0, batch))
        routes = dict(fa_ops.ROUTES), dict(tl_ops.ROUTES)
        # the step's gradients: loss_and_grads is the step's first half and
        # repeatable bit for bit, so AdamW on its gradients must give the
        # step's updated adapters bit for bit
        _, _, grads = steps.loss_and_grads(cfg, params, batch,
                                           attn_impl="flash", microbatches=k)
        upd, _ = step.optimizer.update(grads, opt0, params["adapter"])
        runs[k] = dict(loss=float(metrics["loss"]), grads=grads,
                       adapter=new["adapter"], launches=launches,
                       expected=step_launches(cfg, k),
                       flash_routes=routes[0], tri_routes=routes[1],
                       wall_s=wall, peak_mem_gb=peak, step_is_grads=same_bits(
                           torch, apply_updates(params["adapter"], upd),
                           new["adapter"]))
        del new, upd, grads
    one, four = runs[1], runs[4]
    # the accumulation itself: microbatches 4's gradients are the four
    # one-sequence gradients summed in f32 from zero and divided by 4, bit
    # for bit (each one-sequence pass is the same computation)
    k, per = job["microbatches"][-1], job["batch"] // job["microbatches"][-1]
    acc = [torch.zeros_like(t, dtype=torch.float32)
           for t in tree_leaves(params["adapter"])]
    for i in range(k):
        _, _, g = steps.loss_and_grads(cfg, params, {
            key: x[i * per:(i + 1) * per] for key, x in batch.items()},
            attn_impl="flash")
        acc = [a + b for a, b in zip(acc, tree_leaves(g))]
    by_hand = all(torch.equal(a / k, b) for a, b in zip(
        acc, tree_leaves(four["grads"]), strict=True))
    del acc, g
    loss_gap = abs(four["loss"] - one["loss"])
    ad_gap = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(four["adapter"]), tree_leaves(one["adapter"])))
    tokens = job["batch"] * job["seq"]
    lines = {f"microbatches_{k}": {
        key: r[key] for key in ("loss", "launches", "expected", "flash_routes",
                                "tri_routes", "wall_s", "peak_mem_gb",
                                "step_is_grads")}
        | {"tok_per_s": tokens / r["wall_s"]} for k, r in runs.items()}
    bf16_grads = {k: r["grads"] for k, r in runs.items()}
    del runs, one, four
    free(torch)
    # the gradients by depth (STEPS_DEPTHS and the full 24 layers), each on
    # the same batch: microbatches 4 against 1 in bf16 and, on the same
    # weights in f32 (no GEMM rounds to bf16), in f32; and each bf16 run
    # against the f32 run of its microbatches (the witness: two GEMM
    # orders' roundings sit about equally far from f32, a kernel that
    # fails at one batch shape puts its run far off)
    depths = {}
    for n in STEPS_DEPTHS + (cfg.n_layers,):
        cn = cfg.with_overrides(n_layers=n)
        pn = params if n == cfg.n_layers else random_params(
            torch, model, cn, dev, 25)
        c32 = cn.with_overrides(param_dtype="float32")
        p32 = {"base": tree_map(lambda t: t.float(), pn["base"]),
               "adapter": pn["adapter"]}
        g16 = bf16_grads if n == cfg.n_layers else {
            k: steps.loss_and_grads(cn, pn, batch, attn_impl="flash",
                                    microbatches=k)[2]
            for k in job["microbatches"]}
        g32, f32_runs = {}, {}
        for k in job["microbatches"]:
            (loss, _, g32[k]), _, wall, peak = run_counted(
                torch, fa_ops, tl_ops, lambda: steps.loss_and_grads(
                    c32, p32, batch, attn_impl="flash", microbatches=k))
            f32_runs[k] = {"loss": float(loss), "wall_s": wall,
                           "peak_mem_gb": peak}
        gaps16, gaps32 = (grad_gaps(torch, g[4], g[1]) for g in (g16, g32))
        depths[n] = {"bf16_gap_over_max": next(iter(gaps16.values())),
                     "bf16_worst_leaves": dict(list(gaps16.items())[:3]),
                     "f32_gap_over_max": next(iter(gaps32.values())),
                     "f32_worst_leaves": dict(list(gaps32.items())[:3]),
                     "bf16_vs_f32_rel_norm": {k: grad_rel(torch, g16[k],
                                                          g32[k])
                                              for k in job["microbatches"]},
                     "f32": f32_runs}
        del pn, p32, g16, g32
        free(torch)
    del bf16_grads
    free(torch)

    pairs = {}
    for arch, b, s in REMAT_PAIRS:
        c = get_config(arch)
        p = params if arch == H2O else random_params(torch, model, c, dev, 26)
        mb = lm_batch(torch, c.vocab_size, b, s, 26, dev)
        got = {}
        for remat in (True, False):
            (loss, _, grads), launches, wall, peak = run_counted(
                torch, fa_ops, tl_ops, lambda: steps.loss_and_grads(
                    c.with_overrides(remat=remat), p, mb, attn_impl="flash"))
            got[remat] = (loss, grads, {"launches": launches, "wall_s": wall,
                                        "peak_mem_gb": peak})
        pairs[arch] = {"batch": [b, s],
                       "loss": float(got[True][0]),
                       "bitwise": bool(torch.equal(got[True][0],
                                                   got[False][0]))
                       and same_bits(torch, got[True][1], got[False][1]),
                       "remat": got[True][2], "no_remat": got[False][2]}
        del got, p, mb
        free(torch)
    del params
    free(torch)

    cj = STEPS_CHUNKED
    qc = get_config(cj["arch"])
    qp = random_params(torch, model, qc, dev, 27)
    qb = lm_batch(torch, qc.vocab_size, cj["batch"], cj["seq"], 27, dev)
    chunks, real, limit = [], model._ce_terms, model._CE_CHUNK_THRESHOLD

    def counted(c, h, *a):
        chunks.append(h.shape[1])
        return real(c, h, *a)
    chunked = {}
    model._ce_terms = counted
    try:
        for name, threshold in (("chunked", limit), ("whole", 1 << 62)):
            model._CE_CHUNK_THRESHOLD = threshold
            chunks.clear()
            step = steps.make_train_step(qc, attn_impl="flash")
            (_, _, m), launches, wall, peak = run_counted(
                torch, fa_ops, tl_ops,
                lambda: step(qp, step.optimizer.init(qp["adapter"]), qb))
            chunked[name] = {"loss": float(m["loss"]), "ce_calls":
                             list(chunks), "wall_s": wall,
                             "peak_mem_gb": peak, "launches": launches}
    finally:
        model._ce_terms, model._CE_CHUNK_THRESHOLD = real, limit
    rel = abs(chunked["chunked"]["loss"] - chunked["whole"]["loss"]) / abs(
        chunked["whole"]["loss"])
    del qp, qb
    free(torch)

    emit({"phase": "steps_train", "arch": cfg.name, "layers": cfg.n_layers,
          "dtype": cfg.param_dtype, "adapter_dtype": "float32",
          "attn_impl": "flash", "shape": "train_4k",
          "global_batch": [job["batch"], "of", 256], "seq": job["seq"],
          **lines, "loss_gap": loss_gap,
          "accumulation_bitwise_by_hand": by_hand,
          "updated_adapter_max_gap": ad_gap, "grads_by_depth": depths,
          "remat_pairs": pairs,
          "chunked_loss": {"arch": qc.name, "batch": [cj["batch"],
                                                     cj["seq"]],
                           "s_times_vocab": cj["seq"] * qc.padded_vocab,
                           **chunked, "loss_rel_gap": rel}})
    for k, line in lines.items():
        require(line["launches"] == line["expected"],
                f"steps_train {k} launches {line['launches']} != "
                f"{line['expected']}")
        fl = line["expected"]["flash_fwd"]
        require(line["flash_routes"] == {"fwd_vec": fl, "fwd_scalar": 0,
                                         "bwd_vec": 2 * line["expected"][
                                             "flash_dq"], "bwd_scalar": 0},
                f"steps_train {k} flash routes {line['flash_routes']}")
        require(line["step_is_grads"], f"steps_train {k}: AdamW on "
                f"loss_and_grads's gradients is not the step's update")
    require(loss_gap <= 1e-3 + 1e-3 * abs(lines["microbatches_1"]["loss"]),
            f"steps_train microbatches 4 vs 1: loss gap {loss_gap}")
    for n, d in depths.items():
        l1, l4 = d["f32"][1]["loss"], d["f32"][4]["loss"]
        require(abs(l4 - l1) <= 1e-3 + 1e-3 * abs(l1), f"steps_train "
                f"{n} layers f32 microbatches 4 vs 1: losses {l4} / {l1}")
        w = d["bf16_vs_f32_rel_norm"].values()
        require(max(w) <= 2 * min(w), f"steps_train {n} layers: the bf16 "
                f"runs of microbatches 1 and 4 sit unequally far from f32: "
                f"{d['bf16_vs_f32_rel_norm']}")
    require(by_hand, "steps_train: microbatches 4's gradients are not the "
            "four one-sequence gradients summed and divided by 4")
    shallow = depths[STEPS_DEPTHS[0]]
    require(shallow["f32_gap_over_max"] <= 1e-4, f"steps_train "
            f"{STEPS_DEPTHS[0]} layers f32 microbatches 4 vs 1: gradients "
            f"part by {shallow['f32_worst_leaves']}")
    require(depths[cfg.n_layers]["f32_gap_over_max"] <= 1e-3,
            f"steps_train f32 microbatches 4 vs 1: gradients part by "
            f"{depths[cfg.n_layers]['f32_worst_leaves']}")
    for arch, pair in pairs.items():
        require(pair["bitwise"], f"steps_train {arch}: remat on and off are "
                f"not bitwise equal")
    require(chunked["chunked"]["ce_calls"] == [512] * 16
            and chunked["whole"]["ce_calls"] == [cj["seq"]],
            f"steps_train chunked loss calls {chunked['chunked']['ce_calls']}"
            f" / {chunked['whole']['ce_calls']}")
    require(rel <= 1e-5, f"steps_train {qc.name}: chunked loss "
            f"{chunked['chunked']['loss']} vs {chunked['whole']['loss']}")
    return lines["microbatches_1"]["launches"]


#: the flash forward's 32,768-token prefill rows: query / KV heads, head
#: dim, window (0: the whole causal band), the first channel the
#: channels-lost stand-in drops (the top fifth of hd 120, quarter of 64),
#: the seed and the row's note
FLASH_PREFILL = {
    "prefill 32k": dict(
        h=32, kh=8, hd=120, window=4096, lost_from=96, seed=28,
        note="h2o-danube-3-4b heads, 1x32768 bf16, window 4096; plain_ms "
             "is one synchronized call of attention.blockwise_sdpa (wall), "
             "library_ms SDPA (memory-efficient backend, boolean band "
             "mask) on K/V expanded to the 32 query heads"),
    "whisper prefill": dict(
        h=12, kh=12, hd=64, window=0, lost_from=48, seed=53,
        note="whisper-small decoder heads, 1x32768 bf16, causal; plain_ms "
             "is one synchronized call of attention.blockwise_sdpa (wall), "
             "library_ms SDPA (is_causal)")}


def time_flash_prefill(torch, F, fa_ops, bounds, dev,
                       shape: str = "prefill 32k") -> dict:
    """The flash forward at a FLASH_PREFILL shape (1 x 32768, bf16, causal
    with the row's window): the kernel beside its bound, the plain version
    (``attention.blockwise_sdpa``, the model's plain path at this length;
    one synchronized call, its wall time: a host-bound yardstick of
    correctness whose repeats behind time_ms's growing holds would cost
    tens of seconds) and SDPA (with a window on its memory-efficient
    backend, the band as a boolean mask and K/V expanded to the query
    heads beforehand: with GQA and a mask SDPA takes the math backend,
    which would materialize h x 32768^2 scores; without one ``is_causal``);
    held to the plain version in f32 on the same inputs by ``hold_flash``
    (elementwise at TOL and relatively at FLASH_REL_TOL: under randn
    inputs a row over thousands of keys is about TOL's atol in size); the
    band one 64-key tile short (the whole band: a window of 32,768 - 64)
    and the row's top channels lost, each the plain version rounded to
    bf16, must fail that relative hold.  Returns the kernel-table row."""
    from repro_torch.models.attention import blockwise_sdpa

    spec = FLASH_PREFILL[shape]
    b, s, dt_name = 1, 32768, "bfloat16"
    h, kh, hd, window = spec["h"], spec["kh"], spec["hd"], spec["window"]
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    sets = flash_timed_sets(torch, fa_ops, dev, b, s, h, kh, hd, gen,
                            dt_name, window)
    q, k, v, _, out, _, _ = sets[0]
    want = blockwise_sdpa(q.float(), k.float(), v.float(), window=window)
    errs, rel, nbad = hold_flash(torch, (out,), (want,), dt_name)
    err = errs["out"]
    c = spec["lost_from"]
    lost = [t.float() for t in (q, k, v)]
    for t in lost:
        t[..., c:] = 0
    faults = {}
    for name, ins, win in (
            ("band_one_tile_short", [t.float() for t in (q, k, v)],
             (window or s) - 64),
            (f"channels_{c}_up_lost", lost, window)):
        got = blockwise_sdpa(*ins, window=win).to(out.dtype)
        del ins
        _, f_rel, _ = hold_flash(torch, (got,), (want,), dt_name)
        faults[name] = {"rel": f_rel["out"], "n_out_of_tol": compare(
            torch, got, want.to(got.dtype), dt_name)[1]}
        del got
    del want, lost
    fwd = time_ms(torch, lambda q, k, v, *_: fa_ops.flash_attention_fwd(
        q, k, v, window=window), sets, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blockwise_sdpa(q, k, v, window=window)
    torch.cuda.synchronize()
    plain = 1e3 * (time.perf_counter() - t0)
    free(torch)
    if window:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        pos = torch.arange(s, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                 > pos[:, None] - window)
        g = h // kh
        full = [(q.transpose(1, 2),
                 k.repeat_interleave(g, 2).transpose(1, 2),
                 v.repeat_interleave(g, 2).transpose(1, 2))]
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib = time_ms(torch, lambda q, k, v:
                          F.scaled_dot_product_attention(
                              q, k, v, attn_mask=band), full, 10)
        del full, band
    else:
        lib = time_ms(torch, lambda q, k, v, *_: sdpa_causal(F, q, k, v),
                      sets, 10)
    bd = bounds.flash_fwd(b, h, kh, s, hd, dt_name, window)
    row = dict(name="flash_fwd", route="cuda", source=FLASH_SRC,
               replaces=FLASH_TPU["flash_fwd"], max_abs_err=err, ms=fwd,
               plain_ms=plain, library_ms=lib, **bound(bd), shape=shape,
               note=spec["note"])
    emit({"phase": "flash_timing", "shape": shape, "b": b, "s": s, "h": h,
          "kh": kh, "hd": hd, "dtype": dt_name, "causal": True,
          "window": window, "kernel_ms": {"flash_fwd": fwd},
          "bound_ms": {"flash_fwd": bd.ms}, "plain_ms": {"fwd": plain},
          "sdpa_ms": {"fwd": lib}, "fwd_over_sdpa_fwd": fwd / lib,
          "max_abs_err": {"flash_fwd": err}, "rel_err": rel["out"],
          "rel_tol": FLASH_REL_TOL[dt_name], "n_out_of_tol": nbad,
          "faults": faults, "stream_hold_x": holds_used()})
    require(nbad == 0, f"the flash forward at {shape}'s shape disagrees "
            f"with blockwise_sdpa: {nbad} failures, max {err}, relative "
            f"(tile RMS, max over max) {rel['out']}")
    require(all(f["rel"][0] > FLASH_REL_TOL[dt_name]
                for f in faults.values()),
            f"flash at {shape}'s shape: a stand-in passes the relative "
            f"hold: {faults}")
    del sets
    free(torch)
    return row


def phase_steps_prefill(torch, fa_ops, tl_ops, model, get_config, dev):
    """``steps.make_prefill_step`` on h2o-danube-3-4b at full depth (bf16)
    over prefill_32k's 32,768 tokens at batch 1 (``prefill_steps_phase``,
    profiled): exactly 24 flash-forward launches on the 16-byte route and
    96 tri-LoRA forwards; then the same shape at 2 layers in f32, flash
    against ``attn_impl="blockwise"`` on the card, the last position's
    logits within 1e-4 of their largest.  Returns the launches."""
    from repro_torch.launch import steps

    job = STEPS_PREFILL
    cfg = get_config(job["arch"])
    launches = prefill_steps_phase(torch, fa_ops, tl_ops, model, cfg, job,
                                   "steps_prefill", dev, True)
    toks = lm_batch(torch, cfg.vocab_size, job["batch"], job["seq"], 30,
                    dev)["tokens"]
    c2 = cfg.with_overrides(n_layers=2, param_dtype="float32")
    p2 = random_params(torch, model, c2, dev, 30)
    oracle = {impl: steps.make_prefill_step(c2, attn_impl=impl)(
        p2, {"tokens": toks}) for impl in ("flash", "blockwise")}
    rel = float((oracle["flash"] - oracle["blockwise"])[:, :c2.vocab_size]
                .abs().max()) / float(oracle["blockwise"][:, :c2.vocab_size]
                                     .abs().max())
    del p2, oracle
    free(torch)
    emit({"phase": "steps_prefill (oracle)", "arch": cfg.name,
          "oracle_2_layers_f32": {"logits_rel_gap": rel}})
    require(rel <= 1e-4, f"steps_prefill 2-layer f32 oracle: flash vs "
            f"blockwise logits part by {rel} of the largest")
    return launches


def filled_cache(torch, model, cfg, batch: int, seq_len: int, pos: int,
                 gen, dev) -> dict:
    """A decode cache of ``batch`` x ``seq_len`` with every ring slot of
    every layer filled in place from ``gen`` and the next position
    ``pos``."""
    from repro_torch.tree import tree_leaves
    cache = model.init_decode_cache(cfg, batch, seq_len, device=dev)
    for t in tree_leaves(cache):
        if t.is_floating_point():
            for layer in t:                  # one layer at a time
                layer.normal_(generator=gen)
        else:
            t.fill_(pos)
    return cache


def phase_steps_decode(torch, ops, ref, tl_ops, model, get_config, dev):
    """``steps.make_serve_step`` on h2o-danube-3-4b at full depth (bf16):
    decode_32k at its own batch of 128 against full 4,096-slot rings (the
    32,768-token cache's window; 48.3 GB of K/V filled from a seeded
    generator) (``serve_steps_phase``); then long_500k
    (``shape_variant`` leaves h2o unchanged) at batch 1 from position
    524,287, finite logits.  Returns the launches of one decode_32k
    step."""
    import numpy as np

    from repro_torch.launch import steps

    job = STEPS_DECODE
    cfg = get_config(job["arch"])
    sh = steps.SHAPES["decode_32k"]
    params = random_params(torch, model, cfg, dev, 45)
    launches = serve_steps_phase(torch, ops, ref, tl_ops, model, cfg,
                                 sh.global_batch, job["steps"],
                                 "steps_decode", dev, params)
    require(cfg.window < sh.seq_len, "steps_decode's rings must wrap")
    long_cfg = steps.shape_variant(cfg, "long_500k")
    ls = steps.SHAPES["long_500k"]
    gen = torch.Generator(device=dev).manual_seed(32)
    lcache = filled_cache(torch, model, long_cfg, ls.global_batch,
                          ls.seq_len, ls.seq_len - 1, gen, dev)
    ring = lcache["groups"]["0"]["k"].shape[2]
    ops.reset_launches()
    llog, lcache = steps.make_serve_step(cfg)(params, lcache, {
        "token": torch.as_tensor(np.random.default_rng(32).integers(
            0, cfg.vocab_size, (1, 1)), device=dev),
        "positions": torch.full((1, 1), ls.seq_len - 1, dtype=torch.int32,
                                device=dev)})
    long_launches = dict(ops.LAUNCHES)
    long_ok = (tuple(llog.shape) == (1, cfg.padded_vocab)
               and bool(torch.isfinite(llog[:, :cfg.vocab_size]).all()))
    del lcache, llog, params
    free(torch)
    emit({"phase": "steps_decode (long_500k)", "arch": cfg.name,
          "variant_unchanged": long_cfg is cfg, "ring": ring,
          "position": ls.seq_len - 1, "launches": long_launches,
          "finite": long_ok})
    require(long_cfg is cfg and ring == cfg.window and long_ok
            and long_launches["decode_attention"] == cfg.n_layers,
            f"steps_decode long_500k: variant unchanged {long_cfg is cfg}, "
            f"ring {ring}, finite {long_ok}, launches {long_launches}")
    return launches


def phase_bank_serve(torch, ops, fa_ops, tl_ops, serve, get_config, dev):
    """The personalized train → serve path: ``run_federated`` on fed-100m
    at full width and depth (celora, 4 clients, full participation, 2
    rounds, the scan engine, flash) once on the device and once on the
    host client store, each checkpointed; ``export_bank`` of both
    checkpoints (within 5e-4 of each other, B non-zero, rows distinct);
    ``ServeEngine`` over the exported bank with exact grouped-GEMV and
    decode-attention launches, its tokens equal to ``serve_naive``'s
    (merged weights, eqn. 10) request for request.  Returns the engine's
    launches."""
    from repro_torch.core.adapter_bank import export_bank
    from repro_torch.core.fed_model import FedTask
    from repro_torch.core.tri_lora import is_adapter
    from repro_torch.tree import tree_leaves

    job = BANK_SERVE
    cfg = get_config("fed-100m")
    fed_job = dict(TRAIN, rounds=job["rounds"])
    banks, runs = {}, {}
    for store in job["stores"]:
        path = ROOT / "build" / "chip_smoke" / f"bank_{store}.npz"
        if path.exists():
            path.unlink()
        out, wall = train_job(torch, cfg, dev, "flash", fed_job, "vmap",
                              engine="scan", chunk_rounds=2,
                              client_store=store, use_data_sim=False,
                              checkpoint_path=str(path))
        runs[store] = {"wall_s": wall, "train_loss": [
            r.train_loss for r in out["history"]]}
        banks[store] = export_bank(str(path), device=dev)
        del out
    dev_bank, host_bank = banks["device"], banks["host"]
    gap = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(dev_bank.tree), tree_leaves(host_bank.tree),
        strict=True))
    ads = [a for a in tree_leaves(dev_bank.tree, is_leaf=is_adapter)
           if is_adapter(a)]
    b_nonzero = all(float(a["B"].abs().max()) > 0 for a in ads)
    distinct = all(any(not torch.equal(x[i], x[0]) for x in tree_leaves(
        dev_bank.tree)) for i in range(1, dev_bank.n_clients))
    base = FedTask.create(torch.Generator(device=dev).manual_seed(0), cfg,
                          TRAIN["classes"]).base
    eng = serve.ServeEngine(cfg, base, dev_bank, slots=job["slots"],
                            max_len=job["prompt_len"] + job["gen"],
                            device=dev)
    reqs = serve.make_requests(dev_bank, job["requests"],
                               prompt_len=job["prompt_len"], gen=job["gen"],
                               vocab=cfg.vocab_size, seed=0)
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = dict(ops.LAUNCHES), dict(ops.ROUTES)
    expected = {"grouped_gemv": len(cfg.lora_targets) * cfg.n_layers
                * eng.steps, "decode_attention": cfg.n_layers * eng.steps}
    naive = serve.serve_naive(cfg, base, dev_bank, reqs, device=dev)
    same = sorted(done) == sorted(naive) and all(
        np_equal(done[r], naive[r]) for r in naive)
    emit({"phase": "bank_serve", "arch": cfg.name, "dtype": cfg.param_dtype,
          "clients": TRAIN["clients"], "rounds": job["rounds"],
          "engine": "scan", "runs": runs, "bank_rows": dev_bank.n_clients,
          "bank_rank": dev_bank.rank, "store_bank_max_gap": gap,
          "b_nonzero": b_nonzero, "rows_distinct": distinct,
          "serve": {**{k: job[k] for k in ("requests", "prompt_len", "gen",
                                            "slots")},
                    "users": len({r.user_id for r in reqs}),
                    "steps": eng.steps, "wall_s": wall,
                    "ms_per_step": 1e3 * wall / eng.steps,
                    "launches": launches, "expected_launches": expected,
                    "routes": routes},
          "tokens_equal_serve_naive": same})
    require(gap <= 5e-4, f"bank_serve: the device and host stores' banks "
            f"part by {gap}")
    require(b_nonzero and distinct, f"bank_serve: B non-zero {b_nonzero}, "
            f"rows distinct {distinct}")
    require(launches == expected, f"bank_serve launches {launches} != "
            f"{expected}")
    require(routes["gemv_vec"] == launches["grouped_gemv"]
            and routes["attn_vec"] == launches["decode_attention"],
            f"bank_serve left the 16-byte routes: {routes}")
    require(same, "bank_serve: ServeEngine's tokens differ from "
            "serve_naive's")
    del eng, base, banks, dev_bank, host_bank
    free(torch)
    return launches


def phase_privacy(torch, dev) -> None:
    """``privacy.run_dlg_experiment`` on the card as the example runs it
    (300 attack steps) at seeds 0-4: F1 per method, the example's
    assertion at its seed 0 (celora F1 <= fedpetuning F1 + 0.05; the other
    seeds' ordering reported), and each payload's observed gradients on the
    card within 1e-5 of their largest entry of the CPU's on the same
    model."""
    from repro_torch.core import privacy

    job = PRIVACY
    f1, walls = {}, {}
    for seed in job["seeds"]:
        t0 = time.perf_counter()
        res = privacy.run_dlg_experiment(seed=seed, n_steps=job["n_steps"],
                                         device=dev)
        torch.cuda.synchronize()
        walls[seed] = time.perf_counter() - t0
        f1[seed] = {m: v["f1"] for m, v in res.items()}
    held = {s: f["celora"] <= f["fedpetuning"] + 0.05 for s, f in f1.items()}
    model = privacy.make_model(torch.Generator(device=dev).manual_seed(0))
    cpu = privacy.DLGModel(embed=model.embed.cpu(), w=model.w.cpu(),
                           head=model.head.cpu(),
                           adapter={k: t.cpu()
                                    for k, t in model.adapter.items()})
    true, labels = privacy.private_batch(0, 4, 6, 128)
    gaps = {}
    for method, payload in privacy.PAYLOADS.items():
        got = privacy.observed_grads(model, payload, torch.as_tensor(
            true, device=dev), torch.as_tensor(labels, device=dev))
        want = privacy.observed_grads(cpu, payload, torch.from_numpy(true),
                                      torch.from_numpy(labels))
        gaps[method] = max(float((got[k].cpu() - want[k]).abs().max())
                           / float(want[k].abs().max()) for k in want)
    emit({"phase": "privacy", "n_steps": job["n_steps"], "f1": f1,
          "wall_s": walls, "celora_le_fedpetuning_plus_0.05": held,
          "grads_card_vs_cpu_rel": gaps})
    require(held[0], f"privacy: the example's assertion fails at seed 0: "
            f"{f1[0]}")
    require(max(gaps.values()) <= 1e-5, f"privacy: the card's observed "
            f"gradients part from the CPU's by {gaps}")


def phase_pretrain(torch, tl_ops, get_config, dev):
    """``FedTask.create`` with two warm-up batches of 8×256 at full width:
    the backbone trains, so every projection runs the forward, dx and dW
    kernels."""
    from repro_torch.core.fed_model import FedTask
    from repro_torch.data import synthetic
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves

    cfg = get_config("fed-100m")
    data = synthetic.make_classification_data(12, 16, 256, cfg.vocab_size, 4)
    batches = [{"tokens": data.tokens[i:i + 8], "labels": data.labels[i:i + 8]}
               for i in (0, 8)]
    tl_ops.reset_launches()                   # counts of the path only
    t0 = time.perf_counter()
    task = FedTask.create(torch.Generator(device=dev).manual_seed(12), cfg,
                          4, pretrain_batches=batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tl_ops.LAUNCHES)
    init = model.init_params(cfg, torch.Generator(device=dev).manual_seed(12))
    moved = sum(not torch.equal(a, b) for a, b in zip(
        tree_leaves(task.base), tree_leaves(init["base"])))
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(task.base))
    per_step = cfg.n_layers * len(cfg.lora_targets)
    again = recomputed(cfg) * len(cfg.lora_targets)
    expected = {"tri_lora_fwd": (per_step + again) * len(batches),
                "tri_lora_dx": per_step * len(batches),
                "tri_lora_dw": per_step * len(batches), **NO_GROUPED}
    emit({"phase": "pretrain", "arch": cfg.name, "batches": [2, 8, 256],
          "wall_s": wall, "launches": launches, "expected_launches": expected,
          "base_leaves_moved": moved, "finite": finite})
    require(launches == expected,
            f"pretrain launches {launches} != expected {expected}")
    require(finite and moved > 0, "the warm-up did not train the backbone")
    return launches


def phase_card_vs_cpu(torch, tl_ops, model, get_config, dev):
    """One ``loss_fn`` and its adapter gradients on fed-100m at full width
    and depth (f32, a batch of 2×256): on the card through the tri-LoRA and
    flash kernels, on the CPU through their plain versions.  C and B are
    moved off their zero-delta init (C = I + 0.05·N, B = 0.01·N, a delta
    of a few percent of x·W, as after some training) so that dA and dC are
    not zero.  A delta as large as x·W itself (B = 0.05·N with A shifted
    too) saturates the random backbone's attention, and there f32 on the
    CPU alone is 6e-4 of the largest entry away from f64 at 4 layers."""
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("fed-100m")
    params = random_params(torch, model, cfg, dev, 10)
    batch = lm_batch(torch, cfg.vocab_size, 2, 256, 10, dev)

    def loss_and_grads(where):
        base = tree_map(lambda t: t.to(where), params["base"])
        ad = tree_map(lambda t: t.detach().to(where).requires_grad_(True),
                      params["adapter"])
        b = {key: v.to(where) for key, v in batch.items()}
        loss, _ = model.loss_fn(cfg, ad, base, b, attn_impl="flash")
        grads = torch.autograd.grad(loss, tree_leaves(ad))
        return float(loss.detach()), [g.cpu() for g in grads]

    tl_ops.reset_launches()
    loss_card, grads_card = loss_and_grads(dev)
    launched = dict(tl_ops.LAUNCHES)
    loss_cpu, grads_cpu = loss_and_grads(torch.device("cpu"))
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(grads_card, grads_cpu)]
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    projections = cfg.n_layers * len(cfg.lora_targets)
    emit({"phase": "card_vs_cpu", "arch": cfg.name, "batch": [2, 256],
          "loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel_err": rel,
          "grad_leaves": len(errs), "grad_max_err_over_max": max(errs),
          "launches": launched})
    require(rel <= 1e-4, f"card loss {loss_card} vs CPU {loss_cpu}")
    require(max(errs) <= 1e-3,
            f"adapter gradients differ by {max(errs)} of their largest entry")
    again = recomputed(cfg) * len(cfg.lora_targets)
    require(launched == {"tri_lora_fwd": projections + again,
                         "tri_lora_dx": projections - 3, "tri_lora_dw": 0,
                         **NO_GROUPED},
            f"one loss and gradient launched {launched}")


# ---------------------------------------------------------------------------
# whisper-small (encoder-decoder) and qwen2-vl-72b (M-RoPE, vision prefix)
# ---------------------------------------------------------------------------

WHISPER = "whisper-small"
VLM = "qwen2-vl-72b"
#: whisper_train: train_4k's 4,096-token decoder sequences at a global
#: batch of 4 (train_4k's 256, cut), 1,500 stub frames each, the whole
#: model (12 + 12 layers), bf16 backbone, f32 adapters, flash; 3 steps on
#: one batch
WHISPER_TRAIN = dict(batch=4, seq=4096, steps=3, lr=1e-3)
#: whisper_prefill: prefill_32k's 32,768 tokens at batch 1 (its 32 cut)
WHISPER_PREFILL = dict(batch=1, seq=32768)
#: whisper_decode: decode_32k at batch 32 (its 128 cut: 38.7 GB of K/V
#: rings and 1.8 GB of cross K/V), a few steps ending at position 32,767
WHISPER_DECODE = dict(batch=32, steps=4)
#: whisper_oracle: the whole width at 2 + 2 layers, f32, 1 x 4096 tokens
#: (flash against ref: train_4k's length, where cross-attention over the
#: 1,500 frames takes the blockwise tiles), then 2 x 12 decode steps
#: against the forward
WHISPER_ORACLE = dict(layers=2, seq=4096, dec_batch=2, dec_steps=12)
#: vlm_train: qwen2-vl-72b at full width, 8 of its 80 layers (~16.5 GB of
#: bf16 weights), 2 x (4096 text + 256 patches), bf16, f32 adapters, flash,
#: the chunked loss; 3 steps on one batch
VLM_TRAIN = dict(layers=8, batch=2, seq=4096, steps=3, lr=1e-3)
#: vlm_prefill: 2 layers, 1 x (32,768 + 256)
VLM_PREFILL = dict(layers=2, batch=1, seq=32768)
#: vlm_decode: 2 layers, decode_32k at its own batch of 128 (34.4 GB of K/V)
VLM_DECODE = dict(layers=2, steps=4)
#: vlm_serve: 2 layers bf16, 8 requests of 64 + 16 from 4 users, 4 slots;
#: then the f32 oracle at 2 layers (ServeEngine against serve_naive)
VLM_SERVE = dict(layers=2, users=4, requests=8, slots=4, prompt_len=64,
                 gen=16)
#: vlm_oracle: 2 layers, f32, one 4,352-token sequence (256 patches and
#: 4,096 text tokens), flash / blockwise_cv / ref
VLM_ORACLE = dict(layers=2, seq=4096)


def vlm_positions(torch, b: int, patches: int, text: int, dev):
    """(b, patches + text, 3) int32 Qwen2-VL position ids: the patches a
    √P × √P grid at t = 0, h = row, w = col, the text from the grid's
    largest id + 1 on with t = h = w."""
    side = math.isqrt(patches)
    require(side * side == patches, f"{patches} patches are not a square")
    i = torch.arange(patches, device=dev)
    grid = torch.stack([torch.zeros_like(i), i // side, i % side], -1)
    t = torch.arange(text, device=dev) + (side if patches else 0)
    pos = torch.cat([grid, torch.stack([t, t, t], -1)])
    return pos.to(torch.int32)[None].expand(b, -1, -1).contiguous()


def enc_dec_batch(torch, cfg, b: int, s: int, seed: int, dev) -> dict:
    """An LM batch plus ``frames`` (b, enc_frames, d) of stub audio frame
    embeddings, or ``vision`` (b, P, d) patch embeddings with Qwen2-VL
    position triplets, as the config needs."""
    batch = lm_batch(torch, cfg.vocab_size, b, s, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.enc_dec:
        batch["frames"] = torch.randn((b, cfg.enc_frames, cfg.d_model),
                                      generator=gen, device=dev)
    if cfg.vision_patches:
        batch["vision"] = torch.randn((b, cfg.vision_patches, cfg.d_model),
                                      generator=gen, device=dev)
        batch["positions"] = vlm_positions(torch, b, cfg.vision_patches, s,
                                           dev)
    return batch


def fill_cross_cache(torch, model, cfg, base, cache, frames,
                     chunk: int = 8) -> None:
    """Every decoder block's cross K/V from the encoder's output over
    ``frames`` (``enc_out @ xattn.wk / wv``, no adapter, no bias), in place,
    ``chunk`` sequences at a time: this script's copy of the helper that
    tests/test_decode_consistency.py keeps (the JAX package fills the
    cross cache nowhere else)."""
    q, _, _ = cfg.stack_plan()
    with torch.no_grad():
        for r0 in range(0, frames.shape[0], chunk):
            enc = model.encode(cfg, base, frames[r0:r0 + chunk])
            b = enc.shape[0]
            for key, blk in (cache["groups"] or {}).items():
                xp = base["groups"][key]["xattn"]
                for layer in range(q):
                    for name, w in (("xk", "wk"), ("xv", "wv")):
                        blk[name][layer, r0:r0 + b] = (
                            enc @ xp[w][layer]).reshape(b, -1, cfg.n_heads,
                                                        cfg.hd)
            for blk, p in zip(cache["tail"], base["tail"]):
                for name, w in (("xk", "wk"), ("xv", "wv")):
                    blk[name][r0:r0 + b] = (enc @ p["xattn"][w]).reshape(
                        b, -1, cfg.n_heads, cfg.hd)
            del enc


class RowTap:
    """Wraps ``tri_lora_ops.tri_lora_fwd`` while active and counts its
    launches by the rows of x (M)."""

    def __init__(self, tl_ops):
        self.tl_ops, self.rows = tl_ops, {}

    def __enter__(self):
        orig = self.tl_ops.tri_lora_fwd

        def tapped(x, *a, **kw):
            self.rows[x.shape[0]] = self.rows.get(x.shape[0], 0) + 1
            return orig(x, *a, **kw)

        self._orig = orig
        self.tl_ops.tri_lora_fwd = tapped
        return self

    def __exit__(self, *exc):
        self.tl_ops.tri_lora_fwd = self._orig
        return False


def predicted_routes(torch, tl_ops, cfg, rows: dict, dev) -> dict:
    """The tri-LoRA forward routes ``tl_ops.fwd_route`` gives bf16
    operands of each row count in ``rows`` (M → launches): x (M, d) and W
    (d, d) as the model allocates them."""
    w = torch.empty((cfg.d_model, cfg.d_model), dtype=cfg.dtype, device=dev)
    out = {}
    for m, n in rows.items():
        x = torch.empty((m, cfg.d_model), dtype=cfg.dtype, device=dev)
        key = f"fwd_{tl_ops.fwd_route(x, w)}"
        out[key] = out.get(key, 0) + n
    return out


def train_steps_phase(torch, fa_ops, tl_ops, model, cfg, job: dict,
                      phase: str, dev, ce_tap: bool = False,
                      want_rows: dict | None = None,
                      profiled: bool = True) -> dict:
    """``steps.make_train_step`` (flash) on ``cfg``, ``job["steps"]`` steps
    on one batch from the same params: every loss finite and each below
    the one before; exactly ``step_launches`` flash and tri-LoRA launches,
    flash on its 16-byte routes, the tri-LoRA forwards on the routes
    ``fwd_route`` predicts for each row count (``RowTap``), the row counts
    ``want_rows`` where given; with ``ce_tap`` the chunked loss's calls.
    Emits one line (with ``profiled`` a profile of one more step) and
    returns the launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    params = random_params(torch, model, cfg, dev, 41)
    batch = enc_dec_batch(torch, cfg, job["batch"], job["seq"], 41, dev)
    step = steps.make_train_step(cfg, job["lr"], attn_impl="flash")
    chunks, real = [], model._ce_terms

    def counted(c, h, *a):
        chunks.append(h.shape[1])
        return real(c, h, *a)

    def run():
        p, o, losses = params, step.optimizer.init(params["adapter"]), []
        for _ in range(job["steps"]):
            t0 = time.perf_counter()
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
        return losses, p, o

    step_s = []

    model._ce_terms = counted
    try:
        with RowTap(tl_ops) as rt:
            (losses, p, o), launches, wall, peak = run_counted(
                torch, fa_ops, tl_ops, run)
    finally:
        model._ce_terms = real
    flash_routes, tri_routes = dict(fa_ops.ROUTES), dict(tl_ops.ROUTES)
    split = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(p, o, batch)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        split = device_split(prof, prof_wall * 1e6, 8,
                             shares=FLASH_SHARES + ("tri_lora",))
        del prof
    del p, o
    expected = step_launches(cfg, job["steps"])
    want_routes = predicted_routes(torch, tl_ops, cfg, rt.rows, dev)
    text = job["batch"] * job["seq"]
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "enc_layers": cfg.n_enc_layers if cfg.enc_dec else 0,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
          "dtype": cfg.param_dtype, "adapter_dtype": "float32",
          "attn_impl": "flash", "shape": "train_4k",
          "global_batch": [job["batch"], "of", 256], "seq": job["seq"],
          "prefix": cfg.vision_patches, "frames": cfg.enc_frames
          if cfg.enc_dec else 0, "steps": job["steps"], "lr": job["lr"],
          "losses": losses, "wall_s": wall, "step_s": step_s,
          "s_per_step": wall / job["steps"], "profiled_step": split,
          "text_tok_per_s": text * job["steps"] / wall, "peak_mem_gb": peak,
          "launches": launches, "expected_launches": expected,
          "tri_lora_fwd_rows": rt.rows, "flash_routes": flash_routes,
          "tri_lora_routes": tri_routes, "predicted_routes": want_routes,
          "ce_calls": len(chunks), "ce_chunk_tokens": sorted(set(chunks))})
    require(launches == expected, f"{phase} launches {launches} != "
            f"{expected}")
    require(flash_routes == {"fwd_vec": expected["flash_fwd"],
                             "fwd_scalar": 0, "bwd_vec": 2 * expected[
                                 "flash_dq"], "bwd_scalar": 0},
            f"{phase} flash routes {flash_routes}")
    require({k: v for k, v in tri_routes.items() if v} == want_routes,
            f"{phase} tri-LoRA routes {tri_routes}, predicted {want_routes}")
    require(want_rows is None or rt.rows == want_rows,
            f"{phase} tri-LoRA forwards by rows {rt.rows}, expected "
            f"{want_rows}")
    require(all(math.isfinite(x) for x in losses)
            and all(b < a for a, b in zip(losses, losses[1:])),
            f"{phase} losses {losses}: not finite and falling")
    if ce_tap:
        n = job["seq"] // model._CE_CHUNK
        require(chunks == [model._CE_CHUNK] * (2 * n * job["steps"]),
                f"{phase}: the chunked loss ran {chunks}")
    del params, batch
    free(torch)
    return launches


def phase_whisper_train(torch, fa_ops, tl_ops, model, get_config, dev):
    """whisper-small whole (12 + 12 layers) through ``make_train_step``
    (``train_steps_phase``): the decoder's 12 flash attentions, its 8
    adapted projections a layer (self and cross q/k/v/o), the cross wk /
    wv reading 4 x 1,500 encoder rows and launching no dx; the encoder
    launches nothing.  Not profiled: the ~35 k small launches of a step
    (the plain cross-attention tiles) cost the profiler ~75 s of event
    processing."""
    cfg = get_config(WHISPER)
    job = WHISPER_TRAIN
    want = step_launches(cfg, 1)
    require(want == {**want, "flash_fwd": 24, "flash_dq": 12,
                     "flash_dkv": 12, "tri_lora_fwd": 192,
                     "tri_lora_dx": 69}, f"{WHISPER} step launches {want}")
    passes = 2 * job["steps"]               # the forward and its recompute
    rows = {job["batch"] * job["seq"]: 6 * cfg.n_layers * passes,
            job["batch"] * cfg.enc_frames: 2 * cfg.n_layers * passes}
    return train_steps_phase(torch, fa_ops, tl_ops, model, cfg, job,
                             "whisper_train", dev, want_rows=rows,
                             profiled=False)


def prefill_steps_phase(torch, fa_ops, tl_ops, model, cfg, job: dict,
                        phase: str, dev, profiled: bool) -> dict:
    """``steps.make_prefill_step`` (flash) on ``cfg`` over prefill_32k's
    32,768 text tokens at ``job["batch"]`` (with the config's frames or
    vision prefix): exactly ``step_launches(cfg, 0, 1)`` launches, flash on
    its 16-byte route, finite (batch, padded vocab) logits, tok/s over
    every token of the sequence, peak, and with ``profiled`` a profile of
    one more prefill that must hold one flash forward a layer (their
    device time per call).  Returns the launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    require(job["seq"] == steps.SHAPES["prefill_32k"].seq_len,
            f"{phase} runs prefill_32k's sequence length")
    params = random_params(torch, model, cfg, dev, 43)
    batch = enc_dec_batch(torch, cfg, job["batch"], job["seq"], 43, dev)
    del batch["labels"]
    pf = steps.make_prefill_step(cfg, attn_impl="flash")
    logits, launches, wall, peak = run_counted(torch, fa_ops, tl_ops,
                                               lambda: pf(params, batch))
    flash_routes = dict(fa_ops.ROUTES)
    expected = step_launches(cfg, 0, 1)
    split, wall2, fwd_us = None, None, []
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pf(params, batch)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
        split = device_split(prof, wall2 * 1e6, 10,
                             shares=("flash_fwd", "tri_lora"))
        fwd_us = [e.time_range.elapsed_us() for e in prof.events()
                  if getattr(e.device_type, "name", "") == "CUDA"
                  and "flash_fwd" in e.name]
        del prof
    finite = bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
    tokens = job["batch"] * (job["seq"] + cfg.vision_patches)
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "enc_layers": cfg.n_enc_layers if cfg.enc_dec else 0,
          "dtype": cfg.param_dtype, "shape": "prefill_32k",
          "global_batch": [job["batch"], "of", 32], "seq": job["seq"],
          "prefix": cfg.vision_patches,
          "frames": cfg.enc_frames if cfg.enc_dec else 0, "wall_s": wall,
          "wall_s_profiled": wall2, "tok_per_s": tokens / wall,
          "peak_mem_gb": peak, "launches": launches,
          "expected_launches": expected, "flash_routes": flash_routes,
          "window": cfg.window, "finite": finite, "profile": split,
          "flash_fwd_device_us": {"calls": len(fwd_us), "mean": sum(
              fwd_us) / max(len(fwd_us), 1)}})
    require(launches == expected, f"{phase} launches {launches} != "
            f"{expected}")
    require(flash_routes == {"fwd_vec": cfg.n_layers, "fwd_scalar": 0,
                             "bwd_vec": 0, "bwd_scalar": 0},
            f"{phase} flash routes {flash_routes}")
    require(finite and tuple(logits.shape) == (job["batch"],
                                               cfg.padded_vocab),
            f"{phase} logits not finite or of the wrong shape")
    require(not profiled or len(fwd_us) == cfg.n_layers,
            f"{phase} profile saw {len(fwd_us)} flash forwards")
    del params, logits, batch
    free(torch)
    return launches


def phase_whisper_prefill(torch, fa_ops, tl_ops, model, get_config, dev):
    """whisper-small whole over 32,768 decoder tokens at batch 1 and 1,500
    frames (``prefill_steps_phase``): 12 flash forwards and 96 tri-LoRA
    forwards.  Not profiled: cross-attention over 32,768 x 1,500 takes the
    plain blockwise tiles, whose ~110 k small launches cost the profiler
    ~130 s of event processing."""
    cfg = get_config(WHISPER)
    require(WHISPER_PREFILL["seq"] <= cfg.max_target_positions,
            "whisper_prefill's positions must fit the learned table")
    return prefill_steps_phase(torch, fa_ops, tl_ops, model, cfg,
                               WHISPER_PREFILL, "whisper_prefill", dev,
                               False)


def ring_slots(torch, cache, positions) -> list:
    """The ring slots of ``positions`` in every K/V leaf of ``cache`` and
    every integer leaf (the ring indices), saved: (leaf, slots or None,
    copy) rows for ``restore_slots``."""
    saved = []

    def visit(tree, name=None):
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, k)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                visit(v, name)
        elif tree is not None and not tree.is_floating_point():
            saved.append((tree, None, tree.clone()))
        elif tree is not None and name in ("k", "v"):
            ring = tree.shape[-3]
            slots = torch.tensor([p % ring for p in positions],
                                 device=tree.device)
            saved.append((tree, slots,
                          tree.index_select(tree.dim() - 3, slots)))
    visit(cache)
    return saved


def restore_slots(saved) -> None:
    for t, slots, copy in saved:
        if slots is None:
            t.copy_(copy)
        else:
            t.index_copy_(t.dim() - 3, slots, copy)


def serve_steps_phase(torch, ops, ref, tl_ops, model, cfg, batch: int,
                      n_steps: int, phase: str, dev, params=None) -> dict:
    """``steps.make_serve_step`` at decode_32k's 32,768-token cache (rings
    of ``cfg.window`` slots where the config has one), every slot filled
    from a seeded generator (an encoder-decoder's cross K/V from its
    encoder over random frames), ``n_steps`` steps ending at position
    32,767, the last the learned position table holds (M-RoPE: (t, t, t)):
    per step one decode-attention launch a layer on the 16-byte route and
    the self-attention's tri-LoRA forwards (the cross step takes no
    adapter); the first step's decode-attention calls held to their plain
    version in f32 (``held_decode``: elementwise at TOL, per batch row at
    FLASH_REL_TOL: an output over thousands of slots is about TOL's atol
    in size), where the plain version over the valid slots one 64-slot
    tile short must fail the relative hold.  The steps after the first run
    eagerly, then again from the same cache state (the slots they wrote
    restored) through the step as a cached program with the cache
    donated (``jit_cache.jit``; the JAX dry run's ``donate_argnums=(1,)``,
    the params bound): logits bitwise the eager steps', one replay a step,
    no donated copy, and the peak above the start within a quarter of the
    cache of the eager steps' (no second cache).  Finite logits, ms a step
    captured and eager, and a profile of one more step each way.
    ``params`` (else drawn here) stay the caller's.  Returns one step's
    launches."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from repro_torch.core import jit_cache
    from repro_torch.launch import steps

    sh = steps.SHAPES["decode_32k"]
    gen = torch.Generator(device=dev).manual_seed(45)
    if params is None:
        params = random_params(torch, model, cfg, dev, 45)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    start = sh.seq_len - n_steps
    cache = filled_cache(torch, model, cfg, batch, sh.seq_len, start, gen,
                         dev)
    if cfg.enc_dec:
        fill_cross_cache(torch, model, cfg, params["base"], cache,
                         torch.randn((batch, cfg.enc_frames, cfg.d_model),
                                     generator=gen, device=dev))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    blk = cache["groups"]["0"]
    ring = blk["k"].shape[2]
    kv_gb = sum(blk[k].numel() * blk[k].element_size()
                for k in ("k", "v")) / 1e9
    x_gb = sum(blk[k].numel() * blk[k].element_size()
               for k in ("xk", "xv") if k in blk) / 1e9
    serve_step = steps.make_serve_step(cfg)
    toks = torch.as_tensor(np.random.default_rng(45).integers(
        0, cfg.vocab_size, (batch, 1)), device=dev)

    def batch_at(pos):
        shape = (batch, 1, 3) if cfg.pos_type == "mrope" else (batch, 1)
        return {"token": toks, "positions": torch.full(
            shape, pos, dtype=torch.int32, device=dev)}

    calls, kernel = [], ops.decode_attention

    def recorded(q, k, v, idx):
        out = kernel(q, k, v, idx)
        calls.append((q, k, v, idx, out))
        return out
    ops.reset_launches()
    tl_ops.reset_launches()
    ops.decode_attention = recorded
    try:
        logits, cache = serve_step(params, cache, batch_at(start))
        torch.cuda.synchronize()
    finally:
        ops.decode_attention = kernel
    launches = {**ops.LAUNCHES, **tl_ops.LAUNCHES}
    routes = {**ops.ROUTES, **{k: v for k, v in tl_ops.ROUTES.items() if v}}
    errs, rels, bad, tol = [], [], 0, FLASH_REL_TOL["bfloat16"]
    fault = None
    for i, (q, k, v, idx, out) in enumerate(calls):
        e, n, rel, f = held_decode(torch, ref, q, k, v, idx, out,
                                   fault=i == 0)
        errs.append(e)
        rels.append(rel)
        bad += n + sum(x > tol for x in rel)
        fault = f or fault
    n_calls = len(calls)
    del calls
    peak = torch.cuda.max_memory_allocated() / 1e9
    positions = list(range(start + 1, start + n_steps))
    saved = ring_slots(torch, cache, positions)

    def run_steps(step):
        """The steps after the first through ``step``, from ``cache``:
        (logits, wall seconds, peak GB above the start)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs, walls, c = [], [], cache
        for pos in positions:
            t0 = time.perf_counter()
            lg, c = step(c, batch_at(pos))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            outs.append(lg)
        return outs, walls, (torch.cuda.max_memory_allocated() - base) / 1e9

    eager_logits, walls, eager_above = run_steps(
        lambda c, b: serve_step(params, c, b))
    restore_slots(saved)
    del saved
    programs = jit_cache.JitCache(maxsize=1)
    program = jit_cache.jit(
        programs, (params["base"], params["adapter"], cfg), ("serve_step",),
        functools.partial(serve_step, params), donate_argnums=(0,))
    ops.reset_launches()
    tl_ops.reset_launches()
    before = dict(jit_cache.STATS)
    graph_logits, graph_walls, graph_above = run_steps(program)
    graph_programs = program_stats(before)
    graph_launches = {**ops.LAUNCHES, **tl_ops.LAUNCHES}
    logits_equal = all(torch.equal(a, b) for a, b in zip(graph_logits,
                                                         eager_logits))
    logits = graph_logits[-1]
    del graph_logits, eager_logits
    finite = bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
    splits = {}
    for name, step in (("captured", program),
                       ("eager", lambda c, b: serve_step(params, c, b))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(cache, batch_at(start + n_steps - 1))
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        splits[name] = device_split(prof, prof_wall * 1e6, 8,
                                    shares=("decode_attention", "tri_lora"))
        del prof
    split = splits["captured"]
    n_targets = len(cfg.lora_targets)
    expected = {"decode_attention": cfg.n_layers, "grouped_gemv": 0,
                "tri_lora_fwd": cfg.n_layers * n_targets, "tri_lora_dx": 0,
                "tri_lora_dw": 0, **NO_GROUPED}
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "dtype": cfg.param_dtype, "shape": "decode_32k", "batch": batch,
          "of_batch": sh.global_batch, "seq_len": sh.seq_len, "ring": ring,
          "positions": [start, start + n_steps - 1], "kv_cache_gb": kv_gb,
          "cross_kv_gb": x_gb, "fill_s": fill_s,
          "launches_per_step": launches, "expected_per_step": expected,
          "routes": routes, "attention_calls_held": n_calls,
          "attention_max_abs_err": max(errs),
          "attention_rel_err": [max(r[0] for r in rels),
                                max(r[1] for r in rels)],
          "rel_tol": tol, "n_out_of_tol": bad,
          "fault_ring_one_tile_short": fault,
          "wall_ms_per_step": [1e3 * w for w in graph_walls],
          "eager_wall_ms_per_step": [1e3 * w for w in walls],
          "logits_bitwise_eager": logits_equal, "programs": graph_programs,
          "graph_launches": graph_launches,
          "peak_above_start_gb": {"captured": graph_above,
                                  "eager": eager_above},
          "profiled_step": split, "profiled_step_eager": splits["eager"],
          "finite": finite, "peak_mem_gb": peak})
    require(launches == expected, f"{phase} launches {launches} != "
            f"{expected}")
    require(routes["attn_vec"] == cfg.n_layers and routes["attn_scalar"] == 0,
            f"{phase} attention routes {routes}")
    require(n_calls == cfg.n_layers and bad == 0, f"{phase}: {bad} attention "
            f"failures in {n_calls} calls (max {max(errs)}, relative {rels})")
    require(fault is not None and fault["rel"] > tol, f"{phase}: the "
            f"stand-in with the ring one "
            f"tile short passes the relative hold: {fault}")
    require(finite, f"{phase} logits not finite")
    require(logits_equal, f"{phase}: the captured steps' logits are not "
            f"bitwise the eager steps'")
    require(graph_launches == {k: v * len(positions)
                               for k, v in expected.items()},
            f"{phase}: the captured steps launched {graph_launches}")
    require(graph_programs["graphs"] == 1
            and graph_programs["replays"] == len(positions)
            and graph_programs["donated_in"] == 0,
            f"{phase}: {graph_programs} over {len(positions)} steps (one "
            f"capture, one replay a step, the cache never copied)")
    require(graph_above - eager_above < 0.25 * (kv_gb + x_gb),
            f"{phase}: the captured steps peaked {graph_above:.2f} GB above "
            f"the start, the eager ones {eager_above:.2f}: a second cache?")
    del cache, logits, program, programs
    free(torch)
    return launches


def held_decode(torch, ref, q, k, v, idx, out, rows: int = 16,
                fault: bool = False) -> tuple:
    """One decode-attention call's output held to its plain version in
    f32, ``rows`` batch rows at a time (an f32 copy of a whole 32,768-slot
    ring at batch 128 would not fit beside it): (max abs error, elements
    outside TOL, (largest row RMS error over row RMS, max error over max
    |want|), stand-in), as ``compare`` and ``row_rel`` hold a whole call.
    With ``fault`` the stand-in is the plain version over the valid slots
    less the oldest 64-slot tile (ring slots 64 and up; the newest index
    64 lower where the ring has not wrapped), rounded to the output's
    dtype: {"rel": its largest row RMS error, "n_out_of_tol"}; else
    None."""
    err, n_bad, row, w_max, f_row, f_bad = 0.0, 0, 0.0, 0.0, 0.0, 0
    ring = k.shape[1]
    for r0 in range(0, q.shape[0], rows):
        sl = slice(r0, r0 + rows)
        i = idx if idx.dim() == 0 else idx[sl]
        want = ref.decode_attention_ref(q[sl].float(), k[sl], v[sl], i)
        e, n = compare(torch, out[sl], want.to(out.dtype), "bfloat16")
        err, n_bad = max(err, e), n_bad + n
        row = max(row, row_rel(torch, out[sl], want)[0])
        w_max = max(w_max, float(want.abs().max()))
        if fault:
            short = ref.decode_attention_ref(
                q[sl].float(), k[sl, 64:], v[sl, 64:],
                torch.where(i >= ring, i, i - 64)).to(out.dtype)
            f_row = max(f_row, row_rel(torch, short, want)[0])
            f_bad += compare(torch, short, want.to(out.dtype),
                             "bfloat16")[1]
            del short
        del want
    return (err, n_bad, (row, err / max(w_max, 1e-30)),
            {"rel": f_row, "n_out_of_tol": f_bad} if fault else None)


def phase_whisper_decode(torch, ops, ref, tl_ops, model, get_config, dev):
    """whisper-small whole at decode_32k, batch 32, the cross cache filled
    from the encoder (``serve_steps_phase``)."""
    job = WHISPER_DECODE
    return serve_steps_phase(torch, ops, ref, tl_ops, model,
                             get_config(WHISPER), job["batch"], job["steps"],
                             "whisper_decode", dev)


def flash_impls(torch, fa_ops, model, cfg, params, batch, impls) -> dict:
    """Loss and adapter gradients of ``cfg`` on ``batch`` under each
    attention backend in ``impls``: {impl: (loss, grads, flash launches,
    wall s)}."""
    from repro_torch.tree import tree_leaves, tree_map

    res = {}
    for impl in impls:
        ad = tree_map(lambda t: t.detach().requires_grad_(True),
                      params["adapter"])
        fa_ops.reset_launches()
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(cfg, ad, params["base"], batch,
                                attn_impl=impl)
        grads = torch.autograd.grad(loss, tree_leaves(ad))
        torch.cuda.synchronize()
        res[impl] = (float(loss.detach()), grads, dict(fa_ops.LAUNCHES),
                     time.perf_counter() - t0)
        del loss, ad
    return res


def held_impls(phase: str, res: dict, against: str, cfg) -> dict:
    """Each backend's loss within 1e-4·|loss| and adapter gradients within
    1e-3 of each leaf's largest entry of ``against``'s; flash launched
    forward (again for the checkpointed layers), dq and dk/dv once a layer,
    the others none."""
    lr, gr = res[against][0], res[against][1]
    out = {}
    for impl, (loss, grads, launches, wall) in res.items():
        errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(grads, gr, strict=True)]
        out[impl] = {"loss": loss, "loss_rel_err": abs(loss - lr) / abs(lr),
                     "grad_max_err_over_max": max(errs), "launches": launches,
                     "wall_s": wall}
    emit({"phase": phase, "arch": cfg.name, "dtype": "float32",
          "layers": cfg.n_layers, "against": against, "impls": out})
    n = cfg.n_layers
    for impl, o in out.items():
        require(o["loss_rel_err"] <= 1e-4, f"{phase}: {impl} loss "
                f"{o['loss']} vs {against} {lr}")
        require(o["grad_max_err_over_max"] <= 1e-3, f"{phase}: {impl} "
                f"adapter gradients differ by {o['grad_max_err_over_max']} "
                f"of their largest entry")
        want = ({"flash_fwd": n + recomputed(cfg), "flash_dq": n,
                 "flash_dkv": n} if impl == "flash" else
                {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0})
        require(o["launches"] == want, f"{phase}: {impl} launched "
                f"{o['launches']}, expected {want}")
    return out


def phase_whisper_oracle(torch, fa_ops, model, get_config, dev) -> None:
    """whisper-small at full width, 2 + 2 layers, f32: loss and adapter
    gradients through flash against ``ref`` over 1 x 4096 tokens and the
    1,500 frames (``held_impls``; under flash the cross-attention takes
    the blockwise tiles, as in whisper_train, under ref the materialized
    logits); then with every adapter off zero but
    the ``xattn`` ones (decode applies none there, as the JAX package's),
    12 decode steps of 2 sequences from the filled cross cache against the
    forward's logits at rtol = atol = 2e-3."""
    import numpy as np

    from repro_torch.tree import tree_map_with_path

    job = WHISPER_ORACLE
    cfg = get_config(WHISPER).with_overrides(
        n_layers=job["layers"], n_enc_layers=job["layers"],
        param_dtype="float32")
    from repro_torch.models import attention

    require(attention.select_impl(cfg, job["seq"], impl="flash",
                                  kv_len=cfg.enc_frames) == "blockwise",
            "whisper_oracle's cross-attention must take the blockwise tiles")
    params = random_params(torch, model, cfg, dev, 47)
    batch = enc_dec_batch(torch, cfg, 1, job["seq"], 47, dev)
    held_impls("whisper_oracle", flash_impls(
        torch, fa_ops, model, cfg, params, batch, ("flash", "ref")), "ref",
        cfg)
    del batch
    free(torch)
    params["adapter"] = tree_map_with_path(
        lambda p, t: torch.zeros_like(t) if "xattn" in p and p[-1] == "B"
        else t, params["adapter"])
    b, t = job["dec_batch"], job["dec_steps"]
    batch = enc_dec_batch(torch, cfg, b, t, 48, dev)
    with torch.inference_mode():
        full, _ = model.forward(cfg, params["base"], params["adapter"],
                                batch, attn_impl="flash")
        cache = model.init_decode_cache(cfg, b, 16, device=dev)
        fill_cross_cache(torch, model, cfg, params["base"], cache,
                         batch["frames"])
        got = []
        for i in range(t):
            lg, cache = model.decode_step(
                cfg, params["base"], params["adapter"], cache,
                {"token": batch["tokens"][:, i:i + 1],
                 "positions": torch.full((b, 1), i, dtype=torch.int32,
                                         device=dev)})
            got.append(lg[:, 0])
    err = (torch.stack(got, 1) - full).abs()
    n_bad = int((err > 2e-3 + 2e-3 * full.abs()).sum())
    emit({"phase": "whisper_oracle", "decode": {
        "arch": cfg.name, "dtype": "float32", "layers": cfg.n_layers,
        "batch": b, "steps": t, "xattn_adapters": "zero delta",
        "decode_vs_forward_max_abs_err": float(err.max()),
        "logits_max_abs": float(full.abs().max()),
        "n_out_of_tol": n_bad, "tol": "rtol=atol=2e-3",
        "sample": np.asarray(got[-1][0, :4].cpu()).tolist()}})
    require(n_bad == 0, f"whisper decode differs from the forward: "
            f"{float(err.max())}, {n_bad} out of tolerance")
    del params, batch, full, got, cache
    free(torch)


def phase_vlm_train(torch, fa_ops, tl_ops, model, get_config, dev):
    """qwen2-vl-72b at full width, VLM_TRAIN's 8 layers, through
    ``make_train_step`` (``train_steps_phase``): flash at 64 / 8 heads (a
    GQA group of 8) over 4,352 tokens with q/k/v bias and M-RoPE on
    Qwen2-VL triplets, the loss over the 4,096 text tokens through the
    chunked loss (8 chunks of 512 a pass, again in the backward)."""
    cfg = get_config(cut_depth(get_config, VLM, VLM_TRAIN["layers"]))
    job = VLM_TRAIN
    require(job["seq"] * cfg.padded_vocab > model._CE_CHUNK_THRESHOLD,
            "vlm_train must take the chunked loss")
    require(cfg.n_heads // cfg.n_kv_heads == 8 and cfg.hd == 128
            and cfg.mrope_sections == (16, 24, 24),
            f"{cfg.name}: heads {cfg.n_heads}/{cfg.n_kv_heads}")
    return train_steps_phase(torch, fa_ops, tl_ops, model, cfg, job,
                             "vlm_train", dev, ce_tap=True)


def phase_vlm_prefill(torch, fa_ops, tl_ops, model, get_config, dev):
    """qwen2-vl-72b at full width, 2 layers, 1 x (32,768 text + 256
    patches) (``prefill_steps_phase``, profiled): 2 flash forwards over
    33,024 tokens and 8 tri-LoRA forwards."""
    cfg = get_config(cut_depth(get_config, VLM, VLM_PREFILL["layers"]))
    return prefill_steps_phase(torch, fa_ops, tl_ops, model, cfg,
                               VLM_PREFILL, "vlm_prefill", dev, True)


def phase_vlm_decode(torch, ops, ref, tl_ops, model, get_config, dev):
    """qwen2-vl-72b at full width, 2 layers, decode_32k at its own batch
    of 128 (``serve_steps_phase``), positions (t, t, t)."""
    job = VLM_DECODE
    cfg = get_config(cut_depth(get_config, VLM, job["layers"]))
    return serve_steps_phase(torch, ops, ref, tl_ops, model, cfg,
                             128, job["steps"], "vlm_decode", dev)


def phase_vlm_serve(torch, ops, serve, model, random_bank, get_config,
                    dev) -> dict:
    """qwen2-vl-72b at full width, 2 layers, bf16, serving through
    ServeEngine (``serve_job``: positions (t, t, t), every request
    finishes, both decode kernels every layer of every step on the 16-byte
    routes); then the f32 oracle at 2 layers (``dense_oracle``):
    ServeEngine tokens equal serve_naive's request for request."""
    job = VLM_SERVE
    arch = cut_depth(get_config, VLM, job["layers"])
    launches = serve_job(torch, ops, serve, model, random_bank, get_config,
                         dev, dict({k: v for k, v in job.items()
                                    if k != "layers"}, arch=arch),
                         "vlm_serve")
    dense_oracle(torch, ops, serve, random_bank, get_config, model, dev,
                 VLM, "vlm_serve")
    free(torch)
    return launches


def phase_vlm_oracle(torch, fa_ops, model, get_config, dev) -> None:
    """qwen2-vl-72b at full width, 2 layers, f32, one sequence of 256
    patches and 4,096 text tokens (4,352 = 17 x 256: 'blockwise_cv' takes
    its hand-written backward) on Qwen2-VL triplets: loss and adapter
    gradients under flash and blockwise_cv against ref (``held_impls``)."""
    job = VLM_ORACLE
    cfg = get_config(VLM).with_overrides(n_layers=job["layers"],
                                         param_dtype="float32")
    require((job["seq"] + cfg.vision_patches) % 256 == 0,
            "vlm_oracle's sequence must be a multiple of 256")
    params = random_params(torch, model, cfg, dev, 51)
    batch = enc_dec_batch(torch, cfg, 1, job["seq"], 51, dev)
    held_impls("vlm_oracle", flash_impls(
        torch, fa_ops, model, cfg, params, batch,
        ("flash", "blockwise_cv", "ref")), "ref", cfg)
    del params, batch
    free(torch)


def np_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def card_line() -> str:
    run = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(run.returncode == 0, f"nvidia-smi failed: {run.stderr}")
    return run.stdout.strip().splitlines()[0]


START = time.perf_counter()
#: wall seconds of each phase of this run, in order
PHASE_WALL: dict = {}


def wall_line(name: str, t0: float) -> None:
    PHASE_WALL[name] = time.perf_counter() - t0
    emit({"phase": "wall", "name": name, "s": PHASE_WALL[name],
          "since_start_s": time.perf_counter() - START})


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds kept in PHASE_WALL and printed
    on a line of their own, and what the cached programs did in it on a
    ``{"phase": "programs"}`` line.  The programs an earlier phase cached
    are dropped first (their graph pools and anchored backbones would sit
    in this phase's memory)."""
    from repro_torch.core import jit_cache
    jit_cache.clear_all()
    before = dict(jit_cache.STATS)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    wall_line(name, t0)
    stats = program_stats(before)
    if stats["programs"]:
        emit({"phase": "programs", "name": name, **stats})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.adapter_bank import random_bank
    from repro_torch.kernels import bounds, build
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.kernels.tri_lora import ops as tl_ops
    from repro_torch.kernels.tri_lora import ref as tl_ref
    from repro_torch.launch import serve
    from repro_torch.models import model, rwkv
    from repro_torch.models.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    try:
        timed("build", phase_build, build)
        timed("hold_check", phase_hold_check, torch, dev)
        attn_err = timed("kernels (decode cases)", attn_cases, torch, ops,
                         ref, dev)
        gemv_err = timed("kernels (gemv cases)", gemv_cases, torch, ops, ref,
                         dev)
        flash_err = timed("flash_cases", flash_cases, torch, fa_ops, fa_ref,
                          dev)
        tri_lora_err = timed("tri_lora_cases", tri_lora_cases, torch, tl_ops,
                             tl_ref, dev)
        grouped_err = timed("tri_lora_cases (grouped)",
                            tri_lora_grouped_cases, torch, tl_ops, tl_ref,
                            dev)
        wkv6_err = timed("wkv6_cases", wkv6_cases, torch, wkv_ops, wkv_ref,
                         dev)
        card = card_line()
        t0 = time.perf_counter()
        rows = [time_attention(torch, F, ops, ref, bounds, dev),
                time_gemv(torch, ops, ref, bounds, dev)]
        long_ring = time_attention(torch, F, ops, ref, bounds, dev,
                                   "long ring")
        decode32k_row = time_attention(torch, F, ops, ref, bounds, dev,
                                       "decode 32k")
        wall_line("kernels (decode timing)", t0)
        flash_rows = timed("flash_timing", time_flash, torch, F, fa_ops,
                           fa_ref, bounds, dev)
        tri_lora_rows = timed("tri_lora_timing", lambda: time_tri_lora(
            torch, tl_ops, bounds, dev) + time_tri_lora_grouped(
            torch, tl_ops, bounds, dev))
        wkv6_row = timed("wkv6_timing", time_wkv6, torch, wkv_ops, wkv_ref,
                         rwkv, bounds, dev, card)
        for r in rows + [long_ring, decode32k_row]:
            emit({"phase": "kernels", "timing": r["name"],
                  "kernel_ms": r["ms"], **{k: v for k, v in r.items()
                                           if k not in ("name", "ms")}})
        launches, state = timed("serve", phase_serve, torch, ops, serve,
                                model, random_bank, get_config, dev)
        timed("profile", phase_profile, torch, state, dev)
        # the captured decode program against the eager step
        timed("decode_graph", phase_decode_graph, torch, ops, serve, state,
              dev)
        del state
        gc.collect()          # the timed engine sits in a reference cycle
        torch.cuda.empty_cache()
        timed("oracle", phase_oracle, torch, ops, serve, random_bank,
              get_config, model, dev)
        torch.cuda.empty_cache()
        train_launches, loop_out = timed("train", phase_train, torch, fa_ops,
                                         tl_ops, get_config, dev)
        launches.update(train_launches)
        # the vectorized clients: the grouped tri-LoRA kernels
        vmap, vmap_run = timed("train_vmap", phase_train_vmap, torch, fa_ops,
                               tl_ops, get_config, dev, loop_out)
        launches.update(tri_lora_fwd_grouped=vmap["tri_lora_fwd_grouped"],
                        tri_lora_dx_grouped=vmap["tri_lora_dx_grouped"])
        del loop_out
        # fault injection and admission control on both paths
        storm_hist = timed("train_faults", phase_train_faults, torch, fa_ops,
                           tl_ops, get_config, dev)
        # the scan engine: the same jobs in chunks of rounds, kill and
        # resume, and the host syncs of a chunk
        timed("train_scan", phase_train_scan, torch, fa_ops, tl_ops,
              get_config, dev, vmap_run, storm_hist)
        del vmap_run, storm_hist
        # the host client store and the async engine
        host_device_run = timed("train_host", phase_train_host, torch,
                                fa_ops, tl_ops, get_config, dev)
        timed("train_async", phase_train_async, torch, fa_ops, tl_ops,
              get_config, dev)
        # the LM driver (forward and dx, then vectorized) and the backbone
        # warm-up (dW)
        lm, lm_hist = timed("lm_train", phase_lm_train, torch, fa_ops,
                            tl_ops, get_config, dev)
        launches.update(tri_lora_fwd=lm["tri_lora_fwd"],
                        tri_lora_dx=lm["tri_lora_dx"])
        # the captured programs of the three runs above against eager runs
        timed("train_graph", phase_train_graph, torch, fa_ops, tl_ops,
              get_config, dev)
        _, lm_vmap_hist = timed("lm_train (vmap)", phase_lm_train, torch,
                                fa_ops, tl_ops, get_config, dev, "vmap",
                                lm_hist)
        timed("lm_scan", phase_lm_scan, torch, fa_ops, tl_ops, get_config,
              dev, lm_vmap_hist)
        # the captured chunk programs of train_scan and lm_scan against
        # eager chunks
        timed("scan_graph", phase_scan_graph, torch, fa_ops, tl_ops,
              get_config, dev)
        timed("lm_host / lm_async", phase_lm_host_async, torch, fa_ops,
              tl_ops, get_config, dev, lm_vmap_hist)
        # the eighteenth slice's paths: the client axis over the device mesh
        # (client_parallelism="shard", client_store="sharded") and the
        # federated round step over the pod axis
        timed("train_shard", phase_train_shard, torch, fa_ops, tl_ops,
              get_config, dev, host_device_run, lm_vmap_hist)
        del host_device_run
        timed("fed_round_step", phase_fed_round_step, torch, fa_ops, tl_ops,
              model, get_config, dev)
        free(torch)
        launches["tri_lora_dw"] = timed("pretrain", phase_pretrain, torch,
                                        tl_ops, get_config,
                                        dev)["tri_lora_dw"]
        timed("card_vs_cpu", phase_card_vs_cpu, torch, tl_ops, model,
              get_config, dev)
        # this slice's paths: the RWKV-6 prefill (wkv6 and tri-LoRA
        # forward), its decode and the f32 oracle
        gc.collect()
        torch.cuda.empty_cache()
        rwkv_launches, rwkv_p = timed(
            "rwkv_prefill", phase_rwkv_prefill, torch, wkv_ops, wkv_ref,
            tl_ops, model, get_config, dev)
        launches["wkv6"] = rwkv_launches["wkv6"]
        decode_launches = timed("rwkv_decode", phase_rwkv_decode, torch,
                                wkv_ops, tl_ops, serve, get_config, rwkv_p,
                                dev)
        del rwkv_p
        torch.cuda.empty_cache()
        timed("rwkv_oracle", phase_rwkv_oracle, torch, wkv_ops, model,
              get_config, dev)
        # the eleventh slice's paths: the LM driver on rwkv6-1.6b (loop,
        # then vmap through the grouped kernels) and the dense configs
        gc.collect()
        torch.cuda.empty_cache()
        timed("lm_rwkv", phase_lm_rwkv, torch, wkv_ops, tl_ops, get_config,
              dev)
        gc.collect()
        torch.cuda.empty_cache()
        timed("dense_configs", phase_dense_configs, torch, ops, serve, model,
              random_bank, get_config, dev)
        # the twelfth slice's paths: h2o-danube-3-4b (swa blocks, head dim
        # 120) trained, held to the plain attention, and served
        h2o_launches = timed("h2o_train", phase_h2o_train, torch, fa_ops,
                             tl_ops, get_config, dev)
        timed("h2o_oracle", phase_h2o_oracle, torch, fa_ops, model,
              get_config, dev)
        timed("h2o_serve", phase_h2o_serve, torch, ops, serve, model,
              random_bank, get_config, dev)
        # the fifteenth slice's paths: the step factories at the assigned
        # shapes (train_4k with remat and the chunked loss, prefill_32k,
        # decode_32k, long_500k), the exported bank served, the DLG harness
        timed("steps_train", phase_steps_train, torch, fa_ops, tl_ops, model,
              get_config, dev)
        prefill_row = timed("flash_timing (prefill 32k)", time_flash_prefill,
                            torch, F, fa_ops, bounds, dev)
        prefill_launches = timed("steps_prefill", phase_steps_prefill, torch,
                                 fa_ops, tl_ops, model, get_config, dev)
        decode32k_launches = timed("steps_decode", phase_steps_decode, torch,
                                   ops, ref, tl_ops, model, get_config, dev)
        timed("bank_serve", phase_bank_serve, torch, ops, fa_ops, tl_ops,
              serve, get_config, dev)
        timed("privacy", phase_privacy, torch, dev)
        # the sixteenth slice's paths: the MoE block (llama4-scout trained
        # and held to ref, grok-1 served) and the RG-LRU hybrid
        # (recurrentgemma-2b trained, held to blockwise, decoded)
        free(torch)
        moe_launches = timed("moe_train", phase_moe_train, torch, fa_ops,
                             tl_ops, model, get_config, dev)
        timed("moe_oracle", phase_moe_oracle, torch, fa_ops, model,
              get_config, dev)
        timed("moe_serve", phase_moe_serve, torch, ops, serve, model,
              random_bank, get_config, dev)
        rg_launches = timed("rg_train", phase_rg_train, torch, fa_ops,
                            tl_ops, model, get_config, dev)
        timed("rg_oracle", phase_rg_oracle, torch, fa_ops, model, get_config,
              dev)
        rg_decode_launches = timed("rg_decode", phase_rg_decode, torch, ops,
                                   tl_ops, serve, model, get_config, dev)
        # the seventeenth slice's paths: whisper-small (the encoder-decoder
        # path) and qwen2-vl-72b (M-RoPE, the vision prefix), with the
        # 'blockwise_cv' backend in the VLM's oracle
        free(torch)
        whisper_launches = timed("whisper_train", phase_whisper_train, torch,
                                 fa_ops, tl_ops, model, get_config, dev)
        whisper_row = timed("flash_timing (whisper prefill)",
                            time_flash_prefill, torch, F, fa_ops, bounds,
                            dev, "whisper prefill")
        whisper_prefill = timed("whisper_prefill", phase_whisper_prefill,
                                torch, fa_ops, tl_ops, model, get_config, dev)
        whisper_decode = timed("whisper_decode", phase_whisper_decode, torch,
                               ops, ref, tl_ops, model, get_config, dev)
        timed("whisper_oracle", phase_whisper_oracle, torch, fa_ops, model,
              get_config, dev)
        vlm_launches = timed("vlm_train", phase_vlm_train, torch, fa_ops,
                             tl_ops, model, get_config, dev)
        vlm_prefill = timed("vlm_prefill", phase_vlm_prefill, torch, fa_ops,
                            tl_ops, model, get_config, dev)
        vlm_decode = timed("vlm_decode", phase_vlm_decode, torch, ops, ref,
                           tl_ops, model, get_config, dev)
        vlm_serve = timed("vlm_serve", phase_vlm_serve, torch, ops, serve,
                          model, random_bank, get_config, dev)
        timed("vlm_oracle", phase_vlm_oracle, torch, fa_ops, model,
              get_config, dev)
    except Exception:                       # report, print no result, fail
        traceback.print_exc()
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows += flash_rows + tri_lora_rows + [wkv6_row, prefill_row,
                                          decode32k_row, whisper_row]
    decode32k_row["note"] = "launches: one decode_32k step (steps_decode)"
    path_launches = {"rwkv prefill": rwkv_launches,
                     "rwkv decode": decode_launches,
                     "h2o train": h2o_launches, "rg train": rg_launches,
                     "prefill 32k": prefill_launches,
                     decode32k_row["shape"]: decode32k_launches,
                     "vlm train": vlm_launches,
                     "whisper prefill": whisper_prefill}
    for r in rows:                    # the launches of the row's own path
        r["launches"] = path_launches.get(r.get("shape"), launches)[
            r.get("launch_key", r["name"])]
    emit({"phase": "summary", "max_abs_err_by_dtype": {
        "decode_attention": attn_err, "grouped_gemv": gemv_err,
        "flash_attention": flash_err, "tri_lora": tri_lora_err,
        "tri_lora_grouped": grouped_err,
        "wkv6": wkv6_err}, "phase_wall_s": PHASE_WALL,
        "path_launches": {"moe train": moe_launches,
                          "rg decode": rg_decode_launches,
                          "whisper train": whisper_launches,
                          "whisper decode step": whisper_decode,
                          "vlm prefill": vlm_prefill,
                          "vlm decode step": vlm_decode,
                          "vlm serve": vlm_serve},
        "wall_s": time.perf_counter() - START})
    emit({"kernels": [{k: r[k] for k in keys + ("shape", "note") if k in r}
                      for r in rows]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
