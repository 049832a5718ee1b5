#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``zoo_tpu_torch``) on one Hopper card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports neither JAX nor the JAX package, builds the port's CUDA
kernels from ``zoo_tpu_torch/csrc`` and prints one JSON line per phase,
each phase between two ``host`` lines (the CPU model, the CPUs this
process may use and the load average at its start and end; its wall
and CPU seconds at the end; the ``device`` line holds them too):

1. device — name, capability, count, power limit (fails off Hopper);
2. build — nvcc wall time and each kernel function's ``-Xptxas -v``
   registers, shared memory and spills (fails if an instance of the f32
   conv, the f32 flash backward or the two-pass int8 GEMM spills);
2b. sass — how each kernel multiplies, read from the built libraries'
   SASS (``cuobjdump -sass``): ``wgmma`` (HGMMA, IGMMA), ``mma.sync``
   (HMMA, IMMA) or ``simt``; fails unless the bf16 conv, the bf16
   flash forward and backward (dK/dV, dQ), the fused bottleneck and
   both int8 GEMMs run on the tensor cores, the bf16, f32 (3xTF32)
   and int8 convs and the two-pass int8 GEMM on ``wgmma``, and the
   shuffles of the paged decode, both int8 GEMMs and the f32 flash
   forward and backward (dK/dV, dQ) all on the fast path (no
   ``WARPSYNC.COLLECTIVE``);
3. kernels — each kernel against its plain PyTorch version at the
   Llama-3-8B serving shapes, for f32, bf16 and int8 caches and the
   position edges, then timed (device time per call from
   ``torch.profiler``, and CUDA-event wall time; for the paged decode
   and both int8 GEMMs also the device launches per call, which must
   be one) beside its plain
   version, its least possible time on the card, and (flash only)
   ``scaled_dot_product_attention`` as a yardstick the port never calls;
   the bf16 causal flash forward, dK/dV and dQ also at T = 4096
   (``moe_shape`` (2, 32, 8, 4096, 128) and ``long_context_shape`` (8,
   12, 4, 4096, 64));
4. tiny — ``llama:tiny`` greedy streams through the engine with the
   kernels equal the streams with every plain version, token for
   token, on the bucket and ``chunk=4`` paths; then
   ``llama:tiny:spec_k=4`` (speculative decoding) on prompts tiled from
   a 16-token motif, greedy and seeded (temperature 0.9, top_k 16): the
   kernel streams equal the plain path's and the same model's with the
   engine at ``spec_k=0``, and the verify passes launch the paged
   prefill and no paged decode; then over the wire (``tiny-wire``):
   two ``ServingServer``s, each over an engine with its own model on one
   params tree, an ``HAServingClient`` (``hedge=False``) streaming the
   prompts, the first server stopped after stream 0's third token —
   every stream equals the kernel engine's direct one, greedy and
   seeded, no block held after — and the ``check_llm_serving`` copy
   with ``--device cuda``: two replica processes on the card, one
   SIGKILLed mid-storm, zero client-visible failures, the seat
   respawned, no leaked block and the paged-decode kernel in each
   replica's ``llm_stats``; then ``disagg-tiny`` and ``tenancy-tiny``,
   phase 5's disaggregation and tenancy runs at ``llama:tiny`` (the
   same functions, which also run on the CPU: ``device="cpu"``);
4b. train-tiny — a tiny Llama ``fit`` (T=32, B=4, 2 shuffled epochs,
   f32) through the flash kernels and the fused AdamW kernel equals the
   same ``fit`` through the dense attention and the plain update;
4c. train-bert-tiny — a tiny BERT (2 blocks, hidden 64, 4 heads, S=512,
   so that ``auto`` takes the non-causal flash kernels) ``fit`` for two
   shuffled epochs with the fused AdamW, f32 and ``mixed_bfloat16``,
   equals the same ``fit`` through the dense attention and the plain
   update (f32 to 4b's tolerances, bf16 losses within rtol 2e-2);
4c2. moe-tiny — ``MoELlama`` at ``tiny_llama_config`` widths (4 experts,
   top 2, T=512, so ``auto`` takes the causal flash kernels) ``fit`` for
   two shuffled epochs with the fused AdamW, f32 and ``mixed_bfloat16``,
   equals the same ``fit`` through the dense attention and the plain
   update (4b's and 4c's tolerances), with exact launches;
4d. estimator-tiny — the same tiny BERT through
   ``Estimator.from_keras`` (default guard, a model_dir,
   ``AdamWeightDecay(fused=True)``, L2 clipping 1.0, two epochs) equals
   the estimator run through the plain versions (f32, 1e-4), checkpoints
   at steps 0-2; then an epoch poisoned through the ``fit.batch`` seam
   (a NaN planted in the output bias) leaves params, m, v and the
   device step bit-equal while the AdamW kernel launches for each leaf
   and step;
5. main path — the Llama-3-8B-width engine answers four concurrent
   greedy requests (20/100/300/480-token prompts, 32 new tokens each:
   480 + 32 fills the 512-token context of the default 32 x 16-token
   block table) on the bucket path, then with ``chunk=64`` and with an int8
   cache; kernel launch counts are reset before and read after each
   run and must show each kernel of that path. After the bucket run,
   ``tick`` lines profile decode ticks of the same model, with the
   paged-decode kernel and with its plain version (device time by group,
   device launches per tick). Then a ``spec_k=4`` model on prompts of
   the same lengths tiled from a 16-token motif, its engine at
   ``spec_k=4`` (the verify pass: paged prefill, no paged decode) and
   at ``spec_k=0`` (plain decode), each line with TTFTs, decode
   tokens/s, the drafter's counters and peak memory, and whether the
   two runs' streams are equal (printed, not asserted), with ``tick``
   lines (``"path": "verify"``) profiling verify passes of 8 slots x 5
   rows of that model, through the paged-prefill kernel and its plain
   version. After the bucket run, on its weights, the wire runs:
   the same four prompts through ``ServingServer``s on 127.0.0.1 and an
   ``HAServingClient`` — one server (``wire_1_server``, beside the
   direct run), two (``wire_2_servers``), and two with the first
   stopped at the 480-token stream's 8th token (``wire_failover``, with
   the failover pause and the HA client's failover count); client-side
   TTFTs and decode tokens/s, streams equal to the bucket run's, no
   block held, the flash forward and the paged decode launched. Right
   after ``direct_warm``, ``direct_traced``: the same four prompts
   through an engine on those weights with tracing on, each stream
   under a trace id of its own — streams equal to the bucket run's,
   every trace holding ``llm.admit``, ``llm.first_token``,
   ``llm.stream`` and ``llm.prefill``, the engine's
   ``zoo_llm_ttft_seconds`` count up by 4, TTFT and decode tokens/s
   beside ``direct_warm``'s with the overhead in percent (its launches
   are ``launches_by_path.serve_obs``). Last,
   with this process's weights freed, the same prompts through a
   ``ReplicaGroup`` of one 8B ``python -m zoo_tpu_torch.serving.replica
   --device cuda`` process and ``group.client()``
   (``wire_replica_process``: the client in another process than the
   engine; a cold and a warm pass with the first-token hedge on, a warm
   one without; streams equal to the bucket run's, the kernels in
   ``llm_stats``, no block held), then ``obs-main``: a ``ReplicaGroup``
   of two such 8B replicas (``max_restarts=0``, tracing into one dir
   with this process, ``ZOO_CHAOS_ALLOW=1``, an SLO of 1.0 s on the
   TTFT p99 evaluated every second), warmed off the clock, the four
   prompts twice through ``group.client(hedge=True,
   hedge_delay_ms=500)`` with explicit trace ids, replica 0 SIGKILLed
   at stream 0's first token: 0 failures, every stream equal to the
   bucket run's, one trace rebuilt from the JSONL files alone over both
   replicas with two client attempts, replica 0's postmortem harvested
   (``replica_boot`` in its ring), a live ``debug_dump`` of replica 1
   (``llm_stream_end`` in its ring), replica 1's ``/healthz`` SLO
   verdict (a breach over 1.0 s in the ring), a trace echoed on an
   error reply, and ``flash`` in replica 1's ``llm_stats``; between the
   int8 run and speculation,
   on the bucket run's weights: ``disagg-main`` — a ``role=prefill`` and
   a ``role=decode`` ``ServingServer`` in this process and an
   ``HAServingClient`` (``migrate_min_tokens`` 64) streaming the four
   prompts: the three long ones prefill on the prefill seat, push their
   KV over ``kv_migrate`` and decode on the decode seat with no prefill
   call there, the 20-token one streams plainly on the decode seat;
   streams equal the bucket run's (f32 cache) or the int8 run's (int8
   cache); per handoff blocks, bytes, push seconds and client TTFT
   beside the direct run's; then a push made to fail falls back to a
   re-prefill with the same stream and no leaked block — and
   ``tenancy-main``: one engine of the 8B spec's 8 slots, 24 seeded
   300-token ``greedy`` prompts (rate 4/s, burst 8, at most 6 slots,
   class 1) flooding against four 20-token ``victim`` prompts (class 0)
   one after another, with tenancy off and on, beside the victim alone;
   every stream equals its unpreempted reference, greedy is shed with
   its own bucket's hint and never holds more than 6 slots, each victim
   is admitted ahead of the greedy streams waiting at its submission;
   then a class preemption (greedy 100-token streams on every slot, a
   victim arrives) and a weighted-fair run (weights 4 and 1); the
   victim's TTFT p50/p99 and inter-token p99 beside its unloaded run's
   and ``bench_tenancy``'s 2x bar (printed, not asserted);
6. train-main — Keras ``fit`` of the repo's Llama training config
   (``bench.py`` ``bench_llama``: vocab 32000, hidden 768, 12 blocks, 12
   heads, 4 kv heads, intermediate 2048) at full width and depth, S=512,
   B=64, ``mixed_bfloat16``, ``remat="dots"``, fused AdamW: a warm-up
   fit, then a timed fit of 8 steps (per-step losses finite and
   falling, launches of flash fwd / dK-dV / dQ / AdamW counted), then
   a ``step`` line profiling train steps by kernel group;
7. infer-tiny — a tiny ResNet (bottleneck, blocks (1, 1), 32x32x3, 10
   classes, BatchNorm stats drawn from a seed) predicts through the
   conv kernels within 1e-5 of the plain path in f32, and after
   ``quantize_model`` through the int8 kernels bit-equal to it;
8. infer-main — ``resnet50(1000, (224, 224, 3))`` at full width and
   depth, seed weights, ``mixed_bfloat16``, behind
   ``InferenceModel.load_keras(batch_size=128)``: 8 batches of 128
   images (``bench.py`` ``bench_resnet50_int8_infer``'s
   ``RandomState(0).randn``) in float, then after
   ``quantize_model(mode="force")`` in int8, one batch with
   ``ZOO_INT8_MATMUL=unfused``, and a ``quantize_model(mode="auto")``
   verdict; samples/s, launches per forward (49 ``conv2d``, or 49
   ``conv2d_int8`` and one head GEMM), kernel path vs plain path on one
   batch, top-1 agreement of int8 with float (BatchNorm's statistics
   refreshed from the first batch, and the float path's top-1 spread
   over at least 10 classes before the agreement is read), peak memory,
   and an
   ``infer-step`` line profiling one batch per path;
8b. train-image-tiny — the tiny ResNet of phase 7 ``fit`` with
   ``SGD(0.1, 0.9)``, f32, 8 images, two shuffled epochs at B=4,
   through the conv kernel and the SGD kernel, equals the same ``fit``
   through their plain versions, and repeats itself bit for bit in
   three runs (beside three runs with the reference conv's backward
   free to take cuDNN's nondeterministic algorithms, a control);
9. bottleneck-main — ``fused_bottleneck`` at the geometries of
   ResNet-50's twelve identity blocks (four stages, B=128, bf16),
   forward and forward+backward, one kernel launch per call and no
   composition fallback, beside the port's unfused block (three
   ``conv2d`` dispatches); ms per stage;
10. train-image-main — Keras ``fit`` of ``bench.py`` ``bench_resnet50``
   (``resnet50(1000, (224, 224, 3))``, ``SGD(lr=0.1, momentum=0.9)``,
   ``mixed_bfloat16``, B=128, ``RandomState(0)`` images and labels,
   ``shuffle=False``) at full width and depth: a warm-up fit, 8 timed
   steps (step ms, samples/s, ``mfu`` against ``bench.py``'s 8.0 GFLOP
   per forward, losses finite, 49 ``conv2d`` per forward and one SGD
   launch per trainable leaf per step, running stats moved), then
   ``evaluate(metrics=["accuracy"])`` on 256 images and a
   ``train-image-step`` line profiling steps by kernel group;
11. train-f32-main — the same two training configs (``bench_llama``
   at S=512, B=64, ``remat="dots"``, fused AdamW; ``bench_resnet50`` at
   B=128, ``SGD(0.1, 0.9)``) through Keras ``fit`` with ``compile``
   given no ``dtype_policy``: the ``float32`` default a user gets, which
   runs the f32 routes (the f32 flash forward, dK/dV and dQ; the f32
   conv). Each: a warm-up step, then 4 timed steps on one batch (step
   ms, tokens/s or samples/s, losses finite and falling, peak memory;
   12 flash forward, 12 dK/dV and 12 dQ launches a step, or 49 ``conv2d``
   a forward), and a ``train-f32-step`` line profiling steps by kernel
   group;
12. train-rec-main — Keras ``fit`` of the NCF flagship
   (``__graft_entry__.py`` ``_flagship()``'s config: 6040 users, 3706
   items, 5 classes, embeddings 64, MLP (128, 64, 32), ``Adam(lr=
   0.001)``) at ``bench.py`` ``bench_ncf``'s size: B=8192, 96 steps an
   epoch of ``RandomState(0)`` ids and labels, host-fed, unshuffled; a
   warm-up epoch, then timed epochs (samples/s), per-step losses finite
   and falling, two runs from one start equal bit for bit, no kernel
   launched but the key chain's split, one a step (NCF runs none in the
   JAX package either),
   ``recommend_for_user`` on three users, and a ``train-rec-step`` line
   profiling steps by kernel group with the device's busy share;
13. train-bert-main — Keras ``fit`` of ``bench.py`` ``bench_bert``'s
   BERT-base (vocab 30522, hidden 768, 12 blocks, 12 heads,
   intermediate 3072, no dropout, ``remat="dots"``, ``mixed_bfloat16``,
   ``Lambda(h[:, 0])`` + ``Dense(2)``, from-logits loss): run (a)
   exactly ``bench_bert`` (S=128, B=64, the dense attention, AdamW at
   the knob's default, unfused), run (b) S=512, B=16 with the fused
   AdamW (12 non-causal flash forward, dK/dV and dQ launches and one
   AdamW launch a leaf, every step); each a warm-up fit, 8 timed steps
   (step ms, samples/s, ``mfu`` from ``bench_bert``'s analytic FLOPs
   over the bf16 peak, finite losses) and a ``train-bert-step``
   profile;
13a. train-bert-dropout — run (a) again at BERT's published dropout
   (``hidden_p_drop = attn_p_drop = 0.1``, so the dense attention, as
   JAX's ``auto`` picks): 8 steps from one snapshot through the kernels
   and through ``plain_kernels()`` (losses within 2e-2; 7 ``dropout``
   launches a block a step, 2 + 4 a block ``derive_keys``), step ms,
   ``mfu`` and busy share beside run (a)'s; then text-main:
   a news20-shaped corpus (512 documents in 20 classes, >= 5000
   distinct words) through ``TextSet.read`` -> ``tokenize`` ->
   ``normalize`` -> ``word2idx(max_words_num=5000)`` ->
   ``shape_sequence(500)`` and ``TextClassifier`` at its reference
   widths (token_length 200, encoder 256, dropout 0.2, 20 classes,
   B=128, Adam) with the cnn, lstm and gru encoders: 3 steps against
   the plain path (1e-4), step ms, samples/s, busy share, launches a
   step, a ``predict``; then seq-tiny: ``examples/anomaly_detection.py``'s
   detector (unroll 24, B=128) and a ``SessionRecommender`` with history,
   8 steps each against the plain path and a ``predict``; then
   chronos-main: the LSTM, TCN, Seq2Seq and MTNet forecasters at the JAX
   package's default widths on a seeded series of NAB nyc_taxi's length
   (10,320 half-hourly points, HOUR and WEEKDAY features, lookback 48,
   B=64): 8 steps each against the plain path (1e-4 relative; 2
   ``dropout`` launches a step a dropout site, ``derive_keys`` once a step
   and once a site), a profiled step, a whole epoch, ``evaluate`` on the
   held-out tenth; TCMF on ``examples/tcmf_panel_forecast.py``'s 500 x 240
   panel (tcn's forecast MSE under ar's); ``examples/
   autots_forecasting.py``'s AutoTS search (TPE, then at random over 2
   threads; mse < 0.5; the pipeline saved, loaded and predicting the
   same); ``AEDetector`` on the anomaly series; then zoo-main: the image
   zoo (Inception-v1, MobileNet-v1, MobileNet-v2, SqueezeNet,
   DenseNet-121) at 224 x 224 x 3 and 1000 classes, f32, seed weights,
   through ``ImageClassifier.create(name, 1000).predict_image_set`` on
   64 seeded uint8 BGR images of three sizes in batches of 32 (resize
   256, centre crop 224, normalize): images/s, a batch's wall and
   device ms, busy share, the conv kernel's share, exact ``conv2d``
   launches against the graph's count, the kernel route within 1e-5 of
   ``ZOO_CONV_IMPL=reference`` on outputs that spread (BatchNorm
   refreshed from a batch, the head calibrated; distinct top-1 classes
   printed), a model file round trip; then 4 ``fit`` steps of
   MobileNet-v1 (B=32, SGD 0.9) against plain with exact launches;
   then moe-main: ``MoELlama`` at Mixtral-8x7B-v0.1's published widths
   (vocab 32000, hidden 4096, 32 heads, 8 kv heads, intermediate 14336,
   8 experts, top 2, aux weight 0.02, capacity factor 1.25) cut to 2 of
   32 blocks, B=2 x T=4096, ``remat="dots"``, ``mixed_bfloat16``, the
   fused AdamW: a ``training=False`` forward through the flash kernels
   against the dense attention (loss within 1e-3, at most 5 % of the
   token rows moved by a routing flip), 4 steps with exact launches (2
   flash forwards, 2 dK/dV, 2 dQ and 13 AdamW a step), step wall and
   device ms, busy share, tokens/s, ``mfu``, peak memory and device ms by
   group, ``call_with_aux`` forward and backward (finite aux, a nonzero
   router gradient), and the fused AdamW on one 939.5 M-element expert
   bank against plain; then seam-models-main: 4 ``fit`` steps each of
   Wide & Deep (MovieLens-1M's columns, B=8192) and KNRM (qaranker's
   widths, B=256) against the same fits on the CPU, and NER with its
   CRF (B=32) against the plain route with exact dropout and key
   launches and ``crf_decode`` on the card equal to the CPU's;
13b. estimator-main — the NCF flagship through ``Estimator.from_keras(m,
   model_dir=tmp)`` with the default guard at B=8192 (96 training
   batches an epoch, a tenth of all rows held out for validation,
   EveryEpoch checkpoints and summaries): a straight run of 4 epochs
   (samples/s each); an exception at epoch 2's first superbatch retried
   from the verified checkpoint, bit-equal to the straight run's epoch
   3; a fresh estimator's ``load_orca_checkpoint()`` plus one epoch,
   bit-equal to its epoch 4; a poisoned superbatch (its ids set out of
   range through the ``fit.batch`` seam) skipped (16 steps, past
   ``max_skips``, so also rolled back) with params and Adam's state
   finite and the journal holding it; ``val_accuracy``/``val_loss`` read
   back from the event files; samples/s and CUDA sync-debug warnings
   over one epoch with the guard off and on, in turns: the guard adds
   none, its own host reads are one a superbatch boundary plus one at
   the epoch's end (none with it off), and no step syncs (at most a
   copy of each superbatch array and the loss read). No kernel launches
   but the key chain's split, one a step (``estimator_ncf``);
13c. estimator-bert — BERT-base at run (b)'s S=512, B=16, bf16, through
   the estimator with ``AdamWeightDecay(lr=1e-4, fused=True)``, L2
   clipping 1.0 and the guard, 2 epochs of 4 steps: losses within 2e-2
   of the estimator run through the plain versions, a poisoned epoch
   leaving every param, m, v and the device step bit-equal with the
   fused AdamW launched for it, equal sync-debug warnings with the guard
   off, on and off, the guard's host reads one a boundary and no step
   syncing; its
   launches are ``estimator_bert``;
13d. bench-guard — ``bench.py`` ``bench_guard``'s mix (an MLP, n=16384,
   64 features, B=512, 3 epochs x 3 interleaved reps), guarded and
   unguarded samples/s and ``guard_overhead_pct`` (printed, not gated);
14. predict-mlp — ``bench.py`` ``bench_serving`` in the port: an MLP
   (``Dense(128, relu)``, ``Dense(10, softmax)``, 64 features) behind
   ``ServingServer`` (two batcher threads, ``max_wait_ms=2``) at batch
   sizes 8 and 32, 8 clients on connections of their own, a warm-up
   storm, then 200 timed requests: p50, p99, req/s, and the JAX guard
   (p99 at most 10x p50, or under 250 ms). No kernel: the door's own
   cost. Then ``obs_trace`` (``bench_obs_trace``'s A/B on this MLP's
   door): req/s through one ``HAServingClient`` with tracing off and on,
   twice each, the overhead in percent, and a disabled ``span()``'s cost
   in ns (under the bench's 100 us);
15. predict-main — ResNet-50 of phase 8 (``mixed_bfloat16``, BatchNorm
   drawn from a seed) saved as a model file and published to a
   ``ModelRegistry`` as v1 (alias ``prod``), and int8 after
   ``quantize_model(mode="force")`` as v2; ``resolve_model_spec(
   "registry:<root>:prod", batch_size=32)`` into a ``ServingServer``
   (``max_wait_ms=5``); 32 client threads x 16 single-image requests
   (1, 224, 224, 3) through ``HAServingClient``, a ``reload`` to v2
   once half are answered: zero failures, every reply within 4e-3 of
   its echoed version's direct ``predict`` of the image in a
   zero-padded batch of 32 (bit-equal ones counted), those direct
   outputs against the same batches under the plain versions (v1
   within 4e-3, v2 bit-equal), launches exactly 49 ``conv2d`` a v1
   batch and 49 ``conv2d_int8`` + 1
   ``fused_quantized_matmul`` a v2 batch (load and reload warm-ups
   included); p50/p99, req/s, mean batch occupancy, a ``predict-step``
   profile of one batch per version and the device's busy share over a
   profiled storm. Then a ``ReplicaGroup`` of two ``python -m
   zoo_tpu_torch.serving.replica --device cuda`` processes booted from
   the registry spec (prod at v2): boot seconds, ``version_info()``,
   ``healthz()``, then prod moved to v1 and ``rolling_update()`` under
   client load: zero failures, every reply within tolerance of its
   version, the group all on v1. Last, ``chaos_ejection``
   (``bench_chaos_ejection``'s mix on real work): three such replicas of
   v1, 360 single-image requests from 4 clients, hedge off, replica 1
   slowed over the wire ``chaos`` op by 20x the unloaded p50 of a
   served request (measured first), ejection off, then on: every reply
   bit-equal to v1's direct predict, 0 failures, replica 1 ejected, the
   on-p99 below the off-p99; the bench's keys printed.

16. cluster-main — Cluster Serving (the Redis stream job, its HTTP
   front end and CLI) serving VGG-16 at full width and depth (224 x 224
   x 3, 1000 classes, ``mixed_bfloat16``, weights drawn on the card from
   a seed) from model files encrypted at rest: v1 float saved with
   ``save_encrypted`` under AES-CBC, v2 int8 after
   ``quantize_model(mode="force")`` under AES-GCM. Each version read by
   ``InferenceModel.load_encrypted`` into ``ClusterServing(batch_size=
   32)`` + ``FrontEnd`` over an ``EmbeddedRedis``: 8 client threads x 32
   single-image ``enqueue``s read back with ``OutputQueue``, and 4 HTTP
   ``/predict`` instances: 0 ``"NaN"``, 0 per-record fallbacks, 0
   missing, every reply within 4e-3 of its image's direct ``predict`` in
   a zero-padded batch of 32 (bit-equal ones counted), those direct
   batches against ``plain_kernels()`` (v1 within 4e-3, v2 bit-equal),
   launches exactly 13 ``conv2d`` a v1 batch and 13 ``conv2d_int8`` + 1
   ``quantized_matmul`` (fc6, K = 25,088: the two-pass route) + 2
   ``fused_quantized_matmul`` (fc7, fc8) a v2 batch; records/s, p50/p99,
   mean batch occupancy, the ``decode``/``inference``/``encode`` stage
   times and a ``cluster-step`` profile of one batch per version. Then
   the CLI in a process of its own (``python -m
   zoo_tpu_torch.serving.run --model <v2> --encrypted --model-enc-mode
   gcm --redis-mode embedded --batch-size 32 --device cuda``, the key in
   ``ZOO_MODEL_SECRET``): boot seconds, 64 queue records and 2 HTTP
   instances within tolerance of the in-process v2 outputs, then
   SIGTERM: drained, exit 0.

Phase 7 is followed by predict-tiny: the tiny ResNet served through
``ServingServer`` (``batch_size=4``) and ``HAServingClient.predict``,
float and int8, the kernel replies equal to the plain ones within phase
7's tolerances; then cluster-tiny: ``tests/test_cluster_serving.py``'s
MLP behind ``EmbeddedRedis`` + ``ClusterServing`` + ``FrontEnd`` on the
card, a queue ``enqueue``/``query``, a ``dequeue``, a synchronous
``InputQueue.predict``, an HTTP ``/predict`` (trace and tenant echoed)
and a string-and-sparse schema round trip, every reply within 1e-5 of a
direct ``predict``.

Last, the Orca entry path, detection and the Caffe loader: ``orca-main``
(``init_orca_context()`` on the card and its refusals, ``envcheck``;
then NCF at B=8192 and BERT-base at S=512, B=16 through
``Estimator.from_keras`` with no ``device=``, fed from XShards and from
the same arrays: bit-equal losses, params and optimizer state, equal
launches kernel by kernel, samples/s and busy share of both feeds),
``detect-main`` (SSD300, 21 classes, on 512 synthetic 300-px images:
two steps against the CPU route, 2 epochs at B=32, 64 images' detections
against the CPU route, ``ObjectDetector.predict_image_set``; step ms,
images/s, device ms of convs against the rest) and ``caffe-main`` (a
seeded VGG-16 and BVLC CaffeNet written as deploy prototxts and V2
binaries, loaded with ``InferenceModel.load_caffe``: load s, a batch of
32 against the CPU route, images/s; VGG-16 fine-tuned 4 steps through
the fused SGD, each step against plain).

Then the host-to-card feed and the readers: ``ingest-main`` (ResNet-50
at ``bench_resnet50``'s config, 1024 seeded images written with
``write_parquet`` and read back as arrays and XShards; one epoch each
from the parquet arrays and XShards through the staged feed (pinned
buffers, copy stream), the parquet arrays with ``ZOO_FEED_STAGING=off``
and the original arrays: bit-equal, launches as counted, buffers pinned,
the first step against plain; a ``set_profile(trace_dir)`` run of 4
steps on each feed: its phases, ``op_breakdown`` of its trace with the
conv kernel's launches equal to the counter, the host-to-device copies'
device ms and the part hidden under kernels) and ``readers-main``
(BERT-base at S=512, B=16 from 8 TFRecord shards through the native
reader, from ``FeatureSet.ndarrays`` on a spilling DISK tier and from
the arrays, bit-equal, the first step against plain; NCF's epoch from
``read_csv`` and ``read_parquet`` XShards, bit-equal to the arrays;
``NNClassifier`` fitting ResNet-50 for 2 steps from a pandas DataFrame,
equal to ``fit``; every reader's rows/s and MB/s).

Then the Orca estimators of the torch bridge and the online-learning
loop: ``torch-main`` (BERT-base as a plain ``nn.Module`` through
``orca.learn.pytorch.Estimator.from_torch``: the ``torch.export``
trace on a CPU copy and its seconds and ops, no op of a converted
forward off the card, ``predict`` before ``fit`` against the module and
the CPU route, 8 GLUE-recipe steps (S=128, B=32, ``torch.optim.AdamW``)
through the fused AdamW against the plain update, the trained weights
written back bit-equal, a ``torch.optim.SGD`` fit through the fused
SGD, a 2-trial ``AutoEstimator.from_torch`` on the card), ``gan-main``
(``GANEstimator`` over TF-GAN's MNIST networks: one iteration against
the CPU route, a 64-step epoch, ``generate``, a NaN batch folded away),
``infer-est-main`` (``orca.learn.inference.Estimator.from_model`` on
infer-main's saved ResNet-50, float and int8, from 8 XShards and from
the array, bit-equal to ``InferenceModel.predict``; ``from_caffe`` on
caffe-main's VGG-16 files, its top-1) and ``continuous-main`` (a
``ContinuousTrainingLoop`` turn with ``chronos_train_fn`` over
chronos-main's LSTM: a ``PromotionGate`` over 256 mirrored windows
promotes the candidate; a poisoned window is demoted).

Phase 3 also holds the flash forward (o, lse) and backward kernels
(dK/dV, dQ) against their plain versions, and the gradients against
autograd of the dense path, at B=8 and B=64, H=12, Hkv=4, T=512, D=64
(the f32 backward route timed at B=8 and B=64), checks that the reference
conv's f32 gradients do not change with cuDNN's TF32 switched on, and
holds the fused AdamW and SGD kernels against theirs on device scalars
(the 1-based step, SGD's rate) with the guard's ``ok`` true, false (every
operand bit-unchanged though the gradient holds NaNs) and absent, and the
kernel's bias corrections from the device step against the host's
``bias_corrections`` for steps 1 to 100000, bit for bit, then times them
at the training config's shapes (as the guarded step launches them)
beside their bounds and a library yardstick
(``scaled_dot_product_attention`` and its backward, ``torch.optim``'s
fused AdamW and SGD) the port never calls; and the implicit-GEMM conv
kernels (bf16, f32, int8) at four ResNet-50 shapes, B=128 (int8 on the
K-major weight copy a quantized layer carries, the copy's one-time cost
printed apart), and the int8
GEMMs at the ResNet-50 head, at ``bench_int8_matmul``'s shape and (the
two-pass one, and the fused op's hand-over to it past K = 8192: one
``quantized_matmul`` launch, no fused one) at VGG-16's fc6, B=128 and
the served B=32 (with the eager activation quantization before it
timed), and VGG-16's first conv (Cin = 3, B=32) on the bf16 and int8
routes, beside ``F.conv2d`` and ``torch._int_mm`` as yardsticks; the f32
conv at the image zoo's shapes (B=32: SqueezeNet fire2 and head,
MobileNet-v2's 16/24/144-channel convs, DenseNet-121, Inception 3a)
timed beside its bound and ``F.conv2d``, and every other in-envelope
conv shape of the five families checked (``zoo_shapes``); the reference
conv's gradients (``conv2d_plain_grads``, the float conv's backward)
repeat bit for bit on the same inputs at the four timed conv shapes,
B=128, f32 and bf16; and the
fused bottleneck at ResNet-50's four identity geometries (B=128, bf16,
and f32 at conv2_x) with its gradients at conv2_x, timed beside the
unfused cuDNN composition (three ``F.conv2d``, the ReLUs and the add),
a yardstick the port never calls; and the non-causal bf16
flash forward and backward at BERT run (b)'s shape (B=16, H = Hkv = 12,
T=512, D=64) against their plain versions and dense autograd, timed
beside their bounds and the non-causal SDPA (``bert_shape``), and the
``Embedding`` gather's gradient at NCF's shape repeating bit for bit
(beside ``index_add_``, a control); and the dropout kernel, forward and
backward, bit-equal to its plain version at BERT's hidden (64, 128, 768)
and attention (64, 12, 128, 128) shapes in bf16, (128, 256) f32 and a
spatial mask, its kept share within 4 sigma of 1 - p, timed beside its
bound (bytes at 3.35 TB/s, or 75 integer ops an element at 16.7 T INT32
op/s) and ``F.dropout`` (Philox bits, a yardstick the port never
calls), and the key kernel's splits and fold-ins bit-equal to the plain
chain.

The bf16, f32 and int8 convs (per shape and summed; the f32 conv also
beside its 3xTF32 bound), the bf16 flash forward and backward kernels at the training
shape, the f32 flash forward and the paged prefill at the serving
shape (and at the speculative verify pass's: 8 slots x 5 rows, starts
200-263 and one slot past the context, held to its plain version for
f32 and int8 caches, under ``verify_shape``) and the int8 GEMMs at
their GEMM shapes also print TFLOP/s
(TOP/s for int8), the share of their bound they reach and, where there
is one, their time over the library call's; the f32 flash forward and
the int8 GEMMs also print their launch plans. The paged prefill is also
held to its plain version at a one-row and a 17-row chunk of three
sequences.

Then a ``{"kernels": [...]}`` line (each entry with its ``mma`` route
and its launches by main path, ``serve_spec`` the speculative run's,
``serve_wire`` the wire runs', ``serve_disagg`` the disaggregated runs'
(f32 and int8), ``serve_tenancy`` the tenancy runs', ``serve_obs``
``direct_traced``'s, ``train_bert`` BERT
run (b)'s, ``train_bert_dropout`` train-bert-dropout's, ``text_cnn``,
``text_lstm``, ``text_gru`` text-main's, ``seq_anomaly`` and
``seq_session`` seq-tiny's, ``chronos_lstm``, ``chronos_tcn``,
``chronos_seq2seq``, ``chronos_mtnet`` chronos-main's 8-step runs,
``chronos_tcmf`` its TCMF TCN fit, ``chronos_autots`` its two searches,
``zoo_predict`` zoo-main's five predict runs, ``zoo_fit`` its
MobileNet-v1 steps,
``estimator_ncf`` estimator-main's (the
key split only),
``estimator_bert`` estimator-bert's, ``orca_ncf`` and ``orca_bert``
orca-main's shard-fed runs, ``ingest`` ingest-main's staged parquet
epoch, ``readers`` readers-main's TFRecord, csv and DataFrame runs,
``detect`` detect-main's fit (none),
``caffe_fit`` caffe-main's fine-tune, ``torch_bert`` and
``torch_sgd`` torch-main's AdamW and SGD fits, ``gan`` gan-main's epoch,
``infer_est`` infer-est-main's predicts, ``continuous`` the loop's turns,
``predict`` predict-main's in-process run, ``cluster`` cluster-main's
in-process runs (both versions; ``conv2d`` and ``conv2d_int8`` also
carry ``vgg_first_conv``, ``quantized_matmul`` ``served_fc6``);
for ``conv2d`` and the three flash kernels the numbers are the bf16
route's, the f32 route's sit under ``f32_route``), the card's name and power
limit as ``nvidia-smi`` reports them, and last ``{"ok": true, "device":
...}``.
Any failure exits non-zero without the ``ok`` line. Without a CUDA
device, or without the package beside this file, it exits 2.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

SPEC_8B = ("llama:vocab=128256,hidden=4096,n_block=32,n_head=32,"
           "n_kv_head=8,intermediate=14336")
# phase 5's depth: 4 of the 8B spec's 32 blocks (widths unchanged). On a
# host of CPU model 143 the whole smoke read 1176.8 s of its 1200 s at
# full depth (phase 5 alone 217.5 s) and 1092.8 s at 16 blocks (phase 5
# 143.8 s); on CPU model 207 it read 895.4 s at 8 blocks with the host
# feed's phases (phase 5 76.4 s); a cut cuts n_block only
N_BLOCK = 4
PEAK_BYTES = 3.35e12              # H100 SXM HBM3, bytes/s
PEAK_F32_FLOPS = 67e12            # H100 SXM f32, outside the tensor cores
PEAK_BF16_FLOPS = 989e12          # H100 SXM bf16 tensor cores, dense
PEAK_TF32_FLOPS = 495e12          # H100 SXM TF32 tensor cores, dense
PEAK_INT8_OPS = 1979e12           # H100 SXM int8 tensor cores, dense
# H100 SXM 32-bit integer ops outside the tensor cores: 64 INT32 lanes on
# each of 132 SMs at the 1.98 GHz boost clock (a quarter of the f32 FMA
# rate above, which counts two flops an FMA on 128 lanes)
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# the dropout kernel's integer ops an element: threefry-2x32's 20 rounds
# (add, rotate, xor), 5 key injections (2 adds), the 2 adds of the key
# and the xor, shift, or and compare of the mask
DROPOUT_OPS_PER_ELEMENT = 75
# dropout kernel shapes: BERT-base's hidden (B=64, S=128, 768) and
# attention probabilities (64, 12 heads, 128, 128) in bf16, a small f32
# tensor, and a spatial mask (one element per feature map)
DROPOUT_SHAPES = (((64, 128, 768), "bfloat16", None),
                  ((64, 12, 128, 128), "bfloat16", None),
                  ((128, 256), "float32", None),
                  ((128, 64, 8, 8), "float32", (128, 64, 1, 1)))
DROPOUT_P = 0.1
LOSS = "sparse_categorical_crossentropy_from_logits"
# the training config: bench.py bench_llama, full width and depth
TRAIN_CFG = dict(vocab=32000, hidden=768, n_block=12, n_head=12,
                 n_kv_head=4, intermediate=2048, rope_theta=10000.0)
TRAIN_S, TRAIN_B, TRAIN_STEPS = 512, 64, 8
# the image-inference path: bench.py bench_resnet50_int8_infer
INFER_B, INFER_STEPS = 128, 8
# the distinct top-1 classes the float path must give its images before
# the int8-vs-float top-1 agreement is read
INFER_TOP1_MIN = 10
# ResNet-50 convs inside the kernels' envelope, (spatial, C, k, O, stride)
CONV_SHAPES = ((56, 256, 1, 64, 1), (28, 128, 3, 128, 1),
               (56, 256, 1, 512, 2), (7, 512, 3, 512, 1))
# (M, K, N): the ResNet-50 head at B=128, bench.py bench_int8_matmul, and
# VGG-16's fc6 at B=128 and at the served batch, B=32 (7x7x512 = 25088
# features into Dense(4096)), where the fused path hands over to the
# two-pass path (K > 8192): 103 MB of int8 weights, 12.8 MB of f32 x and
# an 822 MB float64 copy of w for the plain version, all freed after the
# shape
GEMM_SHAPES = ((128, 2048, 1000), (512, 1024, 1024), (128, 25088, 4096),
               (32, 25088, 4096))
# Cluster Serving (cluster-main): VGG-16 at full width and depth behind
# the Redis stream job, batches of 32; 8 client threads x 32 single-image
# requests and 4 HTTP instances a version, then the CLI in a process of
# its own: 64 requests and 2 HTTP instances
CLUSTER_B, CLUSTER_CLIENTS, CLUSTER_PER_CLIENT, CLUSTER_HTTP = 32, 8, 32, 4
CLUSTER_CLI_REQUESTS, CLUSTER_CLI_HTTP = 64, 2
CLUSTER_SECRET, CLUSTER_SALT = "chip-smoke-kms-secret", "chip-smoke-salt"
CLUSTER_IMAGE, CLUSTER_CLASSES, VGG_CONVS = (224, 224, 3), 1000, 13
# VGG-16's first conv (spatial, C, k, O, stride): Cin = 3, K = 27
VGG_FIRST_CONV = (224, 3, 3, 64, 1)
# zoo-main: the image-classification zoo at its published ImageNet widths
# (224 x 224 x 3 in, 1000 classes, MobileNet-v1 alpha 1, DenseNet-121
# growth 32, float32) through ImageClassifier.predict_image_set: 64 seeded
# uint8 BGR images of three sizes, batches of 32; then ZOO_FIT_STEPS fit
# steps of MobileNet-v1 with SGD(momentum 0.9)
ZOO_FAMILIES = ("inception-v1", "mobilenet", "mobilenet-v2", "squeezenet",
                "densenet-121")
ZOO_IMAGES, ZOO_B, ZOO_FIT_STEPS, ZOO_CLASSES = 64, 32, 4, 1000
# the fit steps' rate. Seed-built MobileNet-v1 on random labels carries a
# rounding difference about ten times further each step through
# BatchNorm's batch moments (a 3xTF32 conv against f32 cuDNN, or images
# nudged by one ulp), so each step is held to the plain step from the
# same params and optimizer state, not the two trajectories to each other
ZOO_FIT_LR = 1e-3
# the calibrated heads' logit spread across images: enough to move the
# probabilities by 1e-2 and more, small enough that the 3xTF32 sums'
# error in the logits (relative to their size) stays far inside 1e-5
ZOO_LOGIT_STD = 0.5
# one step's update through the kernels against the plain step's, by norm
# over the trainable leaves, relative to the plain update's norm: within
# this many times the gap a one-ulp nudge of the images opens in the plain
# step (on an H100 both gaps read 0.4-0.9 %: BatchNorm's batch moments
# carry the forward's rounding into the gradients)
TOL_ZOO_UPDATE_X = 10.0
ZOO_SIZES = ((240, 320), (300, 300), (256, 341))
# the zoo's f32 conv shapes the kernel had not been held at, timed at
# B = ZOO_B (spatial, C, k, O, stride): SqueezeNet fire2, MobileNet-v2's
# first projection and a 144-wide expansion, DenseNet-121's bottleneck
# and growth convs, Inception 3a, SqueezeNet's 512 -> 1000 head; C = 16
# and 24 are below the f32 kernel's 32-channel reduction step
ZOO_CONV_SHAPES = ((56, 64, 1, 16, 1), (56, 16, 3, 64, 1),
                   (112, 32, 1, 16, 1), (56, 24, 1, 144, 1),
                   (56, 144, 1, 24, 1), (56, 128, 3, 32, 1),
                   (56, 96, 1, 128, 1), (28, 192, 1, 64, 1),
                   (28, 96, 3, 128, 1), (14, 512, 1, 1000, 1))
# ResNet-50's identity bottlenecks per stage: (name, spatial, Cin, Cmid)
BLOCK_STAGES = (("conv2_x", 56, 256, 64), ("conv3_x", 28, 512, 128),
                ("conv4_x", 14, 1024, 256), ("conv5_x", 7, 2048, 512))
BLOCK_B, BLOCK_GRAD_B = 128, 32
# the image-training path: bench.py bench_resnet50 (:371-384)
TRAIN_IMG_B, TRAIN_IMG_STEPS, TRAIN_IMG_N = 128, 8, 1024
RESNET50_FWD_FLOPS = 8.0e9          # bench.py:65, per image
# the f32 training path (the default policy): timed steps of each model
TRAIN_F32_STEPS = 4
# the NCF flagship: __graft_entry__.py _flagship() (:17-32), trained as
# bench.py bench_ncf (:331-341) trains it, on synthetic ids
NCF_CFG = dict(user_count=6040, item_count=3706, class_num=5,
               user_embed=64, item_embed=64, hidden_layers=(128, 64, 32),
               mf_embed=64)
NCF_B, NCF_STEPS, NCF_EPOCHS = 8192, 96, 3
# BERT-base: bench.py bench_bert (:387-424); run (a) its exact config at
# S=128, B=64, run (b) the same model at S=512 (max_position_len, BERT's
# pre-training length), B=16: the same 8192 tokens a step
BERT_CFG = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                intermediate_size=3072, hidden_p_drop=0.0, attn_p_drop=0.0,
                remat="dots")
BERT_RUNS = (("a", 128, 64), ("b", 512, 16))
BERT_S, BERT_B = BERT_RUNS[1][1:]
BERT_STEPS = 8
# MoE Llama at Mixtral-8x7B-v0.1's published widths (its config.json:
# vocab 32000, hidden 4096, 32 heads, 8 kv heads, intermediate 14336,
# rope_theta 1e6, rms_norm_eps 1e-5, 8 local experts, 2 a token, router
# aux loss coefficient 0.02) with the JAX package's capacity factor 1.25
# (Mixtral routes dropless); depth cut to 2 of 32 blocks by memory (a
# block's f32 weights, gradients and AdamW moments take 23.2 GB), B=2 x
# T=4096 (16 routing groups of 512 tokens, 160 slots an expert a group)
MOE_CFG = dict(vocab=32000, hidden=4096, n_block=2, n_head=32, n_kv_head=8,
               intermediate=14336, rope_theta=1e6, rms_eps=1e-5)
MOE_EXPERTS = dict(n_experts=8, top_k=2, aux_loss_weight=0.02)
MOE_B, MOE_T, MOE_STEPS = 2, 4096, 4
# moe-main, kernels vs plain at the seed weights: the first step's loss
# (a mean of 8192 cross-entropies, each moved by bf16 roundings of the
# attention output that the flash kernel and the dense path place
# differently) within 1e-3 relative of the dense forward's; and the
# token rows whose logits move past the bf16 tolerance (TOL["bfloat16"]
# times the row's largest logit) at most TOL_MOE_MOVED of them: such a
# row is a token whose top-2 choice or capacity slot flipped on a near
# tie of its router probabilities, which moves its whole output by an
# expert's difference
TOL_MOE_LOSS, TOL_MOE_MOVED = 1e-3, 0.05
# phase 3's long-sequence flash shapes, bf16 causal, (B, H, Hkv, T, D):
# the MoE path's, and bench.py bench_llama_longctx's (the training
# config at S=4096, B=8)
LONG_FLASH_SHAPES = (("moe_shape", (2, 32, 8, 4096, 128)),
                     ("long_context_shape", (8, 12, 4, 4096, 64)))
# seam-models-main: Wide & Deep with the column layout of the reference's
# apps/recommendation-wide-n-deep notebook at MovieLens-1M's sizes
# (6040 users, 3706 items, 5 ratings), B=8192; KNRM at the reference
# qaranker example's widths (question 10 and answer 40 tokens, 300-d
# GloVe-width embeddings, 21 kernels), vocab 30,000, B=256; NER at its
# default widths with CoNLL-2003's 9 BIO tags, 20,000 words, 100 chars,
# B=32; SEAM_STEPS fit steps each
WND_COLUMNS = dict(
    wide_base_cols=["occupation", "gender"], wide_base_dims=[21, 3],
    wide_cross_cols=["age-gender"], wide_cross_dims=[100],
    indicator_cols=["genres", "gender"], indicator_dims=[19, 3],
    embed_cols=["userId", "itemId"], embed_in_dims=[6040, 3706],
    embed_out_dims=[64, 64], continuous_cols=["age"])
WND_B, KNRM_B, NER_B, SEAM_STEPS = 8192, 256, 32, 4
KNRM_CFG = dict(text1_length=10, text2_length=40, vocab_size=30000,
                embed_size=300, kernel_num=21, sigma=0.1, exact_sigma=0.001)
NER_CFG = dict(num_entities=9, word_vocab_size=20000, char_vocab_size=100,
               sequence_length=64, word_length=12, word_emb_dim=100,
               char_emb_dim=30, tagger_lstm_dim=100)
# Wide & Deep and KNRM on the card against the CPU, per-step losses
# relative: the first (before any update) is an f32 forward summed in
# another order; after it Adam turns a gradient element that cancels to
# within rounding (a zero-initialised wide table whose rows' samples
# cover the classes evenly) into a step of up to lr = 1e-3 of either
# sign, which moves a later loss by up to ~1e-4 relative
TOL_SEAM_FIRST, TOL_SEAM_LOSS = 1e-5, 1e-3

# tolerances of kernel vs plain version, max absolute error:
# f32 outputs 1e-4 (the same f32 math summed in another order, expf vs
# torch.exp; outputs are O(1)); bf16 outputs 3e-2 (one bf16 rounding of
# O(1) outputs is up to 2**-8 ~ 4e-3, and the plain version rounds its
# probabilities and products to bf16 at the kernel's points or at others);
# optimizer updates 1e-6 (the same f32 elementwise math, on inputs drawn
# so that every output moves by more than 10x that in one step).
# The flash gradients against autograd of the dense path, which rounds
# neither p nor ds to bf16, take the bf16 tolerance times their largest
# magnitude: they reach ~9, and half a bf16 ulp in [8, 16) is 2**-5.
# The conv kernel against its plain version (cuDNN in f32, TF32 off):
# f32 within 1e-5 of the largest output (the same f32 sums in another
# order over up to 9 * C = 4608 terms), bf16 within one bf16 ulp of it,
# 2**-7 (both round one f32 sum, which may fall either side of a tie).
# The int8 kernels: exact (integer sums, the same f32 epilogue).
# The tiny ResNet's probabilities through the f32 conv kernels: 1e-5.
TOL = {"float32": 1e-4, "bfloat16": 3e-2, "update": 1e-6,
       "conv_f32": 1e-5, "conv_bf16": 2.0 ** -7, "int8": 0.0,
       "block": 2.0 ** -6, "block_grad": 2e-2}
TOL_TINY_F32 = 1e-5
# the engine's speculative counters, printed for each speculative run
SPEC_STATS = ("spec_k", "spec_proposed_tokens", "spec_accepted_tokens",
              "spec_accept_rate", "spec_draft_hit_rate")
# The fused bottleneck against its plain version ("block"): within 2**-6
# of the largest output (both round t1, t2, z3 and y to bf16 and may land
# on either side of a tie after summing in another order); its gradients
# through the op (recompute backward) against autograd of the
# composition ("block_grad"): within 2e-2 of the largest gradient.
# Besides, at least BLOCK_BIT_EQUAL of its outputs equal the plain
# version's bit for bit (readings 0.99974 to 0.99997 at the four
# stages): a fault confined to few or small outputs, such as a skipped
# bf16 rounding of z3 or a wrong tap on a tile's border row, stays under
# the max-diff limit but not under this one.
BLOCK_BIT_EQUAL = 0.999
# the tiny ResNet fit, kernel path vs plain path, relative to each
# loss and, by norm, to each parameter and running stat: one step
# differs by the conv's summation order (~1e-7); SGD(0.1, 0.9) on random
# labels is an unstable run that amplifies it step by step (see
# phase_train_image_tiny)
TOL_TRAIN_TINY = 1e-3
# full-width ResNet-50 in bf16, kernel path vs plain path: the two round
# the conv sums to bf16 on either side of ties at other elements, and 53
# layers carry that on; the probabilities stay within this
TOL_MAIN_BF16 = 5e-2


# kernel -> (its library, the __global__ function of its main-path
# route): for conv2d and the flash forward and backward the bf16
# tensor-core bodies; their f32 routes are F32_ROUTES
MMA_FUNCTIONS = {
    "flash_attention": ("flash_attention", "flash_fwd_tc_kernel"),
    "flash_attention_dkdv": ("flash_attention_bwd",
                             "flash_bwd_dkdv_tc_kernel"),
    "flash_attention_dq": ("flash_attention_bwd", "flash_bwd_dq_tc_kernel"),
    "fused_bottleneck": ("fused_block", "fused_bottleneck_kernel"),
    "fused_adam": ("fused_optim", "adam_kernel"),
    "fused_sgd": ("fused_optim", "sgd_kernel"),
    "paged_decode": ("paged_decode", "paged_decode_kernel"),
    "paged_prefill": ("paged_prefill", "paged_prefill_kernel"),
    "conv2d": ("conv2d", "conv_tc_kernel"),
    "conv2d_int8": ("conv2d", "conv_i8_tc_kernel"),
    "quantized_matmul": ("quant_matmul", "qmm_kernel"),
    "fused_quantized_matmul": ("quant_matmul", "fqmm_kernel"),
    "dropout": ("dropout", "dropout_kernel"),
    "derive_keys": ("dropout", "derive_keys_kernel")}
F32_ROUTES = {"flash_attention": ("flash_attention", "flash_fwd_kernel"),
              "flash_attention_dkdv": ("flash_attention_bwd",
                                       "flash_bwd_dkdv_kernel"),
              "flash_attention_dq": ("flash_attention_bwd",
                                     "flash_bwd_dq_kernel"),
              "conv2d": ("conv2d", "conv_f32_tc_kernel")}
# kernels whose main-path route must run on the tensor cores
TENSOR_CORE_KERNELS = ("conv2d", "flash_attention", "flash_attention_dkdv",
                       "flash_attention_dq", "fused_bottleneck",
                       "quantized_matmul", "fused_quantized_matmul")
# ... and on wgmma (HGMMA for bf16, IGMMA for int8); F32_WGMMA: the same
# of F32_ROUTES (the f32 conv, as 3xTF32)
WGMMA_KERNELS = ("conv2d", "conv2d_int8", "quantized_matmul")
F32_WGMMA = ("conv2d",)
# kernels whose warp shuffles must all take the fast path (the decode
# reduces each key row's scores across the warp, the fused int8 GEMM each
# row's absmax; the two-pass int8 GEMM has none, and keeps it so);
# F32_FAST_SHUFFLE: the same of F32_ROUTES (the f32 flash forward reduces
# each row's max over 8 lanes; the backward kernels vote on their causal
# skips)
FAST_SHUFFLE_KERNELS = ("paged_decode", "quantized_matmul",
                        "fused_quantized_matmul")
F32_FAST_SHUFFLE = ("flash_attention", "flash_attention_dkdv",
                    "flash_attention_dq")
# __global__ functions whose ptxas report must show no spills: the f32
# conv, the f32 flash backward and the two-pass int8 GEMM, redesigned to
# keep their sums in registers
NO_SPILL_FUNCTIONS = ("conv_f32_tc_kernel", "f3221flash_bwd_dkdv_kernel",
                      "f3219flash_bwd_dq_kernel", "10qmm_kernel")


def emit(obj):
    print(json.dumps(obj), flush=True)


def host_facts():
    """The host as this process sees it, read only: the CPU model
    (``/proc/cpuinfo``'s first processor: its model name, or where that
    reads ``unknown`` its vendor, family and model numbers), the CPUs it
    may run on (``os.sched_getaffinity``) and the 1, 5 and 15 minute
    load averages."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    model = fields.get("model name")
    if model in (None, "", "unknown") and "vendor_id" in fields:
        model = (f"{fields['vendor_id']} family {fields.get('cpu family')}"
                 f" model {fields.get('model')}")
    return {"cpu_model": model, "cpus": len(os.sched_getaffinity(0)),
            "loadavg": list(os.getloadavg())}


def staged(name, fn, *args):
    """``fn(*args)`` between two ``host`` lines: the host's facts at the
    phase's start and end, and at the end the phase's wall seconds and
    this process's CPU seconds (all threads) over it."""
    emit({"phase": "host", "at": "start", "of": name, **host_facts()})
    t0, c0 = time.perf_counter(), time.process_time()
    try:
        return fn(*args)
    finally:
        emit({"phase": "host", "at": "end", "of": name,
              "seconds": time.perf_counter() - t0,
              "cpu_seconds": time.process_time() - c0, **host_facts()})


def nvidia_smi_line():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else \
            f"nvidia-smi gave nothing (exit {r.returncode})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def ptxas_lines(report):
    """``function: Used ...`` and ``function: ... spill ...`` lines of an
    ``nvcc -Xptxas -v`` report, each named by its (mangled) function."""
    out, fn = [], "?"
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if ln.count("'") >= 2 else ln.strip()
        elif "Used" in ln:
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
        elif "spill" in ln:
            out.append(f"{fn}: {ln.strip()}")
    return out


def cuobjdump():
    """``cuobjdump`` of the CUDA toolkit that builds the kernels (or of
    Triton's package, which carries one)."""
    from zoo_tpu_torch.ops.kernels._build import find_nvcc
    cands = [os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if os.access(c, os.X_OK):
            return c
    raise AssertionError(f"cuobjdump not found (looked at {cands})")


def sass_functions(path):
    """{mangled function name: its SASS} of a built kernel library."""
    out = subprocess.run([cuobjdump(), "-sass", path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def mma_route(funcs, function):
    """How the instances of ``__global__ function`` multiply, read from
    their SASS: ``"wgmma"`` (HGMMA, or IGMMA for int8), ``"mma.sync"``
    (HMMA, IMMA) or
    ``"simt"``; with the instruction counts, the instances found and the
    ``WARPSYNC.COLLECTIVE`` count (the slow path of a warp shuffle or vote
    the compiler could not prove converged)."""
    key = f"{len(function)}{function}"          # as the name is mangled
    hit = [f for n, f in funcs.items() if key in n]
    if not hit:
        raise AssertionError(f"{function}: not in the library's SASS")
    counts = {op: sum(len(re.findall(rf"\b{op}\b", f)) for f in hit)
              for op in ("HGMMA", "IGMMA", "HMMA", "IMMA")}
    route = "wgmma" if counts["HGMMA"] or counts["IGMMA"] else \
        "mma.sync" if counts["HMMA"] or counts["IMMA"] else "simt"
    collective = sum(f.count("WARPSYNC.COLLECTIVE") for f in hit)
    return {"mma": route, "counts": counts, "instances": len(hit),
            "collective_syncs": collective}


def check_no_spills(built):
    """Raise unless each of :data:`NO_SPILL_FUNCTIONS` has instances in
    the ``-Xptxas -v`` reports and every one reports 0 bytes of spill
    stores and loads."""
    seen = set()
    for r in built.values():
        fn = None
        for ln in r.ptxas.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1] if ln.count("'") >= 2 else ln
            elif "spill" in ln and fn:
                for k in NO_SPILL_FUNCTIONS:
                    if k not in fn:
                        continue
                    seen.add(k)
                    if "0 bytes spill stores, 0 bytes spill loads" not in ln:
                        raise AssertionError(f"{fn} spills: {ln.strip()}")
    if seen != set(NO_SPILL_FUNCTIONS):
        raise AssertionError("no ptxas report of "
                             f"{set(NO_SPILL_FUNCTIONS) - seen}")


def phase_sass(built):
    """Each kernel's multiply route from the built libraries' SASS; fails
    unless the bf16 routes of conv2d and the flash forward and backward,
    the fused bottleneck and both int8 GEMMs run on the tensor cores,
    unless conv2d (bf16 and f32), conv2d_int8 and ``quantized_matmul``
    run on ``wgmma``, and unless the paged decode, both int8 GEMMs and
    the f32 flash forward and backward are free of
    ``WARPSYNC.COLLECTIVE`` (slow-path shuffles). The paged kernels, the
    optimizers and the f32 flash routes read ``simt``; the paged kernels
    and the f32 flash kernels by design: the f32 paths stay on f32 FMAs
    (one TF32 product would break their tolerance) and the decode does
    ~4 flops a cache element."""
    from concurrent.futures import ThreadPoolExecutor

    # one cuobjdump a library, all at once
    with ThreadPoolExecutor(max_workers=len(built)) as pool:
        sass = dict(zip(built, pool.map(sass_functions,
                                        [r.path for r in built.values()])))
    routes = {k: mma_route(sass[lib], fn)
              for k, (lib, fn) in MMA_FUNCTIONS.items()}
    f32 = {k: mma_route(sass[lib], fn) for k, (lib, fn) in
           F32_ROUTES.items()}
    emit({"phase": "sass", "kernels": routes, "f32_routes": f32})
    for k in TENSOR_CORE_KERNELS:
        if routes[k]["mma"] == "simt":
            raise AssertionError(f"{k}: its main-path route has no "
                                 "tensor-core instruction in its SASS")
    for k, route in [(k, routes[k]) for k in FAST_SHUFFLE_KERNELS] + \
            [(f"{k} (f32 route)", f32[k]) for k in F32_FAST_SHUFFLE]:
        if route["collective_syncs"]:
            raise AssertionError(f"{k}: {route['collective_syncs']} "
                                 "WARPSYNC.COLLECTIVE in its SASS")
    for k, route in [(k, routes[k]) for k in WGMMA_KERNELS] + \
            [(f"{k} (f32 route)", f32[k]) for k in F32_WGMMA]:
        if route["mma"] != "wgmma":
            raise AssertionError(f"{k}: reads {route['mma']}, not wgmma, in "
                                 f"its SASS ({route['counts']})")
    return routes, f32


def _profiled(torch, fn, iters, kernel):
    """One ``torch.profiler`` pass over ``iters`` calls: the device us of
    all events, of those whose name holds ``kernel``, ms per call by
    device and by host event name, device launches per call, and the
    launches per call of the events whose name holds ``kernel``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = only = 0.0
    launches = kernel_launches = 0
    by_name, host_by_name = {}, {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            host_by_name[e.key] = e.self_cpu_time_total / iters / 1e3
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us
        by_name[e.key] = by_name.get(e.key, 0.0) + us / iters / 1e3
        if kernel is not None and kernel in e.key:
            only += us
            kernel_launches += e.count
        if not e.key.startswith(("Memcpy", "Memset")):
            launches += e.count
    return (total, only, by_name, host_by_name, launches / iters,
            kernel_launches / iters)


def timed(torch, fn, iters, kernel=None, warmup=3, attempts=3):
    """Per call: ``device_ms``, the device time of everything ``fn``
    launches (torch.profiler's kernel, copy and memset events, summed);
    ``kernel_ms``, the part spent in kernels whose name holds
    ``kernel``; ``wall_ms``, CUDA-event time over back-to-back calls,
    which also counts the host's launch overhead when the host is the
    slower side; ``host_ms``, the host clock per call over the same calls
    until the last is issued (near ``wall_ms`` when the host is the
    slower side); ``by_name``, device ms per call of each event name;
    ``host_by_name``, host ms per call of each host event, its own time
    without its children's, under the profiler (which adds its own);
    ``device_busy_share``, ``device_ms`` over ``wall_ms``;
    ``device_launches``, the device kernels ``fn`` launches per call
    (copies and memsets not counted).

    The profiler now and then returns no device event at all on the
    card's machine, or drops some of a pass's kernel records (passes
    have read 0.2, 0.64 and 0.8 launches a call of a kernel that
    launches once, with device time short by as much, where the launch
    counters, the outputs and the CUDA-event times were right); a pass
    that records no device time, or, given ``kernel``, a part of a
    launch of it per call (records of it, but not a whole number a
    call), is repeated, up to ``attempts`` passes. If none passes,
    ``device_ms`` is CUDA-event time from just before to just after
    each call (an upper bound: it
    also holds the host's launch of the call when the device waits for
    it), ``device_source`` says ``cuda_events``, and ``kernel_ms``,
    ``by_name`` and ``device_busy_share`` are empty."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    for attempt in range(1, attempts + 1):
        total, only, by_name, host_by_name, launches, own = _profiled(
            torch, fn, iters, kernel)
        dropped = own > 0 and abs(own - round(own)) > 1e-9
        if total > 0 and not dropped:
            device = total / iters / 1e3
            return {"device_ms": device, "wall_ms": wall, "host_ms": host,
                    "kernel_ms": only / iters / 1e3 if kernel else None,
                    "by_name": by_name, "host_by_name": host_by_name,
                    "device_busy_share": device / wall,
                    "device_launches": launches,
                    "device_source": "profiler"}
        emit({"phase": "timing", "kernel": kernel, "attempt": attempt,
              "kernel_launches_per_call": own,
              "note": "torch.profiler recorded no device time" if not total
              else "torch.profiler dropped kernel records"})
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    device = sum(a.elapsed_time(b) for a, b in pairs) / iters
    return {"device_ms": device, "wall_ms": wall, "host_ms": host,
            "kernel_ms": None, "by_name": {}, "host_by_name": host_by_name,
            "device_busy_share": None, "device_launches": None,
            "device_source": "cuda_events"}


def timing(torch, kernel, fn, plain, library, iters):
    """The kernel wrapper's times beside its plain version's and, where
    one exists, the library call's (device time per call)."""
    t = timed(torch, fn, iters, kernel=kernel)
    return {"ms": t["device_ms"], "kernel_ms": t["kernel_ms"],
            "wall_ms": t["wall_ms"], "by_name": t["by_name"],
            "device_launches_per_call": t["device_launches"],
            "plain_ms": timed(torch, plain, max(3, iters // 5))["device_ms"],
            "library_ms": None if library is None else
            timed(torch, library, iters)["device_ms"]}


def timing_one_launch(torch, name, kernel, fn, plain, library, iters):
    """:func:`timing` of a wrapper that must make one device launch a
    call; fails when the profiler counts another number."""
    t = timing(torch, kernel, fn, plain, library, iters)
    n_dev = t["device_launches_per_call"]
    if n_dev not in (None, 1.0):
        raise AssertionError(f"{name}: {n_dev} device launches per call, "
                             "expected 1")
    return t


def bound(nbytes, flops, peak=PEAK_F32_FLOPS):
    """Least time (ms) for work that must move ``nbytes`` and do
    ``flops`` at ``peak`` flop/s (f32 by default), and which of the two
    sets it."""
    t_b = nbytes / PEAK_BYTES * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def rates(ops, ms, bound_ms, library_ms):
    """A timed call's rate (TFLOP/s or TOP/s), the share of its bound it
    reaches (bound ms over ms) and how many times the library call's
    time it takes (None without one)."""
    return {"tflops": ops / ms / 1e9, "bound_ratio": bound_ms / ms,
            "library_ratio": None if library_ms is None else
            ms / library_ms}


def phase_kernels(torch):
    """Each kernel against its plain version at the 8B path's shapes."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    from zoo_tpu_torch.ops.kernels import paged_decode as PD
    from zoo_tpu_torch.ops.kernels import paged_prefill as PP
    from zoo_tpu_torch.util.quantize import absmax_scale, narrow_int8

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    H, HKV, D, BS, NB, W, S = 32, 8, 128, 16, 128, 32, 8
    results = {}

    def record(kernel, case, err, dtype, magnitude=None):
        # ``magnitude``: the largest output, given where the tolerance
        # scales with it (see TOL)
        tol = TOL[dtype] * (max(1.0, magnitude) if magnitude is not None
                            and dtype in ("bfloat16", "conv_f32",
                                          "conv_bf16", "block",
                                          "block_grad") else 1.0)
        emit({"phase": "kernels", "kernel": kernel, "case": case,
              "max_abs_err": err, "tol": tol})
        if not err <= tol:
            raise AssertionError(f"{kernel} {case}: max abs err {err} "
                                 f"> {tol}")
        r = results.setdefault(kernel, {"max_abs_err": 0.0,
                                        "max_abs_err_by_dtype": {}})
        if dtype in ("float32", "update", "conv_f32", "conv_bf16", "int8",
                     "block"):
            r["max_abs_err"] = max(r["max_abs_err"], err)
        if magnitude is None or dtype != "bfloat16":   # not vs autograd
            by = r["max_abs_err_by_dtype"]
            by[dtype] = max(by.get(dtype, 0.0), err)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    # -- A: flash forward at the 512 bucket: B=1, H=32, Hkv=8, T=512 ----
    for dtype, causal, tq, tk in ((torch.float32, True, 512, 512),
                                  (torch.bfloat16, True, 512, 512),
                                  (torch.float32, False, 100, 300),
                                  (torch.float32, True, 77, 333)):
        q = randn(1, H, tq, D, dtype=dtype)
        k = randn(1, HKV, tk, D, dtype=dtype)
        v = randn(1, HKV, tk, D, dtype=dtype)
        o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        ro, rlse = FA.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        record("flash_attention", f"{name} causal={causal} Tq={tq} "
               f"Tk={tk}", err(o, ro), name)
        if dtype == torch.float32:
            record("flash_attention", f"lse causal={causal} Tq={tq}",
                   err(lse, rlse), name)
    q = randn(1, H, 512, D)
    k = randn(1, HKV, 512, D)
    v = randn(1, HKV, 512, D)
    pairs = 512 * 513 // 2
    b_ms, b_by = bound(4 * (2 * q.numel() + 2 * k.numel()) + 4 * H * 512,
                       4 * D * pairs * H)
    # the f32 route (SIMT body) at the 8B serving shape; the bf16 route
    # is timed at the training shape (phase_training_kernels)
    t = timing(torch, "flash_fwd_kernel",
               lambda: FA.flash_attention_fwd(q, k, v, True),
               lambda: FA.flash_attention_plain(q, k, v, True),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True), 50)
    results["flash_attention"]["f32_route"] = dict(
        t, bound_ms=b_ms, bound_by=b_by,
        shape=f"B=1 H={H} Hkv={HKV} T=512 D={D} f32 causal",
        plan=FA.flash_f32_plan(D, causal=True)._asdict(),
        **rates(4 * D * pairs * H, t["ms"], b_ms, t["library_ms"]))
    emit({"phase": "kernels", "kernel": "flash_attention",
          "timing_f32": results["flash_attention"]["f32_route"]})

    # -- paged caches: 128 blocks of 16 rows, 8 kv heads, f32/bf16/int8 --
    def cache(kind):
        kc, vc = randn(NB, BS, HKV, D), randn(NB, BS, HKV, D)
        if kind == "int8":
            ks, vs = absmax_scale(kc, dim=-1), absmax_scale(vc, dim=-1)
            return (narrow_int8(kc, ks[..., None]),
                    narrow_int8(vc, vs[..., None]), ks, vs)
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        return kc.to(dt), vc.to(dt), None, None

    tables = torch.stack([torch.randperm(NB - 1, generator=g, device=dev)
                          [:W] + 1 for _ in range(S)]).to(torch.int32)
    # position 0, both sides of a block boundary, the last position
    positions = torch.tensor([0, 15, 16, 511, 100, 255, 256, 37],
                             dtype=torch.int32, device=dev)

    def cache_bytes(c, rows):
        item = c[0].element_size()
        return 2 * rows * HKV * D * item + \
            (2 * rows * HKV * 4 if c[2] is not None else 0)

    # -- B: paged decode, S=8 slots x 32 heads, splits=4 ----------------
    for kind in ("f32", "bf16", "int8"):
        c = cache(kind)
        for qdt in ((torch.float32, torch.bfloat16) if kind == "bf16"
                    else (torch.float32,)):
            qd = randn(S, H, D, dtype=qdt)
            before = PD.LAUNCHES
            o = PD.paged_flash_decode(qd, c[0], c[1], tables, positions,
                                      k_scale=c[2], v_scale=c[3])
            if PD.LAUNCHES != before + 1:
                raise AssertionError("paged_decode: one call, "
                                     f"{PD.LAUNCHES - before} launches")
            ro = PD.paged_decode_plain(qd, c[0], c[1], tables, positions,
                                       k_scale=c[2], v_scale=c[3])
            torch.cuda.synchronize()
            name = str(qdt).split(".")[-1]
            record("paged_decode", f"q {name} cache {kind}", err(o, ro),
                   name)
        if kind == "f32":
            live = int((positions.long() + 1).sum())
            b_ms, b_by = bound(
                cache_bytes(c, live) + 2 * qd.numel() * 4
                + tables.numel() * 4 + S * 4, 4 * live * H * D)
            # the split merge runs in the kernel: one device launch a call
            t = timing_one_launch(
                torch, "paged_decode", "paged_decode_kernel",
                lambda: PD.paged_flash_decode(qd, c[0], c[1], tables,
                                              positions),
                lambda: PD.paged_decode_plain(qd, c[0], c[1], tables,
                                              positions), None, 100)
            plan = PD.decode_plan(S, HKV, H // HKV, D, BS, W, 4,
                                  PD.resolve_num_splits(W))
            results["paged_decode"].update(
                t, bound_ms=b_ms, bound_by=b_by,
                shape=f"S={S} H={H} Hkv={HKV} D={D} bs={BS} W={W} f32, "
                      f"{live} live rows",
                plan={"ctas": plan.ctas, "warps": plan.warps,
                      "stages": plan.stages, "chunk_rows": plan.chunk_rows,
                      "copy_bytes": plan.copy_bytes, "smem": plan.smem,
                      "blocks": plan.blocks},
                bound_ratio=b_ms / t["ms"])

    # -- C: paged prefill, one sequence x a 64-row chunk ----------------
    C = 64
    for kind in ("f32", "bf16", "int8"):
        c = cache(kind)
        for start in (0, 200, 448):      # block 0, mid-table, table end
            qp = randn(1, C, H, D)
            pos = (start + torch.arange(C, device=dev)).to(
                torch.int32)[None]
            o = PP.paged_flash_prefill(qp, c[0], c[1], tables[:1], pos,
                                       k_scale=c[2], v_scale=c[3])
            ro = PP.paged_prefill_plain(qp, c[0], c[1], tables[:1], pos,
                                        k_scale=c[2], v_scale=c[3])
            torch.cuda.synchronize()
            record("paged_prefill", f"cache {kind} start={start}",
                   err(o, ro), "float32")
        if kind == "f32":
            # a one-row chunk and a ragged 17-row one, three sequences
            for cs in (1, 17):
                qs = randn(3, cs, H, D)
                pos3 = (torch.tensor([0, 200, 512 - cs], device=dev)[:, None]
                        + torch.arange(cs, device=dev)[None]).to(torch.int32)
                o = PP.paged_flash_prefill(qs, c[0], c[1], tables[:3], pos3)
                ro = PP.paged_prefill_plain(qs, c[0], c[1], tables[:3], pos3)
                torch.cuda.synchronize()
                record("paged_prefill", f"cache f32 S=3 chunk={cs}",
                       err(o, ro), "float32")
            pos = (200 + torch.arange(C, device=dev)).to(torch.int32)[None]
            rows = int(pos.max()) + 1
            pairs = int((pos.long() + 1).sum())
            flops = 4 * pairs * H * D
            b_ms, b_by = bound(
                cache_bytes(c, rows) + 2 * qp.numel() * 4 + C * 4 + W * 4,
                flops)
            # "paged_prefill" names the kernel and its split merge
            t = timing(
                torch, "paged_prefill",
                lambda: PP.paged_flash_prefill(qp, c[0], c[1], tables[:1],
                                               pos),
                lambda: PP.paged_prefill_plain(qp, c[0], c[1], tables[:1],
                                               pos), None, 100)
            plan = PP.prefill_plan(1, C, HKV, H // HKV, D, BS, W, 4)
            results["paged_prefill"].update(
                t, bound_ms=b_ms, bound_by=b_by,
                shape=f"S=1 C={C} H={H} Hkv={HKV} D={D} f32 positions "
                      f"200-263",
                plan={"splits": plan.splits, "blocks": plan.blocks,
                      "smem": plan.smem},
                **rates(flops, t["ms"], b_ms, None))

    # -- C2: the speculative verify pass, 8 slots x k + 1 = 5 rows ------
    # per-slot starts across 200-263 and one slot whose rows run past
    # the 512-token context (clamped: they repeat position 511)
    CV = 5
    starts = torch.tensor([200, 209, 218, 227, 236, 245, 263, 509],
                          device=dev)
    pos_v = (starts[:, None] + torch.arange(CV, device=dev)[None]).clamp(
        max=W * BS - 1).to(torch.int32)
    qv = randn(S, CV, H, D)
    verify_err = 0.0
    for kind in ("f32", "int8"):
        c = cache(kind)
        o = PP.paged_flash_prefill(qv, c[0], c[1], tables, pos_v,
                                   k_scale=c[2], v_scale=c[3])
        ro = PP.paged_prefill_plain(qv, c[0], c[1], tables, pos_v,
                                    k_scale=c[2], v_scale=c[3])
        torch.cuda.synchronize()
        e = err(o, ro)
        verify_err = max(verify_err, e)
        record("paged_prefill", f"verify S={S} C={CV} cache {kind}", e,
               "float32")
        if kind == "f32":
            rows = int((pos_v.max(dim=1).values.long() + 1).sum())
            pairs = int((pos_v.long() + 1).sum())
            flops = 4 * pairs * H * D
            b_ms, b_by = bound(
                cache_bytes(c, rows) + 2 * qv.numel() * 4 + S * CV * 4
                + S * W * 4, flops)
            t = timing(
                torch, "paged_prefill",
                lambda: PP.paged_flash_prefill(qv, c[0], c[1], tables,
                                               pos_v),
                lambda: PP.paged_prefill_plain(qv, c[0], c[1], tables,
                                               pos_v), None, 100)
            plan = PP.prefill_plan(S, CV, HKV, H // HKV, D, BS, W, 4)
            verify_shape = dict(
                t, bound_ms=b_ms, bound_by=b_by,
                shape=f"S={S} C={CV} H={H} Hkv={HKV} D={D} f32, starts "
                      f"{starts.tolist()}, rows past 511 clamped",
                plan={"splits": plan.splits, "blocks": plan.blocks,
                      "smem": plan.smem},
                **rates(flops, t["ms"], b_ms, None))
    results["paged_prefill"]["verify_shape"] = dict(
        verify_shape, max_abs_err=verify_err)
    phase_training_kernels(torch, record, err, results)
    phase_inference_kernels(torch, record, err, results)
    phase_block_kernels(torch, record, err, results)
    phase_dropout_kernels(torch, record, results)
    # conv2d and the flash kernels: the line's numbers are the bf16
    # route's, the f32 route's sit under f32_route
    for k, bf, f32 in (("flash_attention", "bfloat16", "float32"),
                       ("flash_attention_dkdv", "bfloat16", "float32"),
                       ("flash_attention_dq", "bfloat16", "float32"),
                       ("conv2d", "conv_bf16", "conv_f32")):
        by = results[k]["max_abs_err_by_dtype"]
        results[k]["max_abs_err"] = by[bf]
        results[k]["f32_route"]["max_abs_err"] = by[f32]
    for name, r in results.items():
        emit({"phase": "kernels", "kernel": name, "timing": r})
    return results


def _train_leaf_shapes():
    """The training config's 12 parameter leaves (embed, head,
    final_norm and the nine stacked block leaves)."""
    c = TRAIN_CFG
    h, L, kv = c["hidden"], c["n_block"], c["n_kv_head"] * (
        c["hidden"] // c["n_head"])
    return [(c["vocab"], h), (h, c["vocab"]), (h,), (L, h, h), (L, h, kv),
            (L, h, kv), (L, h, h), (L, h), (L, h),
            (L, h, c["intermediate"]), (L, h, c["intermediate"]),
            (L, c["intermediate"], h)]


def _bwd_timing(torch, FA, q, k, v, o, lse, do, causal=True):
    """The two backward kernels timed in one ``flash_attention_bwd``
    call, each beside its plain version, its bound (bf16 at the
    tensor cores' peak, f32 at the SIMT peak) and SDPA's backward (all
    three gradients, one call; the same for both), with its TFLOP/s,
    share of its bound and factor over SDPA's backward."""
    import torch.nn.functional as F
    B, H, S, D = q.shape
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    item = q.element_size()
    qb, kb = q.numel() * item, k.numel() * item
    stats = 2 * B * H * S * 4                      # lse + delta, f32
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    delta = (do.float() * o.float()).sum(-1)
    t = timed(torch, lambda: FA.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal), 10)
    lq, lk, ls = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    lo = F.scaled_dot_product_attention(lq, lk, ls, is_causal=causal,
                                        enable_gqa=True)
    lib = timed(torch, lambda: torch.autograd.grad(
        lo, (lq, lk, ls), do, retain_graph=True), 10)["device_ms"]
    tc = q.dtype == torch.bfloat16
    out = {}
    for kernel, name, plain, nbytes, flops in (
            ("flash_attention_dkdv",
             "flash_bwd_dkdv_tc_kernel" if tc else "flash_bwd_dkdv_kernel",
             lambda: FA.flash_attention_dkdv_plain(q, k, v, do, lse, delta,
                                                   causal),
             2 * qb + 2 * kb + stats + 2 * kb, 8 * D * pairs),
            ("flash_attention_dq",
             "flash_bwd_dq_tc_kernel" if tc else "flash_bwd_dq_kernel",
             lambda: FA.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                 causal),
             2 * qb + 2 * kb + stats + qb, 6 * D * pairs)):
        ms = sum(v_ for n, v_ in t["by_name"].items() if name in n)
        if not ms > 0:
            raise AssertionError(f"{name}: no device time recorded "
                                 f"({t['device_source']})")
        b_ms, b_by = bound(nbytes, flops, peak)
        out[kernel] = dict(
            ms=ms, wall_ms=t["wall_ms"], kernel_ms=ms,
            plain_ms=timed(torch, plain, 3)["device_ms"], library_ms=lib,
            bound_ms=b_ms, bound_by=b_by, **rates(flops, ms, b_ms, lib))
    return out


def _bert_flash_kernels(torch, FA, randn, record, err, results):
    """The bf16 flash kernels at BERT's run (b) shape (``BERT_B``,
    H = Hkv = 12, S=512, D=64, NON-causal): forward (o, lse) and backward
    against their plain versions and the gradients against autograd of
    the dense path, then timed beside their bounds and the non-causal
    SDPA (into ``results[kernel]["bert_shape"]``)."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.attention import dense_attention
    B, H, S, D = BERT_B, BERT_CFG["n_head"], BERT_S, 64
    bf = torch.bfloat16
    q, k, v, do = (randn(B, H, S, D, dtype=bf) for _ in range(4))
    shape = f"bfloat16 causal=False B={B} H={H} Hkv={H} T={S} D={D}"
    o, lse = FA.flash_attention_fwd(q, k, v, causal=False)
    ro, rlse = FA.flash_attention_plain(q, k, v, False)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, False)
    torch.cuda.synchronize()
    record("flash_attention", "o " + shape, err(o, ro), "bfloat16")
    record("flash_attention", "lse " + shape, err(lse, rlse), "bfloat16")
    for i, part in enumerate(("dq", "dk", "dv")):
        kernel = "flash_attention_dq" if part == "dq" else \
            "flash_attention_dkdv"
        record(kernel, f"{part} {shape}", err(got[i], plain[i]), "bfloat16")
    del ro, rlse, plain
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    dense = torch.autograd.grad(dense_attention(*leaves)[0], leaves,
                                do.float())
    torch.cuda.synchronize()
    for i, part in enumerate(("dq", "dk", "dv")):
        kernel = "flash_attention_dq" if part == "dq" else \
            "flash_attention_dkdv"
        record(kernel, f"{part} {shape} vs dense autograd",
               err(got[i], dense[i]), "bfloat16",
               float(dense[i].abs().max()))
    del got, leaves, dense
    torch.cuda.empty_cache()
    pairs = B * H * S * S
    qb = q.numel() * 2
    b_ms, b_by = bound(4 * qb + B * H * S * 4, 4 * D * pairs,
                       PEAK_BF16_FLOPS)
    t = timing(torch, "flash_fwd_tc_kernel",
               lambda: FA.flash_attention_fwd(q, k, v, False),
               lambda: FA.flash_attention_plain(q, k, v, False),
               lambda: F.scaled_dot_product_attention(q, k, v), 10)
    label = f"B={B} H={H} Hkv={H} T={S} D={D} bf16 non-causal"
    results["flash_attention"]["bert_shape"] = dict(
        t, bound_ms=b_ms, bound_by=b_by, shape=label,
        **rates(4 * D * pairs, t["ms"], b_ms, t["library_ms"]))
    for kernel, tb in _bwd_timing(torch, FA, q, k, v, o, lse, do,
                                  causal=False).items():
        results[kernel]["bert_shape"] = dict(tb, shape=label)
    for kernel in ("flash_attention", "flash_attention_dkdv",
                   "flash_attention_dq"):
        emit({"phase": "kernels", "kernel": kernel, "bert_shape": {
            key: results[kernel]["bert_shape"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "tflops", "bound_ratio", "library_ratio", "shape")}})
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()


def _long_flash_kernels(torch, FA, randn, record, err, results):
    """The bf16 causal flash kernels at LONG_FLASH_SHAPES (T = 4096):
    forward (o, lse), dK/dV and dQ against their plain versions (the
    gradients to the bf16 tolerance times their largest magnitude, as
    the dense-autograd witnesses above), then timed beside their bounds
    and SDPA's (into ``results[kernel][label]``). The plain backward
    forms (B, Hkv, rep, T, T) f32 tensors (4-13 GB), freed after each
    shape."""
    import torch.nn.functional as F
    bf = torch.bfloat16
    for label, (B, H, HKV, T, D) in LONG_FLASH_SHAPES:
        q, do = randn(B, H, T, D, dtype=bf), randn(B, H, T, D, dtype=bf)
        k, v = randn(B, HKV, T, D, dtype=bf), randn(B, HKV, T, D, dtype=bf)
        shape = f"bfloat16 causal=True B={B} H={H} Hkv={HKV} T={T} D={D}"
        o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
        ro, rlse = FA.flash_attention_plain(q, k, v, True)
        torch.cuda.synchronize()
        record("flash_attention", "o " + shape, err(o, ro), "bfloat16")
        record("flash_attention", "lse " + shape, err(lse, rlse),
               "bfloat16")
        del ro, rlse
        torch.cuda.empty_cache()
        got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        for i, part in enumerate(("dq", "dk", "dv")):
            kernel = "flash_attention_dq" if part == "dq" else \
                "flash_attention_dkdv"
            record(kernel, f"{part} {shape}", err(got[i], plain[i]),
                   "bfloat16", float(plain[i].abs().max()))
        del got, plain
        torch.cuda.empty_cache()
        pairs = B * H * T * (T + 1) // 2
        qb, kb = q.numel() * 2, k.numel() * 2
        b_ms, b_by = bound(2 * qb + 2 * kb + B * H * T * 4, 4 * D * pairs,
                           PEAK_BF16_FLOPS)
        t = timing(torch, "flash_fwd_tc_kernel",
                   lambda: FA.flash_attention_fwd(q, k, v, True),
                   lambda: FA.flash_attention_plain(q, k, v, True),
                   lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True, enable_gqa=True), 10)
        name = f"B={B} H={H} Hkv={HKV} T={T} D={D} bf16 causal"
        keep = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "tflops", "bound_ratio", "library_ratio", "shape")
        results["flash_attention"][label] = {
            key: val for key, val in dict(
                t, bound_ms=b_ms, bound_by=b_by, shape=name,
                **rates(4 * D * pairs, t["ms"], b_ms,
                        t["library_ms"])).items() if key in keep}
        torch.cuda.empty_cache()
        for kernel, tb in _bwd_timing(torch, FA, q, k, v, o, lse,
                                      do).items():
            results[kernel][label] = {key: val for key, val in dict(
                tb, shape=name).items() if key in keep}
        for kernel in ("flash_attention", "flash_attention_dkdv",
                       "flash_attention_dq"):
            emit({"phase": "kernels", "kernel": kernel,
                  label: results[kernel][label]})
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def _check_embedding_determinism(torch):
    """The gradient of the port's ``Embedding`` gather (``take_rows``,
    whose backward sums the rows of repeated ids) at NCF's shape, B=8192
    ids into the 6040 x 64 user table, twice on the same inputs: must
    repeat bit for bit, beside ``index_add_`` (atomic adds), a control
    whose order may change from run to run."""
    from zoo_tpu_torch.pipeline.api.keras.layers.core import take_rows
    g = torch.Generator(device="cuda").manual_seed(55)
    rows, dim, b = NCF_CFG["user_count"], NCF_CFG["user_embed"], NCF_B
    table = torch.randn(rows, dim, generator=g, device="cuda")
    ids = torch.randint(0, rows, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    dy = torch.randn(b, dim, generator=g, device="cuda")

    def grad():
        e = table.clone().requires_grad_()
        return torch.autograd.grad(take_rows(e, ids), e, dy)[0]

    def control():
        return torch.zeros_like(table).index_add_(0, ids.long(), dy)

    same = {}
    for label, fn in (("take_rows", grad), ("index_add_control", control)):
        a, b2 = fn(), fn()
        torch.cuda.synchronize()
        same[label] = bool(torch.equal(a, b2))
    emit({"phase": "kernels", "check": "embedding_grad_repeat",
          "shape": f"{b} ids into {rows} x {dim}", "bit_equal": same})
    if not same["take_rows"]:
        raise AssertionError("Embedding's gradient: a second run on the "
                             "same inputs gave other bits")


def _check_reference_conv_grads(torch, record, err):
    """The reference conv's gradients (f32, 3x3 stride 2, as ResNet-50's
    3x3/s2 convs take them) with cuDNN's TF32 switched on equal those
    with it off: its backward turns TF32 off itself. Beside them, the
    error autograd of the same ``F.conv2d`` takes under TF32 (what the
    backward was before it did), for scale only."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.kernels import conv as CV
    g = torch.Generator(device="cuda").manual_seed(99)
    x = torch.randn(32, 28, 28, 256, generator=g, device="cuda")
    w = torch.randn(3, 3, 256, 256, generator=g, device="cuda") * 0.05
    dy = torch.randn(32, 14, 14, 256, generator=g, device="cuda")
    flag = torch.backends.cudnn.allow_tf32

    def grads(tf32, plain=True):
        torch.backends.cudnn.allow_tf32 = tf32
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        if plain:
            y = CV.conv2d_plain(xs, ws, (2, 2), "SAME")
        else:   # autograd of F.conv2d, as SAME pads 28 -> 14 at stride 2
            y = F.conv2d(F.pad(xs.permute(0, 3, 1, 2), (0, 1, 0, 1)),
                         ws.permute(3, 2, 0, 1), stride=2).permute(
                             0, 2, 3, 1)
        return torch.autograd.grad(y, (xs, ws), dy)

    try:
        off, on = grads(False), grads(True)
        tf32 = grads(True, plain=False)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    for name, a, b, c in zip(("dx", "dw"), on, off, tf32):
        mag = float(b.abs().max())
        emit({"phase": "kernels", "check": "reference_conv_grads",
              "grad": name, "tf32_on_vs_off": err(a, b),
              "autograd_under_tf32_vs_off": err(c, b), "magnitude": mag})
        record("conv2d_reference", f"{name} f32 3x3/s2, TF32 on vs off",
               err(a, b) / mag, "conv_f32")


@contextlib.contextmanager
def cudnn_deterministic(torch, value):
    """Every ``torch.backends.cudnn.flags`` entry made with
    ``deterministic=value``, whatever its caller asks: with False, the
    control, the reference conv's backward as it was before it asked
    cuDNN for deterministic algorithms."""
    cudnn = torch.backends.cudnn
    real = cudnn.flags

    def flags(**kw):
        return real(**dict(kw, deterministic=value))

    cudnn.flags = flags
    try:
        yield
    finally:
        cudnn.flags = real


def _check_reference_conv_determinism(torch):
    """``conv2d_plain_grads`` (the float conv's backward on both the
    kernel path and the plain path) run twice on the same inputs at the
    timed ResNet-50 shapes, B=128, f32 and bf16: as shipped, its ``dx``
    and ``dw`` must repeat bit for bit; under the control
    (:func:`cudnn_deterministic` False) whether they do is printed."""
    from zoo_tpu_torch.ops.kernels import conv as CV
    g = torch.Generator(device="cuda").manual_seed(77)
    B = INFER_B
    seen = {"reference": [], "control": []}
    for h, c, k, o, s in CONV_SHAPES:
        oh = -(-h // s)
        shape = f"{h}x{h} {c}->{o} {k}x{k} stride {s}"
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(B, h, h, c, generator=g, device="cuda").to(dt)
            w = (torch.randn(k, k, c, o, generator=g, device="cuda")
                 / math.sqrt(k * k * c)).to(dt)
            dy = torch.randn(B, oh, oh, o, generator=g, device="cuda").to(dt)
            for label, ctx in (("reference", contextlib.nullcontext),
                               ("control", lambda: cudnn_deterministic(
                                   torch, False))):
                with ctx():
                    a = CV.conv2d_plain_grads(x, w, dy, (s, s))
                    b = CV.conv2d_plain_grads(x, w, dy, (s, s))
                torch.cuda.synchronize()
                same = {n: bool(torch.equal(p, q))
                        for n, p, q in zip(("dx", "dw"), a, b)}
                seen[label].append(all(same.values()))
                emit({"phase": "kernels", "check": "reference_conv_repeat",
                      "path": label, "shape": f"B={B} {shape}",
                      "dtype": str(dt).split(".")[-1], "bit_equal": same,
                      "max_abs_diff": {n: float((p.float() - q.float())
                                                .abs().max())
                                       for n, p, q in zip(("dx", "dw"),
                                                          a, b)}})
            del x, w, dy, a, b
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "check": "reference_conv_repeat",
          "repeats": {k: f"{sum(v)}/{len(v)}" for k, v in seen.items()}})
    if not all(seen["reference"]):
        raise AssertionError("conv2d_plain_grads: a second run on the "
                             "same inputs gave other bits")


def phase_training_kernels(torch, record, err, results):
    """The flash backward and fused optimizer kernels against their
    plain versions, then timed at the training config's shapes (into
    ``results``, per kernel)."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.attention import dense_attention
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    from zoo_tpu_torch.ops.kernels import fused_optim as FO

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            dtype)

    H, HKV, D = TRAIN_CFG["n_head"], TRAIN_CFG["n_kv_head"], 64

    # -- D: flash backward at B=8 of the training shapes ------------------
    for dtype, causal, tq, tk in ((torch.float32, True, 512, 512),
                                  (torch.bfloat16, True, 512, 512),
                                  (torch.float32, False, 512, 512),
                                  (torch.bfloat16, False, 512, 512),
                                  (torch.float32, True, 77, 333)):
        q, do = randn(8, H, tq, D, dtype=dtype), randn(8, H, tq, D,
                                                       dtype=dtype)
        k, v = randn(8, HKV, tk, D, dtype=dtype), randn(8, HKV, tk, D,
                                                        dtype=dtype)
        o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        ro, rlse = FA.flash_attention_plain(q, k, v, causal=causal)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        # third witness: autograd of the dense path, in f32 from the same
        # (possibly bf16) inputs
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        dense = torch.autograd.grad(
            dense_attention(*leaves, causal=causal)[0], leaves, do.float())
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        shape = f"{name} causal={causal} Tq={tq} Tk={tk} D={D}"
        record("flash_attention", "o " + shape, err(o, ro), name)
        record("flash_attention", "lse " + shape, err(lse, rlse), name)
        for i, part in enumerate(("dq", "dk", "dv")):
            kernel = "flash_attention_dq" if part == "dq" else \
                "flash_attention_dkdv"
            case = f"{part} {name} causal={causal} Tq={tq} Tk={tk}"
            record(kernel, case, err(got[i], plain[i]), name)
            record(kernel, case + " vs dense autograd",
                   err(got[i], dense[i]), name,
                   float(dense[i].abs().max()))
        del leaves, dense, ro, rlse

    # timed at the main path's shape: B=64, bf16, causal
    B, S = TRAIN_B, TRAIN_S
    q, do = randn(B, H, S, D, dtype=torch.bfloat16), \
        randn(B, H, S, D, dtype=torch.bfloat16)
    k, v = randn(B, HKV, S, D, dtype=torch.bfloat16), \
        randn(B, HKV, S, D, dtype=torch.bfloat16)
    pairs = B * H * S * (S + 1) // 2
    qb, kb = q.numel() * 2, k.numel() * 2          # bf16 bytes
    # the forward at the training shape, beside the serving one
    b_ms, b_by = bound(2 * qb + 2 * kb + B * H * S * 4, 4 * D * pairs,
                       PEAK_BF16_FLOPS)
    t = timing(torch, "flash_fwd_tc_kernel",
               lambda: FA.flash_attention_fwd(q, k, v, True),
               lambda: FA.flash_attention_plain(q, k, v, True),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True), 10)
    results["flash_attention"].update(
        t, bound_ms=b_ms, bound_by=b_by,
        shape=f"B={B} H={H} Hkv={HKV} T={S} D={D} bf16 causal",
        **rates(4 * D * pairs, t["ms"], b_ms, t["library_ms"]))
    emit({"phase": "kernels", "kernel": "flash_attention", "summed": {
        k: results["flash_attention"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "tflops",
            "bound_ratio", "library_ratio", "shape")}})
    o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = FA.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    shape = f"bfloat16 causal=True Tq={S} Tk={S} D={D} B={B}"
    record("flash_attention", "o " + shape, err(o, ro), "bfloat16")
    record("flash_attention", "lse " + shape, err(lse, rlse), "bfloat16")
    # the backward at the training shape against its plain version and
    # autograd of the dense path, as the B=8 cases
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    for i, part in enumerate(("dq", "dk", "dv")):
        kernel = "flash_attention_dq" if part == "dq" else \
            "flash_attention_dkdv"
        record(kernel, f"{part} {shape}", err(got[i], plain[i]), "bfloat16")
    del ro, rlse, plain
    torch.cuda.empty_cache()
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    dense = torch.autograd.grad(
        dense_attention(*leaves, causal=True)[0], leaves, do.float())
    torch.cuda.synchronize()
    for i, part in enumerate(("dq", "dk", "dv")):
        kernel = "flash_attention_dq" if part == "dq" else \
            "flash_attention_dkdv"
        record(kernel, f"{part} {shape} vs dense autograd",
               err(got[i], dense[i]), "bfloat16",
               float(dense[i].abs().max()))
    del got, leaves, dense
    torch.cuda.empty_cache()
    # the bf16 (tensor-core) route at the main path's shape
    for kernel, t in _bwd_timing(torch, FA, q, k, v, o, lse, do).items():
        results[kernel].update(
            t, shape=f"B={B} H={H} Hkv={HKV} T={S} D={D} bf16 causal")
        emit({"phase": "kernels", "kernel": kernel, "summed": {
            key: results[kernel][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "tflops",
                "bound_ratio", "library_ratio", "shape")}})
    # the f32 route at the main path's shape too (the default float32
    # policy's), on f32 inputs: forward and backward against their plain
    # versions, then timed
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    qf, dof = randn(B, H, S, D), randn(B, H, S, D)
    kf, vf = randn(B, HKV, S, D), randn(B, HKV, S, D)
    of, lsef = FA.flash_attention_fwd(qf, kf, vf, causal=True)
    ro, rlse = FA.flash_attention_plain(qf, kf, vf, True)
    torch.cuda.synchronize()
    shape = f"float32 causal=True Tq={S} Tk={S} D={D} B={B}"
    record("flash_attention", "o " + shape, err(of, ro), "float32")
    record("flash_attention", "lse " + shape, err(lsef, rlse), "float32")
    del ro, rlse
    torch.cuda.empty_cache()
    got = FA.flash_attention_bwd(qf, kf, vf, of, lsef, dof, causal=True)
    plain = FA.flash_attention_bwd_plain(qf, kf, vf, of, lsef, dof, True)
    torch.cuda.synchronize()
    for i, part in enumerate(("dq", "dk", "dv")):
        kernel = "flash_attention_dq" if part == "dq" else \
            "flash_attention_dkdv"
        record(kernel, f"{part} {shape}", err(got[i], plain[i]), "float32")
    del got, plain
    torch.cuda.empty_cache()
    b64 = _bwd_timing(torch, FA, qf, kf, vf, of, lsef, dof)
    del qf, kf, vf, dof, of, lsef
    torch.cuda.empty_cache()
    # ... and at B=8, where earlier PRs timed it: the kernels line's
    # f32_route
    B8 = 8
    q, do = randn(B8, H, S, D), randn(B8, H, S, D)
    k, v = randn(B8, HKV, S, D), randn(B8, HKV, S, D)
    o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "tflops", "bound_ratio", "library_ratio")
    for kernel, t in _bwd_timing(torch, FA, q, k, v, o, lse, do).items():
        results[kernel]["f32_route"] = dict(
            t, shape=f"B={B8} H={H} Hkv={HKV} T={S} D={D} f32 causal",
            b64=dict({key: b64[kernel][key] for key in keys},
                     shape=f"B={B} H={H} Hkv={HKV} T={S} D={D} f32 "
                           "causal"))
    for b, by in ((B8, {k_: results[k_]["f32_route"] for k_ in b64}),
                  (B, b64)):
        ms = sum(t["ms"] for t in by.values())
        lib = by["flash_attention_dq"]["library_ms"]
        emit({"phase": "kernels", "kernel": "flash_attention_bwd",
              "f32_summed": {"batch": b, "ms": ms, "library_ms": lib,
                             "library_ratio": ms / lib,
                             "bound_ms": sum(t["bound_ms"]
                                             for t in by.values()),
                             **{k_: t["ms"] for k_, t in by.items()}}})
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    _bert_flash_kernels(torch, FA, randn, record, err, results)
    _long_flash_kernels(torch, FA, randn, record, err, results)
    _check_embedding_determinism(torch)
    _check_reference_conv_grads(torch, record, err)
    _check_reference_conv_determinism(torch)

    # -- E: fused AdamW and SGD ------------------------------------------
    # every input at a scale where one step moves each output (p, m, v,
    # the momentum buffer) by far more than the tolerance, so a store
    # that is missing or misplaced cannot pass. The per-step scalars are
    # device tensors (the 1-based step; SGD's rate as a decayed schedule
    # makes it), and ``ok`` the guard's device predicate: true, the
    # kernel equals its plain version; false (the gradient NaN-poisoned),
    # every operand keeps its bits in both.
    dev_scalar = dict(device=dev)
    for n, offset in ((768 * 2048, 0), (1_000_003, 0), (4099, 1)):
        def leaf(scale, positive=False):
            x = randn(n + offset, scale=scale)
            return (x.abs() if positive else x)[offset:]
        p, grad, buf = leaf(0.05), leaf(0.1), leaf(1e-2)
        m, v = leaf(1e-2), leaf(1e-2, positive=True)
        bad = grad.clone()
        bad[::5] = float("nan")
        lr_dev = torch.full((), 0.01, dtype=torch.float32, **dev_scalar)
        for step in (1, 10):
            t = torch.full((), step, dtype=torch.int32, **dev_scalar)
            for ok in (None, True, False):
                flag = None if ok is None else torch.full(
                    (), ok, dtype=torch.bool, **dev_scalar)
                g_in = bad if ok is False else grad
                for kernel, names, ins, want, got in (
                        ("fused_adam", ("p", "m", "v"), (p, m, v),
                         FO.reference_apply_adam(p, g_in, m, v, t, 1e-4,
                                                 weight_decay=0.01, ok=flag),
                         FO.fused_apply_adam(p.clone(), g_in, m.clone(),
                                             v.clone(), t, 1e-4,
                                             weight_decay=0.01, ok=flag)),
                        ("fused_sgd", ("p", "momentum_buf"), (p, buf),
                         FO.reference_apply_sgd(p, g_in, buf, lr_dev, 0.9,
                                                0.01, ok=flag),
                         FO.fused_apply_sgd(p.clone(), g_in, buf.clone(),
                                            lr_dev, 0.9, 0.01, ok=flag))):
                    torch.cuda.synchronize()
                    for out, x, a, b in zip(names, ins, got, want):
                        case = (f"{out} n={n} offset={offset} step={step} "
                                f"ok={ok}")
                        if ok is False:
                            if not (torch.equal(a, x) and torch.equal(b, x)):
                                raise AssertionError(
                                    f"{kernel} {case}: a skipped step "
                                    "changed the operand")
                            record(kernel, case + " (bit-unchanged)", 0.0,
                                   "update")
                            continue
                        moved = err(b, x)
                        if not moved > 10 * TOL["update"]:
                            raise AssertionError(
                                f"{kernel} {case}: the step moves it by "
                                f"only {moved}")
                        record(kernel, case, err(a, b), "update")
        del p, grad, buf, m, v, bad

    # the kernel's bias corrections from the device step, steps 1 to
    # 100000, against the host function, bit for bit
    import numpy as np
    steps = np.arange(1, 100001, dtype=np.int32)
    for b1, b2 in ((0.9, 0.999), (0.9, 0.98)):
        got = FO.adam_bias_corrections(
            torch.from_numpy(steps).to(dev), b1, b2).cpu().numpy()
        want = np.array([FO.bias_corrections(int(s), b1, b2)
                         for s in steps], np.float32)
        unequal = int((got != want).sum())
        emit({"phase": "kernels", "kernel": "fused_adam",
              "bias_corrections": {"steps": [1, 100000], "betas": [b1, b2],
                                   "unequal": unequal}})
        if unequal:
            raise AssertionError(f"fused_adam: {unequal} device bias "
                                 f"corrections differ from the host's "
                                 f"(betas {b1}, {b2})")
        record("fused_adam", f"bias corrections betas=({b1}, {b2}) steps "
               "1-100000", 0.0, "update")

    # timed over one training step's 12 leaves, as the guarded step
    # launches them: the device step, ok, (SGD) a device rate
    shapes = _train_leaf_shapes()
    numel = sum(math.prod(s) for s in shapes)
    ps = [randn(*s, scale=0.05) for s in shapes]
    gs = [randn(*s, scale=1e-3) for s in shapes]
    ms_ = [torch.zeros_like(x) for x in ps]
    vs_ = [torch.zeros_like(x) for x in ps]
    t10 = torch.full((), 10, dtype=torch.int32, device=dev)
    ok_t = torch.ones((), dtype=torch.bool, device=dev)
    lr_t = torch.full((), 1e-4, dtype=torch.float32, device=dev)

    def adam():
        for a, b, c, d in zip(ps, gs, ms_, vs_):
            FO.fused_apply_adam(a, b, c, d, t10, 1e-4, weight_decay=0.01,
                                ok=ok_t)

    def adam_plain():
        for a, b, c, d in zip(ps, gs, ms_, vs_):
            FO.reference_apply_adam(a, b, c, d, t10, 1e-4,
                                    weight_decay=0.01, ok=ok_t)

    def sgd():
        for a, b, c in zip(ps, gs, ms_):
            FO.fused_apply_sgd(a, b, c, lr_t, 0.9, 0.01, ok=ok_t)

    def sgd_plain():
        for a, b, c in zip(ps, gs, ms_):
            FO.reference_apply_sgd(a, b, c, lr_t, 0.9, 0.01, ok=ok_t)

    for x, gx in zip(ps, gs):
        x.grad = gx
    lib = {}
    for label, cls, kw in (("fused_adam", torch.optim.AdamW,
                            dict(lr=1e-4, weight_decay=0.01)),
                           ("fused_sgd", torch.optim.SGD,
                            dict(lr=1e-4, momentum=0.9, weight_decay=0.01))):
        try:   # a yardstick only: a torch without the fused op gives None
            opt = cls(ps, fused=True, **kw)
        except (RuntimeError, TypeError, ValueError) as e:
            emit({"phase": "kernels", "kernel": label,
                  "library": f"torch.optim fused unavailable: {e!r}"})
            lib[label] = None
            continue
        lib[label] = timed(torch, opt.step, 10)["device_ms"]
        del opt
    for kernel, fn, plain, per_elem in (("fused_adam", adam, adam_plain, 28),
                                        ("fused_sgd", sgd, sgd_plain, 20)):
        b_ms, b_by = bound(per_elem * numel, 0)
        t = timed(torch, fn, 10)
        results[kernel].update(
            ms=t["device_ms"], wall_ms=t["wall_ms"], kernel_ms=None,
            plain_ms=timed(torch, plain, 3)["device_ms"],
            library_ms=lib[kernel], bound_ms=b_ms, bound_by=b_by,
            leaves=len(shapes), elements=numel,
            interface="device step, device ok" + (
                ", device lr" if kernel == "fused_sgd" else ""))
        emit({"phase": "kernels", "kernel": kernel, "summed": {
            k: results[kernel][k] for k in (
                "ms", "wall_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "leaves", "elements", "interface")}})
    del ps, gs, ms_, vs_
    torch.cuda.empty_cache()


def _sum_timing(per):
    """One kernel's timings summed over the shapes it was timed at (one
    call at each); ``bound_by`` is that of the shape with the largest
    bound."""
    lib = [t["library_ms"] for t in per]
    return {"ms": sum(t["ms"] for t in per),
            "kernel_ms": sum(t["kernel_ms"] or 0.0 for t in per),
            "wall_ms": sum(t["wall_ms"] for t in per),
            "plain_ms": sum(t["plain_ms"] for t in per),
            "library_ms": None if None in lib else sum(lib),
            "bound_ms": sum(t["bound_ms"] for t in per),
            "bound_by": max(per, key=lambda t: t["bound_ms"])["bound_by"],
            "shapes": per}


def qmm_timing(torch, Q, xq, wq, xs, ws, library):
    """``quantized_matmul`` timed at the main path's output type (bf16),
    one device launch a call, beside its plain version, its bound and
    ``library`` (``torch._int_mm`` + dequant, or None)."""
    (m, k), n = xq.shape, wq.shape[1]
    ops = 2 * m * k * n
    b_ms, b_by = bound(m * k + k * n + 4 * (m + n) + 2 * m * n, ops,
                       PEAK_INT8_OPS)
    bf16 = torch.bfloat16
    t = timing_one_launch(
        torch, f"quantized_matmul M={m} K={k} N={n}", "::qmm_kernel",
        lambda: Q.quantized_matmul(xq, wq, xs, ws, bf16),
        lambda: Q.quantized_matmul_plain(xq, wq, xs, ws, bf16), library, 50)
    return dict(t, shape=f"M={m} K={k} N={n} bf16 out", bound_ms=b_ms,
                bound_by=b_by, **rates(ops, t["ms"], b_ms, t["library_ms"]))


def phase_inference_kernels(torch, record, err, results):
    """The implicit-GEMM conv kernels (f32, bf16, int8) at ResNet-50's
    shapes and the int8 GEMMs at the head's and ``bench_int8_matmul``'s,
    each against its plain version, then timed (into ``results``)."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.kernels import conv as CV
    from zoo_tpu_torch.ops.kernels import quant as Q

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def scales(n):
        return torch.rand(n, generator=g, device=dev) * 1e-2 + 1e-3

    B = INFER_B
    per = {k: [] for k in ("conv2d", "conv2d_f32", "conv2d_int8",
                           "quantized_matmul", "fused_quantized_matmul")}
    for h, c, k, o, s in CONV_SHAPES:
        oh = -(-h // s)
        shape = f"{h}x{h} {c}->{o} {k}x{k} stride {s}"
        x32, w32 = randn(8, h, h, c, dtype=torch.float32), \
            randn(k, k, c, o, dtype=torch.float32)
        y = CV.implicit_gemm_conv2d(x32, w32, (s, s))
        ref = CV.conv2d_plain(x32, w32, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"f32 B=8 {shape}", err(y, ref), "conv_f32",
               float(ref.abs().max()))
        x, w = randn(B, h, h, c), randn(k, k, c, o)
        y, ref = CV.implicit_gemm_conv2d(x, w, (s, s)), \
            CV.conv2d_plain(x, w, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"bf16 B={B} {shape}", err(y, ref), "conv_bf16",
               float(ref.float().abs().max()))
        del x32, w32, y, ref
        ops = 2 * B * oh * oh * k * k * c * o
        # x elements the conv reads: a 1x1 at stride s only every s-th
        # pixel (the JAX cost estimate counts its pre-sliced x), a 3x3 at
        # stride 1 all of them; either way B * oh * oh * c
        x_read = B * oh * oh * c
        b_ms, b_by = bound(2 * (x_read + w.numel() + B * oh * oh * o),
                           ops, PEAK_BF16_FLOPS)
        xn = x.permute(0, 3, 1, 2)                  # channels-last NCHW
        wn = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t = timing(torch, "conv_tc_kernel",
                   lambda: CV.implicit_gemm_conv2d(x, w, (s, s)),
                   lambda: CV.conv2d_plain(x, w, (s, s)),
                   lambda: F.conv2d(xn, wn, stride=s, padding=(k - 1) // 2),
                   10)
        per["conv2d"].append(dict(t, shape=f"B={B} bf16 {shape}",
                                  bound_ms=b_ms, bound_by=b_by, ops=ops,
                                  **rates(ops, t["ms"], b_ms,
                                          t["library_ms"])))
        emit({"phase": "kernels", "kernel": "conv2d",
              "timing": per["conv2d"][-1]})
        # the f32 route (3xTF32 on wgmma) at B=128 on f32 inputs (not
        # bf16 ones: their TF32 split would leave no low part), against
        # its plain version, then timed beside one f32 F.conv2d (TF32 is
        # off for the whole run); its bound at the rate of the route it
        # runs, three TF32 products a term, and the f32 FMA one beside it
        del x, w, xn, wn
        torch.cuda.empty_cache()
        xf, wf = randn(B, h, h, c, dtype=torch.float32), \
            randn(k, k, c, o, dtype=torch.float32)
        y = CV.implicit_gemm_conv2d(xf, wf, (s, s))
        ref = CV.conv2d_plain(xf, wf, (s, s))
        torch.cuda.synchronize()
        mag = float(ref.abs().max())
        record("conv2d", f"f32 B={B} {shape}", err(y, ref), "conv_f32", mag)
        # control: one TF32 product a term (operands rounded to TF32,
        # products exact, f32 sums) must fail the same gate
        one = CV.conv2d_plain(tf32_round(torch, xf), tf32_round(torch, wf),
                              (s, s))
        torch.cuda.synchronize()
        control = err(one, ref) / mag
        emit({"phase": "kernels", "kernel": "conv2d", "control_single_tf32":
              {"shape": f"B={B} f32 {shape}", "err_rel": control,
               "tol": TOL["conv_f32"]}})
        if not control > TOL["conv_f32"]:
            raise AssertionError(f"conv2d f32 {shape}: one TF32 product "
                                 f"({control}) passes the f32 gate")
        del y, ref, one
        xnf = xf.permute(0, 3, 1, 2)
        wnf = wf.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        nbytes = 4 * (x_read + wf.numel() + B * oh * oh * o)
        b_f = bound(nbytes, 3 * ops, PEAK_TF32_FLOPS)
        tf = timing(torch, "conv_f32_tc_kernel",
                    lambda: CV.implicit_gemm_conv2d(xf, wf, (s, s)),
                    lambda: CV.conv2d_plain(xf, wf, (s, s)),
                    lambda: F.conv2d(xnf, wnf, stride=s,
                                     padding=(k - 1) // 2), 10)
        plan = CV.conv_f32_plan(B * oh * oh, c, o)
        per["conv2d_f32"].append(dict(
            tf, shape=f"B={B} f32 {shape}", bound_ms=b_f[0],
            bound_by=b_f[1], ops=ops, bound_fma_ms=bound(nbytes, ops)[0],
            plan={"bm": plan.bm, "bn": plan.bn, "stages": plan.stages,
                  "vec": plan.vec, "smem": plan.smem,
                  "blocks": plan.blocks},
            **rates(ops, tf["ms"], b_f[0], tf["library_ms"])))
        emit({"phase": "kernels", "kernel": "conv2d",
              "timing_f32": per["conv2d_f32"][-1]})
        del xf, wf, xnf, wnf
        xq, wq, xs, ws = int8(B, h, h, c), int8(k, k, c, o), scales(B), \
            scales(o)
        # the K-major weight copy the kernel reads, made once per layer
        # (quantize_model), timed on its own
        tk = timed(torch, lambda: CV.int8_weights_kmajor(wq), 5)
        wk = CV.int8_weights_kmajor(wq)
        if not torch.equal(wk, wq.permute(3, 0, 1, 2).reshape(o, -1)):
            raise AssertionError(f"conv2d_int8 {shape}: K-major copy")
        emit({"phase": "kernels", "kernel": "conv2d_int8",
              "kmajor_copy_once": {"shape": f"{k}x{k}x{c}x{o}",
                                   "ms": tk["device_ms"]}})
        y = CV.implicit_gemm_conv2d_int8(xq, wq, xs, ws, (s, s),
                                         w_kmajor=wk)
        ref = CV.conv2d_int8_plain(xq, wq, xs, ws, (s, s))
        torch.cuda.synchronize()
        record("conv2d_int8", f"B={B} {shape}", err(y, ref), "int8")
        del y, ref
        b_ms, b_by = bound(x_read + wq.numel() + 4 * (B + o)
                           + 4 * B * oh * oh * o, ops, PEAK_INT8_OPS)
        # the float64 plain version is slow: one warm-up, one timed call
        t = timed(torch, lambda: CV.implicit_gemm_conv2d_int8(
            xq, wq, xs, ws, (s, s), w_kmajor=wk), 10,
            kernel="conv_i8_tc_kernel")
        plain = timed(torch, lambda: CV.conv2d_int8_plain(
            xq, wq, xs, ws, (s, s)), 1, warmup=1)
        plan = CV.conv_int8_plan(B * oh * oh, c, o)
        per["conv2d_int8"].append(dict(
            {"ms": t["device_ms"], "kernel_ms": t["kernel_ms"],
             "wall_ms": t["wall_ms"], "plain_ms": plain["device_ms"],
             "library_ms": None, "shape": f"B={B} int8 {shape}",
             "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
             "kmajor_copy_ms": tk["device_ms"],
             "plan": {"bn": plan.bn, "bk": plan.bk, "stages": plan.stages,
                      "vec": plan.vec, "blocks": plan.blocks}},
            **rates(ops, t["device_ms"], b_ms, None)))
        emit({"phase": "kernels", "kernel": "conv2d_int8",
              "timing": per["conv2d_int8"][-1]})
        del xq, wq, wk
        torch.cuda.empty_cache()

    # every other in-envelope conv shape of ResNet-50, checked, not timed
    from zoo_tpu_torch.models.image import resnet50
    rest = sorted(set(envelope_convs(resnet50(1000, (224, 224, 3))))
                  - set(CONV_SHAPES))
    for h, c, k, o, s in rest:
        shape = f"{h}x{h} {c}->{o} {k}x{k} stride {s}"
        x, w = randn(B, h, h, c), randn(k, k, c, o)
        y, ref = CV.implicit_gemm_conv2d(x, w, (s, s)), \
            CV.conv2d_plain(x, w, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"bf16 B={B} {shape}", err(y, ref), "conv_bf16",
               float(ref.float().abs().max()))
        del x, w, y, ref
        x, w = randn(B, h, h, c, dtype=torch.float32), \
            randn(k, k, c, o, dtype=torch.float32)
        y, ref = CV.implicit_gemm_conv2d(x, w, (s, s)), \
            CV.conv2d_plain(x, w, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"f32 B={B} {shape}", err(y, ref), "conv_f32",
               float(ref.abs().max()))
        xq, wq, xs, ws = int8(B, h, h, c), int8(k, k, c, o), scales(B), \
            scales(o)
        y = CV.implicit_gemm_conv2d_int8(xq, wq, xs, ws, (s, s))
        ref = CV.conv2d_int8_plain(xq, wq, xs, ws, (s, s))
        torch.cuda.synchronize()
        record("conv2d_int8", f"B={B} {shape}", err(y, ref), "int8")
        del x, w, xq, wq, y, ref
    # every other in-envelope conv shape of VGG-16, at the served batch
    # on the two routes that serve it (bf16 for v1, int8 for v2),
    # checked, not timed; conv1_1 (Cin = 3) is held and timed below
    from zoo_tpu_torch.models.image import vgg16
    vgg = sorted(set(envelope_convs(vgg16(CLUSTER_CLASSES, CLUSTER_IMAGE)))
                 - {VGG_FIRST_CONV})
    b = CLUSTER_B
    for h, c, k, o, s in vgg:
        shape = f"{h}x{h} {c}->{o} {k}x{k} stride {s} (VGG-16)"
        x, w = randn(b, h, h, c), randn(k, k, c, o)
        y, ref = CV.implicit_gemm_conv2d(x, w, (s, s)), \
            CV.conv2d_plain(x, w, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"bf16 B={b} {shape}", err(y, ref), "conv_bf16",
               float(ref.float().abs().max()))
        del x, w, y, ref
        xq, wq, xs, ws = int8(b, h, h, c), int8(k, k, c, o), scales(b), \
            scales(o)
        y = CV.implicit_gemm_conv2d_int8(xq, wq, xs, ws, (s, s))
        ref = CV.conv2d_int8_plain(xq, wq, xs, ws, (s, s))
        torch.cuda.synchronize()
        record("conv2d_int8", f"B={b} {shape}", err(y, ref), "int8")
        del xq, wq, y, ref
    emit({"phase": "kernels", "conv_shapes_checked":
          len(CONV_SHAPES) + len(rest), "vgg_conv_shapes_checked":
          len(vgg) + 1})
    torch.cuda.empty_cache()
    _vgg_first_conv(torch, CV, F, randn, int8, scales, record, err,
                    results)
    _zoo_conv_shapes(torch, CV, F, randn, record, err, results)

    for m, k, n in GEMM_SHAPES:
        shape = f"M={m} K={k} N={n}"
        two_pass = k > Q._FUSED_MAX_K
        x, wq, ws = randn(m, k), int8(k, n), scales(n)
        x[0] = 0                                   # a zero row: scale 1
        xq, xs = Q.quantize_int8(x, axis=-1)
        for out in (torch.float32, bf16):
            y = Q.quantized_matmul(xq, wq, xs, ws, out_dtype=out)
            ref = Q.quantized_matmul_plain(xq, wq, xs, ws, out_dtype=out)
            torch.cuda.synchronize()
            record("quantized_matmul", f"{shape} out {out}", err(y, ref),
                   "int8")
            del y, ref
            for xdt in (torch.float32, bf16):
                xx = x.to(xdt)
                before = (Q.QMM_LAUNCHES, Q.FQMM_LAUNCHES)
                y = Q.fused_quantized_matmul(xx, wq, ws, out)
                torch.cuda.synchronize()
                launched = (Q.QMM_LAUNCHES - before[0],
                            Q.FQMM_LAUNCHES - before[1])
                if two_pass:
                    # past _FUSED_MAX_K the fused op takes the two-pass
                    # route: quantize_int8, then one quantized_matmul
                    q, sc = Q.quantize_int8(xx, axis=-1)
                    ref = Q.quantized_matmul_plain(q, wq, sc, ws, out)
                    want = (1, 0)
                else:
                    ref = Q.fused_quantized_matmul_plain(xx, wq, ws, out)
                    want = (0, 1)
                torch.cuda.synchronize()
                if launched != want:
                    raise AssertionError(
                        f"fused_quantized_matmul {shape}: launches "
                        f"(quantized_matmul, fused_quantized_matmul) = "
                        f"{launched}, expected {want}")
                record("fused_quantized_matmul",
                       f"{shape} x {xdt} out {out}"
                       + (" (two-pass route)" if two_pass else ""),
                       err(y, ref), "int8")
                del xx, y, ref
        torch.cuda.empty_cache()
        ops = 2 * m * k * n

        def int_mm_dequant(q, sc):
            return (torch._int_mm(q, wq).float() * sc
                    * ws.reshape(1, n)).to(bf16)

        def lib_fused():
            xf = x.float()
            amax = xf.abs().amax(dim=-1, keepdim=True)
            sc = torch.where(amax == 0, 1.0, amax / 127.0)
            q = torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8)
            return int_mm_dequant(q, sc)

        libs = {"quantized_matmul": lambda: int_mm_dequant(xq, xs),
                "fused_quantized_matmul": lib_fused}
        for name, lib in libs.items():
            try:   # a yardstick only: a torch without it gives None
                lib()
            except RuntimeError as e:
                emit({"phase": "kernels", "kernel": name,
                      "library": f"torch._int_mm unavailable: {e!r}"})
                libs[name] = None
        plan = Q.qmm_plan(m, k, n, 16, 16, clusters=Q.cluster_limits(dev))
        extra = {}
        if two_pass:
            # the eager activation quantization the two-pass route runs
            # before the kernel (ROADMAP A.12's "(time)" item)
            tq = timed(torch, lambda: Q.quantize_int8(x, axis=-1), 10)
            extra = {"activation_quantize_ms": tq["device_ms"],
                     "activation_quantize_launches": tq["device_launches"]}
        per["quantized_matmul"].append(dict(
            qmm_timing(torch, Q, xq, wq, xs, ws, libs["quantized_matmul"]),
            plan=plan._asdict(), **extra))
        emit({"phase": "kernels", "kernel": "quantized_matmul",
              "timing": per["quantized_matmul"][-1]})
        if not two_pass:
            b_f = bound(2 * m * k + k * n + 4 * n + 2 * m * n, ops,
                        PEAK_INT8_OPS)
            # quantize, product and epilogue in one device launch a call
            t = timing_one_launch(
                torch, f"fused_quantized_matmul {shape}", "::fqmm_kernel",
                lambda: Q.fused_quantized_matmul(x, wq, ws),
                lambda: Q.fused_quantized_matmul_plain(x, wq, ws),
                libs["fused_quantized_matmul"], 50)
            plan = Q.fqmm_plan(m, k, n, x.element_size(), 16, 16)
            per["fused_quantized_matmul"].append(dict(
                t, shape=shape + " bf16 in and out", bound_ms=b_f[0],
                bound_by=b_f[1], plan=plan._asdict(),
                **rates(ops, t["ms"], b_f[0], t["library_ms"])))
            emit({"phase": "kernels", "kernel": "fused_quantized_matmul",
                  "timing": per["fused_quantized_matmul"][-1]})
        del x, wq, ws, xq, xs, libs
        torch.cuda.empty_cache()
    for name in ("conv2d", "conv2d_int8"):
        results[name].update(_sum_timing(per[name]))
        r = results[name]
        r.update(rates(sum(t["ops"] for t in per[name]), r["ms"],
                       r["bound_ms"], r["library_ms"]))
        emit({"phase": "kernels", "kernel": name, "summed": {
            k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "tflops", "bound_ratio", "library_ratio")}})
    # the f32 route summed over the four shapes, bound at 3xTF32, with
    # the f32 FMA bound beside it
    f32_route = _sum_timing(per["conv2d_f32"])
    f32_route.update(
        rates(sum(t["ops"] for t in per["conv2d_f32"]), f32_route["ms"],
              f32_route["bound_ms"], f32_route["library_ms"]),
        shape=f"B={B} f32, the {len(CONV_SHAPES)} shapes summed",
        bound_fma_ms=sum(t["bound_fma_ms"] for t in per["conv2d_f32"]))
    f32_route["bound_fma_ratio"] = f32_route["bound_fma_ms"] / f32_route["ms"]
    emit({"phase": "kernels", "kernel": "conv2d", "summed_f32": {
        k: f32_route[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_fma_ms",
            "tflops", "bound_ratio", "bound_fma_ratio",
            "library_ratio", "shape")}})
    results["conv2d"]["f32_route"] = f32_route
    for name in ("quantized_matmul", "fused_quantized_matmul"):
        # the kernels line carries the head's shape, the main path's
        results[name].update(per[name][0], shapes=per[name])
    # and the two-pass GEMM at fc6 of a served VGG-16 batch
    results["quantized_matmul"]["served_fc6"] = next(
        t for t in per["quantized_matmul"]
        if t["shape"].startswith(f"M={CLUSTER_B} K=25088"))


def _zoo_conv_shapes(torch, CV, F, randn, record, err, results):
    """The f32 conv kernel at the image zoo's shapes (B = ZOO_B): the
    ZOO_CONV_SHAPES against the plain version and timed beside their
    bound (three TF32 products a term) and one f32 ``F.conv2d`` (TF32
    off), then every other in-envelope conv shape of the five families
    against the plain version, not timed."""
    from zoo_tpu_torch.models.image import create_image_classifier
    b = ZOO_B
    per = []
    for h, c, k, o, s in ZOO_CONV_SHAPES:
        oh = -(-h // s)
        shape = f"B={b} f32 {h}x{h} {c}->{o} {k}x{k} stride {s}"
        x, w = randn(b, h, h, c, dtype=torch.float32), \
            randn(k, k, c, o, dtype=torch.float32)
        y, ref = CV.implicit_gemm_conv2d(x, w, (s, s)), \
            CV.conv2d_plain(x, w, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"{shape} (zoo)", err(y, ref), "conv_f32",
               float(ref.abs().max()))
        del y, ref
        ops = 2 * b * oh * oh * k * k * c * o
        nbytes = 4 * (b * oh * oh * c + w.numel() + b * oh * oh * o)
        b_ms, b_by = bound(nbytes, 3 * ops, PEAK_TF32_FLOPS)
        xn = x.permute(0, 3, 1, 2)
        wn = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t = timing(torch, "conv_f32_tc_kernel",
                   lambda: CV.implicit_gemm_conv2d(x, w, (s, s)),
                   lambda: CV.conv2d_plain(x, w, (s, s)),
                   lambda: F.conv2d(xn, wn, stride=s, padding=(k - 1) // 2),
                   10)
        plan = CV.conv_f32_plan(b * oh * oh, c, o)
        per.append(dict(
            {key: t[key] for key in ("ms", "kernel_ms", "wall_ms",
                                     "plain_ms", "library_ms")},
            shape=shape, bound_ms=b_ms, bound_by=b_by, ops=ops,
            plan={"bm": plan.bm, "bn": plan.bn, "stages": plan.stages,
                  "vec": plan.vec, "blocks": plan.blocks},
            **rates(ops, t["ms"], b_ms, t["library_ms"])))
        emit({"phase": "kernels", "kernel": "conv2d", "zoo_shape": per[-1]})
        del x, w, xn, wn
        torch.cuda.empty_cache()
    results["conv2d"]["zoo_shapes"] = per
    rest = set()
    for name in ZOO_FAMILIES:
        rest |= set(envelope_convs(create_image_classifier(name,
                                                           ZOO_CLASSES)))
    rest = sorted(rest - set(ZOO_CONV_SHAPES))
    for h, c, k, o, s in rest:
        shape = f"B={b} f32 {h}x{h} {c}->{o} {k}x{k} stride {s}"
        x, w = randn(b, h, h, c, dtype=torch.float32), \
            randn(k, k, c, o, dtype=torch.float32)
        y, ref = CV.implicit_gemm_conv2d(x, w, (s, s)), \
            CV.conv2d_plain(x, w, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"{shape} (zoo)", err(y, ref), "conv_f32",
               float(ref.abs().max()))
        del x, w, y, ref
    emit({"phase": "kernels", "zoo_conv_shapes_timed": len(per),
          "zoo_conv_shapes_checked": len(per) + len(rest)})
    torch.cuda.empty_cache()


def _vgg_first_conv(torch, CV, F, randn, int8, scales, record, err,
                    results):
    """VGG-16's first conv at the served batch: Cin = 3, so K = 27 is a
    multiple of neither the bf16 (16) nor the int8 (32) k-step, and the
    activation is gathered an element at a time (``vec`` 1). Both
    routes against their plain versions, then timed beside their bounds
    and ``F.conv2d`` (bf16, channels-last; none for int8)."""
    h, c, k, o, s = VGG_FIRST_CONV
    b = CLUSTER_B
    shape = f"B={b} {h}x{h} {c}->{o} {k}x{k} stride {s}"
    ops = 2 * b * h * h * k * k * c * o
    x, w = randn(b, h, h, c), randn(k, k, c, o)
    y, ref = CV.implicit_gemm_conv2d(x, w), CV.conv2d_plain(x, w)
    torch.cuda.synchronize()
    record("conv2d", f"bf16 {shape} (VGG-16 conv1_1)", err(y, ref),
           "conv_bf16", float(ref.float().abs().max()))
    del y, ref
    b_ms, b_by = bound(2 * (x.numel() + w.numel() + b * h * h * o), ops,
                       PEAK_BF16_FLOPS)
    xn = x.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    t = timing(torch, "conv_tc_kernel", lambda: CV.implicit_gemm_conv2d(x, w),
               lambda: CV.conv2d_plain(x, w),
               lambda: F.conv2d(xn, wn, padding=(k - 1) // 2), 10)
    plan = CV.conv_plan(b * h * h, c, o)
    first = {key: t[key] for key in ("ms", "kernel_ms", "wall_ms",
                                     "plain_ms", "library_ms")}
    first.update(shape=f"{shape} bf16", bound_ms=b_ms, bound_by=b_by,
                 plan={"bm": plan.bm, "bn": plan.bn, "stages": plan.stages,
                       "vec": plan.vec, "blocks": plan.blocks},
                 **rates(ops, t["ms"], b_ms, t["library_ms"]))
    results["conv2d"]["vgg_first_conv"] = first
    emit({"phase": "kernels", "kernel": "conv2d", "vgg_first_conv": first})
    f_conv_ms = t["library_ms"]
    del x, w, xn, wn
    xq, wq, xs, ws = int8(b, h, h, c), int8(k, k, c, o), scales(b), \
        scales(o)
    wk = CV.int8_weights_kmajor(wq)
    y = CV.implicit_gemm_conv2d_int8(xq, wq, xs, ws, w_kmajor=wk)
    ref = CV.conv2d_int8_plain(xq, wq, xs, ws)
    torch.cuda.synchronize()
    record("conv2d_int8", f"{shape} (VGG-16 conv1_1)", err(y, ref), "int8")
    del y, ref
    b_ms, b_by = bound(xq.numel() + wq.numel() + 4 * (b + o)
                       + 4 * b * h * h * o, ops, PEAK_INT8_OPS)
    t = timed(torch, lambda: CV.implicit_gemm_conv2d_int8(
        xq, wq, xs, ws, w_kmajor=wk), 10, kernel="conv_i8_tc_kernel")
    plain = timed(torch, lambda: CV.conv2d_int8_plain(xq, wq, xs, ws), 1,
                  warmup=1)
    plan = CV.conv_int8_plan(b * h * h, c, o)
    first = {"ms": t["device_ms"], "kernel_ms": t["kernel_ms"],
             "wall_ms": t["wall_ms"], "plain_ms": plain["device_ms"],
             "library_ms": None, "f_conv2d_bf16_ms": f_conv_ms,
             "shape": f"{shape} int8", "bound_ms": b_ms, "bound_by": b_by,
             "plan": {"bn": plan.bn, "bk": plan.bk, "stages": plan.stages,
                      "vec": plan.vec, "blocks": plan.blocks},
             **rates(ops, t["device_ms"], b_ms, None)}
    results["conv2d_int8"]["vgg_first_conv"] = first
    emit({"phase": "kernels", "kernel": "conv2d_int8",
          "vgg_first_conv": first})
    del xq, wq, wk
    torch.cuda.empty_cache()


def _block_weights(torch, g, cin, cmid, grad=False):
    """w1 (cin, cmid), w2 (3, 3, cmid, cmid), w3 (cmid, cin), f32, drawn
    at 1 / sqrt(fan in)."""
    return [(torch.randn(s, generator=g, device="cuda") / math.sqrt(fan))
            .requires_grad_(grad)
            for s, fan in (((cin, cmid), cin), ((3, 3, cmid, cmid),
                                                9 * cmid),
                           ((cmid, cin), cmid))]


def _block_bound(b, h, cin, cmid, x_bytes):
    """Least time of one bottleneck: x read and y written once, bf16
    weights read once, against its FLOPs at the bf16 peak."""
    pixels = b * h * h
    flops = 2 * pixels * (2 * cin * cmid + 9 * cmid * cmid)
    nbytes = 2 * pixels * cin * x_bytes + \
        2 * (2 * cin * cmid + 9 * cmid * cmid)
    return bound(nbytes, flops, PEAK_BF16_FLOPS) + (flops,)


def phase_block_kernels(torch, record, err, results):
    """The fused bottleneck kernel against its plain version at
    ResNet-50's four identity geometries (B=128 bf16, conv2_x also f32),
    its gradients through the op against autograd of the composition at
    conv2_x (B=32), then timed beside its bound, its plain version and
    the unfused cuDNN composition (into ``results``)."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.kernels import fused_block as FB

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1357)
    bf16, cl = torch.bfloat16, torch.channels_last
    B, per = BLOCK_B, []
    for name, h, cin, cmid in BLOCK_STAGES:
        ws = _block_weights(torch, g, cin, cmid)
        plan = FB.plan(h, h, cin, cmid)
        smem = plan.smem
        shape = f"{name} {h}x{h} {cin}->{cmid}->{cin}"
        for dt in ((bf16, torch.float32) if name == "conv2_x" else (bf16,)):
            x = torch.randn(B, h, h, cin, generator=g, device=dev).to(dt)
            y = FB.fused_bottleneck(x, *ws, impl="kernel")
            ref = FB.fused_bottleneck_plain(x, *ws)
            torch.cuda.synchronize()
            case = f"{str(dt).split('.')[-1]} B={B} {shape}"
            share = float((y == ref).float().mean())
            emit({"phase": "kernels", "kernel": "fused_bottleneck",
                  "case": case, "smem_bytes": smem,
                  "bit_equal_share": share})
            if not share >= BLOCK_BIT_EQUAL:
                raise AssertionError(
                    f"fused_bottleneck {case}: {share} of the outputs equal "
                    f"the plain version's bit for bit, under "
                    f"{BLOCK_BIT_EQUAL}")
            record("fused_bottleneck", case, err(y, ref), "block",
                   float(ref.float().abs().max()))
            del y, ref
        # timed in bf16, the training path's type
        x = x.to(bf16)
        (b_ms, b_by, flops) = _block_bound(B, h, cin, cmid, 2)
        xn = x.permute(0, 3, 1, 2)                  # channels-last NCHW
        w1n = ws[0].t().reshape(cmid, cin, 1, 1).to(bf16) \
            .contiguous(memory_format=cl)
        w2n = ws[1].permute(3, 2, 0, 1).to(bf16).contiguous(memory_format=cl)
        w3n = ws[2].t().reshape(cin, cmid, 1, 1).to(bf16) \
            .contiguous(memory_format=cl)

        def composition():
            t1 = F.relu(F.conv2d(xn, w1n))
            t2 = F.relu(F.conv2d(t1, w2n, padding=1))
            return F.relu(xn + F.conv2d(t2, w3n))
        t = timing(torch, "fused_bottleneck_kernel",
                   lambda: FB.fused_bottleneck(x, *ws, impl="kernel"),
                   lambda: FB.fused_bottleneck_plain(x, *ws), None, 5)
        comp = timed(torch, composition, 5)["device_ms"]
        per.append(dict(t, shape=f"B={B} bf16 {shape}", bound_ms=b_ms,
                        bound_by=b_by, composition_ms=comp,
                        tflops=flops / t["ms"] / 1e9,
                        bound_ratio=b_ms / t["ms"],
                        composition_ratio=t["ms"] / comp,
                        plan={"tile": [plan.th, plan.tw],
                              "tiles": plan.tiles, "warps": plan.warps,
                              "wn": list(plan.wn), "stages": plan.stages,
                              "smem": plan.smem}))
        emit({"phase": "kernels", "kernel": "fused_bottleneck",
              "timing": per[-1]})
        del x, xn
        torch.cuda.empty_cache()

    # gradients through the op at conv2_x, B=32: kernel forward,
    # recompute backward, against autograd of the composition
    _, h, cin, cmid = BLOCK_STAGES[0]
    x = torch.randn(BLOCK_GRAD_B, h, h, cin, generator=g,
                    device=dev).to(bf16)
    ws = _block_weights(torch, g, cin, cmid)
    dy = torch.randn(x.shape, generator=g, device=dev).to(bf16)
    leaves = [t.clone().requires_grad_() for t in [x] + ws]
    before = FB.LAUNCHES
    got = torch.autograd.grad(FB.fused_bottleneck(*leaves), leaves, dy)
    if FB.LAUNCHES != before + 1:
        raise AssertionError("fused_bottleneck: the gradient pass did not "
                             "launch the kernel once")
    ref_leaves = [t.clone().requires_grad_() for t in [x] + ws]
    want = torch.autograd.grad(FB.bottleneck_reference(*ref_leaves),
                               ref_leaves, dy)
    torch.cuda.synchronize()
    for part, a, b in zip(("dx", "dw1", "dw2", "dw3"), got, want):
        record("fused_bottleneck", f"{part} B={BLOCK_GRAD_B} conv2_x vs "
               "composition autograd", err(a, b), "block_grad",
               float(b.float().abs().max()))
    results["fused_bottleneck"].update(_sum_timing(per))
    r = results["fused_bottleneck"]
    r["composition_ms"] = sum(t["composition_ms"] for t in per)
    r.update(tflops=sum(_block_bound(B, h, cin, cmid, 2)[2]
                        for _, h, cin, cmid in BLOCK_STAGES) / r["ms"] / 1e9,
             bound_ratio=r["bound_ms"] / r["ms"],
             composition_ratio=r["ms"] / r["composition_ms"])
    del x, dy, leaves, ref_leaves, got, want
    torch.cuda.empty_cache()


def phase_dropout_kernels(torch, record, results):
    """The dropout kernel bit-equal to its plain version, forward and
    backward (the backward draws the mask again from the key), at
    :data:`DROPOUT_SHAPES`, its kept share within 4 sigma of 1 - p; the
    key kernel's splits and fold-ins bit-equal to the plain chain; then
    both timed beside their bounds, the plain versions and (dropout)
    ``F.dropout``, which draws Philox bits, not JAX's: a yardstick the
    port never calls. The line's numbers are the BERT hidden shape's."""
    import math
    import torch.nn.functional as F
    from zoo_tpu_torch.ops import random as R
    from zoo_tpu_torch.ops.kernels import dropout as D

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    key = R.PRNGKey(20, dev)
    shapes = []
    for shape, dt, mask_shape in DROPOUT_SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        gy = torch.randn(shape, generator=g, device=dev).to(dtype)
        before = D.LAUNCHES
        xk = x.clone().requires_grad_()
        yk = D.dropout(xk, key, DROPOUT_P, mask_shape)
        yk.backward(gy)
        xp = x.clone().requires_grad_()
        yp = D.dropout_plain(xp, key, DROPOUT_P, mask_shape)
        yp.backward(gy)
        torch.cuda.synchronize()
        if D.LAUNCHES - before != 2:
            raise AssertionError(f"dropout {shape}: {D.LAUNCHES - before} "
                                 "launches for a forward and a backward")
        for what, a, b in (("forward", yk, yp), ("backward", xk.grad,
                                                   xp.grad)):
            if not torch.equal(a, b):
                n_bad = int((a != b).sum())
                raise AssertionError(f"dropout {shape} {dt} {what}: "
                                     f"{n_bad} elements differ from plain")
            record("dropout", f"{what} {shape} {dt} mask={mask_shape}",
                   float((a.float() - b.float()).abs().max().detach()),
                   "float32")
        n_mask = math.prod(mask_shape or shape)
        mask = R.bernoulli(key, 1 - DROPOUT_P, mask_shape or shape)
        kept = float(mask.float().mean())
        sigma = math.sqrt(DROPOUT_P * (1 - DROPOUT_P) / n_mask)
        if abs(kept - (1 - DROPOUT_P)) > 4 * sigma:
            raise AssertionError(f"dropout {shape}: kept share {kept}")
        if not torch.equal(yk != 0, mask.expand(shape) & (x != 0)):
            raise AssertionError(f"dropout {shape}: the output's zeros are "
                                 "not the mask's")
        x = x.detach()
        nbytes = 2 * x.numel() * x.element_size()
        b_ms, b_by = bound(nbytes, DROPOUT_OPS_PER_ELEMENT * x.numel(),
                           PEAK_INT32_OPS)
        with torch.no_grad():
            t = timing_one_launch(
                torch, "dropout", "dropout_kernel",
                lambda: D.dropout(x, key, DROPOUT_P, mask_shape),
                lambda: D.dropout_plain(x, key, DROPOUT_P, mask_shape),
                lambda: F.dropout(x, DROPOUT_P, training=True), 30)
        entry = dict(t, shape=f"{shape} {dt} mask={mask_shape} "
                     f"p={DROPOUT_P}", kept_share=kept, bound_ms=b_ms,
                     bound_by=b_by, elements=x.numel(),
                     **rates(DROPOUT_OPS_PER_ELEMENT * x.numel(), t["ms"],
                             b_ms, t["library_ms"]))
        entry.pop("by_name")
        shapes.append(entry)
        emit({"phase": "kernels", "kernel": "dropout", "timing": entry})
    r = results["dropout"]
    r.update({k: shapes[0][k] for k in (
        "ms", "kernel_ms", "wall_ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "shape", "tflops", "bound_ratio", "library_ratio",
        "device_launches_per_call")})
    r["shapes"] = shapes

    # the key chain: 64 splits and a fold-in each, kernel == plain
    kk = kp = R.PRNGKey(7, dev)
    for i in range(64):
        sk, kk = D.split(kk)
        sp, kp = R.derive(kp, 2)
        fk, fp = D.fold_in(sk, 1000003 * i), R.fold_in(sp, 1000003 * i)
        if not (torch.equal(kk, kp) and torch.equal(sk, sp)
                and torch.equal(fk, fp)):
            raise AssertionError(f"derive_keys: step {i} differs")
    many = D.split(key, 4096)
    if not torch.equal(many, R.split(key, 4096)):
        raise AssertionError("derive_keys: split(key, 4096) differs")
    record("derive_keys", "64 splits + fold_ins, split(4096)", 0.0,
           "float32")
    b_ms, b_by = bound(16 + 32, 2 * 72, PEAK_INT32_OPS)
    t = timing_one_launch(torch, "derive_keys", "derive_keys_kernel",
                          lambda: D.split(key),
                          lambda: R.derive(key, 2), None, 200)
    t.pop("by_name")
    results["derive_keys"].update(
        t, bound_ms=b_ms, bound_by=b_by, shape="split(key) -> 2 keys",
        **rates(2 * 72, t["ms"], b_ms, None))
    emit({"phase": "kernels", "kernel": "derive_keys",
          "timing": results["derive_keys"]})


def _sgd_plain(param, grad, momentum_buf, lr, momentum=0.0,
               weight_decay=0.0, ok=None):
    """``fused_apply_sgd``'s plain version, in place, on any device."""
    import torch
    from zoo_tpu_torch.ops.kernels import fused_optim as FO
    with torch.no_grad():
        for dst, src in zip((param, momentum_buf), FO.reference_apply_sgd(
                param, grad, momentum_buf, lr, momentum, weight_decay, ok)):
            dst.copy_(src)
    return param, momentum_buf


def _adam_plain(param, grad, m, v, step, lr, beta1=0.9, beta2=0.999,
                eps=1e-8, weight_decay=0.0, ok=None):
    """``fused_apply_adam``'s plain version, in place, on any device."""
    import torch
    from zoo_tpu_torch.ops.kernels import fused_optim as FO
    with torch.no_grad():
        for dst, src in zip((param, m, v), FO.reference_apply_adam(
                param, grad, m, v, step, lr, beta1, beta2, eps,
                weight_decay, ok)):
            dst.copy_(src)
    return param, m, v


@contextlib.contextmanager
def plain_kernels():
    """The four image-inference kernel wrappers, the SGD and AdamW
    updates, dropout and the key derivations routed to their plain
    versions: the yardstick path, which nothing on the main path
    takes."""
    from zoo_tpu_torch.ops import random as R
    from zoo_tpu_torch.ops.kernels import conv as CV
    from zoo_tpu_torch.ops.kernels import dropout as DR
    from zoo_tpu_torch.ops.kernels import quant as Q
    from zoo_tpu_torch.pipeline.api.keras import optimizers as OPT
    swaps = ((CV, "implicit_gemm_conv2d", CV.conv2d_plain),
             (CV, "implicit_gemm_conv2d_int8", CV.conv2d_int8_plain),
             (Q, "quantized_matmul", Q.quantized_matmul_plain),
             (Q, "fused_quantized_matmul", Q.fused_quantized_matmul_plain),
             (OPT, "fused_apply_sgd", _sgd_plain),
             (OPT, "fused_apply_adam", _adam_plain),
             (DR, "dropout", DR.dropout_plain),
             (DR, "derive_keys", R.derive))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def tf32_round(torch, t):
    """f32 ``t`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = (t.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


@contextlib.contextmanager
def single_tf32_plain(torch):
    """The plain path (:func:`plain_kernels`) with the float conv routed
    to a control of lower precision: one TF32 product a term (operands
    rounded to TF32, f32 sums), the plain version's gradients passed
    straight through the rounding."""
    from zoo_tpu_torch.ops.kernels import conv as CV

    def conv(x, w, strides=(1, 1), padding="SAME"):
        def rounded(t):
            return t + (tf32_round(torch, t.detach()) - t).detach()
        return CV.conv2d_plain(rounded(x), rounded(w), strides, padding)

    with plain_kernels():
        saved = CV.implicit_gemm_conv2d
        CV.implicit_gemm_conv2d = conv
        try:
            yield
        finally:
            CV.implicit_gemm_conv2d = saved


def redraw_batchnorm(torch, params, seed):
    """BatchNorm gamma, beta and running stats drawn from ``seed``, so BN
    is not the identity (gamma, var ~ U(0.5, 1.5); beta, mean ~ 0.1 N)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict) and "stats" in val:
                d = val["gamma"].shape[0]
                u = torch.rand((4, d), generator=g, device="cuda")
                z = torch.randn((4, d), generator=g, device="cuda")
                val["gamma"], val["beta"] = u[0] + 0.5, 0.1 * z[0]
                val["stats"] = {"mean": 0.1 * z[1], "var": u[1] + 0.5}
            elif isinstance(val, dict):
                walk(val)
    walk(params)


def refresh_batchnorm(torch, model, x):
    """Every BatchNorm's running statistics set to those of its input in
    one training-mode forward of ``x`` (momentum 0 for that pass; its
    dropouts draw from a fixed key): in inference the model then
    normalizes ``x`` as training mode does, so seed-built weights no
    longer send every image to one output."""
    from zoo_tpu_torch.ops import random as R
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.layers import BatchNormalization
    bns = [l for l in model.layers if isinstance(l, BatchNormalization)]
    saved = [l.momentum for l in bns]
    dev = tree_leaves(model.params)[0].device
    collect = {}
    try:
        for layer in bns:
            layer.momentum = 0.0
        with torch.no_grad():
            model._forward(model.params, [torch.as_tensor(x, device=dev)],
                           training=True, collect=collect,
                           rng=R.PRNGKey(0, dev))
    finally:
        for layer, m in zip(bns, saved):
            layer.momentum = m
    for key, val in collect.items():
        model.params[key]["stats"] = val["stats"]
    torch.cuda.synchronize()
    return len(collect)


def envelope_convs(model):
    """(spatial, C, k, O, stride) of each of a functional model's Conv2D
    nodes inside the kernels' envelope, in graph order (square NHWC
    inputs, SAME padding, as ResNet's are)."""
    from zoo_tpu_torch.ops.kernels.conv import pallas_conv_supported
    from zoo_tpu_torch.pipeline.api.keras.layers import Convolution2D
    out = []
    for node in model._topo:
        layer = node.layer
        if isinstance(layer, Convolution2D) and \
                pallas_conv_supported(layer.kernel, layer.subsample):
            h, c = node.inbound[0].shape[1], node.inbound[0].shape[3]
            out.append((h, c, layer.kernel[0], layer.nb_filter,
                        layer.subsample[0]))
    return out


INFER_KERNELS = ("conv2d", "conv2d_int8", "quantized_matmul",
                 "fused_quantized_matmul")


def _launched(counts, **want):
    """Raise unless the four inference kernels launched as ``want``
    (default 0) says."""
    got = {k: counts[k] for k in INFER_KERNELS}
    need = {k: want.get(k, 0) for k in INFER_KERNELS}
    if got != need:
        raise AssertionError(f"launches {got}, expected {need}")


def phase_infer_tiny(torch, K):
    """Kernel path == plain path through a tiny ResNet's predict, f32."""
    import numpy as np
    from zoo_tpu_torch.models.image import ResNet
    from zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                  quantize_model)

    m = ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    m.compile("adamw", "sparse_categorical_crossentropy")
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    redraw_batchnorm(torch, m.params, 1)
    n_conv = len(envelope_convs(m))
    x = np.random.RandomState(5).randn(16, 32, 32, 3).astype(np.float32)
    im = InferenceModel().load_keras(m, batch_size=8)
    for path in ("float", "int8"):
        if path == "int8":
            quantize_model(m, mode="force")
        K.reset_launch_counts()
        got = im.predict(x)
        counts = K.launch_counts()
        with plain_kernels():
            K.reset_launch_counts()
            ref = im.predict(x)
            _launched(K.launch_counts())
        diff = float(np.abs(got - ref).max())
        emit({"phase": "infer-tiny", "path": path, "max_abs_err": diff,
              "tol": TOL_TINY_F32 if path == "float" else 0.0,
              "launches": {k: counts[k] for k in INFER_KERNELS},
              "argmax": got.argmax(1).tolist()})
        if not (np.isfinite(got).all() and got.shape == (16, 10)):
            raise AssertionError(f"infer-tiny {path}: outputs {got}")
        if path == "float":
            _launched(counts, conv2d=2 * n_conv)
            if not diff <= TOL_TINY_F32:
                raise AssertionError(f"infer-tiny float: {diff}")
        else:
            _launched(counts, conv2d_int8=2 * n_conv,
                      fused_quantized_matmul=2)
            if not np.array_equal(got, ref):
                raise AssertionError(f"infer-tiny int8: kernel path "
                                     f"differs from plain by {diff}")


def phase_infer_main(torch, K, card, save_to=None):
    """ResNet-50 at full width and depth through InferenceModel: float,
    int8 (fused head), one unfused-head batch and the auto verdict. With
    ``save_to`` the calibrated float model is saved there first (the
    input of infer-est-main)."""
    import numpy as np
    from zoo_tpu_torch.models.image import resnet50
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                  quantize_model)
    from zoo_tpu_torch.pipeline.inference.inference_model import _copy_tree

    B, steps = INFER_B, INFER_STEPS
    t0 = time.perf_counter()
    m = resnet50(1000, (224, 224, 3))
    m.compile("sgd", "sparse_categorical_crossentropy",
              dtype_policy="mixed_bfloat16")
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    redraw_batchnorm(torch, m.params, 1)
    rs = np.random.RandomState(0)                          # bench.py:504
    x = np.concatenate([rs.randn(B, 224, 224, 3).astype(np.float32)
                        for _ in range(steps)])
    # BN's running stats from the first batch and the head centred per
    # class (zoo-main's calibration), so the predictions spread across
    # classes and the int8-vs-float top-1 agreement means something
    refreshed = refresh_batchnorm(torch, m, x[:B])
    head_scale, _ = calibrate_head(torch, m, x[:B])
    float_params = _copy_tree(m.params)
    if save_to is not None:
        m.save(save_to)
    n_conv = len(envelope_convs(m))
    if n_conv != 49:
        raise AssertionError(f"{n_conv} convs inside the envelope, not 49")
    im = InferenceModel().load_keras(m, batch_size=B)     # warm-up batch
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    emit({"phase": "infer-main", "model": "resnet50(1000, (224, 224, 3))",
          "policy": "mixed_bfloat16", "batch": B, "batches": steps,
          "batchnorm_refreshed_from_batch_0": refreshed,
          "head_scale": head_scale,
          "params": sum(t.numel() for t in tree_leaves(m.params)),
          "setup_s": setup_s})
    launches, outs, profiles = {k: 0 for k in INFER_KERNELS}, {}, {}

    def run(path, xs, **want):
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = im.predict(xs)
        wall = time.perf_counter() - t
        counts = K.launch_counts()
        n_fwd = xs.shape[0] // B
        emit({"phase": "infer-main", "path": path, "card": card,
              "images": xs.shape[0], "wall_s": wall,
              "samples_per_s": xs.shape[0] / wall,
              "launches": {k: counts[k] for k in INFER_KERNELS},
              "launches_per_forward": {k: counts[k] / n_fwd
                                       for k in INFER_KERNELS},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if not (y.shape == (xs.shape[0], 1000) and np.isfinite(y).all()
                and np.allclose(y.sum(1), 1.0, atol=2e-2)):
            raise AssertionError(f"infer-main {path}: outputs not "
                                 "probabilities")
        _launched(counts, **{k: v * n_fwd for k, v in want.items()})
        for k in INFER_KERNELS:
            launches[k] += counts[k]
        return y

    def against_plain(path, y, exact):
        with plain_kernels():
            K.reset_launch_counts()
            ref = im.predict(x[:B])
            _launched(K.launch_counts())
        diff = float(np.abs(y[:B] - ref).max())
        top1 = float((y[:B].argmax(1) == ref.argmax(1)).mean())
        emit({"phase": "infer-main", "path": path, "vs_plain_max_abs": diff,
              "vs_plain_top1": top1,
              "tol": 0.0 if exact else TOL_MAIN_BF16})
        if not (np.array_equal(y[:B], ref) if exact
                else diff <= TOL_MAIN_BF16):
            raise AssertionError(f"infer-main {path}: kernel path differs "
                                 f"from plain by {diff}")

    def profile(path):
        xb = x[:B]
        t = timed(torch, lambda: im.predict(xb), 2, warmup=1)
        groups = {}
        for name, ms in t["by_name"].items():
            n = name.lower()
            label = ("conv2d_int8" if "conv_i8_tc_kernel" in n else
                     "conv2d" if "conv_tc_kernel" in n
                     or "conv_f32_tc_kernel" in n else
                     "int8_gemm" if "qmm_kernel" in n else
                     "cudnn_conv" if "conv" in n or "cudnn" in n
                     or "xmma" in n or "implicit" in n else
                     "copies" if "memcpy" in n.replace(" ", "") else
                     "other")
            groups[label] = groups.get(label, 0.0) + ms
        top = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:10]
        profiles[path] = t
        emit({"phase": "infer-step", "path": path, "card": card,
              "batch": B, "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
              "device_ms": t["device_ms"],
              "device_busy_share": t["device_busy_share"],
              "device_ms_by_group": groups,
              "top_device_ms": [[k[:80], v] for k, v in top]})

    outs["float"] = run("float", x, conv2d=n_conv)
    against_plain("float", outs["float"], exact=False)
    profile("float")
    torch.cuda.synchronize()
    t = time.perf_counter()
    quantize_model(m, mode="force")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t
    # every in-envelope conv carries the K-major weights its kernel reads,
    # made here once, so no forward transposes them
    from zoo_tpu_torch.ops.kernels.conv import kmajor_of
    from zoo_tpu_torch.pipeline.api.keras.layers import Convolution2D
    attached = sum(
        kmajor_of(m.params[m._key_of(l)]["W_q"]) is not None
        for l in m.layers if isinstance(l, Convolution2D))
    emit({"phase": "infer-main", "quantize_s": quantize_s,
          "kmajor_copies_attached": attached})
    if attached != n_conv:
        raise AssertionError(f"{attached} int8 convs carry K-major "
                             f"weights, not {n_conv}")
    outs["int8"] = run("int8", x, conv2d_int8=n_conv,
                       fused_quantized_matmul=1)
    against_plain("int8", outs["int8"], exact=True)
    profile("int8")
    os.environ["ZOO_INT8_MATMUL"] = "unfused"
    try:
        y = run("int8 unfused head", x[:B], conv2d_int8=n_conv,
                quantized_matmul=1)
    finally:
        del os.environ["ZOO_INT8_MATMUL"]
    agree = float((outs["int8"].argmax(1) == outs["float"].argmax(1))
                  .mean())
    classes = int(len(set(outs["float"].argmax(1))))
    spread = float(np.abs(outs["float"] - outs["float"].mean(0)).max())
    top5 = np.argsort(-outs["float"], axis=1)[:, :5]
    in_top5 = float((top5 == outs["int8"].argmax(1)[:, None]).any(1)
                    .mean())
    emit({"phase": "infer-main", "int8_top1_agreement_with_float": agree,
          "int8_top1_in_float_top5": in_top5,
          "int8_vs_float_max_abs": float(
              np.abs(outs["int8"] - outs["float"]).max()),
          "unfused_vs_fused_head_max_abs": float(
              np.abs(y - outs["int8"][:B]).max()),
          "float_top1_classes": classes,
          "float_prob_spread": spread, "min_top1_classes": INFER_TOP1_MIN})
    # the agreement above counts only if the float predictions spread
    if classes < INFER_TOP1_MIN:
        raise AssertionError(f"infer-main: the float path puts the "
                             f"{x.shape[0]} images in {classes} classes; "
                             "the int8 top-1 agreement would be vacuous")

    auto = resnet50(1000, (224, 224, 3))
    auto.compile("sgd", "sparse_categorical_crossentropy",
                 dtype_policy="mixed_bfloat16")
    auto.params = float_params
    t = time.perf_counter()
    quantize_model(auto, mode="auto")
    emit({"phase": "infer-main", "auto_verdict": auto._quant_path,
          "auto_speedup_int8_over_float": auto._quant_speedup,
          "sample_batch": 8, "seconds": time.perf_counter() - t})
    return launches


def zoo_images(n=None, seed=0):
    """``n`` (default ZOO_IMAGES) seeded uint8 BGR images, cycling
    through ZOO_SIZES, so the deploy chain's resize and centre crop do
    real work."""
    import numpy as np
    n = ZOO_IMAGES if n is None else n
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, ZOO_SIZES[i % len(ZOO_SIZES)] + (3,))
            .astype(np.uint8) for i in range(n)]


def calibrate_head(torch, model, x):
    """Seed-built weights send every image to nearly one output; this
    makes the outputs spread. The head's logits (the softmax set aside)
    are centred per class and scaled to ZOO_LOGIT_STD across the images
    of ``x``: a ``Dense`` head's bias takes off each class's
    mean logit in one step; a conv head under ReLU and global pooling
    (SqueezeNet) shifts its bias by the class's offset from the mean
    logit a few times (the ReLU makes the shift inexact). Both then
    scale ``W`` and ``b`` by one factor (the logits scale with it: the
    ReLU and the pooling are positively homogeneous). Returns the
    factor and the logits' centred spread before it."""
    import numpy as np
    from zoo_tpu_torch.pipeline.api.keras.layers import Dense

    out = model.layers[-1]
    act = out.activation
    out.activation = None if isinstance(out, Dense) else (lambda v: v)
    try:
        def logits():
            return model.predict(x, batch_size=ZOO_B, device="cuda")

        head = [l for l in model.layers
                if "W" in model.params.get(model._key_of(l), {})][-1]
        hp = model.params[model._key_of(head)]
        dense = isinstance(head, Dense)
        with torch.no_grad():
            for _ in range(1 if dense else 4):
                lg = logits()
                shift = lg.mean(0) - (0.0 if dense else lg.mean())
                hp["b"].sub_(torch.as_tensor(shift, device=hp["b"].device,
                                             dtype=hp["b"].dtype))
            lg = logits()
            before = float((lg - lg.mean(0)).std())
            scale = ZOO_LOGIT_STD / float(lg.std())
            hp["W"].mul_(scale)
            hp["b"].mul_(scale)
    finally:
        out.activation = act
    return scale, before


def _zoo_reference_convs(model):
    """The convs of a zoo graph that take the reference conv: the
    Conv2D layers outside the kernel's envelope (the stems, Inception's
    5x5s) and the depthwise convs."""
    from zoo_tpu_torch.ops.kernels.conv import pallas_conv_supported
    from zoo_tpu_torch.pipeline.api.keras.layers import (
        Convolution2D, DepthwiseConvolution2D)
    out = {"conv2d_outside_envelope": 0, "depthwise": 0}
    for layer in model.layers:
        if isinstance(layer, DepthwiseConvolution2D):
            out["depthwise"] += 1
        elif isinstance(layer, Convolution2D) and not \
                pallas_conv_supported(layer.kernel, layer.subsample):
            out["conv2d_outside_envelope"] += 1
    return out


def _zoo_group(name):
    """The kernel group of a device event of a zoo forward."""
    n = name.lower()
    if "conv_f32_tc_kernel" in n:
        return "conv2d_kernel"
    if "memcpy" in n.replace(" ", ""):
        return "copies"
    if any(k in n for k in ("conv", "cudnn", "xmma", "implicit",
                            "depthwise")):
        return "reference_conv"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def phase_zoo_main(torch, K, card):
    """``zoo-main``: the image-classification zoo at its published
    ImageNet widths (224 x 224 x 3, 1000 classes, float32, seed-built
    weights) through ``ImageClassifier.create(name, 1000)
    .predict_image_set(image_set, top_k=5)`` on ZOO_IMAGES seeded uint8
    BGR images of mixed sizes, batches of ZOO_B. Per family: the run's
    wall time, a batch's device time (profiler), busy share and
    images/s; the conv kernel's share of device time; the exact
    ``conv2d`` launches (every 1x1 and 3x3/1 conv, counted from the
    graph) and the reference route's convs. Checks (a) the kernel route
    against ``ZOO_CONV_IMPL=reference`` on the same images within
    TOL_TINY_F32, (b) on outputs that spread (BatchNorm's statistics
    refreshed from a batch, the head calibrated: probabilities that move
    across images by at least 100 x the tolerance; the distinct top-1
    classes printed), (c) a
    ``save_model`` / ``load_model`` round trip predicting the same bits;
    then (d) ZOO_FIT_STEPS ``fit`` steps of MobileNet-v1 at B = ZOO_B
    with SGD(ZOO_FIT_LR, momentum 0.9), each step through the kernels
    against the plain step from the same params and optimizer state:
    losses within TOL_TRAIN_TINY, updates within TOL_ZOO_UPDATE_X times
    the gap a one-ulp nudge of the images opens in the plain step, exact
    ``conv2d``, ``fused_sgd``, ``dropout`` and ``derive_keys`` launches.
    Returns the two paths' launches."""
    import shutil
    import tempfile

    import numpy as np
    from zoo_tpu_torch.feature.image import ImageSet
    from zoo_tpu_torch.models.image import ImageClassifier
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
        _split_state)
    from zoo_tpu_torch.pipeline.api.keras.layers import BatchNormalization
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD

    images = zoo_images()
    n_batches = ZOO_IMAGES // ZOO_B
    predict_launches = {"conv2d": 0}
    tmp = tempfile.mkdtemp(prefix="zoo-main-")
    try:
        for name in ZOO_FAMILIES:
            t0 = time.perf_counter()
            clf = ImageClassifier.create(name, ZOO_CLASSES)
            m = clf.model
            m.build(torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
            n_kernel = len(envelope_convs(m))
            reference = _zoo_reference_convs(m)
            th = time.perf_counter()
            x = clf.preprocess(ImageSet.from_arrays(images))
            preprocess_s = time.perf_counter() - th
            has_bn = any(isinstance(l, BatchNormalization)
                         for l in m.layers)
            if has_bn:
                redraw_batchnorm(torch, m.params, 1)
                refresh_batchnorm(torch, m, x[:ZOO_B])
            scale, logit_spread = calibrate_head(torch, m, x)
            clf.predict_image_set(ImageSet.from_arrays(images[:ZOO_B]),
                                  top_k=5, batch_size=ZOO_B)   # warm-up
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            iset = ImageSet.from_arrays([i.copy() for i in images])
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clf.predict_image_set(iset, top_k=5, batch_size=ZOO_B)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = K.launch_counts()
            probs = np.stack([f["predict"] for f in iset.features])
            launched = {k: v for k, v in counts.items() if v}
            want = {"conv2d": n_kernel * n_batches}
            xb = x[:ZOO_B]
            t = timed(torch, lambda: m.predict(xb, batch_size=ZOO_B,
                                               device="cuda"),
                      3, kernel="conv_f32_tc_kernel", warmup=1)
            groups = {}
            for ev, ms in t["by_name"].items():
                g = _zoo_group(ev)
                groups[g] = groups.get(g, 0.0) + ms
            # (a) the same images through the reference conv everywhere
            os.environ["ZOO_CONV_IMPL"] = "reference"
            try:
                K.reset_launch_counts()
                ref = m.predict(x, batch_size=ZOO_B, device="cuda")
                ref_launches = K.launch_counts()["conv2d"]
            finally:
                del os.environ["ZOO_CONV_IMPL"]
            diff = float(np.abs(probs - ref).max())
            # (b) the comparison's spread: across images and classes
            spread = float(np.abs(probs - probs.mean(0)).max())
            classes = int(len(set(probs.argmax(1))))
            # (c) a model file round trip
            path = os.path.join(tmp, f"{name}.model")
            clf.save_model(path)
            back = ImageClassifier.load_model(path)
            again = back.model.predict(x, batch_size=ZOO_B, device="cuda")
            round_trip = bool(np.array_equal(again, probs))
            emit({"phase": "zoo-main", "family": name, "card": card,
                  "model": f"ImageClassifier.create({name!r}, "
                           f"{ZOO_CLASSES})",
                  "input": [224, 224, 3], "policy": "float32",
                  "params": sum(v.numel() for v in tree_leaves(m.params)),
                  "images": ZOO_IMAGES, "batch": ZOO_B,
                  "image_sizes": [list(sz) for sz in ZOO_SIZES],
                  "setup_s": setup_s, "preprocess_s": preprocess_s,
                  "wall_s": wall, "images_per_s": ZOO_IMAGES / wall,
                  "batch_wall_ms": wall * 1e3 / n_batches,
                  "batch_forward_wall_ms": t["wall_ms"],
                  "batch_device_ms": t["device_ms"],
                  "device_busy_share": t["device_busy_share"],
                  "conv_kernel_ms": t["kernel_ms"],
                  "conv_kernel_share": None if not t["device_ms"] or
                  t["kernel_ms"] is None else
                  t["kernel_ms"] / t["device_ms"],
                  "device_ms_by_group": groups,
                  "launches": launched, "expected_launches": want,
                  "conv2d_per_forward_from_graph": n_kernel,
                  "reference_route_convs_per_forward": reference,
                  "batchnorm_refreshed": has_bn, "head_scale": scale,
                  "seed_logit_spread": logit_spread,
                  "vs_reference_max_abs": diff, "tol": TOL_TINY_F32,
                  "reference_conv2d_launches": ref_launches,
                  "prob_spread": spread, "top1_classes": classes,
                  "top5_of_image_0": iset.features[0]["classes"],
                  "save_load_bit_equal": round_trip})
            if not (probs.shape == (ZOO_IMAGES, ZOO_CLASSES)
                    and np.isfinite(probs).all()
                    and np.allclose(probs.sum(1), 1.0, atol=1e-4)
                    and all(len(f["classes"]) == 5
                            for f in iset.features)):
                raise AssertionError(f"zoo-main {name}: outputs are not "
                                     "probabilities with top-5 labels")
            if launched != want or ref_launches:
                raise AssertionError(
                    f"zoo-main {name}: launches {launched} (reference "
                    f"route {ref_launches}), expected {want} and 0")
            if spread < 100 * TOL_TINY_F32:
                raise AssertionError(
                    f"zoo-main {name}: probabilities spread {spread} "
                    f"({classes} top-1 classes): the comparison would "
                    "be vacuous")
            if not diff <= TOL_TINY_F32:
                raise AssertionError(f"zoo-main {name}: kernel route "
                                     f"differs from reference by {diff}")
            if not round_trip:
                raise AssertionError(f"zoo-main {name}: the loaded model "
                                     "predicts other values")
            predict_launches["conv2d"] += counts["conv2d"]
            del clf, m, back, x, probs, ref, again
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) MobileNet-v1 fit steps: each step through the kernels and,
    # from the same params and optimizer state, through the plain path
    clf = ImageClassifier.create("mobilenet", ZOO_CLASSES)
    m = clf.model
    m.compile(SGD(lr=ZOO_FIT_LR, momentum=0.9),
              "sparse_categorical_crossentropy")
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    x = clf.preprocess(ImageSet.from_arrays(images[:ZOO_B]))
    y = np.random.RandomState(1).randint(0, ZOO_CLASSES, ZOO_B) \
        .astype(np.int32)
    n_kernel = len(envelope_convs(m))
    n_train = len(tree_leaves(_split_state(m.params)[0]))
    steps = ZOO_FIT_STEPS
    counts = {}
    losses, plain, update_diff, control, step_s = [], [], [], [], 0.0
    for _ in range(steps):
        start, opt = _cloned(torch, m.params), _cloned(torch, m._opt_state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, c = _fit_losses(m, x, y, ZOO_B, 1)
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t0
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        after, after_opt = _cloned(torch, m.params), \
            _cloned(torch, m._opt_state)
        m.params, m._opt_state = _cloned(torch, start), _cloned(torch, opt)
        ref, c = _fit_losses(m, x, y, ZOO_B, 1, plain=True)
        if any(c.values()):
            raise AssertionError(f"zoo-main fit: the plain path launched {c}")
        plain_after = _cloned(torch, m.params)
        # the control: the plain step on the images nudged by one ulp
        m.params, m._opt_state = _cloned(torch, start), _cloned(torch, opt)
        _fit_losses(m, x * np.float32(1 + 2 ** -23), y, ZOO_B, 1,
                    plain=True)
        t_k, t_p, t_c, t_0 = (tree_leaves(_split_state(t)[0]) for t in (
            after, plain_after, m.params, start))
        losses += loss
        plain += ref
        update_diff.append(_update_gap(t_k, t_p, t_0))
        control.append(_update_gap(t_c, t_p, t_0))
        m.params, m._opt_state = after, after_opt
    # a step: every in-envelope conv forward (the backward is the
    # reference conv's gradients), one SGD launch a trainable leaf,
    # Dropout(0.001) forward and backward, and the key chain's split and
    # the dropout layer's fold-in
    want = {"conv2d": n_kernel * steps, "fused_sgd": n_train * steps,
            "dropout": 2 * steps, "derive_keys": 2 * steps}
    launched = {k: v for k, v in counts.items() if v}
    per_step = (np.abs(np.subtract(losses, plain)) / np.abs(plain)).tolist()
    rel = float(max(per_step))
    emit({"phase": "zoo-main", "fit": "mobilenet", "card": card,
          "optimizer": f"SGD(lr={ZOO_FIT_LR}, momentum=0.9)",
          "batch": ZOO_B, "steps": steps, "step_ms": step_s * 1e3 / steps,
          "losses": losses, "plain_losses": plain,
          "rel_loss_diff_by_step": per_step, "tol": TOL_TRAIN_TINY,
          "rel_update_diff_by_step": update_diff,
          "control_one_ulp_input_by_step": control,
          "update_tol_x_control": TOL_ZOO_UPDATE_X,
          "launches": launched, "expected_launches": want})
    if not (all(np.isfinite(losses)) and rel <= TOL_TRAIN_TINY
            and all(d <= TOL_ZOO_UPDATE_X * c
                    for d, c in zip(update_diff, control))):
        raise AssertionError(f"zoo-main fit: losses {losses} vs plain "
                             f"{plain}, updates apart by {update_diff}")
    if launched != want:
        raise AssertionError(f"zoo-main fit: launches {launched}, "
                             f"expected {want}")
    del clf, m
    torch.cuda.empty_cache()
    return ({"conv2d": predict_launches["conv2d"]},
            {k: counts[k] for k in want})


def _update_gap(params, ref, start):
    """``||params - ref|| / ||ref - start||`` over lists of leaves: how far
    one step's update lies from the reference step's, relative to it."""
    num = math.sqrt(sum(float(((a - b).detach() ** 2).sum())
                        for a, b in zip(params, ref)))
    den = math.sqrt(sum(float(((b - o).detach() ** 2).sum())
                        for b, o in zip(ref, start)))
    return num / den


def _cloned(torch, tree):
    """A copy of a params or optimizer-state tree (tensors cloned)."""
    if isinstance(tree, dict):
        return {k: _cloned(torch, v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def phase_bottleneck_main(torch, K, card):
    """The fused op's own path at full width: the geometries of
    ResNet-50's twelve identity blocks at B=128 in bf16, each stage
    driven forward and forward+backward through ``fused_bottleneck``,
    and through the port's unfused block (three ``conv2d`` dispatches,
    the ReLUs and the add), then timed. Returns the path's launches."""
    from zoo_tpu_torch.ops.kernels import fused_block as FB
    from zoo_tpu_torch.ops.kernels.conv import conv2d

    g = torch.Generator(device="cuda").manual_seed(8642)
    bf16, B = torch.bfloat16, BLOCK_B
    launches = {"fused_bottleneck": 0, "conv2d": 0}

    def unfused(x, ws):
        cin, cmid = ws[0].shape
        w1, w2, w3 = (w.to(bf16) for w in ws)
        t1 = torch.relu(conv2d(x, w1.reshape(1, 1, cin, cmid)))
        t2 = torch.relu(conv2d(t1, w2))
        return torch.relu(x + conv2d(t2, w3.reshape(1, 1, cmid, cin)))

    for name, h, cin, cmid in BLOCK_STAGES:
        x = torch.randn(B, h, h, cin, generator=g, device="cuda").to(bf16)
        ws = _block_weights(torch, g, cin, cmid, grad=True)
        dy = torch.randn(x.shape, generator=g, device="cuda").to(bf16)
        xg = x.clone().requires_grad_()

        def fused_fwd():
            with torch.no_grad():
                return FB.fused_bottleneck(x, *ws)

        def fused_train():
            return torch.autograd.grad(FB.fused_bottleneck(xg, *ws),
                                       [xg] + ws, dy)

        def unfused_fwd():
            with torch.no_grad():
                return unfused(x, ws)

        def unfused_train():
            return torch.autograd.grad(unfused(xg, ws), [xg] + ws, dy)

        runs = (("fused forward", fused_fwd, {"fused_bottleneck": 1}),
                ("fused forward+backward", fused_train,
                 {"fused_bottleneck": 1}),
                ("unfused forward", unfused_fwd, {"conv2d": 3}),
                ("unfused forward+backward", unfused_train, {"conv2d": 3}))
        out, ms = {}, {}
        for label, fn, want in runs:
            K.reset_launch_counts()
            out[label] = fn()
            torch.cuda.synchronize()
            counts = K.launch_counts()
            got = {k: counts[k] for k in ("fused_bottleneck", "conv2d",
                                          "fused_bottleneck_reference")}
            need = {k: want.get(k, 0) for k in got}
            if got != need:
                raise AssertionError(f"bottleneck-main {name} {label}: "
                                     f"launches {got}, expected {need}")
            for k in launches:
                launches[k] += counts[k]
        for label, fn, _ in runs:
            ms[label] = timed(torch, fn, 3, warmup=1)["device_ms"]
        y, yu = out["fused forward"], out["unfused forward"]
        if not (torch.isfinite(y.float()).all() and y.shape == x.shape):
            raise AssertionError(f"bottleneck-main {name}: outputs")
        emit({"phase": "bottleneck-main", "stage": name, "card": card,
              "shape": f"B={B} {h}x{h} {cin}->{cmid}->{cin} bf16",
              "ms": ms, "fused_vs_unfused_max_abs": float(
                  (y.float() - yu.float()).abs().max()),
              "fused_forward_speedup": ms["unfused forward"]
              / ms["fused forward"],
              "fused_train_speedup": ms["unfused forward+backward"]
              / ms["fused forward+backward"]})
        del x, xg, dy, ws, out, y, yu
        torch.cuda.empty_cache()
    return launches


def phase_train_image_tiny(torch, K):
    """Kernel path == plain path through a tiny ResNet's ``fit`` with
    ``SGD(0.1, 0.9)``, f32: 8 images, two shuffled epochs at B=4.

    Only 4 steps: the run is unstable (random labels at lr 0.1 with
    momentum drive the loss from ~2.3 to ~8 within two epochs), and it
    amplifies the conv's summation-order differences (~1e-7 per step)
    step by step; after 8 such steps the CPU parity test
    (``tests/test_torch_resnet_train.py``) sees the JAX package's and the
    port's leaves 2.5e-3 apart from summation order alone."""
    import numpy as np
    from zoo_tpu_torch.models.image import ResNet
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD

    m = ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    m.compile(SGD(lr=0.1, momentum=0.9), "sparse_categorical_crossentropy")
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    redraw_batchnorm(torch, m.params, 1)
    start = tree_map(torch.clone, m.params)
    n_conv = len(envelope_convs(m))
    rs = np.random.RandomState(5)
    x = rs.randn(8, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 10, 8).astype(np.int32)
    out = {}
    # the control: the plain path with one TF32 product a conv term, a
    # lower precision than the f32 route's, which the gate must refuse;
    # the kernel path three times as shipped, and three times with the
    # reference conv's backward free to take cuDNN's nondeterministic
    # algorithms (the determinism control)
    repeats = ("kernels", "kernels_2", "kernels_3")
    controls = ("nondeterministic_1", "nondeterministic_2",
                "nondeterministic_3")
    for label, ctx in (*((r, contextlib.nullcontext) for r in repeats),
                       ("plain", plain_kernels),
                       ("single_tf32", lambda: single_tf32_plain(torch)),
                       *((r, lambda: cudnn_deterministic(torch, False))
                         for r in controls)):
        m.compile(SGD(lr=0.1, momentum=0.9),
                  "sparse_categorical_crossentropy")
        m.params = tree_map(torch.clone, start)
        with ctx():
            K.reset_launch_counts()
            hist = m.fit(x, y, batch_size=4, nb_epoch=2, shuffle=True,
                         seed=0, verbose=0, device="cuda")
            torch.cuda.synchronize()
            counts = K.launch_counts()
        out[label] = (hist["loss"], tree_leaves(m.params), counts)
    (lk, pk, ck), (lp, pp, cp) = out["kernels"], out["plain"]
    n_train = sum(1 for t in pk if t.requires_grad)

    def drift(losses, leaves):
        return (max(abs(a - b) / abs(b) for a, b in zip(losses, lp)),
                max(float((a.detach() - b.detach()).norm()
                          / b.detach().norm()) for a, b in zip(leaves, pp)))

    loss_rel, param_rel = drift(lk, pk)
    control = drift(*out["single_tf32"][:2])

    def repeat(labels):
        """Runs of ``labels`` whose losses and leaves equal the first's
        bit for bit, and the largest leaf difference from it."""
        first = out[labels[0]]
        same, diff = 1, 0.0
        for r in labels[1:]:
            losses, leaves = out[r][:2]
            d = max(float((a.detach() - b.detach()).abs().max())
                    for a, b in zip(leaves, first[1]))
            same += losses == first[0] and d == 0.0
            diff = max(diff, d)
        return {"bit_equal_runs": f"{same}/{len(labels)}",
                "max_leaf_diff": diff}

    determinism = {"shipped": repeat(repeats),
                   "control_nondeterministic": repeat(controls)}
    moved = min(float((a.detach() - b).abs().max())
                for a, b in zip(pk, tree_leaves(start)))
    emit({"phase": "train-image-tiny", "loss_kernels": lk, "loss_plain": lp,
          "loss_max_rel": loss_rel, "param_and_stat_max_rel": param_rel,
          "least_leaf_move": moved, "tol": TOL_TRAIN_TINY,
          "control_single_tf32": {"loss_max_rel": control[0],
                                  "param_and_stat_max_rel": control[1]},
          "repeats": determinism,
          "launches": {k: ck[k] for k in ("conv2d", "fused_sgd")},
          "launches_plain": {k: cp[k] for k in ("conv2d", "fused_sgd")}})
    if not (np.isfinite(lk).all() and loss_rel <= TOL_TRAIN_TINY
            and param_rel <= TOL_TRAIN_TINY and moved > 0):
        raise AssertionError(f"train-image-tiny: kernel path differs from "
                             f"plain: loss {loss_rel}, params {param_rel}, "
                             f"least move {moved}")
    if not max(control) > TOL_TRAIN_TINY:
        raise AssertionError(f"train-image-tiny: one TF32 product a conv "
                             f"term ({control}) passes the gate")
    if determinism["shipped"]["max_leaf_diff"] != 0.0 or \
            determinism["shipped"]["bit_equal_runs"] != "3/3":
        raise AssertionError(f"train-image-tiny: the kernel path does not "
                             f"repeat itself: {determinism['shipped']}")
    steps = 4
    if (ck["conv2d"], ck["fused_sgd"]) != (n_conv * steps,
                                           n_train * steps) \
            or cp["conv2d"] or cp["fused_sgd"]:
        raise AssertionError(f"train-image-tiny: launches {ck} with the "
                             f"kernels, {cp} without")


def phase_train_image_main(torch, K, card):
    """Keras ``fit`` of ``bench.py`` ``bench_resnet50``'s config at full
    width and depth, then ``evaluate``; returns the path's launches."""
    import numpy as np
    from zoo_tpu_torch.models.image import resnet50
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
        _split_state)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD

    B, steps = TRAIN_IMG_B, TRAIN_IMG_STEPS
    t0 = time.perf_counter()
    m = resnet50(1000, (224, 224, 3))
    m.compile(optimizer=SGD(lr=0.1, momentum=0.9),
              loss="sparse_categorical_crossentropy", metrics=["accuracy"],
              dtype_policy="mixed_bfloat16")
    rs = np.random.RandomState(0)                          # bench.py:379
    x = rs.randn(TRAIN_IMG_N, 224, 224, 3).astype(np.float32)
    y = rs.randint(0, 1000, TRAIN_IMG_N).astype(np.int32)
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    trainable, state = _split_state(m.params)
    n_train = len(tree_leaves(trainable))
    stats0 = [t.clone() for t in tree_leaves(state)]
    n_conv = len(envelope_convs(m))
    # warm-up: two steps
    m.fit(x[:2 * B], y[:2 * B], batch_size=B, nb_epoch=1, shuffle=False,
          verbose=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # timed: `steps` steps, one fit per batch so every step's loss shows
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        sl = slice(i * B, (i + 1) * B)
        losses += m.fit(x[sl], y[sl], batch_size=B, nb_epoch=1,
                        shuffle=False, verbose=0, device="cuda")["loss"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak_fit = torch.cuda.max_memory_allocated() / 1e9
    step_s = wall / steps
    stats_moved = min(float((a - b).abs().max()) for a, b in
                      zip(tree_leaves(_split_state(m.params)[1]), stats0))
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    ev = m.evaluate(x[:2 * B], y[:2 * B], batch_size=B, device="cuda")
    eval_s = time.perf_counter() - t1
    emit({"phase": "train-image-main", "model": "resnet50(1000, (224, 224, "
          "3))", "optimizer": "SGD(lr=0.1, momentum=0.9)",
          "policy": "mixed_bfloat16", "card": card, "batch": B,
          "steps": steps, "trainable_leaves": n_train,
          "params": sum(t.numel() for t in tree_leaves(m.params)),
          "setup_s": setup_s, "wall_s": wall, "step_ms": step_s * 1e3,
          "samples_per_s": B / step_s,
          "mfu": 3 * RESNET50_FWD_FLOPS * B / step_s / PEAK_BF16_FLOPS,
          "losses": losses, "launches": counts,
          "launches_per_step": {k: v / steps for k, v in counts.items()},
          "running_stats_least_move": stats_moved,
          "peak_mem_gb_fit": peak_fit, "evaluate": ev,
          "evaluate_images": 2 * B, "evaluate_s": eval_s,
          "peak_mem_gb_evaluate": torch.cuda.max_memory_allocated() / 1e9})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train-image-main: losses {losses}")
    if counts["conv2d"] != n_conv * steps or \
            counts["fused_sgd"] != n_train * steps:
        raise AssertionError(f"train-image-main: launches {counts}, "
                             f"expected {n_conv} conv2d per forward and "
                             f"{n_train} fused_sgd per step")
    if not stats_moved > 0:
        raise AssertionError("train-image-main: a running stat did not "
                             "move")
    if not (set(ev) == {"loss", "accuracy"} and 0 <= ev["accuracy"] <= 1
            and np.isfinite(ev["loss"])):
        raise AssertionError(f"train-image-main: evaluate gave {ev}")

    xb, yb = x[:B], y[:B]
    t = timed(torch, lambda: m.fit(xb, yb, batch_size=B, nb_epoch=1,
                                   shuffle=False, verbose=0, device="cuda"),
              3, warmup=1)
    groups = _grouped(t["by_name"], _image_group)
    top = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "train-image-step", "card": card, "steps": 3,
          "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
          "device_ms": t["device_ms"],
          "device_busy_share": t["device_busy_share"],
          "device_ms_by_group": groups,
          "top_device_ms": [[k[:80], v] for k, v in top]})
    del m, x
    torch.cuda.empty_cache()
    return {k: counts[k] for k in ("conv2d", "fused_sgd")}


def phase_train_tiny(torch, K):
    """Kernel path == plain path through a tiny Llama ``fit``."""
    import numpy as np
    from zoo_tpu_torch.models.llm.llama import (Llama, init_params,
                                                tiny_llama_config)
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay

    cfg = tiny_llama_config()
    rs = np.random.RandomState(3)
    ids = rs.randint(0, cfg.vocab, (32, 32)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    start = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    out = {}
    for label, impl, fused in (("kernels", "flash", True),
                               ("plain", "dense", False)):
        m = Sequential().add(Llama(cfg, attention_impl=impl,
                                   input_shape=(32,)))
        m.compile(AdamWeightDecay(lr=1e-3, fused=fused), LOSS)
        m.params = {"000_llama": tree_map(torch.clone, start)}
        K.reset_launch_counts()
        hist = m.fit(ids, labels, batch_size=4, nb_epoch=2, shuffle=True,
                     seed=0, verbose=0, device="cuda")
        torch.cuda.synchronize()
        out[label] = (hist["loss"], m.params["000_llama"],
                      K.launch_counts())
    (lk, pk, ck), (lp, pp, cp) = out["kernels"], out["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    param_err = max(float((a.detach() - b.detach()).abs().max())
                    for a, b in zip(tree_leaves(pk), tree_leaves(pp)))
    emit({"phase": "train-tiny", "loss_kernels": lk, "loss_plain": lp,
          "loss_max_rel": loss_rel, "param_max_abs": param_err,
          "launches": ck, "launches_plain": cp})
    if not (loss_rel <= 1e-4 and param_err <= 1e-4):
        raise AssertionError(f"train-tiny: kernel path differs from plain: "
                             f"loss rel {loss_rel}, params {param_err}")
    for k in ("flash_attention", "flash_attention_dkdv",
              "flash_attention_dq", "fused_adam"):
        if ck[k] <= 0 or cp[k] != 0:
            raise AssertionError(f"train-tiny: {k} launched {ck[k]} times "
                                 f"with the kernels, {cp[k]} without")


def phase_train_main(torch, K, card):
    """Keras ``fit`` of the training config at full width and depth."""
    import numpy as np
    from zoo_tpu_torch.models.llm.llama import Llama, LlamaConfig
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay

    cfg = LlamaConfig(**TRAIN_CFG)
    B, S = TRAIN_B, TRAIN_S
    m = Sequential().add(Llama(cfg, remat="dots", input_shape=(S,)))
    m.compile(optimizer=AdamWeightDecay(lr=1e-4, fused=True), loss=LOSS,
              dtype_policy="mixed_bfloat16")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab, (3 * B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    t0 = time.perf_counter()
    m.build(torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
    n_params = sum(x.numel() for x in tree_leaves(m.params))
    # warm-up: two steps on two batches
    m.fit(ids[:2 * B], labels[:2 * B], batch_size=B, nb_epoch=1,
          shuffle=False, verbose=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # timed: TRAIN_STEPS steps, one per epoch on one batch, so the
    # history holds every step's loss
    batch = (ids[2 * B:], labels[2 * B:])
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = m.fit(*batch, batch_size=B, nb_epoch=TRAIN_STEPS, shuffle=False,
                 verbose=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    losses = hist["loss"]
    step_s = wall / TRAIN_STEPS
    h, kv = cfg.hidden, cfg.n_kv_head * cfg.head_dim
    fwd_per_token = cfg.n_block * (
        2 * (h * h * 2 + 2 * h * kv) + 2 * 3 * h * cfg.intermediate
        + 4 * S * h) + 2 * h * cfg.vocab            # bench.py:447-453
    flops_per_sample = 3 * fwd_per_token * S
    emit({"phase": "train-main", "config": TRAIN_CFG, "card": card,
          "seq_len": S, "batch": B, "steps": TRAIN_STEPS,
          "params": n_params, "setup_s": setup_s, "wall_s": wall,
          "step_ms": step_s * 1e3, "tokens_per_s": B * S / step_s,
          "mfu": flops_per_sample * B / step_s / PEAK_BF16_FLOPS,
          "losses": losses, "launches": counts,
          "launches_per_step": {k: v / TRAIN_STEPS for k, v in
                                counts.items()},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "attention_impl": m.layers[0].last_attention_impl})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train-main: losses {losses}")
    for k in ("flash_attention", "flash_attention_dkdv",
              "flash_attention_dq", "fused_adam"):
        if counts[k] <= 0:
            raise AssertionError(f"train-main: {k} never launched")

    t = timed(torch, lambda: m.fit(*batch, batch_size=B, nb_epoch=1,
                                   shuffle=False, verbose=0, device="cuda"),
              3, warmup=1)
    groups = _grouped(t["by_name"], _llama_group)
    top = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:16]
    emit({"phase": "step", "card": card, "steps": 3,
          "wall_ms": t["wall_ms"], "device_ms": t["device_ms"],
          "device_busy_share": t["device_busy_share"],
          "device_ms_by_group": groups,
          "top_device_ms": [[k[:80], v] for k, v in top]})
    return {k: counts[k] for k in ("flash_attention", "flash_attention_dkdv",
                                   "flash_attention_dq", "fused_adam",
                                   "fused_sgd")}


def _llama_group(name):
    """The kernel group of a device event of a Llama or BERT training
    step."""
    n = name.lower()
    for key, label in (("flash_fwd_tc_kernel", "flash_fwd"),
                       ("flash_fwd_kernel", "flash_fwd"),
                       ("flash_bwd_dkdv", "flash_dkdv"),
                       ("flash_bwd_dq", "flash_dq"),
                       ("adam_kernel", "fused_adam")):
        if key in n:
            return label
    if any(s in n for s in ("gemm", "gemv", "cutlass", "matmul",
                            "xmma", "nvjet")):
        return "matmul"
    return "other"


def _image_group(name):
    """The kernel group of a device event of a ResNet training step."""
    n = name.lower()
    if "conv_tc_kernel" in n or "conv_f32_tc_kernel" in n:
        return "conv2d_kernel"
    if "sgd_kernel" in n:
        return "fused_sgd"
    if any(k in n for k in ("conv", "cudnn", "xmma", "implicit",
                            "dgrad", "wgrad", "fprop")):
        return "cudnn_conv"
    if "memcpy" in n.replace(" ", ""):
        return "copies"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "nvjet")):
        return "matmul"
    return "elementwise"


def _grouped(by_name, group):
    """Device ms per call summed by ``group(event name)``."""
    groups = {}
    for name, ms in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    return groups


def phase_train_f32_main(torch, K, card):
    """Keras ``fit`` under the default ``float32`` policy (``compile``
    given no ``dtype_policy``) at full width and depth: the Llama training
    config, then ResNet-50; each a warm-up step and TRAIN_F32_STEPS timed
    steps on one batch, then a profile. Returns the path's launches."""
    import numpy as np
    from zoo_tpu_torch.models.image import resnet50
    from zoo_tpu_torch.models.llm.llama import Llama, LlamaConfig
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
        _split_state)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import (AdamWeightDecay,
                                                             SGD)

    steps = TRAIN_F32_STEPS
    total = {}

    def run(label, m, x, y, batch, flops_per_step, want, rate, unit,
            group):
        """Warm-up step, timed steps, checks and a profile of one model;
        ``want`` maps kernel -> launches a step."""
        t0 = time.perf_counter()
        m.build(torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
        if m.dtype_policy != "float32":
            raise AssertionError(f"train-f32-main {label}: policy "
                                 f"{m.dtype_policy}, not the default")
        m.fit(x[:batch], y[:batch], batch_size=batch, nb_epoch=1,
              shuffle=False, verbose=0, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        xb, yb = x[batch:2 * batch], y[batch:2 * batch]
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = m.fit(xb, yb, batch_size=batch, nb_epoch=steps,
                     shuffle=False, verbose=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        losses = hist["loss"]
        step_s = wall / steps
        emit({"phase": "train-f32-main", "model": label,
              "policy": "float32 (compile's default)", "card": card,
              "batch": batch, "steps": steps, "setup_s": setup_s,
              "wall_s": wall, "step_ms": step_s * 1e3,
              unit: rate / step_s,
              "tflops_per_s": flops_per_step / step_s / 1e12,
              "mfu_f32": flops_per_step / step_s / PEAK_F32_FLOPS,
              "losses": losses,
              "launches_per_step": {k: v / steps for k, v in
                                    counts.items() if v},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train-f32-main {label}: losses {losses}")
        got = {k: counts[k] for k in want}
        if got != {k: n * steps for k, n in want.items()}:
            raise AssertionError(f"train-f32-main {label}: launches {got}, "
                                 f"expected {want} a step")
        t = timed(torch, lambda: m.fit(xb, yb, batch_size=batch,
                                       nb_epoch=1, shuffle=False,
                                       verbose=0, device="cuda"),
                  2, warmup=0)
        emit({"phase": "train-f32-step", "model": label, "card": card,
              "steps": 2, "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
              "device_ms": t["device_ms"],
              "device_busy_share": t["device_busy_share"],
              "device_ms_by_group": _grouped(t["by_name"], group),
              "top_device_ms": [[k[:80], v] for k, v in sorted(
                  t["by_name"].items(), key=lambda kv: -kv[1])[:10]]})
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # the Llama training config (bench.py bench_llama), f32
    cfg = LlamaConfig(**TRAIN_CFG)
    B, S = TRAIN_B, TRAIN_S
    m = Sequential().add(Llama(cfg, remat="dots", input_shape=(S,)))
    m.compile(optimizer=AdamWeightDecay(lr=1e-4, fused=True), loss=LOSS)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab, (2 * B, S)).astype(np.int32)
    h, kv = cfg.hidden, cfg.n_kv_head * cfg.head_dim
    fwd_per_token = cfg.n_block * (
        2 * (h * h * 2 + 2 * h * kv) + 2 * 3 * h * cfg.intermediate
        + 4 * S * h) + 2 * h * cfg.vocab            # bench.py:447-453
    n_block = cfg.n_block
    run("llama (bench.py bench_llama, S=512, B=64, remat=dots)", m, ids,
        np.roll(ids, -1, axis=1), B, 3 * fwd_per_token * S * B,
        {"flash_attention": n_block, "flash_attention_dkdv": n_block,
         "flash_attention_dq": n_block}, B * S, "tokens_per_s",
        _llama_group)
    if m.layers[0].last_attention_impl != "flash":
        raise AssertionError("train-f32-main: the Llama layer took "
                             f"{m.layers[0].last_attention_impl}")
    del m
    torch.cuda.empty_cache()

    # ResNet-50 (bench.py bench_resnet50), f32
    B = TRAIN_IMG_B
    m = resnet50(1000, (224, 224, 3))
    m.compile(optimizer=SGD(lr=0.1, momentum=0.9),
              loss="sparse_categorical_crossentropy")
    rs = np.random.RandomState(0)                          # bench.py:379
    x = rs.randn(2 * B, 224, 224, 3).astype(np.float32)
    y = rs.randint(0, 1000, 2 * B).astype(np.int32)
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_conv = len(envelope_convs(m))
    n_train = len(tree_leaves(_split_state(m.params)[0]))
    run("resnet50(1000, (224, 224, 3)) (bench.py bench_resnet50, B=128, "
        "SGD(0.1, 0.9))", m, x, y, B, 3 * RESNET50_FWD_FLOPS * B,
        {"conv2d": n_conv, "fused_sgd": n_train}, B, "samples_per_s",
        _image_group)
    del m, x
    torch.cuda.empty_cache()
    return {k: total.get(k, 0) for k in (
        "conv2d", "flash_attention", "flash_attention_dkdv",
        "flash_attention_dq", "fused_adam", "fused_sgd")}


def _bert_sequential(seq_len, attention_impl="auto", **cfg):
    """``bench.py`` ``bench_bert``'s model (:400-411) at ``cfg``'s
    widths: BERT, ``Lambda(h[:, 0])``, ``Dense(2)``."""
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense, Lambda
    m = Sequential()
    m.add(BERT(seq_len=seq_len, max_position_len=max(seq_len, 512),
               attention_impl=attention_impl, input_shape=(seq_len,),
               **cfg))
    m.add(Lambda(lambda h: h[:, 0], output_shape=(cfg["hidden_size"],)))
    m.add(Dense(2))
    return m


def phase_train_bert_tiny(torch, K):
    """Kernel path == plain path through a tiny BERT ``fit`` at S=512,
    where ``auto`` takes the flash kernels (non-causal), with the fused
    AdamW kernel, against the dense attention and the plain update; f32
    and ``mixed_bfloat16``. Returns the kernel path's launches."""
    import numpy as np
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay
    cfg = dict(vocab=256, hidden_size=64, n_block=2, n_head=4,
               intermediate_size=128, hidden_p_drop=0.0, attn_p_drop=0.0)
    S, B, N = 512, 4, 8
    rs = np.random.RandomState(3)
    ids = rs.randint(0, cfg["vocab"], (N, S)).astype(np.int32)
    y = rs.randint(0, 2, N).astype(np.int32)
    steps = 2 * (N // B)
    total = {}
    for policy in ("float32", "mixed_bfloat16"):
        start = None
        out = {}
        for label, impl, fused in (("kernels", "auto", True),
                                   ("plain", "dense", False)):
            m = _bert_sequential(S, impl, **cfg)
            m.compile(AdamWeightDecay(lr=1e-3, fused=fused), LOSS,
                      dtype_policy=policy)
            if start is None:
                start = tree_map(torch.clone, m.build(
                    torch.Generator(device="cuda").manual_seed(0),
                    device="cuda"))
            m.params = tree_map(torch.clone, start)
            K.reset_launch_counts()
            hist = m.fit(ids, y, batch_size=B, nb_epoch=2, shuffle=True,
                         seed=0, verbose=0, device="cuda")
            torch.cuda.synchronize()
            out[label] = (hist["loss"], m.params, K.launch_counts(),
                          m.layers[0].last_attention_impl)
        (lk, pk, ck, ik), (lp, pp, cp, ip) = out["kernels"], out["plain"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        param_err = max(float((a.detach() - b.detach()).abs().max())
                        for a, b in zip(tree_leaves(pk), tree_leaves(pp)))
        n_leaves = len(tree_leaves(pk))
        emit({"phase": "train-bert-tiny", "policy": policy,
              "loss_kernels": lk, "loss_plain": lp,
              "loss_max_rel": loss_rel, "param_max_abs": param_err,
              "attention_impl": [ik, ip], "leaves": n_leaves,
              "launches": {k: v for k, v in ck.items() if v},
              "launches_plain": {k: v for k, v in cp.items() if v}})
        # f32: train-tiny's tolerances; bf16: the losses within
        # tests/test_torch_keras.py's bf16 rtol (the kernel rounds p and
        # dS to bf16 where the dense path keeps f32, and AdamW turns a
        # sign change of a small bf16 gradient into a full step)
        if policy == "float32":
            ok = loss_rel <= 1e-4 and param_err <= 1e-4
        else:
            ok = loss_rel <= 2e-2 and all(np.isfinite(lk))
        if not ok or (ik, ip) != ("flash", "dense"):
            raise AssertionError(
                f"train-bert-tiny {policy}: kernel path differs from "
                f"plain: loss rel {loss_rel}, params {param_err}, "
                f"impls {ik}, {ip}")
        want = {"flash_attention": cfg["n_block"] * steps,
                "flash_attention_dkdv": cfg["n_block"] * steps,
                "flash_attention_dq": cfg["n_block"] * steps,
                "fused_adam": n_leaves * steps}
        got = {k: ck[k] for k in want}
        if got != want or any(cp[k] for k in want):
            raise AssertionError(f"train-bert-tiny {policy}: launches "
                                 f"{got} (plain {cp}), expected {want}")
        for k, v in ck.items():
            total[k] = total.get(k, 0) + v
    return total


def _rec_group(name):
    """The kernel group of a device event of an NCF training step."""
    n = name.lower()
    if "memcpy" in n.replace(" ", ""):
        return "copies"
    if any(s in n for s in ("embedding", "index", "gather", "scatter",
                            "radix", "sort", "segment", "grad_weight",
                            "unique")):
        return "embedding"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "matmul", "xmma",
                            "nvjet")):
        return "matmul"
    return "elementwise"


def _only_the_key_chain(counts, steps):
    """True when a window of ``steps`` training steps launched no kernel
    but the key chain's: one ``derive_keys`` a step, the fit's split of
    its key (JAX's step splits it too, whether a layer draws or not)."""
    return counts["derive_keys"] == steps and not any(
        v for k, v in counts.items() if k != "derive_keys")


def phase_train_rec_main(torch, K, card):
    """Keras ``fit`` of the NCF flagship (``_flagship()``'s config) at
    ``bench_ncf``'s size: B=8192, 96 steps an epoch, host-fed numpy,
    ``shuffle=False``; a warm-up epoch, then NCF_EPOCHS timed epochs
    (samples/s each), per-step losses of 8 steps on one batch (finite,
    falling), two runs from one start repeating bit for bit,
    ``recommend_for_user`` on a few users, and a ``train-rec-step``
    profile. NCF runs no Pallas kernel in the JAX package, and no
    kernel here: every count must stay 0."""
    import numpy as np
    from zoo_tpu_torch.models.recommendation import (NeuralCF,
                                                     UserItemFeature)
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    def model():
        m = NeuralCF(**NCF_CFG)
        return m.compile(optimizer=Adam(lr=0.001),
                         loss="sparse_categorical_crossentropy",
                         metrics=["accuracy"])

    B, n = NCF_B, NCF_B * NCF_STEPS
    rs = np.random.RandomState(0)                           # bench.py:338
    x = np.stack([rs.randint(0, NCF_CFG["user_count"], n),
                  rs.randint(0, NCF_CFG["item_count"], n)],
                 axis=1).astype(np.int32)
    y = rs.randint(0, NCF_CFG["class_num"], n).astype(np.int32)
    m = model()
    t0 = time.perf_counter()
    start = tree_map(torch.clone, m.build(
        torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    n_params = sum(t.numel() for t in tree_leaves(start))
    m.fit(x, y, batch_size=B, nb_epoch=1, shuffle=False, verbose=0,
          device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rates_, losses = [], []
    for _ in range(NCF_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = m.fit(x, y, batch_size=B, nb_epoch=1, shuffle=False,
                     verbose=0, device="cuda")
        torch.cuda.synchronize()
        rates_.append(n / (time.perf_counter() - t0))
        losses += hist["loss"]
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    # per-step losses: 8 steps on one batch, each an epoch of its own
    steps = m.fit(x[:B], y[:B], batch_size=B, nb_epoch=8, shuffle=False,
                  verbose=0, device="cuda")["loss"]
    # two runs of 8 steps from one start: the Embedding gradients (and
    # everything else) repeat bit for bit
    runs = []
    for _ in range(2):
        r = model()
        r.params = tree_map(torch.clone, start)
        r.fit(x[:8 * B], y[:8 * B], batch_size=B, nb_epoch=1,
              shuffle=False, verbose=0, device="cuda")
        runs.append(tree_leaves(r.params))
    torch.cuda.synchronize()
    repeats = all(torch.equal(a, b) for a, b in zip(*runs))
    users = [1, 17, 4242]
    cands = [UserItemFeature(u, i) for u in users
             for i in range(0, NCF_CFG["item_count"], 97)]
    recs = m.recommend_for_user(cands, 5)
    emit({"phase": "train-rec-main", "config": NCF_CFG, "card": card,
          "batch": B, "steps_per_epoch": NCF_STEPS, "params": n_params,
          "setup_s": setup_s, "samples_per_s": rates_,
          "samples_per_s_median": sorted(rates_)[len(rates_) // 2],
          "step_ms": [B / r * 1e3 for r in rates_],
          "epoch_losses": losses, "step_losses": steps,
          "repeats_bit_for_bit": repeats, "peak_mem_gb": peak,
          "launches": {k: v for k, v in counts.items() if v},
          "recommend_for_user": [[p.user_id, p.item_id, p.probability]
                                 for p in recs]})
    if not (all(np.isfinite(losses + steps)) and steps[-1] < steps[0]):
        raise AssertionError(f"train-rec-main: losses {losses} {steps}")
    if not _only_the_key_chain(counts, NCF_EPOCHS * NCF_STEPS):
        raise AssertionError(f"train-rec-main: kernels launched {counts}; "
                             "NCF's path runs none but the key split")
    if not repeats:
        raise AssertionError("train-rec-main: two runs from one start "
                             "gave other bits")
    if [p.user_id for p in recs] != [u for u in users for _ in range(5)] \
            or not all(0.0 < p.probability <= 1.0 for p in recs):
        raise AssertionError(f"train-rec-main: recommend_for_user {recs}")
    xb, yb = x[:4 * B], y[:4 * B]
    t = timed(torch, lambda: m.fit(xb, yb, batch_size=B, nb_epoch=1,
                                   shuffle=False, verbose=0, device="cuda"),
              2, warmup=1)
    emit({"phase": "train-rec-step", "card": card, "steps_per_call": 4,
          "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
          "device_ms": t["device_ms"],
          "device_busy_share": t["device_busy_share"],
          "device_launches": t["device_launches"],
          "device_ms_by_group": _grouped(t["by_name"], _rec_group),
          "top_device_ms": [[k[:80], v] for k, v in sorted(
              t["by_name"].items(), key=lambda kv: -kv[1])[:10]],
          "top_host_ms": [[k[:80], v] for k, v in sorted(
              t["host_by_name"].items(), key=lambda kv: -kv[1])[:10]]})
    del m, runs
    torch.cuda.empty_cache()


def phase_train_bert_main(torch, K, card):
    """Keras ``fit`` of ``bench.py``'s BERT-base at full width and depth,
    ``mixed_bfloat16``, ``remat="dots"``: run (a) ``bench_bert`` exactly
    (S=128, B=64, dense attention, ``AdamWeightDecay(lr=1e-4)`` at the
    knob's default), run (b) S=512, B=16 with the fused AdamW (the
    non-causal bf16 flash kernels, 12 each a step, one AdamW launch a
    leaf a step). Each: a warm-up fit of two steps, BERT_STEPS timed
    steps on one batch (step ms, samples/s, ``mfu`` from ``bench_bert``'s
    analytic FLOPs, losses finite), then a ``train-bert-step`` profile.
    Returns run (b)'s launches."""
    import numpy as np
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay

    L, h = BERT_CFG["n_block"], BERT_CFG["hidden_size"]
    inter = BERT_CFG["intermediate_size"]
    out = {}
    for run, S, B in BERT_RUNS:
        fused = run == "b"
        m = _bert_sequential(S, **BERT_CFG)
        opt = AdamWeightDecay(lr=1e-4, fused=True) if fused else \
            AdamWeightDecay(lr=1e-4)
        m.compile(optimizer=opt, loss=LOSS, dtype_policy="mixed_bfloat16")
        rs = np.random.RandomState(0)                      # bench.py:415
        ids = rs.randint(0, BERT_CFG["vocab"], (3 * B, S)).astype(np.int32)
        y = rs.randint(0, 2, 3 * B).astype(np.int32)
        t0 = time.perf_counter()
        m.build(torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
        n_leaves = len(tree_leaves(m.params))
        n_params = sum(t.numel() for t in tree_leaves(m.params))
        m.fit(ids[:2 * B], y[:2 * B], batch_size=B, nb_epoch=1,
              shuffle=False, verbose=0, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        xb, yb = ids[2 * B:], y[2 * B:]
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = m.fit(xb, yb, batch_size=B, nb_epoch=BERT_STEPS,
                     shuffle=False, verbose=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        losses = hist["loss"]
        step_s = wall / BERT_STEPS
        fwd_per_token = L * (8 * h ** 2 + 4 * h * inter + 4 * S * h)
        flops_per_sample = 3 * fwd_per_token * S          # bench.py:419-423
        impl = m.layers[0].last_attention_impl
        emit({"phase": "train-bert-main", "run": run, "card": card,
              "config": dict(BERT_CFG, seq_len=S), "batch": B,
              "steps": BERT_STEPS, "params": n_params, "leaves": n_leaves,
              "optimizer_fused": m.optimizer.fused,
              "attention_impl": impl, "setup_s": setup_s, "wall_s": wall,
              "step_ms": step_s * 1e3, "samples_per_s": B / step_s,
              "tokens_per_s": B * S / step_s,
              "mfu": flops_per_sample * B / step_s / PEAK_BF16_FLOPS,
              "losses": losses,
              "launches_per_step": {k: v / BERT_STEPS for k, v in
                                    counts.items() if v},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train-bert-main ({run}): losses {losses}")
        flash = ("flash_attention", "flash_attention_dkdv",
                 "flash_attention_dq")
        if fused:
            want = dict({k: L * BERT_STEPS for k in flash},
                        fused_adam=n_leaves * BERT_STEPS)
            want_impl = "flash"
        else:
            want = dict({k: 0 for k in flash}, fused_adam=0)
            want_impl = "dense"
        got = {k: counts[k] for k in want}
        if got != want or impl != want_impl:
            raise AssertionError(f"train-bert-main ({run}): launches {got}, "
                                 f"attention {impl}; expected {want}, "
                                 f"{want_impl}")
        out[run] = counts
        t = timed(torch, lambda: m.fit(xb[:B], yb[:B], batch_size=B,
                                       nb_epoch=1, shuffle=False,
                                       verbose=0, device="cuda"),
                  3, warmup=1)
        BERT_STEP[run] = {"step_ms": step_s * 1e3,
                          "mfu": flops_per_sample * B / step_s
                          / PEAK_BF16_FLOPS,
                          "device_ms": t["device_ms"],
                          "device_busy_share": t["device_busy_share"],
                          "losses": losses}
        emit({"phase": "train-bert-step", "run": run, "card": card,
              "steps": 3, "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
              "device_ms": t["device_ms"],
              "device_busy_share": t["device_busy_share"],
              "device_launches": t["device_launches"],
              "device_ms_by_group": _grouped(t["by_name"], _llama_group),
              "top_device_ms": [[k[:80], v] for k, v in sorted(
                  t["by_name"].items(), key=lambda kv: -kv[1])[:12]],
              "top_host_ms": [[k[:80], v] for k, v in sorted(
                  t["host_by_name"].items(), key=lambda kv: -kv[1])[:12]]})
        del m
        torch.cuda.empty_cache()
    return {k: out["b"][k] for k in ("flash_attention",
                                     "flash_attention_dkdv",
                                     "flash_attention_dq", "fused_adam")}


# run (a)'s and (b)'s step numbers, for the dropout run beside them
BERT_STEP = {}


def _bert_flops_per_sample(S):
    """``bench_bert``'s analytic training FLOPs a sample (:419-423)."""
    L, h = BERT_CFG["n_block"], BERT_CFG["hidden_size"]
    inter = BERT_CFG["intermediate_size"]
    return 3 * L * (8 * h ** 2 + 4 * h * inter + 4 * S * h) * S


def _restore(torch, m, snapshot):
    """``m``'s params back to ``snapshot`` (a list of tensors in leaf
    order) and its optimizer state dropped: the next ``fit`` starts
    where the snapshot was taken."""
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    with torch.no_grad():
        for t, s in zip(tree_leaves(m.params), snapshot):
            t.copy_(s)
    m._opt_state = None


def _fit_losses(m, x, y, batch, steps, plain=False):
    """Per-step losses of ``steps`` one-batch epochs on ``x[:batch]``
    (through the plain versions with ``plain``), and the launches."""
    import contextlib

    import zoo_tpu_torch.ops.kernels as K
    K.reset_launch_counts()
    with plain_kernels() if plain else contextlib.nullcontext():
        hist = m.fit(x[:batch], y[:batch], batch_size=batch,
                     nb_epoch=steps, shuffle=False, verbose=0,
                     device="cuda")
    return hist["loss"], K.launch_counts()


def phase_train_bert_dropout(torch, K, card):
    """``train-bert-dropout``: run (a) of :func:`phase_train_bert_main`
    exactly (S=128, B=64, ``mixed_bfloat16``, ``remat="dots"``, AdamW)
    with BERT's published dropout, ``hidden_p_drop = attn_p_drop = 0.1``,
    so attention runs dense, as JAX's ``auto`` picks. BERT_STEPS steps
    from one snapshot through the kernels and through every plain
    version: losses within :data:`TOL_BERT_BF16_LOSS` (the dropout kernel
    is bit-equal to its plain version, so they should be equal), the
    dropout kernel launched 5 times a block a step (3 forward sites, the
    attention and first hidden backward; the MLP site's backward and its
    recompute under ``remat="dots"`` make 2 more: 7) and the key kernel
    for the chain. Then step ms, ``mfu`` and busy share beside run
    (a)'s. Returns the kernel run's launches."""
    import numpy as np
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay

    run, S, B = BERT_RUNS[0]
    L = BERT_CFG["n_block"]
    cfg = dict(BERT_CFG, hidden_p_drop=0.1, attn_p_drop=0.1)
    m = _bert_sequential(S, **cfg)
    m.compile(optimizer=AdamWeightDecay(lr=1e-4), loss=LOSS,
              dtype_policy="mixed_bfloat16")
    rs = np.random.RandomState(0)                          # bench.py:415
    ids = rs.randint(0, cfg["vocab"], (3 * B, S)).astype(np.int32)
    y = rs.randint(0, 2, 3 * B).astype(np.int32)
    t0 = time.perf_counter()
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    snapshot = [t.detach().clone() for t in tree_leaves(m.params)]
    m.fit(ids[:2 * B], y[:2 * B], batch_size=B, nb_epoch=1, shuffle=False,
          verbose=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    xb, yb = ids[2 * B:], y[2 * B:]
    _restore(torch, m, snapshot)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, counts = _fit_losses(m, xb, yb, B, BERT_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    impl = m.layers[0].last_attention_impl
    _restore(torch, m, snapshot)
    plain, plain_counts = _fit_losses(m, xb, yb, B, BERT_STEPS, plain=True)
    step_s = wall / BERT_STEPS
    mfu = _bert_flops_per_sample(S) * B / step_s / PEAK_BF16_FLOPS
    want = {"dropout": 7 * L * BERT_STEPS,
            "derive_keys": (2 + 4 * L) * BERT_STEPS}
    got = {k: counts[k] for k in want}
    rel = float(np.max(np.abs(np.subtract(losses, plain))
                       / np.abs(plain)))
    t = timed(torch, lambda: m.fit(xb[:B], yb[:B], batch_size=B,
                                   nb_epoch=1, shuffle=False, verbose=0,
                                   device="cuda"), 3, warmup=1)
    a = BERT_STEP.get("a", {})
    emit({"phase": "train-bert-dropout", "run": run, "card": card,
          "config": dict(cfg, seq_len=S), "batch": B, "steps": BERT_STEPS,
          "attention_impl": impl, "setup_s": setup_s, "wall_s": wall,
          "step_ms": step_s * 1e3, "samples_per_s": B / step_s, "mfu": mfu,
          "device_ms": t["device_ms"],
          "device_busy_share": t["device_busy_share"],
          "device_launches": t["device_launches"],
          "losses": losses, "plain_losses": plain,
          "max_rel_loss_diff": rel, "tol": TOL_BERT_BF16_LOSS,
          "launches_per_step": {k: v / BERT_STEPS for k, v in
                                counts.items() if v},
          "plain_launches": {k: v for k, v in plain_counts.items() if v},
          "dropout_device_ms": sum(v for k, v in t["by_name"].items()
                                   if "dropout_kernel" in k),
          "run_a_no_dropout": a,
          "step_ms_ratio_to_run_a": step_s * 1e3 / a["step_ms"]
          if a else None,
          "device_ms_ratio_to_run_a": t["device_ms"] / a["device_ms"]
          if a else None,
          "top_device_ms": [[k[:80], v] for k, v in sorted(
              t["by_name"].items(), key=lambda kv: -kv[1])[:12]]})
    if not all(np.isfinite(losses)) or rel > TOL_BERT_BF16_LOSS:
        raise AssertionError(f"train-bert-dropout: losses {losses} vs "
                             f"plain {plain}")
    if got != want or impl != "dense":
        raise AssertionError(f"train-bert-dropout: launches {got}, "
                             f"attention {impl}; expected {want}, dense")
    if plain_counts["dropout"] or plain_counts["derive_keys"]:
        raise AssertionError("train-bert-dropout: the plain path launched "
                             f"{plain_counts}")
    del m, snapshot
    torch.cuda.empty_cache()
    return {k: counts[k] for k in ("dropout", "derive_keys")}


# text-main: TextClassifier at its constructor widths (the Scala
# reference's) on a news20-shaped TextSet: 20 classes, the 5000 most
# frequent of >= 5000 distinct words, 500-token sequences, B=128, Adam
TEXT_CFG = dict(class_num=20, token_length=200, sequence_length=500,
                encoder_output_dim=256, hidden_drop=0.2)
TEXT_B, TEXT_STEPS, TEXT_WORDS, TEXT_DOCS = 128, 3, 8000, 4 * 128
# seq-tiny: examples/anomaly_detection.py's detector (unroll 24, B=128)
# and a SessionRecommender with history
SEQ_UNROLL, SEQ_B = 24, 128


def text_corpus(root, n_docs, n_words, n_classes, seed):
    """``root/<class>/<i>.txt``, news20's layout: documents of 300-700
    words drawn from a Zipf law over ``n_words`` words (w0, w1, ...),
    with capitals, digits and punctuation for the normalizer to strip.
    Returns the number of distinct words written."""
    import numpy as np
    rs = np.random.RandomState(seed)
    seen = set()
    for c in range(n_classes):
        os.makedirs(os.path.join(root, f"class{c:02d}"))
    for i in range(n_docs):
        ids = (rs.zipf(1.2, rs.randint(300, 700)) - 1) % n_words
        seen.update(ids.tolist())
        words = [f"W{j}" if j % 7 == 0 else f"w{j}" for j in ids]
        words[::50] = [str(j) for j in ids[::50]]
        with open(os.path.join(root, f"class{i % n_classes:02d}",
                               f"{i}.txt"), "w") as f:
            f.write(" ".join(words) + ". The end!")
    return len(seen)


def _steps_timing(torch, fit_one, steps):
    """``timed`` of one-step fits, and its step numbers."""
    t = timed(torch, fit_one, steps, warmup=1)
    return {"wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
            "device_ms": t["device_ms"],
            "device_busy_share": t["device_busy_share"],
            "device_launches": t["device_launches"],
            "top_device_ms": [[k[:80], v] for k, v in sorted(
                t["by_name"].items(), key=lambda kv: -kv[1])[:8]],
            "top_host_ms": [[k[:80], v] for k, v in sorted(
                t["host_by_name"].items(), key=lambda kv: -kv[1])[:8]]}


def phase_text_main(torch, K, card):
    """``text-main``: a news20-shaped corpus through ``TextSet.read`` ->
    ``tokenize().normalize().word2idx(max_words_num=5000)
    .shape_sequence(500)`` -> ``TextClassifier`` at :data:`TEXT_CFG`
    for each of the cnn, lstm and gru encoders: TEXT_STEPS ``fit``
    steps through the kernels and, from the same weights, through every
    plain version (losses within 1e-4 relative: the dropout kernel is
    bit-equal to its plain version), the dropout kernel launched twice a
    step (forward, backward), then step ms, samples/s, busy share and
    device launches a step, and a ``predict`` of the corpus (finite
    probabilities of shape (docs, 20), rows summing to 1). Returns each
    encoder's launches of the kernel run."""
    import tempfile

    import numpy as np
    from zoo_tpu_torch.feature.text import TextSet
    from zoo_tpu_torch.models.textclassification import TextClassifier
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        distinct = text_corpus(root, TEXT_DOCS, TEXT_WORDS,
                               TEXT_CFG["class_num"], seed=0)
        ts = TextSet.read(root).tokenize().normalize() \
            .word2idx(max_words_num=5000) \
            .shape_sequence(TEXT_CFG["sequence_length"])
    x, y = ts.to_arrays()
    prep_s = time.perf_counter() - t0
    vocab = len(ts.get_word_index()) + 1
    emit({"phase": "text-main", "corpus": {
        "documents": len(ts), "distinct_words": distinct,
        "word_index": vocab - 1, "x": list(x.shape), "prep_s": prep_s}})
    if distinct < 5000 or vocab != 5001 or x.shape != (
            TEXT_DOCS, TEXT_CFG["sequence_length"]):
        raise AssertionError(f"text-main: corpus {distinct} words, index "
                             f"{vocab - 1}, x {x.shape}")
    out = {}
    for enc in ("cnn", "lstm", "gru"):
        m = TextClassifier(encoder=enc, vocab=vocab, **TEXT_CFG)
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
        t0 = time.perf_counter()
        m.build(torch.Generator(device="cuda").manual_seed(1),
                device="cuda")
        snapshot = [t.detach().clone() for t in tree_leaves(m.params)]
        m.fit(x[:TEXT_B], y[:TEXT_B], batch_size=TEXT_B, nb_epoch=1,
              shuffle=False, verbose=0, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        _restore(torch, m, snapshot)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, counts = _fit_losses(m, x, y, TEXT_B, TEXT_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _restore(torch, m, snapshot)
        plain, plain_counts = _fit_losses(m, x, y, TEXT_B, TEXT_STEPS,
                                          plain=True)
        rel = float(np.max(np.abs(np.subtract(losses, plain))
                           / np.abs(plain)))
        # one profiled step: a recurrent step is ~2.5 x 10^4 launches
        step = _steps_timing(
            torch, lambda: m.fit(x[:TEXT_B], y[:TEXT_B], batch_size=TEXT_B,
                                 nb_epoch=1, shuffle=False, verbose=0,
                                 device="cuda"), 1)
        t0 = time.perf_counter()
        probs = m.predict(x, batch_size=256, device="cuda")
        predict_s = time.perf_counter() - t0
        emit({"phase": "text-main", "encoder": enc, "card": card,
              "config": dict(TEXT_CFG, vocab=vocab), "batch": TEXT_B,
              "steps": TEXT_STEPS, "setup_s": setup_s,
              "step_ms": wall / TEXT_STEPS * 1e3,
              "samples_per_s": TEXT_B * TEXT_STEPS / wall,
              "losses": losses, "plain_losses": plain,
              "max_rel_loss_diff": rel,
              "launches_per_step": {k: v / TEXT_STEPS for k, v in
                                    counts.items() if v},
              "step": step, "predict_s": predict_s,
              "predict_samples_per_s": len(x) / predict_s})
        want = {"dropout": 2 * TEXT_STEPS, "derive_keys": 2 * TEXT_STEPS}
        got = {k: counts[k] for k in want}
        if not np.isfinite(losses).all() or rel > TOL["float32"]:
            raise AssertionError(f"text-main {enc}: losses {losses} vs "
                                 f"plain {plain}")
        if got != want or plain_counts["dropout"]:
            raise AssertionError(f"text-main {enc}: launches {got}, plain "
                                 f"{plain_counts['dropout']}; expected "
                                 f"{want}")
        if probs.shape != (len(x), TEXT_CFG["class_num"]) or \
                not np.isfinite(probs).all() or \
                np.abs(probs.sum(axis=1) - 1).max() > 1e-4:
            raise AssertionError(f"text-main {enc}: predict {probs.shape}")
        out[f"text_{enc}"] = counts
        del m, snapshot
        torch.cuda.empty_cache()
    return out


def anomaly_series(n=2000, n_anomalies=8, seed=0):
    """``examples/anomaly_detection.py``'s series: two sines, noise and
    planted spikes; returns the series and the spikes' indexes."""
    import numpy as np
    rs = np.random.RandomState(seed)
    t = np.arange(n)
    base = (np.sin(t * 2 * np.pi / 50) + 0.5 * np.sin(t * 2 * np.pi / 113)
            + 0.05 * rs.randn(n)).astype(np.float32)
    idx = rs.choice(np.arange(100, n - 100), n_anomalies, replace=False)
    base[idx] += rs.choice([-1, 1], n_anomalies) * rs.uniform(
        2.0, 3.0, n_anomalies).astype(np.float32)
    return base, set(int(i) for i in idx)


def phase_seq_tiny(torch, K, card):
    """``seq-tiny``: ``AnomalyDetector`` (unroll 24, B=128, three stacked
    LSTMs each with dropout 0.2, Adam, MSE: the repo's example) and a
    ``SessionRecommender`` with history: a short ``fit`` and a
    ``predict`` each, through the kernels and, from the same weights,
    through the plain versions (losses within 1e-4 relative). The
    detector's dropouts launch the kernel 2 x 3 times a step. Returns
    the launches of both kernel runs."""
    import numpy as np
    from zoo_tpu_torch.models.anomalydetection import AnomalyDetector
    from zoo_tpu_torch.models.recommendation import SessionRecommender
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves

    series, _ = anomaly_series()
    x, y = AnomalyDetector.unroll(series, SEQ_UNROLL)
    rs = np.random.RandomState(2)
    sess = rs.randint(1, 301, (4 * SEQ_B, 10)).astype(np.int32)
    hist = rs.randint(1, 301, (4 * SEQ_B, 5)).astype(np.int32)
    nxt = rs.randint(1, 301, 4 * SEQ_B).astype(np.int32)
    out = {}
    for name, m, xs, ys, loss, n_drop in (
            ("anomaly", AnomalyDetector((SEQ_UNROLL, 1)), x, y, "mse", 3),
            ("session", SessionRecommender(300, item_embed=32,
                                           include_history=True),
             [sess, hist], nxt, "sparse_categorical_crossentropy", 0)):
        m.compile(optimizer="adam", loss=loss)
        m.build(torch.Generator(device="cuda").manual_seed(3),
                device="cuda")
        snapshot = [t.detach().clone() for t in tree_leaves(m.params)]
        first = [a[:4 * SEQ_B] for a in xs] if isinstance(xs, list) \
            else xs[:4 * SEQ_B]
        runs = {}
        for plain in (False, True):
            _restore(torch, m, snapshot)
            K.reset_launch_counts()
            with plain_kernels() if plain else contextlib.nullcontext():
                t0 = time.perf_counter()
                h = m.fit(first, ys[:4 * SEQ_B], batch_size=SEQ_B,
                          nb_epoch=2, shuffle=True, seed=0, verbose=0,
                          device="cuda")
                torch.cuda.synchronize()
                runs[plain] = (h["loss"], K.launch_counts(),
                               time.perf_counter() - t0)
        (losses, counts, wall), (plain_losses, _, _) = runs[False], \
            runs[True]
        K.reset_launch_counts()
        pred = m.predict(xs, batch_size=256, device="cuda")
        rel = float(np.max(np.abs(np.subtract(losses, plain_losses))
                           / np.abs(plain_losses)))
        extra = {}
        if name == "anomaly":
            anoms = m.detect_anomalies(y, pred, anomaly_size=12)
            extra["flagged"] = sorted(int(a) + SEQ_UNROLL for a in anoms)
        else:
            extra["top3"] = m.recommend_for_session(
                [sess[:2], hist[:2]], 3, device="cuda")
        emit({"phase": "seq-tiny", "model": name, "card": card,
              "batch": SEQ_B, "steps": 8, "fit_s": wall,
              "step_ms": wall / 8 * 1e3, "losses": losses,
              "plain_losses": plain_losses, "max_rel_loss_diff": rel,
              "launches": {k: v for k, v in counts.items() if v},
              "predict_shape": list(pred.shape), **extra})
        if not np.isfinite(losses).all() or rel > TOL["float32"] or \
                not np.isfinite(pred).all():
            raise AssertionError(f"seq-tiny {name}: losses {losses} vs "
                                 f"plain {plain_losses}")
        if counts["dropout"] != 2 * n_drop * 8:
            raise AssertionError(f"seq-tiny {name}: {counts['dropout']} "
                                 f"dropout launches, expected "
                                 f"{2 * n_drop * 8}")
        out[f"seq_{name}"] = counts
    return out


# chronos-main: NAB's nyc_taxi.csv length (10,320 half-hourly points,
# the series the Chronos quick start forecasts), lookback one day, the
# forecasters at the JAX package's default widths at docs/chronos.md's
# example batch; the last tenth of the windows held out
CHRONOS_POINTS, CHRONOS_LOOKBACK, CHRONOS_B, CHRONOS_STEPS = 10320, 48, 64, 8
# examples/tcmf_panel_forecast.py's panel and fits
TCMF_SERIES, TCMF_T, TCMF_HORIZON, TCMF_RANK = 500, 240, 8, 2
TCMF_TCN = dict(tcn_epochs=150, dropout=0.0, lr=2e-3, kernel_size=4)
# examples/autots_forecasting.py's series and search
AUTOTS_POINTS, AUTOTS_TRIALS, AUTOTS_EPOCHS = 600, 4, 3


def chronos_series(n=CHRONOS_POINTS, seed=0):
    """Half-hourly daily and weekly sines plus noise from 2014-07-01
    (nyc_taxi's first stamp), with HOUR and WEEKDAY (scaled to [0, 1])
    from :func:`~zoo_tpu_torch.chronos.data.dt_features`: the (n, 3)
    inputs, target first."""
    import numpy as np
    from zoo_tpu_torch.chronos.data import dt_features
    rs = np.random.RandomState(seed)
    t = np.arange(n)
    value = (np.sin(t * 2 * np.pi / 48) + 0.5 * np.sin(t * 2 * np.pi / 336)
             + 0.1 * rs.randn(n))
    stamps = np.datetime64("2014-07-01T00:00") + \
        t.astype("timedelta64[m]") * 30
    f = dt_features(stamps, ["HOUR", "WEEKDAY"])
    return np.stack([value, f["HOUR"] / 23.0, f["WEEKDAY"] / 6.0],
                    axis=1).astype(np.float32)


def tcmf_panel(n_series=TCMF_SERIES, t=TCMF_T, seed=0):
    """``examples/tcmf_panel_forecast.py``'s ``make_panel``: a panel
    driven by two threshold-AR factors."""
    import numpy as np
    rs = np.random.RandomState(seed)
    x1 = np.empty(t, np.float32)
    x1[0] = 0.2
    for i in range(1, t):
        x1[i] = 0.95 * x1[i - 1] + (0.4 if x1[i - 1] < 0 else -0.4)
    x2 = np.empty(t, np.float32)
    x2[0] = -0.3
    for i in range(1, t):
        x2[i] = 0.9 * x2[i - 1] + (0.5 if x2[i - 1] < 0.1 else -0.6)
    F = rs.randn(n_series, 2).astype(np.float32)
    return (F @ np.stack([x1, x2]) + 0.01 * rs.randn(n_series, t)).astype(
        np.float32)


def _chronos_forecasters():
    """(name, forecaster, horizon, dropout sites): the four neural
    forecasters at their defaults' widths."""
    from zoo_tpu_torch.chronos.forecaster import (
        LSTMForecaster,
        MTNetForecaster,
        Seq2SeqForecaster,
        TCNForecaster,
    )
    L = CHRONOS_LOOKBACK
    return (("lstm", LSTMForecaster(L, 3, 1, hidden_dim=32, dropout=0.1,
                                    device="cuda"), 1, 1),
            ("tcn", TCNForecaster(L, 4, 3, 1, num_channels=[30, 30],
                                  kernel_size=3, dropout=0.1,
                                  device="cuda"), 4, 2),
            ("seq2seq", Seq2SeqForecaster(L, 4, 3, 1, lstm_hidden_dim=64,
                                          device="cuda"), 4, 0),
            ("mtnet", MTNetForecaster(target_dim=1, feature_dim=3,
                                      long_series_num=1,
                                      series_length=L // 2,
                                      cnn_hid_size=32, rnn_hid_size=32,
                                      device="cuda"), 1, 0))


def _chronos_tcmf(K):
    """TCMF on the example's panel, ``ar`` and ``tcn``: the held-out
    horizon's MSE of each (the example's check: tcn < ar)."""
    import numpy as np
    from zoo_tpu_torch.chronos.forecaster import TCMFForecaster
    Y = tcmf_panel()
    train, test = Y[:, :-TCMF_HORIZON], Y[:, -TCMF_HORIZON:]
    out = {}
    for tm, kw in (("ar", {}), ("tcn", TCMF_TCN)):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        f = TCMFForecaster(rank=TCMF_RANK, ar_lag=8, temporal_model=tm,
                           device="cuda", **kw)
        fit = f.fit({"y": train})
        pred = f.predict(horizon=TCMF_HORIZON)
        out[tm] = {"fit_s": time.perf_counter() - t0,
                   "reconstruction_mse": fit["mse"],
                   "forecast_mse": float(np.mean((pred - test) ** 2)),
                   "launches": {k: v for k, v in K.launch_counts().items()
                                if v}}
    return out


def _chronos_autots():
    """``examples/autots_forecasting.py``'s search from numpy columns:
    LSTM, lookback 24, ``hidden_dim`` in {16, 32}, ``lr`` log-uniform in
    [1e-3, 1e-2], 4 trials of 3 epochs with TPE (``n_parallel=2`` asked,
    which a model-based search runs one trial at a time), then the same
    search at random over 2 threads on the card; each best pipeline
    saved, loaded and predicting as before, its held-out mse under the
    example's 0.5."""
    import tempfile

    import numpy as np
    from zoo_tpu_torch.automl import hp
    from zoo_tpu_torch.chronos.autots import AutoTSEstimator, TSPipeline
    from zoo_tpu_torch.chronos.data import TSDataset
    rs = np.random.RandomState(0)
    t = np.arange(AUTOTS_POINTS)
    value = (np.sin(t * 2 * np.pi / 24) + 0.3 * np.sin(t * 2 * np.pi / 168)
             + 0.1 * rs.randn(AUTOTS_POINTS)).astype(np.float32)
    stamps = np.datetime64("2024-01-01T00") + t.astype("timedelta64[h]")
    cut = int(AUTOTS_POINTS * 0.8)
    out = {}
    for alg in ("tpe", None):
        def data(lo, hi):
            return TSDataset.from_numpy({"datetime": stamps[lo:hi],
                                         "value": value[lo:hi]},
                                        "datetime", "value")
        train, val = data(0, cut), data(cut, AUTOTS_POINTS)
        est = AutoTSEstimator(
            "lstm", {"hidden_dim": hp.choice([16, 32]),
                     "lr": hp.loguniform(1e-3, 1e-2)},
            past_seq_len=24, future_seq_len=1)
        t0 = time.perf_counter()
        pipe = est.fit(train, validation_data=val, epochs=AUTOTS_EPOCHS,
                       n_sampling=AUTOTS_TRIALS, search_alg=alg,
                       n_parallel=2, device="cuda")
        search_s = time.perf_counter() - t0
        res = pipe.evaluate(val, metrics=["mse", "smape"])
        pred = pipe.predict(val)
        with tempfile.TemporaryDirectory() as d:
            pipe.save(d)
            again = TSPipeline.load(d, device="cuda").predict(val)
        out[alg or "random"] = {
            "search_s": search_s, "best_config": pipe.best_config,
            "mse": res["mse"], "smape": res["smape"],
            "predict_shape": list(pred.shape),
            "reload_equal": bool(np.array_equal(pred, again))}
    return out


def phase_chronos_main(torch, K, card):
    """``chronos-main``: Chronos forecasting on the card, no pandas,
    scikit-learn, prophet or ray. The LSTM (hidden 32, dropout 0.1), TCN
    ([30, 30], k = 3, dropout 0.1), Seq2Seq (hidden 64) and MTNet (one
    memory block of 24 steps, 32/32) forecasters on
    :func:`chronos_series`'s windows (lookback 48; horizon 1 for LSTM
    and MTNet, 4 for TCN and Seq2Seq), B = 64: CHRONOS_STEPS steps
    through the kernels and, from the same weights, through the plain
    versions (losses within ``TOL["float32"]`` relative), the dropout
    kernel launched 2 times a step a dropout site and the key kernel
    once a step plus once a site (the fit's split, each dropout's
    ``layer_rng``; the Seq2Seq and MTNet steps launch the key chain's
    split alone); a profiled step; one whole epoch on the kernel path
    and ``evaluate`` on the held-out tenth. Then TCMF on the example's
    panel (tcn's forecast MSE under ar's), the AutoTS search of
    ``examples/autots_forecasting.py`` (mse < 0.5, a pipeline predicting
    the same after save and load) and ``AEDetector`` (roll 24) on
    :func:`anomaly_series`. Returns the kernel-path launches of each
    forecaster's steps, of TCMF's TCN fit and of the searches."""
    import numpy as np
    from zoo_tpu_torch.chronos.data import roll_windows
    from zoo_tpu_torch.chronos.detector import AEDetector
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves

    series = chronos_series()
    out = {}
    B, steps = CHRONOS_B, CHRONOS_STEPS
    for name, f, horizon, sites in _chronos_forecasters():
        x, y = roll_windows(series, series[:, :1], CHRONOS_LOOKBACK,
                            horizon)
        n_train = len(x) - len(x) // 10
        m = f._ensure_model()
        m.build(torch.Generator(device="cuda").manual_seed(7),
                device="cuda")
        snapshot = [t.detach().clone() for t in tree_leaves(m.params)]
        runs = {}
        for plain in (False, True):
            _restore(torch, m, snapshot)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            with plain_kernels() if plain else contextlib.nullcontext():
                t0 = time.perf_counter()
                h = f.fit((x[:B], y[:B]), epochs=steps, batch_size=B)
                torch.cuda.synchronize()
                runs[plain] = (h["loss"], K.launch_counts(),
                               time.perf_counter() - t0)
        (losses, counts, wall), (plain_losses, plain_counts, _) = \
            runs[False], runs[True]
        rel = float(np.max(np.abs(np.subtract(losses, plain_losses))
                           / np.abs(plain_losses)))
        _restore(torch, m, snapshot)
        step = _steps_timing(
            torch, lambda: f.fit((x[:B], y[:B]), epochs=1, batch_size=B), 1)
        _restore(torch, m, snapshot)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        f.fit((x[:n_train], y[:n_train]), epochs=1, batch_size=B)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        epoch_counts = K.launch_counts()
        held = f.evaluate((x[n_train:], y[n_train:]),
                          metrics=["mse", "smape"])
        pred = f.predict(x[n_train:])
        n_steps = n_train // B
        emit({"phase": "chronos-main", "forecaster": name, "card": card,
              "windows": len(x), "train_windows": n_train,
              "lookback": CHRONOS_LOOKBACK, "horizon": horizon,
              "batch": B, "steps": steps, "step_ms": wall / steps * 1e3,
              "losses": losses, "plain_losses": plain_losses,
              "max_rel_loss_diff": rel,
              "launches": {k: v for k, v in counts.items() if v},
              "step": step, "epoch_steps": n_steps, "fit_s": fit_s,
              "epoch_samples_per_s": n_steps * B / fit_s,
              "epoch_launches": {k: v for k, v in epoch_counts.items()
                                 if v},
              "held_out": held, "predict_shape": list(pred.shape)})
        want = {"dropout": 2 * sites * steps,
                "derive_keys": (1 + sites) * steps}
        got = {k: counts[k] for k in want}
        if not np.isfinite(losses).all() or rel > TOL["float32"]:
            raise AssertionError(f"chronos-main {name}: losses {losses} "
                                 f"vs plain {plain_losses}")
        if got != want or any(plain_counts.values()) or any(
                v for k, v in counts.items() if k not in want):
            raise AssertionError(f"chronos-main {name}: launches {counts},"
                                 f" plain {plain_counts}; expected {want}")
        if epoch_counts["dropout"] != 2 * sites * n_steps or \
                epoch_counts["derive_keys"] != (1 + sites) * n_steps:
            raise AssertionError(f"chronos-main {name}: epoch launches "
                                 f"{epoch_counts} over {n_steps} steps")
        if pred.shape != (len(x) - n_train, horizon, 1) or \
                not np.isfinite(pred).all() or \
                not np.isfinite(list(held.values())).all():
            raise AssertionError(f"chronos-main {name}: predict "
                                 f"{pred.shape}, held-out {held}")
        out[f"chronos_{name}"] = counts
        del f, m, snapshot
        torch.cuda.empty_cache()

    tcmf = _chronos_tcmf(K)
    emit({"phase": "chronos-main", "tcmf": tcmf, "card": card,
          "panel": [TCMF_SERIES, TCMF_T], "horizon": TCMF_HORIZON,
          "rank": TCMF_RANK})
    if not tcmf["tcn"]["forecast_mse"] < tcmf["ar"]["forecast_mse"]:
        raise AssertionError(f"chronos-main tcmf: tcn {tcmf['tcn']} not "
                             f"under ar {tcmf['ar']}")
    want = {"derive_keys": TCMF_TCN["tcn_epochs"]}
    if tcmf["tcn"]["launches"] != want or tcmf["ar"]["launches"]:
        raise AssertionError(f"chronos-main tcmf: launches "
                             f"{tcmf['tcn']['launches']}, expected {want}")
    out["chronos_tcmf"] = tcmf["tcn"]["launches"]

    K.reset_launch_counts()
    autots = _chronos_autots()
    counts = K.launch_counts()
    emit({"phase": "chronos-main", "autots": autots, "card": card,
          "launches": {k: v for k, v in counts.items() if v}})
    for alg, r in autots.items():
        if not r["mse"] < 0.5 or not r["reload_equal"] or \
                r["predict_shape"][1:] != [1, 1]:
            raise AssertionError(f"chronos-main autots {alg}: {r}")
    if not counts["dropout"] or not counts["derive_keys"]:
        raise AssertionError(f"chronos-main autots: launches {counts}")
    out["chronos_autots"] = counts

    series, spikes = anomaly_series()
    t0 = time.perf_counter()
    det = AEDetector(roll_len=24, device="cuda").fit(series)
    found = sorted(set(int(i) for i in det.anomaly_indexes()) & spikes)
    emit({"phase": "chronos-main", "detector": "ae", "card": card,
          "roll_len": 24, "fit_s": time.perf_counter() - t0,
          "flagged": int(len(det.anomaly_indexes())),
          "planted": sorted(spikes), "planted_flagged": found})
    if not np.isfinite(det.score()).all():
        raise AssertionError("chronos-main ae: non-finite scores")
    return out


ESTIMATOR_EPOCHS = 3
# BERT-base through the estimator: run (b)'s S and B, 4 steps an epoch
ESTIMATOR_BERT_STEPS = 4
ESTIMATOR_BERT_EPOCHS = 2
# bench.py bench_guard's mix (:645-690)
GUARD_MIX = dict(n=16384, feat=64, batch_size=512, epochs=3, reps=3)
# bf16 BERT losses, kernel path vs plain path (train-bert-tiny's bf16 bar)
TOL_BERT_BF16_LOSS = 2e-2


def _sync_warnings(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result, the number of synchronizing-operation warnings it raised
    (stream synchronisations and blocking copies between host and
    device; an event wait is not one) and their count by the Python
    line that raised each."""
    import collections
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    where = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs)
    return out, len(syncs), dict(where)


def _epoch_host_syncs(model, arrs, batch_size, n_batches):
    """What one epoch of ``fit`` may make the host wait for: the guard's
    reads (one at every ``check_every``-th superbatch boundary and one at
    the epoch's end; 0 without a guard), and the most synchronizing
    operations sync-debug mode may see (a copy of each array of each
    host superbatch, and the epoch's loss read). A guard read at every
    step exceeds the first, any sync at every step the second."""
    supers = -(-n_batches // model._superbatch_group(arrs, batch_size,
                                                     n_batches))
    guard = model._active_guard()
    reads = 0 if guard is None else supers // guard.config.check_every + 1
    return {"boundary_reads_expected": reads,
            "sync_warnings_max": supers * len(arrs) + 1}


def _host_syncs_ok(sync):
    return all(v["boundary_reads"] == v["boundary_reads_expected"]
               and v["sync_warnings"] <= v["sync_warnings_max"]
               for v in sync.values()) and sync["on"]["boundary_reads"]


def _est_leaves(torch, tree):
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    return [t.detach().clone() for t in tree_leaves(tree)]


def _bit_equal(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_estimator_tiny(torch, K):
    """The estimator's path at a small width on the card: a tiny BERT
    (train-bert-tiny's config, S=512 so ``auto`` takes the flash kernels,
    f32) through ``Estimator.from_keras`` with its default guard, a
    model_dir, ``AdamWeightDecay(fused=True)`` and L2 clipping 1.0, two
    epochs, against the same estimator run through the plain versions
    (dense attention, ``plain_kernels()``); then a poisoned superbatch
    (a NaN planted in the output layer's bias, restored after) leaves
    params, m, v and the device step bit-equal while the AdamW kernel
    still launches. Returns the kernel path's launches."""
    import numpy as np
    import tempfile
    from zoo_tpu_torch.orca.learn.keras import Estimator
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay
    from zoo_tpu_torch.util.resilience import inject
    cfg = dict(vocab=256, hidden_size=64, n_block=2, n_head=4,
               intermediate_size=128, hidden_p_drop=0.0, attn_p_drop=0.0)
    S, B, N = 512, 4, 16
    rs = np.random.RandomState(3)
    data = {"x": rs.randint(0, cfg["vocab"], (N, S)).astype(np.int32),
            "y": rs.randint(0, 2, N).astype(np.int32)}
    start, out = None, {}
    for label, impl in (("kernels", "auto"), ("plain", "dense")):
        m = _bert_sequential(S, impl, **cfg)
        m.compile(AdamWeightDecay(lr=1e-3, fused=True), LOSS)
        if start is None:
            start = tree_map(torch.clone, m.build(
                torch.Generator(device="cuda").manual_seed(0),
                device="cuda"))
        m.params = tree_map(torch.clone, start)
        with tempfile.TemporaryDirectory() as d:
            est = Estimator.from_keras(m, model_dir=d)
            est.set_l2_norm_gradient_clipping(1.0)
            K.reset_launch_counts()
            ctx = plain_kernels() if label == "plain" else \
                contextlib.nullcontext()
            with ctx:
                hist = est.fit(data, epochs=2, batch_size=B)
            torch.cuda.synchronize()
            counts = K.launch_counts()
            steps = est._ckpt.all_steps()
        out[label] = (hist["loss"], _est_leaves(torch, m.params), counts,
                      m.layers[0].last_attention_impl, steps)
    (lk, pk, ck, ik, sk), (lp, pp, cp, ip, sp) = out["kernels"], out["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    param_err = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
    n_leaves = len(pk)
    steps = 2 * (N // B)
    want = {"flash_attention": cfg["n_block"] * steps,
            "flash_attention_dkdv": cfg["n_block"] * steps,
            "flash_attention_dq": cfg["n_block"] * steps,
            "fused_adam": n_leaves * steps}
    got = {k: ck[k] for k in want}
    emit({"phase": "estimator-tiny", "loss_kernels": lk, "loss_plain": lp,
          "loss_max_rel": loss_rel, "param_max_abs": param_err,
          "attention_impl": [ik, ip], "checkpoint_steps": sk,
          "launches": {k: v for k, v in ck.items() if v},
          "launches_plain": {k: v for k, v in cp.items() if v}})
    if not (loss_rel <= 1e-4 and param_err <= 1e-4) or \
            (ik, ip) != ("flash", "dense") or sk != sp or sk != [0, 1, 2]:
        raise AssertionError(f"estimator-tiny: kernel path differs from "
                             f"plain: loss rel {loss_rel}, params "
                             f"{param_err}, impls {ik} {ip}, steps {sk}")
    if got != want or any(cp[k] for k in want):
        raise AssertionError(f"estimator-tiny: launches {got} (plain "
                             f"{cp}), expected {want}")
    # a poisoned superbatch: NaN features cannot enter int ids, so the
    # poison is a NaN planted in the output bias for the epoch (the
    # loss and every gradient turn NaN), then restored
    m = _bert_sequential(S, "auto", **cfg)
    m.compile(AdamWeightDecay(lr=1e-3, fused=True), LOSS)
    m.params = tree_map(torch.clone, start)
    with tempfile.TemporaryDirectory() as d:
        est = Estimator.from_keras(m, model_dir=d)
        est.fit(data, epochs=1, batch_size=B)
        skipped = _poisoned_epoch(torch, K, est, data, B)
    emit({"phase": "estimator-tiny", "poisoned_epoch": skipped})
    return ck


def _poisoned_epoch(torch, K, est, data, batch_size):
    """One estimator epoch with a NaN planted in the last layer's bias
    by the ``fit.batch`` seam (so each of the superbatch's steps has a
    NaN loss and NaN gradients), removed again before the bias is read:
    every param, m, v and the device step bit-equal to before the
    epoch, every step skipped, the AdamW kernel launched for each leaf
    and step all the same."""
    from zoo_tpu_torch.util.resilience import inject
    model = est.model
    key = sorted(model.params)[-1]
    before = (_est_leaves(torch, model.params),
              _est_leaves(torch, model._opt_state))
    bias = model.params[key]["b"]
    saved = bias.detach().clone()
    guard = est._guard
    skipped0 = guard.nonfinite_steps

    def plant(site=None, arrays=None, idx=None, **_):
        with torch.no_grad():
            bias.fill_(float("nan"))

    K.reset_launch_counts()
    with inject("fit.batch", action=plant, exc=None, times=1):
        hist = est.fit(data, epochs=1, batch_size=batch_size)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    with torch.no_grad():
        nan_left = bool(torch.isnan(bias).any())
        bias.copy_(saved)
    after = (_est_leaves(torch, model.params),
             _est_leaves(torch, model._opt_state))
    steps = len(data["y"]) // batch_size
    n_leaves = len(before[0])
    skipped = guard.nonfinite_steps - skipped0
    result = {"steps": steps, "skipped": skipped, "loss": hist["loss"],
              "params_bit_equal": _bit_equal(torch, before[0], after[0]),
              "optimizer_state_bit_equal": _bit_equal(torch, before[1],
                                                      after[1]),
              "fused_adam_launches": counts["fused_adam"],
              "nan_bias_left": nan_left}
    if not (result["params_bit_equal"] and
            result["optimizer_state_bit_equal"] and skipped == steps
            and nan_left and counts["fused_adam"] == n_leaves * steps):
        raise AssertionError(f"poisoned epoch: {result}")
    return result


def phase_estimator_main(torch, K, card):
    """The NCF flagship (``NCF_CFG``) through ``Estimator.from_keras(m,
    model_dir=tmp)`` with the default guard at ``bench_ncf``'s B=8192:
    96 training batches an epoch and a tenth of the rows held out for
    validation, EveryEpoch checkpoints and summaries. A straight run of
    4 epochs (samples/s each); (b) an exception injected at epoch 2's
    first superbatch, retried from the epoch-1 checkpoint, ends bit-equal
    to the straight run's epoch 3; (c) a fresh estimator's
    ``load_orca_checkpoint()`` and one more epoch, bit-equal to its epoch
    4; (a) a NaN superbatch (NaN planted in the output bias) skipped:
    params, Adam's mu/nu/count and the loss sum finite and unchanged by
    it, the quarantine journal recording it; (d) ``val_accuracy`` and
    ``val_loss`` read back from the summary files. Then samples/s and
    synchronizing-operation warnings over one epoch with the guard on
    and off: the guard adds none. NCF runs no kernel: every count stays
    0 but the key chain's, one split a step. Returns the launches."""
    import json
    import numpy as np
    import tempfile
    from zoo_tpu_torch.models.recommendation import NeuralCF
    from zoo_tpu_torch.orca.learn.keras import Estimator
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map
    from zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from zoo_tpu_torch.tensorboard import read_scalars
    from zoo_tpu_torch.util.resilience import inject

    B = NCF_B
    n_train = B * NCF_STEPS
    n_val = n_train // 9                      # 10 % of all the rows
    rs = np.random.RandomState(0)                           # bench.py:338
    n = n_train + n_val
    x = np.stack([rs.randint(0, NCF_CFG["user_count"], n),
                  rs.randint(0, NCF_CFG["item_count"], n)],
                 axis=1).astype(np.int32)
    y = rs.randint(0, NCF_CFG["class_num"], n).astype(np.int32)
    data = {"x": x[:n_train], "y": y[:n_train]}
    val = (x[n_train:], y[n_train:])

    def model():
        m = NeuralCF(**NCF_CFG)
        return m.compile(optimizer=Adam(lr=0.001),
                         loss="sparse_categorical_crossentropy",
                         metrics=["accuracy"])

    start = tree_map(torch.clone, model().build(
        torch.Generator(device="cuda").manual_seed(0), device="cuda"))

    def estimator(d, **kw):
        m = model()
        m.params = tree_map(torch.clone, start)
        return Estimator.from_keras(m, model_dir=d, **kw)

    root = tempfile.mkdtemp(prefix="zoo-estimator-")
    try:
        K.reset_launch_counts()
        a = estimator(os.path.join(root, "a"))
        rates_, hist = [], {}
        snaps = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = a.fit(data, epochs=1, batch_size=B, validation_data=val)
            torch.cuda.synchronize()
            rates_.append(n_train / (time.perf_counter() - t0))
            for k, v in h.items():
                hist.setdefault(k, []).extend(v)
            snaps.append((_est_leaves(torch, a.model.params),
                          _est_leaves(torch, a.model._opt_state)))
        counts = K.launch_counts()
        fit_steps = a.model._step
        # (b) retry from the verified checkpoint
        b = estimator(os.path.join(root, "b"))
        b.fit(data, epochs=1, batch_size=B, validation_data=val)
        with inject("fit.batch", exc=RuntimeError("injected"),
                    times=1) as armed:
            b.fit(data, epochs=2, batch_size=B, validation_data=val)
        retry = {"fired": armed.fired, "epoch": b._epoch,
                 "params_bit_equal": _bit_equal(
                     torch, _est_leaves(torch, b.model.params), snaps[2][0]),
                 "optimizer_state_bit_equal": _bit_equal(
                     torch, _est_leaves(torch, b.model._opt_state),
                     snaps[2][1])}
        # (c) a fresh estimator resumes the checkpoint dir
        c = estimator(os.path.join(root, "c"))
        c.load_orca_checkpoint(os.path.join(root, "b"))
        resumed_at = c._epoch
        c.fit(data, epochs=1, batch_size=B, validation_data=val)
        resume = {"from_epoch": resumed_at,
                  "params_bit_equal": _bit_equal(
                      torch, _est_leaves(torch, c.model.params), snaps[3][0]),
                  "optimizer_state_bit_equal": _bit_equal(
                      torch, _est_leaves(torch, c.model._opt_state),
                      snaps[3][1])}
        # (a) a NaN superbatch is skipped
        poisoned = _poisoned_superbatch(torch, c, data, B, val)
        # (d) the validation series from the event files, once the
        # writers have flushed and closed them
        a.model.train_summary.close()
        a.model.validation_summary.close()
        on_disk = read_scalars(os.path.join(root, "a", "summaries", "val"))
        read_back = {k: [v for _, _, v in on_disk.get(k, [])]
                     for k in ("accuracy", "loss")}
        # guard on / off: samples/s and synchronizing operations, one
        # epoch each, in turns (off, on, off, on) on two warmed models
        sync = {}
        models = {}
        for label, guard in (("off", False), ("on", None)):
            e = estimator(os.path.join(root, "sync-" + label), guard=guard)
            e.fit(data, epochs=1, batch_size=B)        # warm
            models[label] = e.model
            # and once under the sync-debug mode, uncounted: anything
            # that warns once a process or a model stays out of the turns
            _sync_warnings(torch, lambda: e.model.fit(
                data, batch_size=B, nb_epoch=1, verbose=0, device="cuda"))
        for label in ("off", "on", "off_again", "on_again"):
            m = models[label.split("_")[0]]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, warned, where = _sync_warnings(torch, lambda: m.fit(
                data, batch_size=B, nb_epoch=1, verbose=0, device="cuda"))
            torch.cuda.synchronize()
            sync[label] = {"samples_per_s": n_train / (time.perf_counter()
                                                       - t0),
                           "sync_warnings": warned, "sync_sources": where,
                           "boundary_reads": m.boundary_reads,
                           **_epoch_host_syncs(m, [data["x"], data["y"]], B,
                                               NCF_STEPS)}
        journal = [json.loads(line) for line in open(os.path.join(
            root, "c", "guard", "quarantine.jsonl"))]
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "estimator-main", "config": NCF_CFG, "card": card,
          "batch": B, "train_rows": n_train, "val_rows": n_val,
          "samples_per_s": rates_, "losses": hist["loss"],
          "val_loss": hist.get("val_loss"),
          "val_accuracy": hist.get("val_accuracy"),
          "summary_read_back": read_back, "retry": retry, "resume": resume,
          "poisoned": poisoned, "journal_events": [e["event"]
                                                   for e in journal],
          "guard": sync, "launches": {k: v for k, v in counts.items() if v}})
    if not _only_the_key_chain(counts, fit_steps):
        raise AssertionError(f"estimator-main: kernels launched {counts}; "
                             "NCF's path runs none but the key split")
    if not (all(np.isfinite(hist["loss"])) and retry["fired"] == 1
            and retry["epoch"] == 3 and retry["params_bit_equal"]
            and retry["optimizer_state_bit_equal"]):
        raise AssertionError(f"estimator-main: retry {retry}, losses "
                             f"{hist['loss']}")
    if not (resume["from_epoch"] == 3 and resume["params_bit_equal"]
            and resume["optimizer_state_bit_equal"]):
        raise AssertionError(f"estimator-main: resume {resume}")
    # an event file holds f32 scalars
    if read_back["accuracy"] != [float(np.float32(v)) for v in
                                 hist["val_accuracy"]] or \
            read_back["loss"] != [float(np.float32(v)) for v in
                                  hist["val_loss"]]:
        raise AssertionError(f"estimator-main: summaries {read_back} vs "
                             f"history {hist}")
    if "nonfinite_steps" not in [e["event"] for e in journal]:
        raise AssertionError(f"estimator-main: journal {journal}")
    if len({sync[k]["sync_warnings"] for k in sync}) != 1 or \
            not _host_syncs_ok(sync):
        raise AssertionError(f"estimator-main: the guard adds synchronizing "
                             f"operations: {sync}")
    return counts


def _poisoned_superbatch(torch, est, data, batch_size, val):
    """One epoch of ``est`` with the ``fit.batch`` seam poisoning the
    first host superbatch in place: every id of it is set out of range,
    so the ``Embedding`` gives NaN rows there (``jnp.take``'s fill mode)
    and that superbatch's steps are skipped, the rest train; the params,
    Adam's mu/nu/count and the epoch loss stay finite, and the count
    moves by the steps that were not skipped. The poison rides the
    batch: the seam runs on the feed's slice thread, a superbatch or two
    ahead of the step (as in the JAX ``fit``). A superbatch of 16
    skipped steps is a streak past the default ``max_skips`` (8), so the
    guard also rolls back to the epoch's starting checkpoint there and
    trains on from it: the count still moves by the good steps."""
    import math
    model = est.model
    count0 = int(model._opt_state["count"])
    calls = {"n": 0}

    def plant(site=None, arrays=None, idx=None, **_):
        calls["n"] += 1
        if calls["n"] == 1:
            arrays[0][...] = 1 << 30    # ids past every table

    from zoo_tpu_torch.util.resilience import inject
    skipped0 = est._guard.nonfinite_steps
    with inject("fit.batch", action=plant, exc=None):
        hist = est.fit(data, epochs=1, batch_size=batch_size,
                       validation_data=val)
    torch.cuda.synchronize()
    steps = len(data["y"]) // batch_size
    skipped = est._guard.nonfinite_steps - skipped0
    finite = all(bool(torch.isfinite(t).all()) for t in
                 _est_leaves(torch, model.params) +
                 _est_leaves(torch, model._opt_state))
    out = {"steps": steps, "skipped": skipped, "loss": hist["loss"],
           "count_moved": int(model._opt_state["count"]) - count0,
           "rollbacks": est._guard.rollbacks, "finite": finite}
    if not (finite and 0 < skipped < steps and
            out["count_moved"] == steps - skipped and
            all(math.isfinite(v) for v in hist["loss"])):
        raise AssertionError(f"poisoned superbatch: {out}")
    return out


def phase_estimator_bert(torch, K, card):
    """BERT-base (``BERT_CFG``) at run (b)'s shape (S=512, B=16,
    ``mixed_bfloat16``, the flash kernels) through
    ``Estimator.from_keras`` with ``AdamWeightDecay(lr=1e-4, fused=True)``,
    ``set_l2_norm_gradient_clipping(1.0)`` and the default guard (no
    model_dir: estimator-main covers checkpoints): a few epochs of a few
    steps, their losses against the same
    estimator run through the plain versions (dense attention,
    ``plain_kernels()``) within the bf16 loss bar; a poisoned epoch
    leaves every param, m, v and the device step bit-equal while the
    fused AdamW kernel launches for it; synchronizing operations over one
    epoch with the guard on equal those with it off. Returns the kernel
    path's launches (counted over the compared run)."""
    import numpy as np
    from zoo_tpu_torch.orca.learn.keras import Estimator
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay

    S, B = BERT_S, BERT_B
    N = ESTIMATOR_BERT_STEPS * B
    rs = np.random.RandomState(0)
    data = {"x": rs.randint(0, BERT_CFG["vocab"], (N, S)).astype(np.int32),
            "y": rs.randint(0, 2, N).astype(np.int32)}
    start, out = None, {}
    for label, impl in (("kernels", "auto"), ("plain", "dense")):
        m = _bert_sequential(S, impl, **BERT_CFG)
        m.compile(optimizer=AdamWeightDecay(lr=1e-4, fused=True),
                  loss=LOSS, dtype_policy="mixed_bfloat16")
        if start is None:
            start = tree_map(torch.clone, m.build(
                torch.Generator(device="cuda").manual_seed(0),
                device="cuda"))
        m.params = tree_map(torch.clone, start)
        # no model_dir: a BERT-base step's checkpoint is 1.3 GB and
        # takes ~5 s to write; estimator-main covers checkpoints
        est = Estimator.from_keras(m)
        est.set_l2_norm_gradient_clipping(1.0)
        ctx = plain_kernels() if label == "plain" else \
            contextlib.nullcontext()
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            hist = est.fit(data, epochs=ESTIMATOR_BERT_EPOCHS,
                           batch_size=B)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[label] = (hist["loss"], K.launch_counts(),
                      m.layers[0].last_attention_impl, wall, est)
        if label == "plain":
            del est, m
            torch.cuda.empty_cache()
    (lk, ck, ik, wk, est), (lp, cp, ip, wp, _) = out["kernels"], \
        out["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    n_leaves = len(_est_leaves(torch, est.model.params))
    steps = ESTIMATOR_BERT_STEPS * ESTIMATOR_BERT_EPOCHS
    L = BERT_CFG["n_block"]
    want = {"flash_attention": L * steps,
            "flash_attention_dkdv": L * steps,
            "flash_attention_dq": L * steps,
            "fused_adam": n_leaves * steps}
    got = {k: ck[k] for k in want}
    poisoned = _poisoned_epoch(torch, K, est, data, B)
    sync = {}
    for label in ("off", "on", "off_again"):
        if label.startswith("off"):
            est.model.clear_guard()
        else:
            est.model.set_guard(est._guard)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, warned, where = _sync_warnings(torch, lambda: est.model.fit(
            data, batch_size=B, nb_epoch=1, verbose=0, device="cuda"))
        torch.cuda.synchronize()
        sync[label] = {"samples_per_s": N / (time.perf_counter() - t0),
                       "sync_warnings": warned, "sync_sources": where,
                       "boundary_reads": est.model.boundary_reads,
                       **_epoch_host_syncs(est.model, [data["x"], data["y"]],
                                           B, ESTIMATOR_BERT_STEPS)}
    est.model.set_guard(est._guard)
    emit({"phase": "estimator-bert", "card": card,
          "config": dict(BERT_CFG, seq_len=S), "batch": B,
          "steps_per_epoch": ESTIMATOR_BERT_STEPS,
          "epochs": ESTIMATOR_BERT_EPOCHS, "leaves": n_leaves,
          "loss_kernels": lk, "loss_plain": lp, "loss_max_rel": loss_rel,
          "wall_s_kernels": wk, "wall_s_plain": wp,
          "attention_impl": [ik, ip], "poisoned_epoch": poisoned,
          "guard": sync, "launches": {k: v for k, v in ck.items() if v},
          "launches_plain": {k: v for k, v in cp.items() if v}})
    if not (loss_rel <= TOL_BERT_BF16_LOSS and all(np.isfinite(lk))) or \
            (ik, ip) != ("flash", "dense"):
        raise AssertionError(f"estimator-bert: losses {lk} vs plain {lp} "
                             f"(rel {loss_rel}), impls {ik} {ip}")
    if got != want or any(cp[k] for k in want):
        raise AssertionError(f"estimator-bert: launches {got} (plain {cp}), "
                             f"expected {want}")
    if not (sync["on"]["sync_warnings"] == sync["off"]["sync_warnings"]
            == sync["off_again"]["sync_warnings"]) or \
            not _host_syncs_ok(sync):
        raise AssertionError(f"estimator-bert: the guard adds synchronizing "
                             f"operations: {sync}")
    del est
    torch.cuda.empty_cache()
    return ck


def phase_bench_guard(torch, card):
    """``bench.py`` ``bench_guard``'s mix in the port: an MLP (Dense 256
    relu, Dense 256 relu, Dense 1; Adam; MSE) over n=16384 rows of 64
    features at B=512, 3 epochs a fit, guarded and unguarded fits
    interleaved 3 times; samples/s median and spread of each and
    ``guard_overhead_pct``. Printed, not gated."""
    import numpy as np
    from zoo_tpu_torch.orca.learn.guard import GuardConfig, TrainingGuard
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import Dense
    mix = GUARD_MIX
    n, feat, bs = mix["n"], mix["feat"], mix["batch_size"]
    rs = np.random.RandomState(0)
    x = rs.randn(n, feat).astype(np.float32)
    y = (x @ rs.randn(feat, 1)).astype(np.float32)

    def build(guarded):
        m = Sequential()
        m.add(Dense(256, input_shape=(feat,), activation="relu"))
        m.add(Dense(256, activation="relu"))
        m.add(Dense(1))
        m.compile(optimizer="adam", loss="mse")
        if guarded:
            m.set_guard(TrainingGuard(
                config=GuardConfig(enabled=True, preempt_signal="none")))
        m.fit(x, y, batch_size=bs, nb_epoch=1, shuffle=False, verbose=0,
              device="cuda")
        return m

    def stats(xs):
        xs = sorted(xs)
        med = xs[len(xs) // 2]
        return med, (xs[-1] - xs[0]) / med

    mu, mg = build(False), build(True)
    bare, guarded = [], []
    for _ in range(mix["reps"]):
        for m, into in ((mu, bare), (mg, guarded)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.fit(x, y, batch_size=bs, nb_epoch=mix["epochs"],
                  shuffle=False, verbose=0, device="cuda")
            torch.cuda.synchronize()
            into.append(n * mix["epochs"] / (time.perf_counter() - t0))
    (u50, usp), (g50, gsp) = stats(bare), stats(guarded)
    emit({"phase": "bench-guard", "card": card, "mix": mix,
          "guard_unguarded_samples_per_sec": u50,
          "guard_unguarded_spread": usp,
          "guard_guarded_samples_per_sec": g50,
          "guard_guarded_spread": gsp,
          "guard_overhead_pct": (u50 / g50 - 1.0) * 100,
          "unguarded": bare, "guarded": guarded})
    del mu, mg
    torch.cuda.empty_cache()


def drive(engine, prompts, n_new, budget=600.0, sampling=None):
    """Submit every prompt at once, wait for all streams; returns the
    handles and the wall time."""
    t0 = time.perf_counter()
    hs = [engine.submit(p, n_new, rid=f"q{i}", sampling=sampling)
          for i, p in enumerate(prompts)]
    _wait_done(hs, budget)
    return hs, time.perf_counter() - t0


def phase_tiny(torch, K):
    """Kernel path == plain path, token for token, at tiny width."""
    import numpy as np
    from zoo_tpu_torch.serving.llm import build_llm_engine

    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 256, (n,)) for n in (5, 40, 200)]
    plain = dict(decode_impl="dense", prefill_impl="dense",
                 attention_impl="dense")
    for spec in ("llama:tiny", "llama:tiny:chunk=4"):
        streams, counts, params = {}, None, None
        for label, kw in (("kernels", {}), ("plain", plain)):
            eng = build_llm_engine(spec, device="cuda", params=params, **kw)
            params = eng.model.params
            K.reset_launch_counts()
            try:
                hs, _ = drive(eng, prompts, 16)
            finally:
                eng.stop()
            if label == "kernels":
                counts = K.launch_counts()
            bad = [(h.outcome, h.error) for h in hs if h.outcome != "ok"]
            if bad:
                raise AssertionError(f"{spec} {label}: {bad}")
            streams[label] = [h.tokens for h in hs]
        equal = streams["kernels"] == streams["plain"]
        emit({"phase": "tiny", "spec": spec, "streams_equal": equal,
              "launches": counts})
        if not equal:
            raise AssertionError(f"{spec}: kernel streams differ from "
                                 f"plain: {streams}")
        need = ("paged_prefill",) if "chunk" in spec else \
            ("flash_attention",)
        for k in need + ("paged_decode",):
            if counts[k] <= 0:
                raise AssertionError(f"{spec}: {k} never launched")
    phase_tiny_spec(torch, K, plain)
    phase_tiny_wire(torch, K)
    phase_tiny_disagg(torch, K)
    phase_tiny_tenancy(torch, K)


def wire_streams(clients, prompts, n_new, sampling=None, stop_at=None):
    """Stream every prompt concurrently, one thread each, stream ``i``
    through ``clients[i]`` (an ``HAServingClient``). ``sampling`` is
    None or a list of per-stream dicts. ``stop_at = (i, k, fn)`` runs
    ``fn()`` on a thread of its own once stream ``i`` has received ``k``
    tokens (and joins it before returning). Returns per stream (tokens,
    arrival times, start time) and the moment ``fn`` started."""
    import threading
    out = [None] * len(prompts)
    errors, fired = [], {}

    def run(i):
        toks, times = [], []
        kw = sampling[i] if sampling else {}
        t0 = time.perf_counter()
        try:
            for tok in clients[i].generate(prompts[i], n_new, **kw):
                toks.append(tok)
                times.append(time.perf_counter())
                if stop_at and stop_at[0] == i and len(toks) == stop_at[1]:
                    fired["t"] = time.perf_counter()
                    fired["thread"] = threading.Thread(target=stop_at[2],
                                                       daemon=True)
                    fired["thread"].start()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"stream {i}: {e!r}")
        out[i] = (toks, times, t0)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if "thread" in fired:
        fired["thread"].join(60)
    if errors or any(o is None for o in out):
        raise AssertionError(f"wire streams failed: {errors}")
    return out, fired.get("t")


def serve_group(spec, params, n=2):
    """``n`` ``ServingServer``s on 127.0.0.1, each over an engine with
    its own ``PagedLlamaModel`` on the one ``params`` tree (``.to`` on
    the same device copies nothing)."""
    from zoo_tpu_torch.serving.llm import build_llm_engine
    from zoo_tpu_torch.serving.server import ServingServer

    engines = [build_llm_engine(spec, device="cuda", params=params)
               for _ in range(n)]
    servers = [ServingServer(None, llm_engine=e, port=0).start()
               for e in engines]
    return engines, servers


def wire_clients(servers, n_streams, pinned):
    """One ``HAServingClient`` (``hedge=False``) per stream: stream
    ``pinned`` gets a client of its own whose first endpoint is server
    0, and a fresh client's first plan starts at its first endpoint (no
    affinity, occupancy or ejection state yet), so that stream lands on
    server 0 — the one a failover run stops. The other streams share a
    client over the servers from server 1 on, so round-robin spreads
    them over all servers. Returns (per-stream clients, every client)."""
    from zoo_tpu_torch.serving.ha_client import HAServingClient

    eps = [(s.host, s.port) for s in servers]

    def client(order):
        return HAServingClient(order, hedge=False, deadline_ms=900_000)

    shared = client(eps[1:] + eps[:1])
    own = client(eps) if len(eps) > 1 else shared
    per = [own if i == pinned else shared for i in range(n_streams)]
    return per, list({id(c): c for c in per}.values())


def failovers():
    """The HA client's ``zoo_serve_failover_total`` count."""
    from zoo_tpu_torch.serving import ha_client
    return ha_client._failover.value


def used_blocks_over_wire(servers, engines):
    """Each engine's ``used_blocks`` read over ``llm_stats`` (a stopped
    server's engine is read directly: its door is closed)."""
    from zoo_tpu_torch.serving.tcp_client import _Connection
    out = []
    for srv, eng in zip(servers, engines):
        if srv._stop.is_set():
            out.append(eng.stats()["blocks_used"])
            continue
        conn = _Connection(srv.host, srv.port)
        out.append(conn.rpc({"op": "llm_stats"})["stats"]["blocks_used"])
        conn.close()
    return out


def phase_tiny_wire(torch, K):
    """``llama:tiny`` over the wire on the card. In process: two servers
    over two models on one params tree, an ``HAServingClient``
    (``hedge=False``) streams phase 4's prompts, the first server stops
    after stream 0's third token, and every stream equals the kernel
    engine's direct one, greedy and seeded (temperature 0.9, top_k 16,
    a seed per stream); neither engine holds a block afterwards. Then
    the ``check_llm_serving`` copy with ``--device cuda``: two replica
    processes, one SIGKILLed mid-storm."""
    import numpy as np
    from zoo_tpu_torch.scripts import check_llm_serving
    from zoo_tpu_torch.serving.llm import build_llm_engine

    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 256, (n,)) for n in (5, 40, 200)]
    for leg, sampling in (("greedy", None),
                          ("seeded", [{"temperature": 0.9, "top_k": 16,
                                       "seed": 100 + i}
                                      for i in range(len(prompts))])):
        direct = build_llm_engine("llama:tiny", device="cuda")
        try:
            hs = [direct.submit(p, 16, rid=f"q{i}",
                                sampling=sampling and sampling[i])
                  for i, p in enumerate(prompts)]
            for h in hs:
                while not h.done:
                    h.wait_new(len(h.tokens), 1.0)
        finally:
            direct.stop()
        ref = [h.tokens for h in hs]
        engines, servers = serve_group("llama:tiny", direct.model.params)
        clients, every = wire_clients(servers, len(prompts), pinned=0)
        f0 = failovers()
        K.reset_launch_counts()
        try:
            out, _ = wire_streams(clients, prompts, 16, sampling,
                                  stop_at=(0, 3, servers[0].stop))
            torch.cuda.synchronize()
            counts = K.launch_counts()
            moved = failovers() - f0
            for c in every:
                c.close()
            used = used_blocks_over_wire(servers, engines)
        finally:
            for srv in servers:
                srv.stop()
        got = [o[0] for o in out]
        emit({"phase": "tiny-wire", "leg": leg,
              "streams_equal_direct": got == ref, "used_blocks": used,
              "failovers": moved, "launches": counts})
        if got != ref or any(used) or counts["paged_decode"] <= 0 or \
                moved < 1:
            raise AssertionError(f"tiny wire {leg}: streams {got} vs "
                                 f"{ref}, used blocks {used}, {moved} "
                                 f"failovers, {counts}")
    t0 = time.perf_counter()
    rc = check_llm_serving.check(verbose=True, device="cuda")
    emit({"phase": "tiny-wire", "check_llm_serving": "--device cuda",
          "rc": rc, "seconds": time.perf_counter() - t0})
    if rc != 0:
        raise AssertionError(f"check_llm_serving --device cuda: rc {rc}")


def motif_prompts(vocab, lengths, seed):
    """Prompts of the given lengths tiled from one 16-token motif: text
    that repeats itself, which the prompt-lookup drafter can draft."""
    import numpy as np
    motif = np.random.RandomState(seed).randint(0, vocab, (16,))
    return [np.resize(motif, n) for n in lengths]


def phase_tiny_spec(torch, K, plain):
    """``llama:tiny:spec_k=4`` on motif-tiled prompts: the kernel streams
    equal the plain path's, greedy and seeded (temperature 0.9, top_k
    16), and the same model's with the engine at ``spec_k=0``."""
    from zoo_tpu_torch.serving.llm import LLMEngine, build_llm_engine

    spec = "llama:tiny:spec_k=4"
    prompts = motif_prompts(256, (5, 40, 200), 5)
    seeded = {"temperature": 0.9, "top_k": 16}
    for leg, sampling in (("greedy", None), ("seeded", seeded)):
        eng = build_llm_engine(spec, device="cuda", start=False)
        model = eng.model
        engines = (("kernels", eng),
                   ("plain", build_llm_engine(spec, device="cuda",
                                              start=False,
                                              params=model.params, **plain)),
                   ("kernels_spec_k=0", LLMEngine(model, spec_k=0)))
        streams, counts, stats = {}, None, None
        for label, eng in engines:
            K.reset_launch_counts()
            eng.start()
            try:
                hs, _ = drive(eng, prompts, 16, sampling=sampling)
                st = eng.stats()
            finally:
                eng.stop()
            if label == "kernels":
                counts, stats = K.launch_counts(), st
            bad = [(h.outcome, h.error) for h in hs if h.outcome != "ok"]
            if bad or eng.allocator.used_blocks:
                raise AssertionError(f"{spec} {leg} {label}: {bad}, "
                                     f"{eng.allocator.used_blocks} blocks "
                                     "leaked")
            streams[label] = [h.tokens for h in hs]
        equal = streams["kernels"] == streams["plain"]
        equal_nospec = streams["kernels"] == streams["kernels_spec_k=0"]
        emit({"phase": "tiny", "spec": spec, "leg": leg,
              "streams_equal": equal, "streams_equal_nospec": equal_nospec,
              "launches": counts, "compiles": stats["compiles"],
              **{k: stats[k] for k in SPEC_STATS}})
        if not (equal and equal_nospec):
            raise AssertionError(f"{spec} {leg}: kernel streams differ: "
                                 f"{streams}")
        passes = stats["compiles"]["verify"]
        if passes <= 0 or counts["paged_decode"] or \
                counts["paged_prefill"] != model.cfg.n_block * passes:
            raise AssertionError(f"{spec} {leg}: the verify passes must "
                                 "launch paged_prefill once a layer and "
                                 f"paged_decode never: {counts}, "
                                 f"{stats['compiles']}")


def phase_tick(torch, m, card, ticks=10, path="decode"):
    """Where a decode tick's (``path="decode"``) or a speculative verify
    pass's (``path="verify"``: (slots, spec_k + 1) rows, greedy, rows
    rewritten at the same positions each cycle of 6 passes) time goes:
    every slot prefilled with a 200-token prompt, then passes of all
    slots straight through ``m`` (no engine threads), with the paged
    kernel (decode or prefill) and with its plain version. Per pass:
    CUDA-event wall time back to back, device time by group (matrix
    products, the paged kernel, the rest) and the device's busy share
    of the wall time."""
    import numpy as np
    S, W, n_prompt = m.num_slots, m.max_blocks_per_seq, 200
    T = m.spec_k + 1 if path == "verify" else 1
    span = T * 6 if path == "verify" else 2 * ticks + 3
    per_slot = (n_prompt + span) // m.block_size + 1
    tables = np.zeros((S, W), np.int32)
    for i in range(S):                       # private blocks, 0 is trash
        tables[i, :per_slot] = 1 + per_slot * i + np.arange(per_slot)
    rs = np.random.RandomState(11)
    first = np.array([m.prefill(rs.randint(0, m.cfg.vocab, (n_prompt,)),
                                tables[i]) for i in range(S)], np.int32)
    rows = rs.randint(0, m.cfg.vocab, (S, T)).astype(np.int32)
    rows[:, 0] = first
    lanes = (np.zeros(S, np.float32), np.zeros(S, np.int32),
             np.ones(S, np.float32), np.zeros(S, np.uint32))
    fresh = np.ones(S, bool)
    kernel = "paged_decode" if path == "decode" else "paged_prefill"
    attr = f"{'decode' if path == 'decode' else 'prefill'}_attention_impl"

    def group(name):
        n = name.lower()
        if kernel + "_kernel" in n or kernel + "_merge" in n:
            return kernel
        if any(s in n for s in ("gemm", "gemv", "cutlass", "matmul")):
            return "matmul"
        return "other"

    impl0 = getattr(m, attr)
    try:
        for impl in ("flash", "dense"):
            setattr(m, attr, impl)
            st = {"prev": None, "t": 0}

            def tick():
                prev = st["prev"]
                if path == "verify":
                    st["prev"] = m.verify_step(
                        rows, tables,
                        np.full(S, n_prompt + T * (st["t"] % 6), np.int32),
                        lanes)
                else:
                    st["prev"] = m.decode_step(
                        prev, first, fresh if prev is None else ~fresh,
                        tables, np.full(S, n_prompt + st["t"], np.int32),
                        lanes)
                st["t"] += 1

            t = timed(torch, tick, ticks)
            m.read_tokens(st["prev"])
            groups = {}
            for name, ms in t["by_name"].items():
                groups[group(name)] = groups.get(group(name), 0.0) + ms
            top = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:6]
            host = sorted(t["host_by_name"].items(),
                          key=lambda kv: -kv[1])[:8]
            emit({"phase": "tick", "path": path, "impl": impl,
                  "card": card, "slots": S, "rows_per_slot": T,
                  "context": n_prompt, "ticks": ticks,
                  "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
                  "device_ms": t["device_ms"],
                  "device_busy_share": t["device_busy_share"],
                  "device_launches_per_tick": t["device_launches"],
                  "device_ms_by_group": groups,
                  "top_device_ms": [[k[:80], v] for k, v in top],
                  "top_host_self_ms": [[k[:80], v] for k, v in host]})
    finally:
        setattr(m, attr, impl0)


def serve_run(torch, K, eng, prompts, label, card, setup_s, extra=None):
    """Drive ``eng`` with ``prompts`` (32 new tokens each) from launch
    counts of 0, check the outcomes, and print the run's line; returns
    the launch counts, the stats, the streams and their TTFTs."""
    K.reset_launch_counts()
    try:
        hs, wall = drive(eng, prompts, 32)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        stats = eng.stats()
    finally:
        eng.stop()
    used = eng.allocator.used_blocks
    bad = [(h.outcome, h.error) for h in hs if h.outcome != "ok"]
    toks = [h.tokens for h in hs]
    ok_tokens = all(len(t) == 32 and all(0 <= x < 128256 for x in t)
                    for t in toks)
    if bad or not ok_tokens:
        raise AssertionError(f"{label}: outcomes {bad}, tokens {toks}")
    t_first = min(h.first_token_at for h in hs)
    t_last = max(h.last_token_at for h in hs)
    decode_tps = sum(len(t) - 1 for t in toks) / (t_last - t_first)
    emit({"phase": "main", "run": label, "card": card,
          "setup_s": setup_s, "wall_s": wall,
          "ttft_s": [h.ttft() for h in hs],
          "decode_tokens_per_s": decode_tps,
          "launches": counts, "used_blocks_after": used,
          "compiles": stats["compiles"],
          "kv_cache_dtype": stats["kv_cache_dtype"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          **(extra(stats) if extra else {})})
    if used != 0:
        raise AssertionError(f"{label}: {used} KV blocks leaked")
    return counts, stats, toks, [h.ttft() for h in hs]


def phase_main(torch, K, card):
    """The 8B-width engine on the bucket, chunk=64 and int8 paths, then
    disaggregation (``disagg-main``, f32 and int8 caches) and tenancy
    (``tenancy-main``) on the bucket run's weights, then speculation
    (``spec_k=4``) and the same model's engine at ``spec_k=0``. Returns
    the launches of the plain runs, the speculative run, the wire runs,
    the disaggregated runs, the tenancy runs and ``direct_traced``."""
    import numpy as np
    from zoo_tpu_torch.serving.llm import LLMEngine, build_llm_engine

    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 128256, (n,)) for n in (20, 100, 300, 480)]
    bucket_prompts = prompts
    spec = SPEC_8B.replace("n_block=32", f"n_block={N_BLOCK}")
    emit({"phase": "main", "spec": spec, "depth_cut": N_BLOCK != 32})
    runs = (("bucket", {}, ("flash_attention", "paged_decode")),
            ("chunk=64", {"prefill_chunk": 64},
             ("paged_prefill", "paged_decode")),
            ("kv=int8", {"kv_dtype": "int8"},
             ("flash_attention", "paged_decode")))
    params, launches, first, int8 = None, {}, None, None
    for label, kw, need in runs:
        t0 = time.perf_counter()
        eng = build_llm_engine(spec, device="cuda", params=params, **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        params = eng.model.params
        counts, stats, toks, ttft = serve_run(torch, K, eng, prompts,
                                              label, card, setup_s)
        for k in need:
            if counts[k] <= 0:
                raise AssertionError(f"{label}: {k} never launched")
        if label == "bucket":
            first = toks
            launches.update(flash_attention=counts["flash_attention"],
                            paged_decode=counts["paged_decode"])
            phase_tick(torch, eng.model, card)
            wire, warm_ttft, traced = phase_main_wire(
                torch, K, card, spec, params, prompts, first)
        elif label == "chunk=64":
            launches["paged_prefill"] = counts["paged_prefill"]
            # information only, not asserted: the two paths sum attention
            # in another order, and random 8B weights leave near-tied
            # logits whose argmax may flip
            emit({"phase": "main", "run": label,
                  "streams_equal_bucket": toks == first})
        else:
            int8 = (toks, ttft)
        del eng
        torch.cuda.empty_cache()

    # disaggregation: f32 streams held to the bucket run's (TTFTs beside
    # direct_warm's), int8 ones to the kv=int8 run's
    disagg = {}
    for kv, (direct, d_ttft) in (("f32", (first, warm_ttft)),
                                 ("int8", int8)):
        counts = disagg_run(torch, K, spec, params, prompts, 32, direct,
                            d_ttft, kv, "cuda", "disagg-main", card)
        for k, n in counts.items():
            disagg[k] = disagg.get(k, 0) + n
        torch.cuda.empty_cache()
    disagg = {k: disagg[k] for k in ("flash_attention", "paged_decode",
                                     "paged_prefill") if disagg[k]}
    tenancy = tenancy_run(torch, K, spec, params, 128256, "cuda",
                          "tenancy-main", card)
    tenancy = {k: tenancy[k] for k in ("flash_attention", "paged_decode",
                                       "paged_prefill") if tenancy[k]}
    torch.cuda.empty_cache()

    # speculation: a spec_k=4 model, its engine at spec_k=4 and then at
    # spec_k=0 (the A/B rig), on motif-tiled prompts of the same lengths
    prompts = motif_prompts(128256, (20, 100, 300, 480), 7)
    t0 = time.perf_counter()
    eng = build_llm_engine(spec, device="cuda", params=params, spec_k=4)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = eng.model

    def spec_stats(stats):
        return {k: stats[k] for k in SPEC_STATS}

    spec_counts, st, spec_toks, _ = serve_run(
        torch, K, eng, prompts, "spec_k=4", card, setup_s, spec_stats)
    passes = st["compiles"]["verify"]
    if passes <= 0 or spec_counts["paged_decode"] or \
            spec_counts["paged_prefill"] != N_BLOCK * passes:
        raise AssertionError(f"spec_k=4: the verify passes must launch "
                             f"paged_prefill once a layer and paged_decode "
                             f"never: {spec_counts}, {passes} passes")
    phase_tick(torch, model, card, path="verify")
    eng = LLMEngine(model, spec_k=0)
    nospec_counts, _, nospec_toks, _ = serve_run(
        torch, K, eng.start(), prompts, "spec_k=4 model, engine spec_k=0",
        card, 0.0, spec_stats)
    if nospec_counts["paged_decode"] <= 0:
        raise AssertionError("engine spec_k=0: paged_decode never launched")
    # information only, not asserted: a verify pass runs its GEMMs over
    # 40 rows where a decode tick runs 8, and random 8B weights leave
    # near-tied logits whose argmax may flip
    emit({"phase": "main", "run": "spec_k=4",
          "streams_equal_nospec": spec_toks == nospec_toks})
    del eng, model, params
    phase_main_replica(torch, card, spec, bucket_prompts, first)
    phase_obs_main(torch, card, spec, bucket_prompts, first)
    return launches, {k: spec_counts[k] for k in ("flash_attention",
                                                  "paged_prefill")}, wire, \
        disagg, tenancy, traced


def phase_main_wire(torch, K, card, spec, params, prompts, direct):
    """The bucket run's four prompts over the wire at 8B width:
    ``ServingServer``s on 127.0.0.1 over models on the bucket run's
    ``params``, an ``HAServingClient`` streaming all four at once.
    ``direct_warm``: the four prompts through an engine on those weights
    with no wire, after the bucket run warmed its shapes.
    ``wire_1_server``: one server, so one engine holds the four streams
    as ``direct_warm``'s does — its client-side TTFTs and decode
    tokens/s stand beside that run's and show what the wire costs.
    ``wire_2_servers``: two servers, no fault. ``wire_failover``: two
    servers, the first stopped once the 480-token stream (pinned to that
    server by ``wire_clients``) has its 8th token; the HA client's
    failover count must rise; the failover pause is the
    largest gap between two tokens of one stream from its last token
    before the stop on (a stream resumed on the second server emits
    nothing while that server re-prefills it and re-decodes what it had
    sent). Every run's streams must equal the direct bucket run's (the HA
    contract's premise), end ``ok`` with 32 tokens, and leave no block;
    launch counts, reset before the first run and read after the last,
    must show the flash forward and the paged decode. Returns them and
    ``direct_warm``'s TTFTs."""
    from zoo_tpu_torch.serving.llm import build_llm_engine

    eng = build_llm_engine(spec, device="cuda", params=params)
    try:
        hs, wall = drive(eng, prompts, 32)
    finally:
        eng.stop()
    toks = [h.tokens for h in hs]
    emit({"phase": "main", "run": "direct_warm", "card": card,
          "wall_s": wall, "decode_steps": [eng.stats()["decode_steps"]],
          "ttft_s": [h.ttft() for h in hs],
          "decode_tokens_per_s": sum(len(t) - 1 for t in toks) / (
              max(h.last_token_at for h in hs) -
              min(h.first_token_at for h in hs)),
          "streams_equal_bucket": toks == direct})
    warm_ttft = [h.ttft() for h in hs]
    warm_rate = sum(len(t) - 1 for t in toks) / (
        max(h.last_token_at for h in hs) - min(h.first_token_at for h in hs))
    del eng, hs
    traced = direct_traced(torch, K, card, spec, params, prompts, direct,
                           warm_ttft, warm_rate)
    K.reset_launch_counts()
    for label, n in (("wire_1_server", 1), ("wire_2_servers", 2),
                     ("wire_failover", 2)):
        engines, servers = serve_group(spec, params, n)
        clients, every = wire_clients(servers, len(prompts), pinned=3)
        stop_at = (3, 8, servers[0].stop) if label == "wire_failover" \
            else None
        f0 = failovers()
        try:
            t0 = time.perf_counter()
            out, t_stop = wire_streams(clients, prompts, 32, None,
                                       stop_at=stop_at)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            moved = failovers() - f0
            for c in every:
                c.close()
            used = used_blocks_over_wire(servers, engines)
            stats = [e.stats() for e in engines]
            impl = [st["decode_attention_impl"] for st in stats]
        finally:
            for srv in servers:
                srv.stop()
        toks = [o[0] for o in out]
        ttft = [o[1][0] - o[2] for o in out]
        t_first = min(o[1][0] for o in out)
        t_last = max(o[1][-1] for o in out)
        # decode_steps per engine over the wall: ticks of one engine
        # interleave with the other's on the one card and the one GIL
        line = {"phase": "main", "run": label, "card": card,
                "wall_s": wall,
                "decode_steps": [st["decode_steps"] for st in stats],
                "ttft_s": ttft,
                "decode_tokens_per_s": sum(len(t) - 1 for t in toks) /
                (t_last - t_first),
                "streams_equal_bucket": toks == direct,
                "used_blocks_after": used, "decode_attention_impl": impl,
                "failovers": moved}
        if t_stop is not None:
            gaps, cadence = [], []
            for t, times, _ in out:
                before = [x for x in times if x <= t_stop]
                after = [x for x in times if x > t_stop]
                if before and after:
                    seq = [before[-1]] + after
                    gaps.append(max(b - a for a, b in zip(seq, seq[1:])))
                if len(before) > 2:
                    cadence.append(sorted(b - a for a, b in zip(
                        before[1:], before[2:]))[(len(before) - 2) // 2])
            line["failover_pause_s"] = max(gaps)
            line["largest_gap_after_stop_s"] = gaps
            line["median_gap_before_stop_s"] = cadence
        emit(line)
        del engines, servers, clients, every
        torch.cuda.empty_cache()
        bad = [len(t) for t in toks if len(t) != 32]
        if bad or any(used) or toks != direct or impl != ["flash"] * n \
                or (t_stop is None) != (moved == 0):
            raise AssertionError(
                f"{label}: lengths {bad}, used blocks {used}, impl "
                f"{impl}, {moved} failovers, streams equal the bucket "
                f"run's: {toks == direct}")
    counts = K.launch_counts()
    for k in ("flash_attention", "paged_decode"):
        if counts[k] <= 0:
            raise AssertionError(f"serve_wire: {k} never launched")
    return {k: counts[k] for k in ("flash_attention", "paged_decode")}, \
        warm_ttft, traced


def _ttft_count():
    from zoo_tpu_torch.obs.metrics import get_registry
    return sum(h["count"] for h in get_registry().snapshot()["histograms"]
               if h["name"] == "zoo_llm_ttft_seconds")


def direct_traced(torch, K, card, spec, params, prompts, direct, warm_ttft,
                  warm_rate):
    """``direct_traced``: ``direct_warm`` again with tracing on — the
    four prompts through an engine on the bucket run's weights, each
    stream under a trace id of its own, spans into a temp dir. Required:
    the streams equal the bucket run's; every trace holds ``llm.admit``,
    ``llm.first_token``, ``llm.stream`` and an ``llm.prefill`` span
    (every prompt here prefills in one bucket call; from
    ``ZOO_LLAMA_FLASH_MIN_SEQ``'s bucket on through the flash kernel);
    the engine's ``zoo_llm_ttft_seconds`` count rises by 4. TTFT and
    decode tokens/s beside ``direct_warm``'s, the overhead in percent.
    Returns the run's launches (``serve_obs``)."""
    import shutil
    import tempfile

    from zoo_tpu_torch.obs import tracing
    from zoo_tpu_torch.obs.timeline import group_traces, load_events
    from zoo_tpu_torch.serving.llm import build_llm_engine

    d = tempfile.mkdtemp(prefix="zoo-smoke-trace-")
    eng = build_llm_engine(spec, device="cuda", params=params)
    tids = [tracing.new_trace_id() for _ in prompts]
    c0 = _ttft_count()
    tracing.trace_to(d)
    K.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        hs = [eng.submit(p, 32, rid=f"t{i}", trace_id=tids[i])
              for i, p in enumerate(prompts)]
        _wait_done(hs)
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
        tracing.stop_tracing()
    counts = K.launch_counts()
    n_ttft = _ttft_count() - c0
    traces = group_traces(load_events(d))
    shutil.rmtree(d, ignore_errors=True)
    toks = [h.tokens for h in hs]
    ttft = [h.ttft() for h in hs]
    rate = sum(len(t) - 1 for t in toks) / (
        max(h.last_token_at for h in hs) - min(h.first_token_at for h in hs))
    need = ("llm.admit", "llm.first_token", "llm.stream", "llm.prefill")
    missing = {tid[:8]: [n for n in need if n not in
                         {e.get("name") for e in traces.get(tid, ())}]
               for tid in tids}
    missing = {k: v for k, v in missing.items() if v}
    emit({"phase": "main", "run": "direct_traced", "card": card,
          "wall_s": wall, "ttft_s": ttft, "decode_tokens_per_s": rate,
          "direct_warm_ttft_s": warm_ttft,
          "direct_warm_decode_tokens_per_s": warm_rate,
          "ttft_overhead_pct": 100.0 * (sum(ttft) / sum(warm_ttft) - 1.0),
          "decode_overhead_pct": 100.0 * (warm_rate / rate - 1.0),
          "events_per_trace": [len(traces.get(t, ())) for t in tids],
          "missing": missing, "ttft_histogram_count": n_ttft,
          "streams_equal_bucket": toks == direct,
          "launches": {k: counts[k] for k in ("flash_attention",
                                              "paged_decode")}})
    if toks != direct or missing or n_ttft != len(prompts) or \
            counts["flash_attention"] <= 0 or counts["paged_decode"] <= 0:
        raise AssertionError(
            f"direct_traced: streams equal {toks == direct}, missing "
            f"{missing}, ttft count {n_ttft}, launches {counts}")
    return {k: counts[k] for k in ("flash_attention", "paged_decode")}


def _replica_logs(log_dir, n, tail=6000):
    for i in range(n):
        log = os.path.join(log_dir, f"serving-replica-{i}.log")
        if os.path.exists(log):
            with open(log, "rb") as f:
                sys.stderr.write(f.read()[-tail:].decode("utf-8",
                                                         "replace"))


def phase_main_replica(torch, card, spec, prompts, direct):
    """The bucket run's four prompts through the entry points users
    serve with: a ``ReplicaGroup`` of one ``python -m
    zoo_tpu_torch.serving.replica --device cuda`` process at 8B width
    (it loads the prebuilt serving kernels and builds the spec's seeded
    weights, the bucket run's, from its command line) and
    ``group.client()``. This process frees its own weights first, so one
    copy is on the card. Three passes: ``cold`` (the replica's first
    requests) and ``warm`` through the client's defaults, the
    first-token hedge on (with one seat the hedge lands on the same seat
    and joins the live stream), then ``warm_no_hedge``, the client
    ``wire_1_server`` uses. The client runs here and the engine in the
    replica, so the warm passes' decode tokens/s, beside
    ``wire_1_server``'s (client and engine in one process), show what
    sharing the process costs the wire. Required of every pass: each
    stream ends with 32 tokens equal to the bucket run's, the replica's
    ``llm_stats`` read the kernels (``decode_attention_impl`` and
    ``prefill_attention_impl`` both ``flash``), and no block is held.
    The replica's launches are counted in its own process, so
    ``serve_wire`` does not hold them."""
    import gc
    import tempfile

    from zoo_tpu_torch.serving import ha_client
    from zoo_tpu_torch.serving.ha import ReplicaGroup

    def hedge_counts():
        return {e: ha_client._hedge.labels(event=e).value
                for e in ("fired", "won")}

    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    log_dir = tempfile.mkdtemp(prefix="zoo-smoke-replica-")
    group = ReplicaGroup(spec, num_replicas=1, max_restarts=0,
                         log_dir=log_dir, device="cuda")
    try:
        t0 = time.perf_counter()
        group.start(timeout=300)
        setup_s = time.perf_counter() - t0
        steps = 0
        for label, hedge in (("cold", None), ("warm", None),
                             ("warm_no_hedge", False)):
            client = group.client(deadline_ms=900_000, hedge=hedge)
            h0 = hedge_counts()
            try:
                t0 = time.perf_counter()
                out, _ = wire_streams([client] * len(prompts), prompts, 32)
                wall = time.perf_counter() - t0
                hedges = {e: v - h0[e] for e, v in hedge_counts().items()}
                (stats,) = client.update_topology().values()
            finally:
                client.close()
            toks = [o[0] for o in out]
            impl = (stats["decode_attention_impl"],
                    stats["prefill_attention_impl"])
            emit({"phase": "main", "run": "wire_replica_process",
                  "pass": label, "card": card,
                  "this_process_held_gb": held_gb, "setup_s": setup_s,
                  "wall_s": wall,
                  "decode_steps": [stats["decode_steps"] - steps],
                  "ttft_s": [o[1][0] - o[2] for o in out],
                  "decode_tokens_per_s": sum(len(t) - 1 for t in toks) /
                  (max(o[1][-1] for o in out) - min(o[1][0] for o in out)),
                  "streams_equal_bucket": toks == direct,
                  "used_blocks_after": stats["blocks_used"],
                  "decode_attention_impl": impl[0],
                  "prefill_attention_impl": impl[1], "hedges": hedges})
            bad = [len(t) for t in toks if len(t) != 32]
            if bad or stats["blocks_used"] or toks != direct or \
                    impl != ("flash", "flash"):
                raise AssertionError(
                    f"wire_replica_process {label}: lengths {bad}, used "
                    f"blocks {stats['blocks_used']}, impl {impl}, streams "
                    f"equal the bucket run's: {toks == direct}")
            steps = stats["decode_steps"]
    except Exception:
        _replica_logs(log_dir, 1, tail=8000)
        raise
    finally:
        group.stop()


OBS_NEW, OBS_HEDGE_MS, OBS_SLO_TTFT_S = 32, 500, 1.0


def phase_obs_main(torch, card, spec, prompts, direct):
    """``obs-main``: the traced 8B streams across a replica SIGKILL. A
    ``ReplicaGroup`` of two ``--device cuda`` replica processes at 8B
    width (``max_restarts=0``; env ``ZOO_TRACE_DIR``, ``ZOO_CHAOS_ALLOW=1``,
    ``ZOO_SLO_TTFT_P99_S=1.0``, ``ZOO_SLO_INTERVAL_S=1``; this process
    traces into the same dir), each warmed off the clock on the four
    prompts; then the four prompts twice (8 streams, 32 new tokens)
    through ``group.client(hedge=True, hedge_delay_ms=500)`` with
    explicit trace ids, replica 0 SIGKILLed once stream 0 has its first
    token. Required: no client-visible failure; every stream equal to
    the bucket run's for its prompt; from the JSONL files alone, one
    trace with two or more ``client.attempt`` spans and ``server.``/
    ``llm.`` spans from both replicas' files, ``client.generate`` and
    ``llm.admit`` among them; ``harvest_postmortems()`` yields, within
    30 s, replica 0's bundle with a ring holding ``replica_boot``;
    ``debug_dump`` on replica 1 a bundle whose ring holds
    ``llm_stream_end``; replica 1's ``/healthz`` an SLO verdict with
    ``ttft_p99`` measured (over 1.0 s, the breach event in the bundle's
    ring); a predict to the LLM replica errors and echoes its trace;
    replica 1's ``llm_stats`` read ``flash`` for both attention paths.
    The replicas count their launches in their own processes."""
    import gc
    import json
    import shutil
    import tempfile

    import numpy as np
    from zoo_tpu_torch.obs import tracing
    from zoo_tpu_torch.obs.timeline import group_traces, load_events
    from zoo_tpu_torch.serving.ha import ReplicaGroup
    from zoo_tpu_torch.serving.tcp_client import _Connection

    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="zoo-smoke-obs-")
    trace_dir = os.path.join(work, "trace")
    log_dir = os.path.join(work, "logs")
    env = {"ZOO_TRACE_DIR": trace_dir, "ZOO_CHAOS_ALLOW": "1",
           "ZOO_SLO_TTFT_P99_S": str(OBS_SLO_TTFT_S),
           "ZOO_SLO_INTERVAL_S": "1"}
    group = ReplicaGroup(spec, num_replicas=2, max_restarts=0,
                         log_dir=log_dir, device="cuda", env=env)
    tracing.trace_to(trace_dir)
    try:
        t0 = time.perf_counter()
        group.start(timeout=600)
        boot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for host, port in group.endpoints():
            conn = _Connection(host, port)
            try:
                for p in prompts:
                    for _ in conn.stream({"op": "generate", "prompt": p,
                                          "max_new_tokens": 2}):
                        pass
            finally:
                conn.close()
        warm_s = time.perf_counter() - t0
        streams = list(prompts) * 2
        tids = [f"{i:02d}" + os.urandom(15).hex()
                for i in range(len(streams))]
        client = group.client(deadline_ms=900_000, hedge=True,
                              hedge_delay_ms=OBS_HEDGE_MS)
        try:
            t0 = time.perf_counter()
            out, t_kill = wire_streams(
                [client] * len(streams), streams, OBS_NEW,
                [{"trace_id": t} for t in tids],
                stop_at=(0, 1, lambda: group.kill_replica(0)))
            wall = time.perf_counter() - t0
        finally:
            client.close()
        tracing.stop_tracing()
        toks = [o[0] for o in out]
        ttft = [o[1][0] - o[2] for o in out]
        gaps = []
        for _, times, _ in out:
            before = [x for x in times if x <= t_kill]
            after = [x for x in times if x > t_kill]
            if after:
                seq = ([before[-1]] if before else []) + after
                if len(seq) > 1:
                    gaps.append(max(b - a for a, b in zip(seq, seq[1:])))
        equal = [t == direct[i % len(direct)] for i, t in enumerate(toks)]

        # the timeline from the JSONL files alone
        traces = group_traces(load_events(trace_dir))
        crossed = None
        for tid in tids:
            evs = traces.get(tid, [])
            attempts = [e for e in evs if e.get("name") == "client.attempt"]
            files = {e.get("file") for e in evs if str(
                e.get("name", "")).startswith(("server.", "llm."))}
            names = {e.get("name") for e in evs}
            if len(attempts) >= 2 and len(files) >= 2 and \
                    {"client.generate", "llm.admit"} <= names:
                crossed = {"trace": tid, "attempts": len(attempts),
                           "replica_files": len(files),
                           "events": len(evs)}
                break

        # the killed replica's postmortem (the healthz sweep may have
        # harvested it already: read the group's dir)
        t0 = time.perf_counter()
        pm_dir = group.postmortem_dir()
        bundle_path = None
        while bundle_path is None and time.perf_counter() - t0 < 30:
            group.harvest_postmortems()
            mine = sorted(f for f in (os.listdir(pm_dir) if os.path.isdir(
                pm_dir) else []) if f.startswith("replica-0-"))
            if mine:
                bundle_path = os.path.join(pm_dir, mine[0])
            else:
                time.sleep(0.2)
        harvest_s = time.perf_counter() - t0
        ring0 = []
        if bundle_path is not None:
            with open(bundle_path, encoding="utf-8") as f:
                ring0 = json.load(f).get("ring") or []

        # replica 1: the SLO verdict on /healthz, then the live bundle
        slo, deadline = None, time.monotonic() + 15
        while time.monotonic() < deadline:
            hz = group.healthz()[1] or {}
            rule = ((hz.get("slo") or {}).get("rules") or {}).get(
                "ttft_p99") or {}
            if "measured" in rule:
                slo = hz["slo"]
                break
            time.sleep(0.3)
        host1, port1 = group.endpoints()[1]
        conn = _Connection(host1, port1)
        try:
            dump = conn.rpc({"op": "debug_dump"})
            stats = conn.rpc({"op": "llm_stats"})["stats"]
            probe_tid = "ee" * 16
            probe = conn.rpc({"op": "predict", "uri": "u",
                              "data": np.zeros((1, 2), np.float32),
                              "trace": probe_tid})
        finally:
            conn.close()
        bundle = dump.get("bundle") or {}
        ring1 = [e.get("kind") for e in bundle.get("ring") or ()]
        watch_p99 = slo["rules"]["ttft_p99"]["measured"] if slo else None
        breach_seen = "slo_breach" in ring1
        emit({"phase": "obs-main", "card": card, "replicas": 2,
              "boot_s": boot_s, "warm_s": warm_s, "wall_s": wall,
              "ttft_s": ttft, "client_ttft_p99_s": _pct(ttft, 99),
              "failover_pause_s": max(gaps) if gaps else None,
              "streams_equal_bucket": equal, "crossed_trace": crossed,
              "traces": len(traces),
              "postmortem": {"found": bundle_path is not None,
                             "ring_len": len(ring0),
                             "kinds": sorted({e.get("kind")
                                              for e in ring0}),
                             "harvest_s": harvest_s},
              "debug_dump_bytes": len(json.dumps(bundle, default=str)),
              "debug_dump_ring_len": len(ring1),
              "watchdog_ttft_p99_s": watch_p99,
              "slo_objective_s": OBS_SLO_TTFT_S,
              "slo_breach_in_ring": breach_seen,
              "probe_echo": probe.get("trace") == probe_tid,
              "decode_attention_impl": stats["decode_attention_impl"],
              "prefill_attention_impl": stats["prefill_attention_impl"]})
        bad = []
        if not all(equal) or any(len(t) != OBS_NEW for t in toks):
            bad.append(f"streams equal {equal}")
        if crossed is None:
            bad.append("no trace crosses both replicas with 2 attempts")
        if not ring0 or "replica_boot" not in {e.get("kind")
                                               for e in ring0}:
            bad.append(f"harvested ring {len(ring0)} events, "
                       f"{bundle_path}")
        if "llm_stream_end" not in ring1:
            bad.append("debug_dump ring holds no llm_stream_end")
        if watch_p99 is None:
            bad.append("no ttft_p99 verdict on replica 1's /healthz")
        elif watch_p99 > OBS_SLO_TTFT_S and not breach_seen:
            bad.append(f"ttft_p99 {watch_p99} over the objective, no "
                       "breach event in the ring")
        if "error" not in probe or probe.get("trace") != probe_tid:
            bad.append(f"probe reply {probe}")
        if (stats["decode_attention_impl"],
                stats["prefill_attention_impl"]) != ("flash", "flash"):
            bad.append(f"impl {stats['decode_attention_impl']}, "
                       f"{stats['prefill_attention_impl']}")
        if bad:
            raise AssertionError("obs-main: " + "; ".join(bad))
    except Exception:
        _replica_logs(log_dir, 2)
        raise
    finally:
        tracing.stop_tracing()
        group.stop()
        shutil.rmtree(work, ignore_errors=True)


# disaggregation and tenancy (phases disagg-main and tenancy-main): the
# client's handoff floor, and the tenancy mix — a class-0 victim against
# a rate-limited, slot-capped class-1 flood
MIGRATE_MIN_TOKENS = 64
TENANT_CONFIG = ("victim:class=0,weight=4,rate=0;"
                 "greedy:class=1,weight=1,rate=4,burst=8,slots=6")
# the class-preemption run: the same classes without the flood's slot
# cap and rate, and prompts short enough that greedy streams on every
# slot fit the pool (300-token streams fill it at 6 slots, so a waiter
# never finds every slot held), when a victim arrives
CLASS_CONFIG = "victim:class=0,weight=4,rate=0;greedy:class=1,weight=1"
CLASS_LEN = 100
FAIR_CONFIG = "a:weight=4,rate=0;b:weight=1,rate=0"
GREEDY_STREAMS, GREEDY_LEN, GREEDY_SLOTS = 24, 300, 6
VICTIM_STREAMS, VICTIM_LEN, TENANCY_NEW = 4, 20, 32
GREEDY_RATE = 4.0
# bench.py bench_tenancy's bar: the victim's p99 within 2x its unloaded
# p99 through the flood (printed, not asserted here)
TENANCY_BAR = 2.0


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def _wait_done(handles, budget=900.0):
    end = time.monotonic() + budget
    for h in handles:
        while not h.done:
            if time.monotonic() > end:
                raise TimeoutError("streams did not finish in time")
            h.wait_new(len(h.tokens), 1.0)


def _settled_blocks(engines, budget=10.0):
    """Each engine's used blocks once its streams let go of them (a
    decode seat frees a stream's blocks as it finishes; wait briefly)."""
    end = time.monotonic() + budget
    while True:
        used = [e.allocator.used_blocks for e in engines]
        if not any(used) or time.monotonic() > end:
            return used
        time.sleep(0.02)


def _prefill_calls(model):
    c = model.compile_counts()
    return c["prefill"] + c["prefill_chunk"]


def direct_streams(spec, params, prompts, n_new, device, **kw):
    """``prompts`` through one engine on ``params`` with no wire, all at
    once: (tokens, TTFTs) per prompt."""
    from zoo_tpu_torch.serving.llm import build_llm_engine
    eng = build_llm_engine(spec, device=device, params=params, **kw)
    try:
        hs, _ = drive(eng, prompts, n_new)
    finally:
        eng.stop()
    bad = [(h.outcome, h.error) for h in hs if h.outcome != "ok"]
    if bad:
        raise AssertionError(f"direct run: {bad}")
    return [h.tokens for h in hs], [h.ttft() for h in hs]


def disagg_run(torch, K, spec, params, prompts, n_new, direct, direct_ttft,
               kv, device, phase, card=None):
    """One prefill seat and one decode seat, two ``ServingServer``s in
    this process over engines on ``params`` (``role="prefill"`` and
    ``role="decode"``, cache ``kv``), and an ``HAServingClient``
    (``migrate_min_tokens`` 64, after ``update_topology()``) streaming
    ``prompts`` at once: the prompts from 64 tokens on take the two-leg
    handoff (prefill seat, ``kv_migrate`` push, adoption on the decode
    seat), the shorter ones stream plainly on the decode seat. Checked:
    every stream equals its direct run (``direct``), the seats count one
    handoff out and in per long prompt, the decode engine's prefill
    calls rise by the short prompts only, no block is held afterwards,
    and on the card the paged decode and a prefill kernel launched.
    Per handoff: blocks, bytes and the push's seconds (from the push's
    fault seam, after the blocks are taken, to the decode seat staging
    the payload), beside the client-side TTFT and the direct run's.
    Then the push of the longest prompt fails (an injected connection
    reset at ``serving.kv_migrate.push``): the client re-prefills it on
    the decode seat, the stream still equals its direct run, and no
    block leaks. Returns the launch counts of the first leg."""
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.llm import build_llm_engine
    from zoo_tpu_torch.serving.server import ServingServer
    from zoo_tpu_torch.util.resilience import inject

    P = build_llm_engine(spec, device=device, params=params,
                         role="prefill", kv_dtype=kv)
    D = build_llm_engine(spec, device=device, params=params,
                         role="decode", kv_dtype=kv)
    servers = [ServingServer(None, llm_engine=e, port=0).start()
               for e in (P, D)]
    starts, pushes = {}, []

    def note_push(site, rid, blocks):
        starts[rid] = time.perf_counter()

    offer = D.offer_adopted

    def offer_timed(payload):
        ok = offer(payload)
        t0 = starts.get(payload["rid"])
        kvp = payload.get("kv") or {}
        pushes.append({
            "prompt_tokens": len(payload["prompt"]),
            "blocks": int(next(iter(kvp.values())).shape[1]) if kvp
            else 0,
            "bytes": sum(int(a.nbytes) for a in kvp.values()),
            "push_s": None if t0 is None else time.perf_counter() - t0,
            "adopted": ok})
        return ok

    D.offer_adopted = offer_timed
    cli = HAServingClient([(s.host, s.port) for s in servers], hedge=False,
                          deadline_ms=900_000,
                          migrate_min_tokens=MIGRATE_MIN_TOKENS)
    long_ = [len(p) >= MIGRATE_MIN_TOKENS for p in prompts]
    try:
        roles = sorted(st["role"] for st in cli.update_topology().values())
        calls0 = _prefill_calls(D.model)
        K.reset_launch_counts()
        with inject("serving.kv_migrate.push", action=note_push):
            t0 = time.perf_counter()
            out, _ = wire_streams([cli] * len(prompts), prompts, n_new)
            _sync(torch, device)
            wall = time.perf_counter() - t0
        counts = K.launch_counts()
        toks = [o[0] for o in out]
        ttft = [o[1][0] - o[2] for o in out]
        st_p, st_d = P.stats(), D.stats()
        calls = _prefill_calls(D.model) - calls0
        used = _settled_blocks([P, D])
        by_len = {p["prompt_tokens"]: p for p in pushes}
        handoffs = [dict(by_len.get(len(p), {}), ttft_s=t,
                         direct_ttft_s=d)
                    for p, t, d, lg in zip(prompts, ttft, direct_ttft,
                                           long_) if lg]
        line = {"phase": phase, "run": f"kv={kv}", "card": card,
                "roles": roles, "wall_s": wall,
                "streams_equal_direct": toks == direct,
                "handoffs_out": st_p["handoffs_out"],
                "handoffs_in": st_d["handoffs_in"],
                "decode_prefill_calls": calls,
                "kv_cache_dtype": st_d["kv_cache_dtype"],
                "handoffs": handoffs, "ttft_s": ttft,
                "direct_ttft_s": direct_ttft,
                "decode_tokens_per_s": sum(len(t) - 1 for t in toks) / (
                    max(o[1][-1] for o in out) -
                    min(o[1][0] for o in out)),
                "used_blocks_after": used, "launches": counts}
        emit(line)
        n_long = sum(long_)
        kernels_ok = device != "cuda" or (
            counts["paged_decode"] > 0 and
            counts["flash_attention"] + counts["paged_prefill"] > 0)
        if toks != direct or st_p["handoffs_out"] != n_long or \
                st_d["handoffs_in"] != n_long or \
                calls != len(prompts) - n_long or any(used) or \
                len(pushes) != n_long or \
                not all(p["adopted"] for p in pushes) or not kernels_ok:
            raise AssertionError(f"{phase} kv={kv}: {line}")

        # the push of the longest prompt fails: plain re-prefill on the
        # decode seat, same stream, no leak
        i = max(range(len(prompts)), key=lambda j: len(prompts[j]))
        f0, calls0 = failovers(), _prefill_calls(D.model)
        with inject("serving.kv_migrate.push",
                    exc=ConnectionResetError("injected push failure")) \
                as armed:
            out, _ = wire_streams([cli], [prompts[i]], n_new)
        got = out[0][0]
        used = _settled_blocks([P, D])
        line = {"phase": phase, "run": f"kv={kv} push_fails",
                "card": card, "pushes_failed": armed.fired,
                "stream_equal_direct": got == direct[i],
                "failovers": failovers() - f0,
                "decode_prefill_calls": _prefill_calls(D.model) - calls0,
                "handoffs_out": P.stats()["handoffs_out"],
                "handoffs_in": D.stats()["handoffs_in"],
                "ttft_s": out[0][1][0] - out[0][2],
                "used_blocks_after": used}
        emit(line)
        if got != direct[i] or armed.fired != 1 or any(used) or \
                line["decode_prefill_calls"] != 1 or \
                line["handoffs_in"] != n_long or line["failovers"] < 1:
            raise AssertionError(f"{phase} kv={kv} push_fails: {line}")
        return counts
    finally:
        cli.close()
        for srv in servers:
            srv.stop()
        for e in (P, D):
            e.stop()


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, float), q)) if xs else None


def _victim_leg(eng, victims, n_new, qos):
    """The victim's prompts, one after another, each submitted when the
    previous one ended, reading its tokens as they land. With ``qos``,
    the greedy streams waiting at each victim's submission are noted
    (the victim must be admitted ahead of all of them)."""
    out = []
    for i, p in enumerate(victims):
        t0 = time.perf_counter()
        h = eng.submit(p, n_new, rid=f"victim{i}", tenant="victim")
        waiting = []
        if qos:
            with eng._lock:
                waiting = [g for g in eng._wait if g.tenant == "greedy"]
        times, cursor = [], 0
        while True:
            toks, done = h.wait_new(cursor, 1.0)
            now = time.perf_counter()
            times += [now] * len(toks)
            cursor += len(toks)
            if done:
                break
        out.append({"h": h, "t0": t0, "times": times, "waiting": waiting})
    return out


def _victim_numbers(leg):
    ttft = [v["times"][0] - v["t0"] for v in leg]
    gaps = [b - a for v in leg for a, b in zip(v["times"], v["times"][1:])]
    return {"ttft_s": ttft, "ttft_p50_s": _pct(ttft, 50),
            "ttft_p99_s": _pct(ttft, 99), "inter_token_p99_s": _pct(gaps, 99)}


def _flood(eng, prompts, tenant, handles, sheds):
    """Submit ``prompts`` as ``tenant`` one after another, each shed
    retried after its own hint."""
    from zoo_tpu_torch.serving.llm.engine import AdmissionError
    for i, p in enumerate(prompts):
        while True:
            try:
                handles.append(eng.submit(p, TENANCY_NEW,
                                          rid=f"{tenant}{i}", tenant=tenant))
                break
            except AdmissionError as e:
                sheds.append((e.tenant, e.reason, e.retry_after_ms))
                time.sleep(max(e.retry_after_ms, 1) / 1000.0)


def tenancy_run(torch, K, spec, params, vocab, device, phase, card=None):
    """Multi-tenant QoS on one engine (the spec's slots) over ``params``:
    24 seeded 300-token ``greedy`` prompts and four 20-token ``victim``
    prompts, 32 new tokens each. References: each prompt's stream
    through a tenancy-off engine in groups small enough that no stream
    is preempted. Runs: ``unloaded`` (the victim alone, tenancy on),
    ``flood_qos_off`` (the greedy flood, tenancy off: FIFO),
    ``flood_qos_on`` (the flood under ``TENANT_CONFIG``: greedy rate 4/s,
    burst 8, at most 6 slots), in each the victim's prompts one after
    another once the flood has its first token; ``class_preempt`` (8
    greedy streams on every slot, tenancy on without the slot cap, then
    a victim); ``fair_share`` (tenants ``a`` weight 4 and ``b`` weight 1,
    12 greedy prompts each at once; served tokens read when half the
    streams are done). Checked: every stream equals its reference
    (preempted and resumed ones included), greedy is shed with its own
    bucket's hint and the victim never, each victim is admitted ahead of
    every greedy stream waiting when it was submitted, greedy never
    holds more than 6 slots, class preemptions happen in
    ``class_preempt``, no block is held after a run, and on the card the
    flash forward and the paged decode launched. Printed, not asserted:
    the victim's TTFT p50/p99 and inter-token p99 per run beside the
    unloaded run's, against bench_tenancy's 2x bar, and the fair share
    normalised as bench_tenancy normalises it. Returns the launch counts
    of the runs."""
    import threading

    import numpy as np
    from zoo_tpu_torch.serving.llm import build_llm_engine
    from zoo_tpu_torch.serving.llm.engine import _tenant_preempted
    from zoo_tpu_torch.serving.tenancy import TenantRegistry

    rs = np.random.RandomState(16)
    greedy = [rs.randint(0, vocab, (GREEDY_LEN,))
              for _ in range(GREEDY_STREAMS)]
    victims = [rs.randint(0, vocab, (VICTIM_LEN,))
               for _ in range(VICTIM_STREAMS)]

    def engine(cfg):
        return build_llm_engine(spec, device=device, params=params,
                                tenancy=TenantRegistry(spec=cfg, qos=True))

    # references: groups of GREEDY_SLOTS greedy streams never run out of
    # blocks, so none of them is preempted
    ref_eng = engine("")
    slots = ref_eng.model.num_slots
    short = [rs.randint(0, vocab, (CLASS_LEN,)) for _ in range(slots)]
    try:
        refs = {}
        groups = [[("victim", i, p) for i, p in enumerate(victims)],
                  [("class", i, p) for i, p in enumerate(short)]] + [
            [("greedy", i, greedy[i])
             for i in range(j, min(j + GREEDY_SLOTS, len(greedy)))]
            for j in range(0, len(greedy), GREEDY_SLOTS)]
        for g in groups:
            hs = [ref_eng.submit(p, TENANCY_NEW, rid=f"ref-{t}{i}")
                  for t, i, p in g]
            _wait_done(hs)
            for (t, i, _), h in zip(g, hs):
                if h.outcome != "ok" or h.preempts:
                    raise AssertionError(f"{phase} reference {t}{i}: "
                                         f"{h.outcome} {h.preempts}")
                refs[(t, i)] = h.tokens
    finally:
        ref_eng.stop()

    half = len(greedy) // 2

    def ref_of(rid):
        """The reference of a stream by its id: ``victim<i>``,
        ``greedy<i>``, ``class<i>``, or the fair run's ``a<i>`` (greedy
        prompt i) and ``b<i>`` (greedy prompt half + i)."""
        for prefix, t, off in (("victim", "victim", 0),
                               ("greedy", "greedy", 0),
                               ("class", "class", 0),
                               ("a", "greedy", 0), ("b", "greedy", half)):
            if rid.startswith(prefix):
                return refs[(t, off + int(rid[len(prefix):]))]
        raise KeyError(rid)

    def check_streams(label, handles):
        bad = [(h.id, h.outcome, h.preempts) for h in handles
               if h.outcome != "ok" or h.tokens != ref_of(h.id)]
        if bad:
            raise AssertionError(f"{phase} {label}: streams differ from "
                                 f"their references: {bad}")

    results = {}
    K.reset_launch_counts()
    # the victim alone
    eng = engine(TENANT_CONFIG)
    try:
        leg = _victim_leg(eng, victims, TENANCY_NEW, qos=False)
        check_streams("unloaded", [v["h"] for v in leg])
        results["unloaded"] = _victim_numbers(leg)
        used = _settled_blocks([eng])
    finally:
        eng.stop()
    emit({"phase": phase, "run": "unloaded", "card": card,
          **results["unloaded"], "used_blocks_after": used})

    for label, cfg in (("flood_qos_off", ""), ("flood_qos_on",
                                                TENANT_CONFIG)):
        qos = bool(cfg)
        eng = engine(cfg)
        handles, sheds, most = [], [], [0]
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                with eng._lock:
                    n = eng._slots_by_tenant().get("greedy", 0)
                most[0] = max(most[0], n)
                time.sleep(0.002)

        c0 = {r: _tenant_preempted.labels(tenant="greedy", reason=r).value
              for r in ("class", "kv")}
        watcher = threading.Thread(target=watch, daemon=True)
        flooder = threading.Thread(target=_flood, daemon=True, args=(
            eng, greedy, "greedy", handles, sheds))
        try:
            t0 = time.perf_counter()
            watcher.start()
            flooder.start()
            while not handles or handles[0].first_token_at is None:
                time.sleep(0.001)
            leg = _victim_leg(eng, victims, TENANCY_NEW, qos)
            flooder.join(900)
            _wait_done(handles)
            wall = time.perf_counter() - t0
            stop.set()
            watcher.join(10)
            check_streams(label, handles + [v["h"] for v in leg])
            used = _settled_blocks([eng])
            st = eng.stats()
        finally:
            stop.set()
            eng.stop()
        nums = _victim_numbers(leg)
        results[label] = nums
        hints = sorted({s[2] for s in sheds})
        ahead = all(v["h"].admit_seq < g.admit_seq
                    for v in leg for g in v["waiting"])
        line = {"phase": phase, "run": label, "card": card, "wall_s": wall,
                **nums, "greedy_sheds": len(sheds),
                "greedy_shed_hints_ms": hints[:3] + hints[-3:],
                "max_greedy_slots": most[0], "preempts": st["preempts"],
                "greedy_preempts": {
                    r: _tenant_preempted.labels(tenant="greedy",
                                                reason=r).value - c0[r]
                    for r in c0},
                "victim_admitted_ahead": ahead,
                "victim_waited_behind": [len(v["waiting"]) for v in leg],
                "used_blocks_after": used}
        if qos:
            line["tenants"] = st.get("tenants")
        emit(line)
        bad_sheds = [s for s in sheds if s[0] != "greedy" or s[1] != "rate"
                     or not 0 < s[2] <= 1000.0 / GREEDY_RATE + 1]
        if any(used) or (qos and (not sheds or bad_sheds or not ahead or
                                  most[0] > GREEDY_SLOTS)) or \
                (not qos and sheds):
            raise AssertionError(f"{phase} {label}: {line}, bad sheds "
                                 f"{bad_sheds[:3]}")

    # class preemption: greedy on every slot, then a victim arrives
    eng = engine(CLASS_CONFIG)
    c0 = _tenant_preempted.labels(tenant="greedy", reason="class").value
    try:
        hs = [eng.submit(p, TENANCY_NEW, rid=f"class{i}", tenant="greedy")
              for i, p in enumerate(short)]
        while sum(1 for h in hs if len(h.tokens) >= 2) < slots:
            if all(h.done for h in hs):
                break
            time.sleep(0.001)
        v = eng.submit(victims[0], TENANCY_NEW, rid="victim0",
                       tenant="victim")
        _wait_done(hs + [v])
        check_streams("class_preempt", hs + [v])
        used = _settled_blocks([eng])
    finally:
        eng.stop()
    moved = _tenant_preempted.labels(tenant="greedy",
                                     reason="class").value - c0
    resumed = [h.id for h in hs if h.preempts]
    line = {"phase": phase, "run": "class_preempt", "card": card,
            "class_preemptions": moved, "resumed_streams": resumed,
            "victim_ttft_s": v.ttft(), "used_blocks_after": used}
    emit(line)
    if moved < 1 or not resumed or any(used):
        raise AssertionError(f"{phase} class_preempt: {line}")

    # weighted-fair share: both tenants backlogged
    eng = engine(FAIR_CONFIG)
    try:
        hs = []
        for i in range(half):
            hs.append(eng.submit(greedy[i], TENANCY_NEW, rid=f"a{i}",
                                 tenant="a"))
            hs.append(eng.submit(greedy[half + i], TENANCY_NEW,
                                 rid=f"b{i}", tenant="b"))
        while sum(1 for h in hs if h.done) < half:
            time.sleep(0.002)
        served = {t: v["served_tokens"]
                  for t, v in eng.stats()["tenants"].items()}
        _wait_done(hs)
        check_streams("fair_share", hs)
        used = _settled_blocks([eng])
    finally:
        eng.stop()
    _sync(torch, device)
    counts = K.launch_counts()
    raw = served["a"] / max(served["b"], 1)
    emit({"phase": phase, "run": "fair_share", "card": card,
          "served_tokens": served,
          "served_per_weight": {"a": served["a"] / 4.0, "b": served["b"]},
          "fair_share_ratio": raw, "fair_share_normalized": raw / 4.0,
          "used_blocks_after": used})
    if any(used):
        raise AssertionError(f"{phase} fair_share: {used} blocks held")

    base = results["unloaded"]
    summary = {"phase": phase, "run": "victim_ratios", "card": card,
               "bar": TENANCY_BAR}
    for label in ("flood_qos_off", "flood_qos_on"):
        r = results[label]
        summary[label] = {
            k: (r[k] / base[k] if base[k] else None)
            for k in ("ttft_p50_s", "ttft_p99_s", "inter_token_p99_s")}
    summary["bar_holds_qos_on"] = \
        summary["flood_qos_on"]["ttft_p99_s"] is not None and \
        summary["flood_qos_on"]["ttft_p99_s"] <= TENANCY_BAR
    summary["launches"] = counts
    emit(summary)
    if device == "cuda" and (counts["flash_attention"] <= 0 or
                             counts["paged_decode"] <= 0):
        raise AssertionError(f"{phase}: kernels not launched: {counts}")
    return counts


def tiny_prompts():
    """The serving phases' prompt lengths at ``llama:tiny``'s vocab."""
    import numpy as np
    rs = np.random.RandomState(7)
    return [rs.randint(0, 256, (n,)) for n in (20, 100, 300, 480)]


def phase_tiny_disagg(torch, K, device="cuda"):
    """``disagg_run`` at ``llama:tiny`` (the prompts of the main path's
    lengths), f32 and int8 caches."""
    from zoo_tpu_torch.serving.llm import build_llm_engine
    prompts = tiny_prompts()
    params = build_llm_engine("llama:tiny", device=device,
                              start=False).model.params
    for kv in ("f32", "int8"):
        direct, ttft = direct_streams("llama:tiny", params, prompts, 16,
                                      device, kv_dtype=kv)
        disagg_run(torch, K, "llama:tiny", params, prompts, 16, direct,
                   ttft, kv, device, "disagg-tiny")


def phase_tiny_tenancy(torch, K, device="cuda"):
    """``tenancy_run`` at ``llama:tiny``."""
    from zoo_tpu_torch.serving.llm import build_llm_engine
    params = build_llm_engine("llama:tiny", device=device,
                              start=False).model.params
    tenancy_run(torch, K, "llama:tiny", params, 256, device,
                "tenancy-tiny")


# the replies of the served ResNet-50 against its direct predict:
# mixed_bfloat16's tolerance of tests/test_torch_resnet.py (TOL, :41)
TOL_PREDICT_BF16 = 4e-3
# the served VGG-16 v1's logits (its softmax head set aside) against
# plain_kernels(), as a share of the plain logits' range: seed weights
# leave its 1000 probabilities near 1e-3 each, where TOL_PREDICT_BF16
# would pass a conv that wrote zeros; 2^-4 is far above what bf16
# rounding gives (a whole float32 forward of seed weights differs from
# a mixed_bfloat16 one by under 2^-7 of the range), and a conv that
# writes zeros or garbage moves the logits by about their range
TOL_VGG_LOGITS_REL = 2.0 ** -4
PREDICT_B, PREDICT_CLIENTS, PREDICT_PER_CLIENT = 32, 32, 16
# bench.py bench_serving: an MLP behind the micro-batcher, 8 clients,
# 200 requests a batch size, batch sizes 8 and 32
MLP_FEAT, MLP_CLIENTS, MLP_REQUESTS = 64, 8, 200
OBS_TRACE_REQUESTS = 300


def phase_predict_tiny(torch, K):
    """The tiny ResNet of phase 7 served through ``ServingServer``
    (``batch_size=4``) and ``HAServingClient.predict``: float and int8
    replies through the kernels equal the same server's replies with
    every plain version, within phase 7's tolerances."""
    import numpy as np
    from zoo_tpu_torch.models.image import ResNet
    from zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                  quantize_model)
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.server import ServingServer

    m = ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    m.compile("adamw", "sparse_categorical_crossentropy")
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    redraw_batchnorm(torch, m.params, 1)
    n_conv = len(envelope_convs(m))
    x = np.random.RandomState(5).randn(12, 32, 32, 3).astype(np.float32)
    im = InferenceModel().load_keras(m, batch_size=4)
    server = ServingServer(im, batch_size=4, max_wait_ms=2.0).start()
    client = HAServingClient([(server.host, server.port)], hedge=False,
                             deadline_ms=120_000)

    def serve():
        # one request at a time: each reply a batch of its own
        return np.concatenate([client.predict(x[i:i + 1])
                               for i in range(len(x))])

    try:
        for path in ("float", "int8"):
            if path == "int8":
                quantize_model(m, mode="force")
            K.reset_launch_counts()
            got = serve()
            counts = K.launch_counts()
            with plain_kernels():
                K.reset_launch_counts()
                ref = serve()
                _launched(K.launch_counts())
            diff = float(np.abs(got - ref).max())
            tol = TOL_TINY_F32 if path == "float" else 0.0
            emit({"phase": "predict-tiny", "path": path,
                  "requests": len(x), "max_abs_err": diff, "tol": tol,
                  "launches": {k: counts[k] for k in INFER_KERNELS}})
            if not (np.isfinite(got).all() and got.shape == (12, 10)):
                raise AssertionError(f"predict-tiny {path}: {got}")
            if path == "float":
                _launched(counts, conv2d=len(x) * n_conv)
            else:
                _launched(counts, conv2d_int8=len(x) * n_conv,
                          fused_quantized_matmul=len(x))
            if not diff <= tol:
                raise AssertionError(f"predict-tiny {path}: served "
                                     f"replies differ by {diff}")
    finally:
        client.close()
        server.stop()


def phase_predict_mlp(torch, card):
    """``bench.py`` ``bench_serving`` in the port: ``Dense(128, relu)``
    -> ``Dense(10, softmax)`` over 64 features behind
    ``InferenceModel(supported_concurrent_num=2)`` and a
    ``ServingServer`` with two batcher threads and ``max_wait_ms=2.0``,
    at batch sizes 8 and 32: a concurrent warm-up storm, then 200
    requests from 8 clients, each on a connection of its own (the
    ``_Connection`` a ``TCPInputQueue`` holds); p50, p99 and req/s, and
    the JAX guard (p99 at most 10x p50, or under 250 ms). The MLP runs
    no kernel of the port: the row is the door's own cost."""
    import gc

    import numpy as np
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from zoo_tpu_torch.pipeline.inference import InferenceModel
    from zoo_tpu_torch.serving.server import ServingServer
    from zoo_tpu_torch.serving.tcp_client import _Connection

    m = Sequential()
    m.add(Dense(128, input_shape=(MLP_FEAT,), activation="relu"))
    m.add(Dense(10, activation="softmax"))
    m.compile(optimizer="sgd", loss="mse")
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    model = InferenceModel(supported_concurrent_num=2).load_keras(m)
    xs = np.random.RandomState(0).randn(
        MLP_CLIENTS, MLP_FEAT).astype(np.float32)
    guard = []
    for srv_bs in (8, 32):
        server = ServingServer(model, port=0, batch_size=srv_bs,
                               max_wait_ms=2.0, num_replicas=2).start()
        conns = [_Connection(server.host, server.port)
                 for _ in range(MLP_CLIENTS)]
        try:
            _predict_storm(conns, xs, MLP_CLIENTS, 4)
            gc.collect()
            replies, errors, wall = _predict_storm(
                conns, xs, MLP_CLIENTS, MLP_REQUESTS // MLP_CLIENTS)
            line = _latency_line(replies, wall)
            p50, p99 = line["p50_ms"], line["p99_ms"]
            emit({"phase": "predict-mlp", "batch_size": srv_bs,
                  "card": card, "clients": MLP_CLIENTS, **line,
                  "p99_over_p50": p99 / p50, "errors": len(errors),
                  "batches": server.timers["inference"].n,
                  "stats": {k: t.stats()
                            for k, t in server.timers.items()}})
            bad = [y for _, _, y, _ in replies
                   if y.shape != (1, 10) or not np.isfinite(y).all()]
            if errors or bad or len(replies) != MLP_REQUESTS:
                raise AssertionError(
                    f"predict-mlp bs{srv_bs}: {len(replies)} replies, "
                    f"errors {errors[:3]}, bad replies {bad[:1]}")
            if p99 > 10 * max(p50, 0.1) and p99 > 250.0:
                guard.append(f"bs{srv_bs}: p99 {p99:.1f} ms > 10x p50 "
                             f"{p50:.1f} ms")
        finally:
            for conn in conns:
                conn.close()
            server.stop()
    if guard:
        raise AssertionError("predict-mlp latency guard: "
                             + "; ".join(guard))
    phase_obs_trace(model, card)


class _CountedModel:
    """A served model that counts its ``predict`` calls (the batches it
    ran, and a reload's warm-up batches)."""

    def __init__(self, model, calls=0):
        self.model, self.calls = model, calls
        self._device = getattr(model, "_device", None)

    def predict(self, x, batch_size=None):
        self.calls += 1
        return self.model.predict(x, batch_size=batch_size)


def _predict_storm(client, images, n_clients, per_client, at=None,
                   stop=None):
    """``n_clients`` threads, each sending ``per_client`` single-image
    requests (client ``c``'s ``i``-th is image ``(c + i) % len``; with
    ``stop``, until it is set) as ``predict`` ops through
    ``client.rpc``, or through ``client[c].rpc`` where ``client`` is a
    list, one a thread; ``at`` =
    ``(count, fn)`` calls ``fn`` on a thread of its own once ``count``
    replies are in. Returns ``(replies, errors, wall_s)``, each reply
    ``(image, version, output, latency_s)``."""
    import threading

    import numpy as np
    replies, errors = [], []
    lock = threading.Lock()
    fired = threading.Event()

    def worker(c):
        mine = client[c] if isinstance(client, list) else client
        i = 0
        while (stop is None and i < per_client) or \
                (stop is not None and not stop.is_set()):
            k = (c + i) % len(images)
            t0 = time.perf_counter()
            try:
                resp = mine.rpc({"op": "predict", "uri": f"c{c}-{i}",
                                 "data": images[k:k + 1]})
                if "error" in resp:
                    raise RuntimeError(resp["error"])
                rec = (k, resp.get("version"), np.asarray(resp["result"]),
                       time.perf_counter() - t0)
                with lock:
                    replies.append(rec)
                    due = at is not None and len(replies) >= at[0] and \
                        not fired.is_set()
                    if due:
                        fired.set()
                if due:
                    threading.Thread(target=at[1], daemon=True).start()
            except Exception as e:  # noqa: BLE001 — every failure counts
                with lock:
                    errors.append(f"client {c} request {i}: {e!r}")
            i += 1

    threads = [threading.Thread(target=worker, args=(c,))
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return replies, errors, time.perf_counter() - t0


def _direct_outputs(model, images, batch):
    """Each image's output through ``model.predict`` in a batch of
    ``batch`` rows, the image first and zeros after."""
    import numpy as np
    out = []
    for k in range(len(images)):
        xb = np.zeros((batch,) + images.shape[1:], images.dtype)
        xb[0] = images[k]
        out.append(np.asarray(model.predict(xb, batch_size=batch))[0])
    return np.stack(out)


def _check_replies(label, replies, direct):
    """Every reply against its version's direct output: within
    ``TOL_PREDICT_BF16``; returns (max error, bit-equal count, replies
    by version)."""
    import numpy as np
    worst, equal, by_version = 0.0, 0, {}
    for k, version, y, _ in replies:
        if version not in direct:
            raise AssertionError(f"{label}: a reply echoes {version!r}")
        by_version[version] = by_version.get(version, 0) + 1
        ref = direct[version][k]
        if y.shape != (1,) + ref.shape or not np.isfinite(y).all():
            raise AssertionError(f"{label}: reply of shape {y.shape}")
        worst = max(worst, float(np.abs(y[0] - ref).max()))
        equal += int(np.array_equal(y[0], ref))
    if not worst <= TOL_PREDICT_BF16:
        raise AssertionError(f"{label}: a reply differs from its "
                             f"version's direct predict by {worst}")
    return worst, equal, by_version


def _latency_line(replies, wall):
    import numpy as np
    lat = np.asarray(sorted(r[3] for r in replies)) * 1e3
    return {"requests": len(replies), "wall_s": wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "req_per_s": len(replies) / wall}


def phase_predict_main(torch, K, card):
    """ResNet-50 at full width and depth served from a model registry:
    v1 float and v2 int8 (``quantize_model(mode="force")``) published
    as model files, ``resolve_model_spec("registry:<root>:prod")`` into
    a ``ServingServer`` (``batch_size=32``, ``max_wait_ms=5``), 32
    client threads x 16 single-image requests through
    ``HAServingClient.predict``, a ``reload`` to v2 midway; each
    version's kernels held to their plain versions at batch 32. Then a
    ``ReplicaGroup`` of two ``--device cuda`` replica processes booted
    from the same registry spec, rolled from v2 back to v1 with
    ``rolling_update()`` under client load. Returns the in-process
    run's kernel launches."""
    import shutil
    import tempfile

    import numpy as np
    from zoo_tpu_torch.models.image import resnet50
    from zoo_tpu_torch.pipeline.inference import quantize_model
    from zoo_tpu_torch.serving.ha import resolve_model_spec
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.registry import ModelRegistry
    from zoo_tpu_torch.serving.server import ServingServer
    from zoo_tpu_torch.serving.tcp_client import _Connection
    from zoo_tpu_torch.util.resilience import Deadline

    B = PREDICT_B
    root = tempfile.mkdtemp(prefix="zoo-smoke-registry-")
    try:
        t0 = time.perf_counter()
        m = resnet50(1000, (224, 224, 3))
        m.compile("sgd", "sparse_categorical_crossentropy",
                  dtype_policy="mixed_bfloat16")
        m.build(torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
        redraw_batchnorm(torch, m.params, 1)
        n_conv = len(envelope_convs(m))
        reg = ModelRegistry(os.path.join(root, "registry"))
        m.save(os.path.join(root, "model.zoo"))
        v1 = reg.publish(os.path.join(root, "model.zoo"), alias="prod")
        quantize_model(m, mode="force")
        m.save(os.path.join(root, "model.zoo"))
        v2 = reg.publish(os.path.join(root, "model.zoo"))
        publish_s = time.perf_counter() - t0
        del m
        torch.cuda.empty_cache()
        spec = f"registry:{reg.root}:prod"
        models = {}

        def loader(s):
            # InferenceModel.load runs one warm-up batch at batch_size
            im, version = resolve_model_spec(s, batch_size=B)
            models[version] = _CountedModel(im, calls=1)
            return models[version], version

        t0 = time.perf_counter()
        model, version = loader(spec)
        load_s = time.perf_counter() - t0
        images = np.random.RandomState(0).randn(
            16, 224, 224, 3).astype(np.float32)
        server = ServingServer(model, batch_size=B, max_wait_ms=5.0,
                               version=version, model_spec=spec,
                               model_loader=loader).start()
        client = HAServingClient([(server.host, server.port)],
                                 deadline_ms=600_000)
        reload_info = {}

        def reload_v2():
            # one attempt on a connection of its own: a hedged duplicate
            # of a reload would load the version twice
            conn = _Connection(server.host, server.port)
            try:
                reload_info.update(conn.rpc(
                    {"op": "reload", "spec": f"registry:{reg.root}:{v2}"},
                    deadline=Deadline(600.0)))
            finally:
                conn.close()

        try:
            # one warm-up window, uncounted
            _predict_storm(client, images, B, 1)
            for mod in models.values():
                mod.calls = 0
            served0 = server.timers["inference"].n
            K.reset_launch_counts()
            torch.cuda.synchronize()
            n = PREDICT_CLIENTS * PREDICT_PER_CLIENT
            replies, errors, wall = _predict_storm(
                client, images, PREDICT_CLIENTS, PREDICT_PER_CLIENT,
                at=(n // 2, reload_v2))
            torch.cuda.synchronize()
            counts = K.launch_counts()
            batches = {v: mod.calls for v, mod in models.items()}
            direct = {v: _direct_outputs(mod.model, images, B)
                      for v, mod in models.items()}
            # each version's kernels against their plain versions at the
            # served shapes (B = 32: a part-filled GEMM tile, a 7x7
            # stage of 1568 rows), which the replies alone cannot show:
            # a reply is held to the same kernels' direct predict
            with plain_kernels():
                K.reset_launch_counts()
                plain = {v: _direct_outputs(mod.model, images, B)
                         for v, mod in models.items()}
                _launched(K.launch_counts())
            vs_plain = {v: float(np.abs(direct[v] - plain[v]).max())
                        for v in direct}
            worst, equal, by_version = _check_replies(
                "predict-main", replies, direct)
            served = server.timers["inference"].n - served0
            occupancy = n / max(1, served)
            emit({"phase": "predict-main", "run": "in_process",
                  "model": "resnet50(1000, (224, 224, 3))",
                  "policy": "mixed_bfloat16", "card": card,
                  "batch_size": B, "clients": PREDICT_CLIENTS,
                  "publish_s": publish_s, "load_s": load_s,
                  **_latency_line(replies, wall),
                  "errors": len(errors), "replies_by_version": by_version,
                  "batches_by_version": batches,
                  "served_batches": served,
                  "mean_batch_occupancy": occupancy,
                  "launches": {k: counts[k] for k in INFER_KERNELS},
                  "launches_per_batch": {
                      v1: {"conv2d": counts["conv2d"] / batches[v1]},
                      v2: {k: counts[k] / batches[v2] for k in (
                          "conv2d_int8", "fused_quantized_matmul")}},
                  "reload": {k: reload_info.get(k) for k in (
                      "ok", "version", "previous", "warmed",
                      "reload_seconds")},
                  "max_abs_err_vs_direct": worst,
                  "bit_equal_replies": equal, "tol": TOL_PREDICT_BF16,
                  "vs_plain_max_abs": vs_plain,
                  "vs_plain_tol": {v1: TOL_PREDICT_BF16, v2: 0.0},
                  "stats": {k: t.stats()
                            for k, t in server.timers.items()}})
            if errors:
                raise AssertionError(
                    f"predict-main: {len(errors)} failed request(s): "
                    + "; ".join(errors[:5]))
            if len(replies) != n or reload_info.get("version") != v2 or \
                    set(by_version) != {v1, v2}:
                raise AssertionError(
                    f"predict-main: {len(replies)} replies of {n}, "
                    f"reload {reload_info}, versions {by_version}")
            _launched(counts, conv2d=n_conv * batches[v1],
                      conv2d_int8=n_conv * batches[v2],
                      fused_quantized_matmul=batches[v2])
            if not (vs_plain[v1] <= TOL_PREDICT_BF16
                    and np.array_equal(direct[v2], plain[v2])):
                raise AssertionError(
                    f"predict-main: the kernels differ from their plain "
                    f"versions at batch {B} by {vs_plain}")
            # where a served batch's time goes, per version, and the
            # device's busy share over a storm
            for v in (v1, v2):
                xb = np.zeros((B, 224, 224, 3), np.float32)
                xb[:16] = images
                t = timed(torch, lambda: models[v].model.predict(
                    xb, batch_size=B), 4, warmup=1)
                emit({"phase": "predict-step", "version": v, "card": card,
                      "batch": B, "wall_ms": t["wall_ms"],
                      "host_ms": t["host_ms"],
                      "device_ms": t["device_ms"],
                      "device_busy_share": t["device_busy_share"],
                      "device_launches": t["device_launches"],
                      "top_device_ms": [[k[:80], ms] for k, ms in sorted(
                          t["by_name"].items(), key=lambda kv: -kv[1])[
                              :8]]})
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                sampled, _, _ = _predict_storm(client, images,
                                               PREDICT_CLIENTS, 4)
                torch.cuda.synchronize()
                busy_wall = time.perf_counter() - t0
            device_s = sum(
                (getattr(e, "self_device_time_total", None) or 0.0)
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
            ) / 1e6
            emit({"phase": "predict-main", "run": "busy_share",
                  "card": card, "requests": len(sampled),
                  "wall_s": busy_wall, "device_s": device_s,
                  "device_busy_share": device_s / busy_wall,
                  "note": "under torch.profiler"})
        finally:
            client.close()
            server.stop()
        del server, client, models, model
        torch.cuda.empty_cache()
        _predict_group(reg, v1, v2, images, direct, card)
        _chaos_ejection(reg, v1, images, direct[v1], card)
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _predict_group(reg, v1, v2, images, direct, card):
    """Two ``--device cuda`` replica processes booted from
    ``registry:<root>:prod`` (prod moved to v2 first), their versions
    and ``/healthz``, then prod moved to v1 and ``rolling_update()``
    under client load: zero failed requests, every reply within
    tolerance of its version's direct output, and the group ends on v1
    with no mixed versions."""
    import tempfile
    import threading

    from zoo_tpu_torch.serving.ha import ReplicaGroup

    reg.set_alias("prod", v2)
    log_dir = tempfile.mkdtemp(prefix="zoo-smoke-predict-group-")
    group = ReplicaGroup(f"registry:{reg.root}:prod", num_replicas=2,
                         batch_size=PREDICT_B, max_wait_ms=5.0,
                         max_restarts=0, log_dir=log_dir, device="cuda")
    try:
        t0 = time.perf_counter()
        group.start(timeout=300)
        boot_s = time.perf_counter() - t0
        before = [d and d.get("version") for d in group.version_info()]
        health = group.healthz()
        if before != [v2, v2] or not all(h and h.get("ok")
                                         for h in health):
            raise AssertionError(f"predict-group: versions {before}, "
                                 f"healthz {health}")
        client = group.client(deadline_ms=600_000)
        _predict_storm(client, images, 8, 2)     # warm both seats
        stop = threading.Event()
        result = {}

        def roll():
            try:
                reg.set_alias("prod", v1)
                t = time.perf_counter()
                result["update"] = group.rolling_update()
                result["seconds"] = time.perf_counter() - t
            except Exception as e:  # noqa: BLE001 — reported below
                result["error"] = repr(e)
            finally:
                stop.set()

        replies, errors, wall = _predict_storm(
            client, images, 16, 0, at=(16, roll), stop=stop)
        after = [d and d.get("version") for d in group.version_info()]
        worst, equal, by_version = _check_replies(
            "predict-group", replies, direct)
        emit({"phase": "predict-main", "run": "replica_group",
              "card": card, "replicas": 2, "boot_s": boot_s,
              "versions_before": before, "healthz": health,
              **_latency_line(replies, wall), "errors": len(errors),
              "rolling_update": result, "versions_after": after,
              "replies_by_version": by_version,
              "max_abs_err_vs_direct": worst, "bit_equal_replies": equal,
              "restarts": group.restarts()})
        client.close()
        if errors or "error" in result or after != [v1, v1]:
            raise AssertionError(
                f"predict-group: {len(errors)} failed request(s) "
                f"{errors[:3]}, rolling update {result}, versions "
                f"{after}")
    except Exception:
        _replica_logs(log_dir, 2)
        raise
    finally:
        group.stop()


CHAOS_REQUESTS, CHAOS_CLIENTS, CHAOS_SLOWDOWN = 360, 4, 20.0


def _chaos_ejection(reg, v1, images, direct, card):
    """``chaos_ejection``: ``bench.py`` ``bench_chaos_ejection``'s mix on
    real work. Three ``--device cuda`` replica processes of ResNet-50 v1
    from the registry (``ZOO_CHAOS_ALLOW=1``), 360 single-image requests
    from 4 clients, hedge off; replica 1 slowed over the wire ``chaos``
    op (``serving.infer``) by 20x the unloaded p50 of a served request
    measured first in this run (the bench's 40 ms over its synthetic
    model's 2 ms), then cleared; ejection off, then on (the bench's
    ``EjectionConfig``). Required: every reply bit-equal to v1's direct
    predict, no request failed, replica 1 ejected, the on-p99 below the
    off-p99 (both over the last two thirds, as the bench)."""
    import tempfile
    import threading

    import numpy as np
    from zoo_tpu_torch.serving.ejection import EjectionConfig
    from zoo_tpu_torch.serving.ha import ReplicaGroup
    from zoo_tpu_torch.serving.ha_client import HAServingClient

    log_dir = tempfile.mkdtemp(prefix="zoo-smoke-chaos-ejection-")
    group = ReplicaGroup(f"registry:{reg.root}:{v1}", num_replicas=3,
                         batch_size=PREDICT_B, max_wait_ms=5.0,
                         max_restarts=0, log_dir=log_dir, device="cuda",
                         env={"ZOO_CHAOS_ALLOW": "1"})
    mismatched, failed = [], []

    def check(k, y):
        if not np.array_equal(np.asarray(y)[0], direct[k]):
            mismatched.append(k)

    try:
        t0 = time.perf_counter()
        group.start(timeout=300)
        boot_s = time.perf_counter() - t0
        probe = HAServingClient(group.endpoints(), deadline_ms=600_000,
                                hedge=False,
                                ejection_config=EjectionConfig(
                                    enabled=False))
        for k in range(12):               # every seat warm
            check(k % len(images), probe.predict(images[k % len(images):][:1]))
        lats = []
        for k in range(30):
            t = time.perf_counter()
            check(k % len(images), probe.predict(images[k % len(images):][:1]))
            lats.append(time.perf_counter() - t)
        probe.close()
        unloaded_p50_ms = _pct(lats, 50) * 1e3
        slow_ms = CHAOS_SLOWDOWN * unloaded_p50_ms

        def run(eject_on):
            cfg = EjectionConfig(
                enabled=eject_on, min_ms=20.0, min_samples=4,
                probation_s=0.4, probe_interval_s=0.3, readmit_base_s=0.5)
            client = HAServingClient(group.endpoints(),
                                     deadline_ms=600_000, hedge=False,
                                     ejection_config=cfg)
            for k in range(12):
                check(k % len(images),
                      client.predict(images[k % len(images):][:1]))
            group.chaos_rpc(1, "serving.infer", delay_ms=slow_ms)
            t_slow = time.monotonic()
            got, lock = [], threading.Lock()

            def one_client(c):
                for i in range(CHAOS_REQUESTS // CHAOS_CLIENTS):
                    k = (c * 5 + i) % len(images)
                    t = time.perf_counter()
                    try:
                        y = client.predict(images[k:k + 1])
                    except Exception as e:  # noqa: BLE001 — counted
                        with lock:
                            failed.append(repr(e))
                        continue
                    t1 = time.perf_counter()
                    with lock:
                        got.append((t1, t1 - t, k, y))

            threads = [threading.Thread(target=one_client, args=(c,))
                       for c in range(CHAOS_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            group.chaos_rpc(1, "serving.infer", clear=True)
            detect = None
            for ts, kind, _seat in client.ejection_events():
                if kind == "ejected":
                    detect = ts - t_slow
                    break
            client.close()
            for _, _, k, y in got:
                check(k, y)
            got.sort(key=lambda r: r[0])
            steady = [r[1] * 1e3 for r in got[len(got) // 3:]]
            return _pct(steady, 99), _pct(steady, 50), detect, len(got)

        off_p99, off_p50, _, n_off = run(False)
        on_p99, on_p50, detect, n_on = run(True)
        emit({"phase": "predict-main", "run": "chaos_ejection",
              "card": card, "replicas": 3, "boot_s": boot_s,
              "requests": CHAOS_REQUESTS, "clients": CHAOS_CLIENTS,
              "unloaded_p50_ms": unloaded_p50_ms, "slow_ms": slow_ms,
              "chaos_ejection_off_p50_ms": off_p50,
              "chaos_ejection_off_p99_ms": off_p99,
              "chaos_ejection_on_p50_ms": on_p50,
              "chaos_ejection_on_p99_ms": on_p99,
              "chaos_ejection_detect_ms":
                  None if detect is None else detect * 1e3,
              "chaos_ejection_p99_speedup": off_p99 / on_p99,
              "replies": n_off + n_on, "failed": len(failed),
              "not_bit_equal": len(mismatched)})
        if failed or mismatched or detect is None or not on_p99 < off_p99 \
                or n_off + n_on != 2 * CHAOS_REQUESTS:
            raise AssertionError(
                f"chaos_ejection: {len(failed)} failed {failed[:3]}, "
                f"{len(mismatched)} replies not bit-equal, detect "
                f"{detect}, p99 on {on_p99} off {off_p99}")
    except Exception:
        _replica_logs(log_dir, 3)
        raise
    finally:
        group.stop()


def phase_obs_trace(model, card):
    """``obs_trace``: ``bench.py`` ``bench_obs_trace``'s A/B on the door
    of ``bench_serving``'s MLP — ``HAServingClient`` (hedge off) ->
    ``ServingServer`` (``batch_size=8``, ``max_wait_ms=1``) over the MLP,
    20 warm-up requests, then 300 timed ones, request-scoped tracing off
    and on (every request minting a trace id, every hop writing JSONL
    spans), twice each, interleaved; req/s and the overhead in percent
    from the better run of each. Then the disabled path: with no sink a
    ``span()`` costs at most the bench's 100 us (best of 5 x 50000)."""
    import shutil
    import tempfile

    import numpy as np
    from zoo_tpu_torch.obs import tracing
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.server import ServingServer

    x = np.ones((1, MLP_FEAT), np.float32)

    def run():
        srv = ServingServer(model, port=0, batch_size=8,
                            max_wait_ms=1.0).start()
        cli = HAServingClient([(srv.host, srv.port)], hedge=False,
                              deadline_ms=10000)
        try:
            for _ in range(20):
                cli.predict(x)
            t0 = time.perf_counter()
            for _ in range(OBS_TRACE_REQUESTS):
                y = cli.predict(x)
            dt = time.perf_counter() - t0
        finally:
            cli.close()
            srv.stop()
        if y.shape != (1, 10) or not np.isfinite(y).all():
            raise AssertionError(f"obs_trace: a reply of {y.shape}")
        return OBS_TRACE_REQUESTS / dt

    d = tempfile.mkdtemp(prefix="zoo-smoke-obs-trace-")
    off, on = [], []
    try:
        for _ in range(2):
            tracing.stop_tracing()
            off.append(run())
            tracing.trace_to(d)
            on.append(run())
            tracing.stop_tracing()
        spans = sum(1 for e in tracing.read_trace(d)
                    if e.get("name") in ("client.rpc", "server.predict"))
    finally:
        tracing.stop_tracing()
        shutil.rmtree(d, ignore_errors=True)
    n = 50_000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("bench.hot"):
                pass
        best = min(best, time.perf_counter() - t0)
    per_ns = best / n * 1e9
    emit({"phase": "predict-mlp", "run": "obs_trace", "card": card,
          "requests": OBS_TRACE_REQUESTS,
          "obs_trace_off_req_per_sec": off, "obs_trace_on_req_per_sec": on,
          "obs_trace_overhead_pct": 100.0 * (max(off) / max(on) - 1.0),
          "traced_spans": spans, "obs_trace_disabled_span_ns": per_ns})
    if per_ns >= 100_000 or spans < 2 * 2 * OBS_TRACE_REQUESTS:
        raise AssertionError(f"obs_trace: disabled span {per_ns} ns, "
                             f"{spans} spans written")


def _free_ports(n):
    """``n`` distinct free TCP ports on 127.0.0.1 (all held open until
    every one is drawn)."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _cluster_result(oq, uri, budget=120.0, poll=0.002):
    """``uri``'s result from ``oq`` (deleted as read), polled every
    ``poll`` s; None when ``budget`` s pass without one."""
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        out = oq.query_and_delete(uri)
        if not (isinstance(out, str) and out == "[]"):
            return out
        time.sleep(poll)
    return None


def _cluster_http(host, port, image, headers=None):
    """One ``/predict`` instance through a front end: its output."""
    import json
    import urllib.request

    import numpy as np
    body = json.dumps({"instances": [{"t": image.tolist()}]}).encode()
    req = urllib.request.Request(f"http://{host}:{port}/predict", data=body,
                                 headers=dict(headers or {}))
    with urllib.request.urlopen(req, timeout=300) as resp:
        pred = json.loads(resp.read())["predictions"][0]
    if pred == "NaN":
        return pred
    val = json.loads(json.loads(pred)["value"])
    return np.asarray(val["data"], np.float32).reshape(val["shape"])


def _cluster_storm(port, images, n_clients, per_client, label):
    """``n_clients`` threads, each with a queue pair of its own, sending
    ``per_client`` single-image records (client ``c``'s ``i``-th is image
    ``(c + i) % len``) with ``InputQueue.enqueue`` and reading each result
    back with ``OutputQueue.query_and_delete``. Returns ``(replies,
    missing, wall_s)``, each reply ``(image, output, latency_s)``."""
    import threading

    from zoo_tpu_torch.serving import InputQueue, OutputQueue
    replies, missing = [], []
    lock = threading.Lock()

    def worker(c):
        iq = InputQueue(host="127.0.0.1", port=port)
        oq = OutputQueue(host="127.0.0.1", port=port)
        try:
            for i in range(per_client):
                k = (c + i) % len(images)
                uri = f"{label}-c{c}-{i}"
                t0 = time.perf_counter()
                iq.enqueue(uri, t=images[k])
                out = _cluster_result(oq, uri)
                with lock:
                    if out is None:
                        missing.append(uri)
                    else:
                        replies.append((k, out, time.perf_counter() - t0))
        finally:
            iq.db.close()
            iq.output_queue.db.close()
            oq.db.close()

    threads = [threading.Thread(target=worker, args=(c,))
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return replies, missing, time.perf_counter() - t0


def _cluster_check(label, outs, direct):
    """Every output (``(image, output)`` pairs) against its image's
    direct output: no ``"NaN"``, within ``TOL_PREDICT_BF16``; returns
    (max error, bit-equal count)."""
    import numpy as np
    worst, equal = 0.0, 0
    for k, y in outs:
        if isinstance(y, str):
            raise AssertionError(f"{label}: image {k} answered {y!r}")
        ref = direct[k]
        if y.shape != ref.shape or not np.isfinite(y).all():
            raise AssertionError(f"{label}: a reply of shape {y.shape}")
        worst = max(worst, float(np.abs(y - ref).max()))
        equal += int(np.array_equal(y, ref))
    if not worst <= TOL_PREDICT_BF16:
        raise AssertionError(f"{label}: a reply differs from its image's "
                             f"direct predict by {worst}")
    return worst, equal


def _job_counts(cs):
    """The serving job's counters and stage timers (n, total s) now."""
    out = {k: getattr(cs, k) for k in ("records_out", "batches",
                                        "fallback_batches",
                                        "fallback_records", "nan_records")}
    out["timers"] = {k: (t.n, t.total) for k, t in cs.timers.items()}
    return out


def _job_window(before, after):
    """What the job counted between two :func:`_job_counts`, the stage
    timers as mean ms a batch."""
    out = {k: after[k] - before[k] for k in before if k != "timers"}
    out["stage_ms"] = {
        k: 1e3 * (after["timers"][k][1] - before["timers"][k][1])
        / max(1, after["timers"][k][0] - before["timers"][k][0])
        for k in before["timers"]}
    return out


def phase_cluster_tiny(torch, K):
    """The ``Sequential`` MLP of ``tests/test_cluster_serving.py``
    (``Dense(4, relu)`` -> ``Dense(2)`` over 6 features, weights drawn on
    the card) behind ``EmbeddedRedis`` + ``ClusterServing`` +
    ``FrontEnd`` on ``cuda``: queue ``enqueue``/``query``, a ``dequeue``,
    a synchronous ``InputQueue.predict``, an HTTP ``/predict`` with its
    trace and tenant echoed, and a string-and-sparse schema round trip;
    every reply within 1e-5 of a direct ``predict`` (``TOL_TINY_F32``),
    no ``"NaN"``, no fallback. No kernel runs (the MLP's matmuls are
    cuBLAS's, as in ``predict-mlp``)."""
    import json
    import urllib.request

    import numpy as np
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from zoo_tpu_torch.pipeline.inference import InferenceModel
    from zoo_tpu_torch.serving import (ClusterServing, EmbeddedRedis,
                                       FrontEnd, InputQueue, OutputQueue)
    from zoo_tpu_torch.serving.client import (decode_input_b64,
                                              encode_input_b64)

    t_start = time.perf_counter()
    m = Sequential()
    m.add(Dense(4, input_shape=(6,), activation="relu"))
    m.add(Dense(2))
    m.compile(optimizer="adam", loss="mse")
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    im = InferenceModel().load_keras(m)
    xs = np.random.RandomState(0).randn(8, 6).astype(np.float32)
    direct = im.predict(xs)
    redis = EmbeddedRedis().start()
    cs = ClusterServing(im, redis_port=redis.port).start()
    iq = InputQueue(port=redis.port)
    oq = OutputQueue(port=redis.port)
    fe = FrontEnd(cs, iq).start()
    K.reset_launch_counts()
    try:
        outs = []
        for i in range(3):
            iq.enqueue(f"q{i}", t=xs[i])
        for i in range(3):
            y = _cluster_result(oq, f"q{i}", budget=30.0)
            outs.append((i, "missing" if y is None else y))
        iq.enqueue("d3", t=xs[3])
        iq.enqueue("d4", t=xs[4])
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not all(
                not isinstance(oq.query(u), str) for u in ("d3", "d4")):
            time.sleep(0.01)
        drained = oq.dequeue()
        if set(drained) != {"d3", "d4"} or oq.dequeue() != {}:
            raise AssertionError(f"cluster-tiny: dequeue {sorted(drained)}")
        outs += [(3, drained["d3"]), (4, drained["d4"])]
        outs.append((5, np.asarray(iq.predict(xs[5], timeout=30.0))))
        req = urllib.request.Request(
            f"http://{fe.host}:{fe.port}/predict",
            data=json.dumps({"instances": [{"t": xs[6].tolist()}]}).encode(),
            headers={"X-Zoo-Trace": "cluster-tiny", "X-Zoo-Tenant": "t0"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            echoed = (resp.headers.get("X-Zoo-Trace"),
                      resp.headers.get("X-Zoo-Tenant"))
            pred = json.loads(resp.read())["predictions"][0]
        val = json.loads(json.loads(pred)["value"])
        outs.append((6, np.asarray(val["data"], np.float32)))
        metrics = json.loads(urllib.request.urlopen(
            f"http://{fe.host}:{fe.port}/metrics", timeout=30).read())
        schema = decode_input_b64(encode_input_b64(
            s=["a", "b", "c"], t=xs[:2]))
        # a sparse [indices, values, shape] input with every value
        # present decodes to its values in the dense shape
        sparse = decode_input_b64(encode_input_b64(
            sp=[np.array([[0], [1]]), xs[0, :2], np.array([2])]))["sp"]
        worst = 0.0
        for k, y in outs:
            if isinstance(y, str) or np.asarray(y).shape != (2,):
                raise AssertionError(f"cluster-tiny: record {k} -> {y!r}")
            worst = max(worst, float(np.abs(y - direct[k]).max()))
        counts = K.launch_counts()
        emit({"phase": "cluster-tiny", "seconds":
              time.perf_counter() - t_start, "records": len(outs),
              "max_abs_err": worst, "tol": TOL_TINY_F32,
              "echoed": list(echoed),
              "job": {k: metrics[k] for k in (
                  "records_out", "batches", "fallback_records",
                  "nan_records")},
              "launches": {k: counts[k] for k in INFER_KERNELS}})
        if not worst <= TOL_TINY_F32:
            raise AssertionError(f"cluster-tiny: replies differ from the "
                                 f"direct predict by {worst}")
        if echoed != ("cluster-tiny", "t0") or metrics["nan_records"] or \
                metrics["fallback_records"] or metrics["records_out"] != 7:
            raise AssertionError(f"cluster-tiny: headers {echoed}, job "
                                 f"{metrics}")
        if schema["s"] != "a|b|c" or not np.array_equal(
                schema["t"], xs[:2]) or not np.array_equal(sparse, xs[0, :2]):
            raise AssertionError(f"cluster-tiny: schema {schema}, sparse "
                                 f"{sparse}")
        _launched(counts)
    finally:
        fe.stop()
        cs.stop()
        redis.stop()


def _cluster_version(torch, K, card, version, path, mode, images, n_conv):
    """One encrypted VGG-16 file served in this process:
    ``InferenceModel.load_encrypted`` -> ``ClusterServing(batch_size=32)``
    + ``FrontEnd`` over an ``EmbeddedRedis``; a warm-up window, then the
    counted storm (``CLUSTER_CLIENTS`` x ``CLUSTER_PER_CLIENT`` queue
    records) and ``CLUSTER_HTTP`` HTTP instances; the replies against
    each image's direct predict in a zero-padded batch of 32, those
    against ``plain_kernels()`` (v1's logits too), the launches a
    batch, and a ``cluster-step`` profile of one batch. Returns
    (launches, direct outputs)."""
    import numpy as np
    from zoo_tpu_torch.pipeline.inference import InferenceModel
    from zoo_tpu_torch.serving import (ClusterServing, EmbeddedRedis,
                                       FrontEnd, InputQueue)

    B = CLUSTER_B
    t0 = time.perf_counter()
    # decrypted in memory, read through the model file's allowlist, one
    # warm-up batch at B
    im = InferenceModel(supported_concurrent_num=2).load_encrypted(
        path, CLUSTER_SECRET, CLUSTER_SALT, mode=mode, batch_size=B)
    load_s = time.perf_counter() - t0
    per_batch = {"v1": {"conv2d": n_conv},
                 "v2": {"conv2d_int8": n_conv, "quantized_matmul": 1,
                        "fused_quantized_matmul": 2}}[version]
    redis = EmbeddedRedis().start()
    cs = ClusterServing(im, redis_port=redis.port, batch_size=B).start()
    fe = FrontEnd(cs, InputQueue(port=redis.port)).start()
    try:
        # one uncounted window: a batch's worth of records
        _cluster_storm(redis.port, images, B, 1, f"{version}-warm")
        torch.cuda.synchronize()
        before = _job_counts(cs)
        K.reset_launch_counts()
        replies, missing, wall = _cluster_storm(
            redis.port, images, CLUSTER_CLIENTS, CLUSTER_PER_CLIENT, version)
        http = [(k, _cluster_http(fe.host, fe.port, images[k]))
                for k in range(CLUSTER_HTTP)]
        torch.cuda.synchronize()
        counts = K.launch_counts()
        job = _job_window(before, _job_counts(cs))
        direct = _direct_outputs(im, images, B)
        with plain_kernels():
            K.reset_launch_counts()
            plain = _direct_outputs(im, images, B)
            _launched(K.launch_counts())
        vs_plain = float(np.abs(direct - plain).max())
        logits_rel = _logits_vs_plain(K, im, images, B) \
            if version == "v1" else None
        worst, equal = _cluster_check(
            f"cluster-main {version}",
            [(k, y) for k, y, _ in replies] + http, direct)
        n = CLUSTER_CLIENTS * CLUSTER_PER_CLIENT
        lat = np.asarray(sorted(r[2] for r in replies)) * 1e3
        emit({"phase": "cluster-main", "run": "in_process",
              "version": version, "cipher": mode, "card": card,
              "model": f"vgg16({CLUSTER_CLASSES}, {CLUSTER_IMAGE})",
              "policy": "mixed_bfloat16", "batch_size": B,
              "clients": CLUSTER_CLIENTS, "load_s": load_s,
              "records": len(replies), "missing": len(missing),
              "http_instances": len(http), "wall_s": wall,
              "records_per_s": len(replies) / wall,
              "p50_ms": float(np.percentile(lat, 50)),
              "p99_ms": float(np.percentile(lat, 99)),
              "mean_batch_occupancy": job["records_out"]
              / max(1, job["batches"]),
              "job": job,
              "launches": {k: counts[k] for k in INFER_KERNELS},
              "launches_per_batch": {k: counts[k] / max(1, job["batches"])
                                     for k in INFER_KERNELS},
              "max_abs_err_vs_direct": worst, "bit_equal_replies": equal,
              "tol": TOL_PREDICT_BF16, "vs_plain_max_abs": vs_plain,
              "vs_plain_tol": TOL_PREDICT_BF16 if version == "v1" else 0.0,
              "logits_vs_plain_rel": logits_rel,
              "logits_vs_plain_tol_rel": TOL_VGG_LOGITS_REL})
        if missing or len(replies) != n:
            raise AssertionError(f"cluster-main {version}: {len(replies)} "
                                 f"replies of {n}, missing {missing[:5]}")
        if job["fallback_batches"] or job["fallback_records"] or \
                job["nan_records"] or job["records_out"] != n + len(http):
            raise AssertionError(f"cluster-main {version}: job {job}")
        _launched(counts, **{k: v * job["batches"]
                             for k, v in per_batch.items()})
        if not (vs_plain <= TOL_PREDICT_BF16 if version == "v1"
                else np.array_equal(direct, plain)):
            raise AssertionError(
                f"cluster-main {version}: the kernels differ from their "
                f"plain versions at batch {B} by {vs_plain}")
        if logits_rel is not None and not logits_rel <= TOL_VGG_LOGITS_REL:
            raise AssertionError(
                f"cluster-main {version}: the logits differ from plain's by "
                f"{logits_rel} of their range at batch {B}")
        xb = np.zeros((B,) + images.shape[1:], np.float32)
        xb[:len(images)] = images
        t = timed(torch, lambda: im.predict(xb, batch_size=B), 4,
                  warmup=1)
        emit({"phase": "cluster-step", "version": version, "card": card,
              "batch": B, "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
              "device_ms": t["device_ms"],
              "device_busy_share": t["device_busy_share"],
              "device_launches": t["device_launches"],
              "top_device_ms": [[k[:80], ms] for k, ms in sorted(
                  t["by_name"].items(), key=lambda kv: -kv[1])[:8]]})
        return counts, direct
    finally:
        fe.stop()
        cs.stop()
        redis.stop()


def _logits_vs_plain(K, im, images, batch):
    """The largest gap between each image's logits (the output layer's
    activation set aside) with the kernels and under ``plain_kernels()``,
    in direct batches of ``batch``, as a share of the plain logits'
    range."""
    import numpy as np
    head = im.model._topo[-1].layer
    act, head.activation = head.activation, None
    try:
        z = _direct_outputs(im, images, batch)
        with plain_kernels():
            K.reset_launch_counts()
            z_plain = _direct_outputs(im, images, batch)
            _launched(K.launch_counts())
    finally:
        head.activation = act
    return float(np.abs(z - z_plain).max() / np.ptp(z_plain))


def _cluster_cli(path, images, direct, card, log_path):
    """The CLI in a process of its own: ``python -m
    zoo_tpu_torch.serving.run --model <v2> --encrypted --model-enc-mode
    gcm --redis-mode embedded --batch-size 32 --device cuda``, the key
    in ``ZOO_MODEL_SECRET`` / ``ZOO_MODEL_SALT``; boot seconds, then
    ``CLUSTER_CLI_REQUESTS`` queue records from 8 threads and
    ``CLUSTER_CLI_HTTP`` HTTP instances, each within tolerance of the
    in-process v2 direct output, then SIGTERM: drained, rc 0."""
    import json
    import signal
    import socket
    import subprocess
    import urllib.request

    redis_port, http_port = _free_ports(2)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ZOO_MODEL_SECRET=CLUSTER_SECRET,
               ZOO_MODEL_SALT=CLUSTER_SALT,
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("ZOO_MODEL_ENC_MODE", None)
    log = open(log_path, "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "zoo_tpu_torch.serving.run", "--model", path,
         "--encrypted", "--model-enc-mode", "gcm", "--redis-mode",
         "embedded", "--redis-port", str(redis_port), "--http-port",
         str(http_port), "--batch-size", str(CLUSTER_B), "--device",
         "cuda"], cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT)
    rc = None
    try:
        deadline = time.monotonic() + 300
        while True:
            try:
                with socket.create_connection(("127.0.0.1", http_port),
                                              timeout=1):
                    break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("cluster CLI never opened its HTTP "
                                         f"port (rc {proc.poll()})")
                time.sleep(0.2)
        boot_s = time.perf_counter() - t0
        replies, missing, wall = _cluster_storm(
            redis_port, images, 8, CLUSTER_CLI_REQUESTS // 8, "cli")
        http = [(k, _cluster_http("127.0.0.1", http_port, images[k]))
                for k in range(CLUSTER_CLI_HTTP)]
        job = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{http_port}/metrics", timeout=30).read())
        worst, equal = _cluster_check(
            "cluster-main cli", [(k, y) for k, y, _ in replies] + http,
            direct)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    with open(log_path) as f:
        out = f.read()
    boot_line = next((ln for ln in out.splitlines()
                      if ln.startswith("serving: redis")), "")
    emit({"phase": "cluster-main", "run": "cli", "card": card,
          "boot_s": boot_s, "cli_boot_line": boot_line,
          "records": len(replies), "missing": len(missing),
          "http_instances": len(http), "wall_s": wall,
          "records_per_s": len(replies) / wall,
          "max_abs_err_vs_in_process": worst, "bit_equal_replies": equal,
          "job": {k: job[k] for k in ("records_out", "batches",
                                      "fallback_records", "nan_records")},
          "stage_ms": {k: job[k]["avg_ms"] for k in
                       ("decode", "inference", "encode")},
          "drain_rc": rc})
    if missing or len(replies) != CLUSTER_CLI_REQUESTS or \
            job["nan_records"] or job["fallback_records"]:
        raise AssertionError(f"cluster-main cli: {len(replies)} replies, "
                             f"missing {missing[:5]}, job {job}")
    if rc != 0 or "drained" not in out:
        raise AssertionError(f"cluster-main cli: exit {rc} after SIGTERM:\n"
                             + out[-3000:])


def phase_cluster_main(torch, K, card):
    """VGG-16 at full width and depth (224 x 224 x 3, 1000 classes,
    ``mixed_bfloat16``, weights drawn on the card from a seed) served by
    Cluster Serving from encrypted model files: v1 float saved with
    ``save_encrypted`` (AES-CBC), v2 int8 after
    ``quantize_model(mode="force")`` (AES-GCM); each through
    :func:`_cluster_version` in this process, then v2 through the CLI in
    a process of its own (:func:`_cluster_cli`). Returns the in-process
    runs' kernel launches (both versions)."""
    import shutil
    import tempfile

    import numpy as np
    from zoo_tpu_torch.models.image import vgg16
    from zoo_tpu_torch.pipeline.inference import (quantize_model,
                                                  save_encrypted)

    root = tempfile.mkdtemp(prefix="zoo-smoke-cluster-")
    try:
        t0 = time.perf_counter()
        m = vgg16(CLUSTER_CLASSES, CLUSTER_IMAGE)
        m.compile("sgd", "sparse_categorical_crossentropy",
                  dtype_policy="mixed_bfloat16")
        m.build(torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
        n_conv = len(envelope_convs(m))
        if n_conv != VGG_CONVS:
            raise AssertionError(f"VGG-16: {n_conv} convs in the kernels' "
                                 f"envelope, expected {VGG_CONVS}")
        build_s = time.perf_counter() - t0
        files = {"v1": (os.path.join(root, "vgg16-v1.enc"), "cbc"),
                 "v2": (os.path.join(root, "vgg16-v2.enc"), "gcm")}
        save_s = {}
        for version, (path, mode) in files.items():
            if version == "v2":
                quantize_model(m, mode="force")
            t0 = time.perf_counter()
            save_encrypted(m, path, CLUSTER_SECRET, CLUSTER_SALT, mode=mode)
            save_s[version] = time.perf_counter() - t0
        emit({"phase": "cluster-main", "run": "publish", "card": card,
              "build_s": build_s, "save_encrypted_s": save_s,
              "file_bytes": {v: os.path.getsize(p)
                             for v, (p, _) in files.items()}})
        del m
        torch.cuda.empty_cache()
        images = np.random.RandomState(0).randn(
            16, *CLUSTER_IMAGE).astype(np.float32)
        launches, direct = {}, {}
        for version, (path, mode) in files.items():
            counts, direct[version] = _cluster_version(
                torch, K, card, version, path, mode, images, n_conv)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            torch.cuda.empty_cache()
        _cluster_cli(files["v2"][0], images, direct["v2"], card,
                     os.path.join(root, "cli.log"))
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _moe_group(name):
    """The kernel group of a device event of an MoE Llama training step:
    the flash kernels and AdamW by name, every GEMM (the projections, the
    expert products, the dispatch and combine bmm, the head) as
    ``matmul``, the routing's sort and scan as ``routing``, copies, and
    the rest (norms, RoPE, casts, SwiGLU, the one-hot slots, the loss) as
    ``elementwise``."""
    n = name.lower()
    for key, label in (("flash_fwd_tc_kernel", "flash_fwd"),
                       ("flash_bwd_dkdv", "flash_dkdv"),
                       ("flash_bwd_dq", "flash_dq"),
                       ("adam_kernel", "fused_adam")):
        if key in n:
            return label
    if any(s in n for s in ("gemm", "gemv", "cutlass", "matmul", "xmma",
                            "nvjet")):
        return "matmul"
    if any(s in n for s in ("sort", "scan", "radix")):
        return "routing"
    if "memcpy" in n.replace(" ", ""):
        return "copies"
    return "elementwise"


def moe_step_flops(cfg, n_experts, top_k, B, T, capacity_factor=1.25,
                   group=512):
    """One training step's FLOPs as the kernels and GEMMs run them (3x
    the forward; dense over every capacity slot; the causal half of the
    attention core; the remat's recompute not counted), with the
    forward's parts a block and the head's."""
    from zoo_tpu_torch.ops.moe import expert_capacity
    h, hd = cfg["hidden"], cfg["hidden"] // cfg["n_head"]
    kv, f = cfg["n_kv_head"] * hd, cfg["intermediate"]
    N = B * T
    G = min(group, N)
    g = -(-N // G)
    C = expert_capacity(G, n_experts, top_k, capacity_factor)
    slots = n_experts * g * C
    parts = {"projections": 2 * N * (2 * h * h + 2 * h * kv),
             "attention_core": 4 * hd * B * cfg["n_head"] * T * (T + 1) // 2,
             "router": 2 * N * h * n_experts,
             "dispatch_combine": 2 * (2 * g * G * n_experts * C * h),
             "experts": 3 * 2 * slots * h * f}
    head = 2 * N * h * cfg["vocab"]
    fwd = cfg["n_block"] * sum(parts.values()) + head
    return 3 * fwd, {"per_block_forward": parts, "head_forward": head,
                     "capacity": C, "groups": g, "slots_a_block": slots}


def _expert_leaf_adam(torch, K, shape):
    """``fused_apply_adam`` on one stacked expert bank (``shape``, 939.5 M
    elements at Mixtral's widths and 2 blocks) against its plain version
    (step 3, weight decay 0.01), then timed beside its bytes bound and
    the plain version."""
    from zoo_tpu_torch.ops.kernels import fused_optim as FO
    g = torch.Generator(device="cuda").manual_seed(23)

    def leaf(scale, positive=False):
        x = torch.randn(shape, generator=g, device="cuda") * scale
        return x.abs() if positive else x
    p, grad, m, v = leaf(0.05), leaf(0.1), leaf(1e-2), leaf(1e-2, True)
    step = torch.full((), 3, dtype=torch.int32, device="cuda")
    got = FO.fused_apply_adam(p.clone(), grad, m.clone(), v.clone(), step,
                              1e-4, weight_decay=0.01)
    torch.cuda.synchronize()
    errs = []
    for i, ref in enumerate(FO.reference_apply_adam(
            p, grad, m, v, step, 1e-4, weight_decay=0.01)):
        errs.append(float((got[i] - ref).abs().max()))
        del ref
    del got
    torch.cuda.empty_cache()
    n = p.numel()
    b_ms, b_by = bound(7 * 4 * n, 0)
    K.reset_launch_counts()
    t = timed(torch, lambda: FO.fused_apply_adam(p, grad, m, v, step, 1e-4,
                                                 weight_decay=0.01), 5,
              kernel="adam_kernel")
    plain = timed(torch, lambda: FO.reference_apply_adam(
        p, grad, m, v, step, 1e-4, weight_decay=0.01), 3)["device_ms"]
    out = {"shape": list(shape), "elements": n, "max_abs_err": max(errs),
           "ms": t["kernel_ms"] or t["device_ms"], "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "bound_ratio": b_ms / (t["kernel_ms"] or t["device_ms"])}
    del p, grad, m, v
    torch.cuda.empty_cache()
    if max(errs) > TOL["update"]:
        raise AssertionError(f"fused_adam at the expert leaf {shape}: max "
                             f"abs err {max(errs)}")
    return out


def phase_moe_main(torch, K, card):
    """``moe-main``: Keras ``fit`` of ``MoELlama`` at Mixtral-8x7B's
    widths (MOE_CFG, MOE_EXPERTS; 2 blocks, B=2, T=4096) with
    ``remat="dots"``, ``mixed_bfloat16`` and the fused AdamW. First one
    ``training=False`` forward through the flash kernels against the
    dense attention at the seed weights (the logits' max-abs gap, the
    loss); then MOE_STEPS steps on one batch with the launch counts reset
    before and read after: 2 flash forwards, 2 dK/dV and 2 dQ a step, one
    AdamW launch a leaf a step, the first step's loss within TOL_MOE_LOSS
    of the plain forward's (the first step's loss is computed before any
    update), every loss finite and the last under the first; step wall
    and device ms, busy share, tokens/s, ``mfu``, peak memory and the
    device time by group; then ``call_with_aux`` forward and backward
    (finite aux, a nonzero router gradient); then, with the model freed,
    the fused AdamW at one expert bank's size against its plain version.
    Returns the fit's launches."""
    import gc

    import numpy as np
    from zoo_tpu_torch.models.llm import LlamaConfig, MoELlama
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras import objectives as OBJ
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay

    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig(**MOE_CFG)
    B, T = MOE_B, MOE_T
    layer = MoELlama(cfg, remat="dots", input_shape=(T,), **MOE_EXPERTS)
    m = Sequential().add(layer)
    m.compile(optimizer=AdamWeightDecay(lr=1e-4, fused=True), loss=LOSS,
              dtype_policy="mixed_bfloat16")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    t0 = time.perf_counter()
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    dev = m._params_device()
    y = torch.from_numpy(labels).to(dev)
    build_s = time.perf_counter() - t0
    key = m._key_of(layer)
    n_leaves = len(tree_leaves(m.params))
    n_params = sum(x.numel() for x in tree_leaves(m.params))
    bank = tuple(m.params[key]["blocks"]["w_gate"].shape)

    # the inference forward through the kernels and through the dense
    # attention, at the seed weights
    logits, loss0, impls = {}, {}, {}
    for impl in ("auto", "dense"):
        layer.attention_impl = impl
        step = m._build_pred_step()
        logits[impl] = step(ids)
        with torch.no_grad():
            loss0[impl] = float(OBJ.sparse_categorical_crossentropy_from_logits(
                y, logits[impl]))
        impls[impl] = layer.last_attention_impl
        del step
        torch.cuda.empty_cache()
    layer.attention_impl = "auto"
    diff = (logits["auto"] - logits["dense"]).abs().amax(-1)
    row_top = logits["dense"].abs().amax(-1)
    gap, top = float(diff.max()), float(row_top.max())
    moved = float((diff > TOL["bfloat16"] * row_top.clamp(min=1.0)).float()
                  .mean())
    del logits, diff, row_top
    torch.cuda.empty_cache()

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = m.fit(ids, labels, batch_size=B, nb_epoch=MOE_STEPS,
                 shuffle=False, verbose=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    first_rel = abs(losses[0] - loss0["dense"]) / abs(loss0["dense"])

    t = timed(torch, lambda: m.fit(ids, labels, batch_size=B, nb_epoch=1,
                                   shuffle=False, verbose=0, device="cuda"),
              3, warmup=1)
    flops, work = moe_step_flops(MOE_CFG, MOE_EXPERTS["n_experts"],
                                 MOE_EXPERTS["top_k"], B, T)
    step_s = t["wall_ms"] / 1e3
    groups = _grouped(t["by_name"], _moe_group)

    # the training forward with the aux loss, and its backward to the
    # router
    trainable = m.params[key]
    ids_t = torch.from_numpy(ids).to(dev)
    with torch.enable_grad():
        out, aux = layer.call_with_aux(m._cast_compute(trainable), ids_t)
        total = OBJ.sparse_categorical_crossentropy_from_logits(y, out) + aux
        g_router, = torch.autograd.grad(total, trainable["blocks"]["router"])
    aux_v = float(aux.detach())
    router_grad = float(g_router.abs().max())
    del out, aux, total, g_router
    emit({"phase": "moe-main", "config": dict(MOE_CFG, **MOE_EXPERTS),
          "capacity_factor": layer.capacity_factor, "card": card,
          "seq_len": T, "batch": B, "steps": MOE_STEPS, "params": n_params,
          "leaves": n_leaves, "expert_bank": list(bank),
          "build_s": build_s, "wall_s": wall,
          "eval_forward": {"logit_max_abs_gap": gap, "logit_max_abs": top,
                           "rows_moved_share": moved,
                           "loss_kernels": loss0["auto"],
                           "loss_plain": loss0["dense"],
                           "attention_impl": impls},
          "losses": losses, "first_step_loss_rel_to_plain": first_rel,
          "step_wall_ms": t["wall_ms"], "step_device_ms": t["device_ms"],
          "device_busy_share": t["device_busy_share"],
          "device_source": t["device_source"],
          "tokens_per_s": B * T / step_s,
          "flops_per_step": flops, "work": work,
          "mfu": flops / step_s / PEAK_BF16_FLOPS,
          "peak_mem_gb": peak / 1e9,
          "device_ms_by_group": groups,
          "top_device_ms": [[k[:80], v] for k, v in sorted(
              t["by_name"].items(), key=lambda kv: -kv[1])[:16]],
          "aux": aux_v, "router_grad_max_abs": router_grad,
          "launches": counts,
          "attention_impl": layer.last_attention_impl})
    want = {"flash_attention": cfg.n_block * MOE_STEPS,
            "flash_attention_dkdv": cfg.n_block * MOE_STEPS,
            "flash_attention_dq": cfg.n_block * MOE_STEPS,
            "fused_adam": n_leaves * MOE_STEPS}
    got = {k: counts[k] for k in want}
    if n_leaves != 13 or got != want:
        raise AssertionError(f"moe-main: launches {got} over {n_leaves} "
                             f"leaves, expected {want} over 13")
    if impls != {"auto": "flash", "dense": "dense"} or \
            layer.last_attention_impl != "flash":
        raise AssertionError(f"moe-main: attention routes {impls}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"moe-main: losses {losses}")
    if not (first_rel <= TOL_MOE_LOSS and moved <= TOL_MOE_MOVED):
        raise AssertionError(
            f"moe-main: kernels vs plain: first-step loss rel {first_rel} "
            f"(tol {TOL_MOE_LOSS}), {moved} of the rows moved (logits gap "
            f"{gap} of {top})")
    if not (np.isfinite(aux_v) and aux_v > 0 and router_grad > 0
            and np.isfinite(router_grad)):
        raise AssertionError(f"moe-main: aux {aux_v}, router gradient "
                             f"{router_grad}")
    del m, layer, trainable, hist
    gc.collect()
    torch.cuda.empty_cache()
    leaf = _expert_leaf_adam(torch, K, bank)
    emit({"phase": "moe-main", "expert_leaf_adam": leaf, "card": card})
    return counts, leaf


def phase_moe_tiny(torch, K):
    """``moe-tiny``: ``MoELlama`` at ``tiny_llama_config`` widths with 4
    experts, top 2, T=512 (so ``auto`` takes the flash kernels), two
    shuffled epochs of ``fit`` (B=4, 8 sequences) with the fused AdamW,
    f32 and ``mixed_bfloat16``, against the same ``fit`` through the dense
    attention and the plain update, to 4b's and 4c's tolerances; exact
    launches. Returns the kernel runs' launches."""
    import numpy as np
    from zoo_tpu_torch.models.llm import MoELlama, tiny_llama_config
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay
    cfg = tiny_llama_config()
    S, B, N = 512, 4, 8
    rs = np.random.RandomState(5)
    ids = rs.randint(0, cfg.vocab, (N, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    steps = 2 * (N // B)
    total = {}
    for policy in ("float32", "mixed_bfloat16"):
        start, out = None, {}
        for label, impl, fused in (("kernels", "auto", True),
                                   ("plain", "dense", False)):
            layer = MoELlama(cfg, attention_impl=impl, input_shape=(S,),
                             n_experts=4, top_k=2)
            m = Sequential().add(layer)
            m.compile(AdamWeightDecay(lr=1e-3, fused=fused), LOSS,
                      dtype_policy=policy)
            if start is None:
                start = tree_map(torch.clone, m.build(
                    torch.Generator(device="cuda").manual_seed(0),
                    device="cuda"))
            m.params = tree_map(torch.clone, start)
            K.reset_launch_counts()
            hist = m.fit(ids, labels, batch_size=B, nb_epoch=2,
                         shuffle=True, seed=0, verbose=0, device="cuda")
            torch.cuda.synchronize()
            out[label] = (hist["loss"], m.params, K.launch_counts(),
                          layer.last_attention_impl)
        (lk, pk, ck, ik), (lp, pp, cp, ip) = out["kernels"], out["plain"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        param_err = max(float((a.detach() - b.detach()).abs().max())
                        for a, b in zip(tree_leaves(pk), tree_leaves(pp)))
        n_leaves = len(tree_leaves(pk))
        emit({"phase": "moe-tiny", "policy": policy, "loss_kernels": lk,
              "loss_plain": lp, "loss_max_rel": loss_rel,
              "param_max_abs": param_err, "attention_impl": [ik, ip],
              "leaves": n_leaves,
              "launches": {k: v for k, v in ck.items() if v},
              "launches_plain": {k: v for k, v in cp.items() if v}})
        if policy == "float32":
            ok = loss_rel <= 1e-4 and param_err <= 1e-4
        else:
            ok = loss_rel <= 2e-2 and all(np.isfinite(lk))
        if not ok or (ik, ip) != ("flash", "dense"):
            raise AssertionError(
                f"moe-tiny {policy}: kernel path differs from plain: loss "
                f"rel {loss_rel}, params {param_err}, impls {ik}, {ip}")
        want = {"flash_attention": cfg.n_block * steps,
                "flash_attention_dkdv": cfg.n_block * steps,
                "flash_attention_dq": cfg.n_block * steps,
                "fused_adam": n_leaves * steps}
        got = {k: ck[k] for k in want}
        if got != want or any(cp[k] for k in want):
            raise AssertionError(f"moe-tiny {policy}: launches {got} "
                                 f"(plain {cp}), expected {want}")
        for k, v in ck.items():
            total[k] = total.get(k, 0) + v
    return total


def _one_batch_fits(m, xs, y, batch, steps, device):
    """Per-step losses of ``steps`` fits of one batch each, the batches
    taken in order from ``xs`` (a list of arrays) and ``y``."""
    losses = []
    for i in range(steps):
        sl = slice(i * batch, (i + 1) * batch)
        hist = m.fit([a[sl] for a in xs] if len(xs) > 1 else xs[0][sl],
                     y[sl], batch_size=batch, nb_epoch=1, shuffle=False,
                     verbose=0, device=device)
        losses.append(hist["loss"][0])
    return losses


def _card_and_cpu(torch, K, make, xs, y, batch, label):
    """The same SEAM_STEPS one-batch fits of a model made by ``make()``
    on the card (launches counted) and on the CPU from the card's initial
    weights; a profiled step on the card. Returns the losses, the
    launches and the step numbers."""
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map
    m = make()
    m.build(torch.Generator(device="cuda").manual_seed(0),
            [(None,) + a.shape[1:] for a in xs], device="cuda")
    start = tree_map(lambda t: t.detach().cpu().clone(), m.params)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    card = _one_batch_fits(m, xs, y, batch, SEAM_STEPS, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    step = _steps_timing(torch, lambda: _one_batch_fits(
        m, xs, y, batch, 1, "cuda"), 2)
    c = make()
    c.params = start
    cpu = _one_batch_fits(c, xs, y, batch, SEAM_STEPS, "cpu")
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    emit({"phase": "seam-models-main", "model": label, "batch": batch,
          "steps": SEAM_STEPS, "losses": card, "cpu_losses": cpu,
          "rel_to_cpu": rel, "step_ms": wall / SEAM_STEPS * 1e3,
          "samples_per_s": batch * SEAM_STEPS / wall, "step": step,
          "launches": {k: v for k, v in counts.items() if v}})
    return card, cpu, rel, counts


def phase_seam_models_main(torch, K, card):
    """``seam-models-main``: SEAM_STEPS ``fit`` steps each on the card of
    Wide & Deep (WND_COLUMNS, 5 classes, hidden (40, 20, 10), Adam,
    B=8192), KNRM (KNRM_CFG, Adam, binary cross-entropy, B=256) and NER
    with its CRF (NER_CFG, dropout 0.5, Adam, B=32). Wide & Deep and KNRM
    run no kernel (as in JAX) but the key chain's split, one a step: their
    per-step losses are held to the same fits on the CPU from the same
    weights (the first within TOL_SEAM_FIRST, the rest within
    TOL_SEAM_LOSS). NER: exact ``dropout`` (2 sites, forward and backward)
    and ``derive_keys`` (the split and a key a site) launches, losses
    within 1e-4 of the plain route's (the dropout kernel is bit-equal to
    its plain version), and ``crf_decode`` on the card equal to the CPU's
    tag for tag. Step ms and busy shares. Returns the launches."""
    import numpy as np
    from zoo_tpu_torch.models.ranking import KNRM
    from zoo_tpu_torch.models.recommendation import (ColumnFeatureInfo,
                                                     WideAndDeep)
    from zoo_tpu_torch.models.text import NER, crf_decode
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves

    rs = np.random.RandomState(0)
    n = WND_B * SEAM_STEPS
    ci = WND_COLUMNS
    dims = ci["wide_base_dims"] + ci["wide_cross_dims"] + \
        ci["indicator_dims"] + ci["embed_in_dims"]
    x = np.stack([rs.randint(0, d, n) for d in dims]
                 + [rs.uniform(18, 60, n)], 1).astype(np.float32)
    y = rs.randint(0, 5, n).astype(np.int32)

    def wnd():
        m = WideAndDeep(5, ColumnFeatureInfo(**WND_COLUMNS))
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
        return m
    out = {}
    checks = {}
    *_, rel, counts = _card_and_cpu(torch, K, wnd, [x], y, WND_B,
                                    "wide_and_deep")
    checks["wide_and_deep"] = (rel, counts)
    out["seam_wide_and_deep"] = counts

    q, d = KNRM_CFG["text1_length"], KNRM_CFG["text2_length"]
    pairs = rs.randint(0, KNRM_CFG["vocab_size"],
                       (KNRM_B * SEAM_STEPS, q + d)).astype(np.int32)
    # an answer holds a question word in about half the pairs: relevant
    plant = rs.rand(len(pairs)) < 0.5
    pairs[plant, q + rs.randint(0, d)] = pairs[plant, 0]
    rel_y = np.array([[float(r[0] in r[q:])] for r in pairs], np.float32)

    def knrm():
        m = KNRM(**KNRM_CFG)
        m.compile(optimizer="adam", loss="binary_crossentropy")
        return m
    *_, rel, counts = _card_and_cpu(torch, K, knrm, [pairs], rel_y, KNRM_B,
                                    "knrm")
    checks["knrm"] = (rel, counts)
    out["seam_knrm"] = counts
    for label, (rel, counts) in checks.items():
        bad = {k: v for k, v in counts.items()
               if v and k != "derive_keys"}
        if rel[0] > TOL_SEAM_FIRST or max(rel[1:]) > TOL_SEAM_LOSS or bad \
                or counts["derive_keys"] != SEAM_STEPS:
            raise AssertionError(f"seam-models-main {label}: loss gaps to "
                                 f"the CPU {rel}, launches {counts}")

    L, W = NER_CFG["sequence_length"], NER_CFG["word_length"]
    words = rs.randint(0, NER_CFG["word_vocab_size"],
                       (NER_B, L)).astype(np.int32)
    chars = rs.randint(0, NER_CFG["char_vocab_size"],
                       (NER_B, L, W)).astype(np.int32)
    tags = rs.randint(0, NER_CFG["num_entities"], (NER_B, L)).astype(
        np.int32)
    ner = NER(**NER_CFG)
    ner.compile(optimizer="adam", loss=ner.default_loss())
    ner.build(torch.Generator(device="cuda").manual_seed(2), device="cuda")
    snapshot = [t.detach().clone() for t in tree_leaves(ner.params)]

    def ner_fit(plain=False):
        K.reset_launch_counts()
        with plain_kernels() if plain else contextlib.nullcontext():
            hist = ner.fit([words, chars], tags, batch_size=NER_B,
                           nb_epoch=SEAM_STEPS, shuffle=False, verbose=0,
                           device="cuda")
        torch.cuda.synchronize()
        return hist["loss"], K.launch_counts()
    t0 = time.perf_counter()
    losses, counts = ner_fit()
    wall = time.perf_counter() - t0
    _restore(torch, ner, snapshot)
    plain, plain_counts = ner_fit(plain=True)
    rel = float(np.max(np.abs(np.subtract(losses, plain)) / np.abs(plain)))
    step = _steps_timing(torch, lambda: ner.fit(
        [words, chars], tags, batch_size=NER_B, nb_epoch=1, shuffle=False,
        verbose=0, device="cuda"), 1)
    packed = ner.predict([words, chars], batch_size=NER_B, device="cuda")
    on_card = crf_decode(torch.from_numpy(packed).to(
        ner._params_device())).cpu().numpy()
    on_cpu = crf_decode(torch.from_numpy(packed)).numpy()
    tagged = ner.predict_tags(words, chars, batch_size=NER_B)
    emit({"phase": "seam-models-main", "model": "ner", "card": card,
          "batch": NER_B, "steps": SEAM_STEPS, "losses": losses,
          "plain_losses": plain, "max_rel_loss_diff": rel,
          "step_ms": wall / SEAM_STEPS * 1e3,
          "samples_per_s": NER_B * SEAM_STEPS / wall, "step": step,
          "decode_equal": bool((on_card == on_cpu).all()),
          "decoded_tags": int(len(np.unique(on_card))),
          "launches": {k: v for k, v in counts.items() if v}})
    want = {"dropout": 4 * SEAM_STEPS, "derive_keys": 3 * SEAM_STEPS}
    got = {k: counts[k] for k in want}
    if not np.isfinite(losses).all() or rel > TOL["float32"]:
        raise AssertionError(f"seam-models-main ner: losses {losses} vs "
                             f"plain {plain}")
    if got != want or plain_counts["dropout"]:
        raise AssertionError(f"seam-models-main ner: launches {got}, plain "
                             f"{plain_counts['dropout']}; expected {want}")
    if not ((on_card == on_cpu).all() and (tagged == on_card).all()
            and on_card.shape == (NER_B, L)):
        raise AssertionError("seam-models-main ner: crf_decode on the card "
                             "differs from the CPU's")
    out["seam_ner"] = counts
    total = {}
    for c in out.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


# -- the Orca entry path, SSD detection and the Caffe loader ----------------
# XShards of the NCF and BERT rows: 8 shards, as the README's Quick start
ORCA_SHARDS = 8
ORCA_BERT_STEPS = 4
# NCF's timed epochs take the first 32 steps' rows (two superbatches):
# a profiled pass over all 96 steps costs the host tens of seconds
ORCA_NCF_TIMED_STEPS = 32
# SSD300 on PASCAL VOC's 20 classes plus background, the JAX model's
# default channels (32, 64, 128): feature maps 38, 19, 10, 5715 anchors
SSD_CFG = dict(n_classes=21, input_size=300)
SSD_IMAGES, SSD_B, SSD_EPOCHS, SSD_PREDICT = 512, 32, 2, 64
SSD_SCORE = 0.1
# f32 on both routes (TF32 off), card against the CPU route: the losses
# of two steps on one batch (the second reads the first's update), and
# the detection scores and boxes
TOL_SSD_LOSS = 1e-4
SSD_LR = 1e-3
# the params after one step, elementwise. Adam's first step moves an
# element by lr * g / (|g| + eps), the rate times its gradient's sign,
# so the routes agree far within TOL_SSD_PARAM wherever their gradients
# share a sign. An element whose CPU-route gradient is within
# SSD_GRAD_NEAR_ZERO of its leaf's largest (a sum that cancels, added in
# another order; a dead ReLU's exact zero) may step either way: it may
# pass TOL_SSD_PARAM, excused and counted, and at most SSD_EXCUSED_MAX of
# the params may be. Controls: the params before the step, and half the
# CPU route's step, must both fail the same check
TOL_SSD_PARAM = 1e-5
SSD_GRAD_NEAR_ZERO = 1e-4
SSD_EXCUSED_MAX = 1e-3
TOL_SSD_DETECT = 1e-4
# a detection row may differ between the routes only where the CPU
# route's own margins (adjacent top-k scores, an IoU against the NMS
# threshold, a score against the score threshold) are below this
SSD_NEAR_TIE = 1e-5
CAFFE_B, CAFFE_STEPS = 32, 4
# softmax outputs of a seeded VGG-16 / CaffeNet, card against CPU (f32,
# TF32 off); the fine-tune's rate
TOL_CAFFE_PROB = 1e-4
CAFFE_LR = 1e-4
# a fine-tune step's loss, fused against plain SGD from the same params
# (the same forward: only an atomic sum could move it)
TOL_CAFFE_STEP_LOSS = 1e-6


@contextlib.contextmanager
def _recorded_steps(model):
    """Each training step's loss (a device scalar) while active, read
    by wrapping the model's ``_train_step`` on the instance."""
    losses = []
    step = model._train_step

    def recording(*args, **kwargs):
        out = step(*args, **kwargs)
        losses.append(out[1])
        return out

    model._train_step = recording
    try:
        yield losses
    finally:
        del model._train_step


def _run_numbers(t, samples, steps):
    return {"samples_per_s": samples / (t["wall_ms"] / 1e3),
            "step_wall_ms": t["wall_ms"] / steps,
            "step_device_ms": t["device_ms"] / steps,
            "device_busy_share": t["device_busy_share"],
            "device_source": t["device_source"]}


def _orca_context_checks(torch):
    """``init_orca_context()`` on the card and its refusals: returns the
    facts, raises on a wrong one; leaves a live context."""
    import logging
    from zoo_tpu_torch.common import envcheck
    from zoo_tpu_torch.orca import init_orca_context, stop_orca_context
    from zoo_tpu_torch.parallel.mesh import DEFAULT_AXES

    ctx = init_orca_context()
    out = {"platform": ctx.platform,
           "devices": [str(d) for d in ctx.devices],
           "mesh": dict(ctx.mesh.shape)}
    try:
        init_orca_context(mesh_axes={"data": -1})
        out["reinit_refused"] = False
    except RuntimeError:
        out["reinit_refused"] = True
    stop_orca_context()
    try:
        init_orca_context(mesh_axes={"data": 2})
        out["data_2"] = "accepted"
    except ValueError as e:
        out["data_2"] = str(e)
    stop_orca_context()
    warned = []

    class Caught(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    log = logging.getLogger("zoo_tpu_torch.orca.common")
    handler = Caught()
    log.addHandler(handler)
    os.environ["ZOO_MESH_DATA"] = "2"
    try:
        out["env_fallback_mesh"] = dict(init_orca_context().mesh.shape)
    finally:
        del os.environ["ZOO_MESH_DATA"]
        log.removeHandler(handler)
        stop_orca_context()
    out["env_fallback_warned"] = any("ZOO_MESH_" in m for m in warned)
    ctx = init_orca_context()
    out["envcheck"] = {n: [ok, d] for n, ok, d in envcheck.collect()}
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        out["envcheck_rc"] = envcheck.main()
    ones = dict.fromkeys(DEFAULT_AXES, 1)
    if not (out["platform"] == "gpu" and out["devices"] == ["cuda:0"]
            and out["mesh"] == ones and out["reinit_refused"]
            and "ROADMAP A.14" in out["data_2"]
            and out["env_fallback_mesh"] == ones
            and out["env_fallback_warned"]
            and all(ok for ok, _ in out["envcheck"].values())
            and out["envcheck_rc"] == 0):
        raise AssertionError(f"orca-main context: {out}")
    return ctx, out


def _shards_and_arrays(x, y):
    """The rows as XShards (``ORCA_SHARDS`` numpy-dict shards, cast to
    int32 by a ``transform_shard``) and as the same int32 arrays."""
    import numpy as np
    from zoo_tpu_torch.orca.data import XShards

    shards = XShards.partition({"x": x, "y": y}, num_shards=ORCA_SHARDS
                               ).transform_shard(lambda s: {
                                   "x": s["x"].astype(np.int32),
                                   "y": s["y"].astype(np.int32)})
    return shards, {"x": x.astype(np.int32), "y": y.astype(np.int32)}


def _fed_both_ways(torch, K, make, start, x, y, batch, steps, setup=None,
                   timed_steps=None):
    """One estimator epoch of ``make()`` from ``start``'s weights, fed
    from XShards and from the same arrays, no ``device=`` (the context
    places it): per-step losses, final params and optimizer state,
    launches, ``evaluate`` and ``predict``; then an epoch of the first
    ``timed_steps`` steps' rows (default all) timed, each feed."""
    from zoo_tpu_torch.orca.learn.keras import Estimator
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map

    shards, arrays = _shards_and_arrays(x, y)
    runs = {}
    for label, data in (("shards", shards), ("numpy", arrays)):
        m = make()
        m.params = tree_map(torch.clone, start)
        est = Estimator.from_keras(m)
        if setup is not None:
            setup(est)
        K.reset_launch_counts()
        with _recorded_steps(m) as losses:
            est.fit(data, epochs=1, batch_size=batch)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        runs[label] = {
            "losses": torch.stack(losses), "counts": counts,
            "params": _est_leaves(torch, m.params),
            "opt": _est_leaves(torch, m._opt_state),
            "device": str(m._params_device()),
            "evaluate": est.evaluate(data, batch_size=batch),
            "predict": est.predict(data, batch_size=batch),
            "est": est, "data": data}
    a, b = runs["shards"], runs["numpy"]
    same = {"losses": torch.equal(a["losses"], b["losses"]),
            "params": _bit_equal(torch, a["params"], b["params"]),
            "optimizer_state": _bit_equal(torch, a["opt"], b["opt"]),
            "launches": a["counts"] == b["counts"],
            "evaluate": a["evaluate"] == b["evaluate"],
            "predict": bool((a["predict"] == b["predict"]).all())}
    timed_steps = min(timed_steps or steps, steps)
    rows = timed_steps * batch
    feeds = dict(zip(("shards", "numpy"),
                     _shards_and_arrays(x[:rows], y[:rows])))
    numbers = {}
    for label, r in runs.items():
        t = timed(torch, lambda: r["est"].fit(feeds[label], epochs=1,
                                              batch_size=batch),
                  iters=1, warmup=1)
        numbers[label] = dict(_run_numbers(t, rows, timed_steps),
                              steps=timed_steps)
        r.pop("est")
    return runs, same, numbers


def phase_orca_main(torch, K, card):
    """``orca-main``: the README's Quick start on the card. The context:
    ``init_orca_context()`` gives platform ``gpu``, one device and a
    data-parallel mesh of size 1; a second call with other arguments
    raises; ``mesh_axes={"data": 2}`` raises naming ROADMAP A.14;
    ``ZOO_MESH_DATA=2`` falls back with its warning; ``envcheck`` passes.
    Then, under that context, (a) NCF
    at ``NCF_CFG``, B=8192, one epoch of ``NCF_STEPS``, and (b) BERT-base
    at estimator-bert's config (S=512, B=16, ``mixed_bfloat16``, fused
    AdamW, clipping 1.0), 4 steps, each through ``Estimator.from_keras``
    with no ``device=``, fed from XShards and from the same rows as
    arrays: per-step losses, params and optimizer state bit-equal,
    launches equal kernel by kernel (NCF: the key chain only; BERT: the
    three flash bodies once a block a step, AdamW once a leaf a step,
    the key split once a step), ``evaluate`` and ``predict`` equal; then
    samples/s, step wall and device ms and busy share of both feeds.
    Returns the shards runs' launches."""
    import numpy as np
    from zoo_tpu_torch.models.recommendation import NeuralCF
    from zoo_tpu_torch.orca import stop_orca_context
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map
    from zoo_tpu_torch.pipeline.api.keras.optimizers import (
        Adam,
        AdamWeightDecay,
    )

    try:
        _, facts = _orca_context_checks(torch)
        emit({"phase": "orca-main", "run": "context", "card": card,
              **facts})
        # (a) NCF
        B, n = NCF_B, NCF_B * NCF_STEPS
        rs = np.random.RandomState(0)
        x = np.stack([rs.randint(0, NCF_CFG["user_count"], n),
                      rs.randint(0, NCF_CFG["item_count"], n)], axis=1)
        y = rs.randint(0, NCF_CFG["class_num"], n)

        def ncf():
            m = NeuralCF(**NCF_CFG)
            return m.compile(optimizer=Adam(lr=0.001),
                             loss="sparse_categorical_crossentropy",
                             metrics=["accuracy"])

        start = tree_map(torch.clone, ncf().build(
            torch.Generator(device="cuda").manual_seed(0), device="cuda"))
        runs, same, numbers = _fed_both_ways(
            torch, K, ncf, start, x, y, B, NCF_STEPS,
            timed_steps=ORCA_NCF_TIMED_STEPS)
        counts = runs["shards"]["counts"]
        emit({"phase": "orca-main", "run": "ncf", "card": card,
              "config": NCF_CFG, "batch": B, "steps": NCF_STEPS,
              "shards": ORCA_SHARDS, "device": runs["shards"]["device"],
              "losses_first_last": [float(runs["shards"]["losses"][0]),
                                    float(runs["shards"]["losses"][-1])],
              "bit_equal": same, "timing": numbers,
              "launches": {k: v for k, v in counts.items() if v}})
        if not (all(same.values()) and runs["shards"]["device"] == "cuda:0"
                and _only_the_key_chain(counts, NCF_STEPS)):
            raise AssertionError(f"orca-main ncf: {same}, {counts}")
        ncf_counts = counts
        del runs, start
        torch.cuda.empty_cache()
        # (b) BERT-base
        S, B = BERT_S, BERT_B
        N = ORCA_BERT_STEPS * B
        rs = np.random.RandomState(0)
        x = rs.randint(0, BERT_CFG["vocab"], (N, S))
        y = rs.randint(0, 2, N)

        def bert():
            m = _bert_sequential(S, "auto", **BERT_CFG)
            return m.compile(optimizer=AdamWeightDecay(lr=1e-4, fused=True),
                             loss=LOSS, dtype_policy="mixed_bfloat16")

        start = tree_map(torch.clone, bert().build(
            torch.Generator(device="cuda").manual_seed(0), device="cuda"))
        runs, same, numbers = _fed_both_ways(
            torch, K, bert, start, x, y, B, ORCA_BERT_STEPS,
            setup=lambda est: est.set_l2_norm_gradient_clipping(1.0))
        counts = runs["shards"]["counts"]
        L, steps = BERT_CFG["n_block"], ORCA_BERT_STEPS
        n_leaves = len(runs["shards"]["params"])
        want = {"flash_attention": L * steps,
                "flash_attention_dkdv": L * steps,
                "flash_attention_dq": L * steps,
                "fused_adam": n_leaves * steps, "derive_keys": steps}
        emit({"phase": "orca-main", "run": "bert", "card": card,
              "config": dict(BERT_CFG, seq_len=S), "batch": B,
              "steps": steps, "shards": ORCA_SHARDS, "leaves": n_leaves,
              "device": runs["shards"]["device"],
              "losses": runs["shards"]["losses"].tolist(),
              "bit_equal": same, "timing": numbers,
              "launches": {k: v for k, v in counts.items() if v}})
        if not (all(same.values()) and runs["shards"]["device"] == "cuda:0"
                and counts == dict(dict.fromkeys(counts, 0), **want)):
            raise AssertionError(f"orca-main bert: {same}, {counts}, "
                                 f"expected {want}")
        del runs, start
        torch.cuda.empty_cache()
        return ncf_counts, counts
    finally:
        stop_orca_context()


# -- the host-to-card feed (orca/data/ingest.py) and the readers ----------
# ingest-main trains bench.py bench_resnet50's config (the train-image-main
# model and data: TRAIN_IMG_N seeded images) fed from parquet through the
# staged feed; one epoch a run (the whole file at TRAIN_IMG_B),
# INGEST_TRACED_STEPS of them in each profiled run
INGEST_IMAGE, INGEST_CLASSES = (224, 224, 3), 1000
INGEST_TRACED_STEPS = 4
# readers-main: BERT-base at estimator-bert's config from TFRecord shards,
# the tiered cache and arrays; NCF (orca-main's epoch) from csv and
# parquet; NNClassifier's two ResNet-50 steps from a pandas DataFrame
READER_SHARDS = 8
READER_BERT_STEPS = 4
NNCLASSIFIER_STEPS = 2
# the TFRecord reader and the DISK tier read at volume: BERT-base rows
# (S=512 int32 token ids and a label, 2052 bytes) to 269 MB, about twice
# READER_CACHE_STORE's 128 MB DRAM budget, so half the cache's bytes go
# to the spill file; the fit takes the first READER_BERT_STEPS batches
# of each reader
READER_RATE_ROWS = 131072
READER_CACHE_STORE = "DISK_4"
# a step through the kernels against the same step through the plain
# versions. The loss is the forward's (bf16: one rounding of an O(1)
# loss is up to 4e-3, and the plain path rounds at other points; the
# readings were 4.0e-4 for BERT and 6.7e-4 for ResNet-50). BERT's
# gradients by norm, through the flash backward against the dense
# attention's autograd: TOL_FEED_GRAD (the reading was 1.9e-2, led by
# the MLP's weights). ResNet-50's gradients are not held: at
# bench_resnet50's config the plain step's own gradients move by their
# whole norm (1.014 of it) when the images move by one f32 ulp, led by
# conv1's, so the kernels' gap (1.007) shows nothing beside that
# control. The optimizer is held on the kernel step's own gradients,
# state and params against its plain update, within TOL["update"]
TOL_FEED_PLAIN_LOSS = 4e-3
TOL_FEED_GRAD = TOL["bfloat16"]


def _launched_exactly(label, counts, want):
    """Raise unless ``counts`` holds exactly ``want`` (every other
    kernel 0)."""
    if counts != dict(dict.fromkeys(counts, 0), **want):
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def _staged_pinned(label, pool, staged):
    """Raise unless a staged run fed from a pool of pinned buffers and an
    unstaged one from none."""
    if staged != (pool is not None) or (staged and not (
            pool["pinned"] and pool["tensors_pinned"])):
        raise AssertionError(f"{label}: staging {pool}, staged {staged}")


def _traced_as_counted(label, traced, counted, want):
    """Raise unless the trace holds the kernel's launches as the counter
    and the model count them."""
    if not traced == counted == want:
        raise AssertionError(f"{label}: the conv kernel traced {traced} "
                             f"times, counted {counted}, expected {want}")


def _intervals_union(spans):
    """The union of ``(start, end)`` spans as sorted disjoint spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_copy_numbers(path):
    """From one ``torch.profiler`` Chrome trace: the device ms of
    kernels, of host-to-device copies and of the other copies and fills,
    and the ms of host-to-device copy time that runs while a kernel
    runs (the copy hidden under compute)."""
    import bisect
    import json
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels, h2d = [], []
    other = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        if cat == "kernel":
            kernels.append(span)
        elif cat == "gpu_memcpy" and name.startswith("Memcpy HtoD"):
            h2d.append(span)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            other += span[1] - span[0]
    union = _intervals_union(kernels)
    starts = [a for a, _ in union]
    hidden = 0.0
    for a, b in h2d:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(union) and union[i][0] < b:
            hidden += max(0.0, min(b, union[i][1]) - max(a, union[i][0]))
            i += 1
    return {"kernel_ms": sum(b - a for a, b in kernels) / 1e3,
            "h2d_ms": sum(b - a for a, b in h2d) / 1e3,
            "h2d_copies": len(h2d),
            "h2d_hidden_ms": hidden / 1e3,
            "other_copy_ms": other / 1e3}


def _rates(rows, nbytes, seconds):
    return {"rows": rows, "mb": nbytes / 1e6, "seconds": seconds,
            "rows_per_s": rows / seconds, "mb_per_s": nbytes / 1e6 / seconds}


def _fit_run(torch, K, m, start, data, steps, batch, **fit_kw):
    """One epoch of ``m`` from ``start``'s params and a fresh optimizer,
    fed ``data`` (arrays ``(x, y)`` or anything ``fit`` takes as x):
    per-step losses, params, optimizer state, launches, host seconds,
    the feed's pool and stats."""
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map
    m.params = tree_map(torch.clone, start)
    m._opt_state = None
    x, y = data if isinstance(data, tuple) else (data, None)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with _recorded_steps(m) as losses:
        m.fit(x, y, batch_size=batch, nb_epoch=1, verbose=0, **fit_kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = K.launch_counts()
    pool = m._staging_pool
    if len(losses) != steps:
        raise AssertionError(f"{len(losses)} steps, expected {steps}")
    return {"losses": torch.stack(losses), "counts": counts,
            "params": _est_leaves(torch, m.params),
            "opt": _est_leaves(torch, m._opt_state), "seconds": seconds,
            "pool": None if pool is None else {
                "pinned": pool.pinned,
                "tensors_pinned": all(t.is_pinned() for slot in
                                      pool.tensors() for t in slot),
                "create_seconds": pool.create_seconds,
                "rows": pool.rows, "buffers": len(pool.tensors())},
            "overlap_ratio": m.feed_stats.overlap_ratio(),
            "feed_busy_s": dict(m.feed_stats.busy)}


def _same_run(torch, a, b):
    return {"losses": torch.equal(a["losses"], b["losses"]),
            "params": _bit_equal(torch, a["params"], b["params"]),
            "optimizer_state": _bit_equal(torch, a["opt"], b["opt"]),
            "launches": a["counts"] == b["counts"]}


@contextlib.contextmanager
def _staging(mode):
    """``ZOO_FEED_STAGING`` set to ``mode`` while active."""
    old = os.environ.get("ZOO_FEED_STAGING")
    os.environ["ZOO_FEED_STAGING"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["ZOO_FEED_STAGING"]
        else:
            os.environ["ZOO_FEED_STAGING"] = old


def _profiled_fit(torch, K, m, start, x, y, batch, steps, trace_dir, kernel):
    """A ``set_profile(trace_dir)`` fit of ``steps`` steps: its phase
    stats, the trace's breakdown, its copy numbers, and the launches of
    the kernel whose bare name is ``kernel`` in the trace beside the
    counter's (one traced run; the caller holds them equal)."""
    from zoo_tpu_torch.common.profiling import trace_files
    from zoo_tpu_torch.common.xplane import op_breakdown
    rows = steps * batch
    m.set_profile(trace_dir=trace_dir)
    try:
        run = _fit_run(torch, K, m, start, (x[:rows], y[:rows]), steps,
                       batch, shuffle=False)
        stats = m.get_profile_stats()
    finally:
        m.clear_profile()
    path = trace_files(trace_dir)[-1]
    breakdown = op_breakdown(path, top=200, include_async=True)
    return {"phases": stats, "breakdown": breakdown[:8],
            "conv_traced": dict((k, n) for k, _, n in breakdown).get(
                kernel, 0),
            "conv_counted": run["counts"]["conv2d"],
            "copies": trace_copy_numbers(path), "run": run,
            "trace_mb": os.path.getsize(path) / 1e6}


@contextlib.contextmanager
def _captured_update(torch, model):
    """While active, the first call of ``model.optimizer.apply`` is
    recorded in the yielded dict: ``before``, clones of its grads,
    optimizer state, params and ``ok``; ``after``, clones of the params
    and the state it left."""
    opt, box = model.optimizer, {}
    apply = opt.apply

    def recording(grads, state, trainable, ok=None):
        first = not box
        if first:
            box["before"] = (_cloned(torch, grads), _cloned(torch, state),
                             _cloned(torch, trainable), ok)
        out = apply(grads, state, trainable, ok)
        if first:
            box["after"] = (_cloned(torch, out[0]), _cloned(torch, out[1]))
        return out

    opt.apply = recording
    try:
        yield box
    finally:
        del opt.apply


def _tensor_leaves(torch, tree):
    """The tensors of a dict tree (or a tuple of them), in tree order."""
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _tensor_leaves(torch, sub)]
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _grad_gap(torch, grads, ref):
    """``||grads - ref|| / ||ref||`` over the leaves, and the three
    leaves that differ most: ``[index, shape, ||diff||, ||ref||]``."""
    per = [(i, list(a.shape), float((a.float() - b.float()).norm()),
            float(b.float().norm()))
           for i, (a, b) in enumerate(zip(_tensor_leaves(torch, grads),
                                          _tensor_leaves(torch, ref)))]
    num = math.sqrt(sum(d * d for _, _, d, _ in per))
    den = math.sqrt(sum(r * r for _, _, _, r in per))
    return num / den, sorted(per, key=lambda e: -e[2])[:3]


def _step_against_plain(torch, K, m, plain_m, start, x, y, batch,
                        control_x=None):
    """One step on ``x[:batch]`` from ``start`` (a fresh optimizer)
    through the kernels (``m``) and through every plain version
    (``plain_m``: ``m`` itself or its dense-attention twin): the losses
    (the forward) and their relative gap; the gradients' gap by norm
    (:func:`_grad_gap`; with ``control_x``, also the gap of the plain
    step's gradients on ``control_x``, the images nudged); and the
    optimizer's update on the kernel step's own gradients, state and
    params run again through the plain update: ``update_max_abs_err``
    over params and state, and what that plain update launched."""
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map

    def one_step(model, xs, plain):
        model.params = tree_map(torch.clone, start)
        model._opt_state = None
        with _captured_update(torch, model) as box:
            loss, counts = _fit_losses(model, xs, y, batch, 1, plain=plain)
        return loss[0], box, counts

    kern_loss, kern, _ = one_step(m, x, False)
    plain_loss, plain, plain_counts = one_step(plain_m, x, True)
    grads, state, params, ok = kern["before"]
    K.reset_launch_counts()
    with plain_kernels():
        params, state = m.optimizer.apply(grads, state, params, ok)
    update_counts = K.launch_counts()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(_tensor_leaves(torch, (params, state)),
                              _tensor_leaves(torch, kern["after"])))
    gap, top = _grad_gap(torch, kern["before"][0], plain["before"][0])
    out = {"loss_kernels": kern_loss, "loss_plain": plain_loss,
           "loss_rel": abs(kern_loss - plain_loss) / abs(plain_loss),
           "grad_gap": gap, "grad_gap_top_leaves": top,
           "update_max_abs_err": err,
           "plain_launches": {k: v for k, v in plain_counts.items() if v},
           "plain_update_launches": {k: v for k, v in update_counts.items()
                                     if v}}
    if control_x is not None:
        _, control, _ = one_step(plain_m, control_x, True)
        out["control_grad_gap"] = _grad_gap(
            torch, control["before"][0], plain["before"][0])[0]
    return out


def phase_ingest_main(torch, K, card, root):
    """``ingest-main``: ResNet-50 at ``bench_resnet50``'s config (224 x
    224 x 3, 1000 classes, B=128, ``mixed_bfloat16``, ``SGD(0.1, 0.9)``)
    fed from parquet through the staged feed. ``TRAIN_IMG_N`` seeded
    images go through ``write_parquet("ndarray", ...)`` and back through
    ``read_parquet`` as arrays and as XShards (read rates printed). One
    epoch from the same start, four ways: the parquet arrays staged
    (pinned buffers, copy stream), the parquet XShards staged, the
    parquet arrays with ``ZOO_FEED_STAGING=off`` (pageable copies) and
    the original arrays staged; per-step losses, params and optimizer
    state bit-equal, ``conv2d`` (bf16) and ``fused_sgd`` launched once a
    conv a forward and once a leaf a step, the key split once a step,
    the staged buffers pinned; a step held to the same step through the
    plain versions (:func:`_step_against_plain`: the loss, and
    ``fused_sgd`` on the step's own gradients). Each feed's epoch
    (pinned, staging off) timed twice without a profiler, in the order
    pinned, pageable, pageable, pinned. Then a ``set_profile(trace_dir)``
    run of ``INGEST_TRACED_STEPS`` steps on each feed: its phases, its
    trace's breakdown with the conv kernel's launches equal to the
    counter, and from the trace the device ms of host-to-device copies
    and the part of it hidden under kernels (under the profiler, which
    syncs each step and slows the host). Returns the staged run's
    launches and the images (readers-main's NNClassifier reuses them)."""
    import numpy as np
    from zoo_tpu_torch.models.image import resnet50
    from zoo_tpu_torch.orca.data.parquet_dataset import (read_parquet,
                                                         write_parquet)
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
        _split_state)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD

    B, steps = TRAIN_IMG_B, TRAIN_IMG_N // TRAIN_IMG_B
    rs = np.random.RandomState(0)                          # bench.py:379
    x = rs.randn(TRAIN_IMG_N, *INGEST_IMAGE).astype(np.float32)
    y = rs.randint(0, INGEST_CLASSES, TRAIN_IMG_N).astype(np.int32)
    nbytes = x.nbytes + y.nbytes
    path = os.path.join(root, "images")
    t0 = time.perf_counter()
    write_parquet("ndarray", path, x, y)
    rates = {"parquet_write": _rates(len(x), nbytes,
                                     time.perf_counter() - t0)}
    t0 = time.perf_counter()
    arrays = read_parquet("arrays", path)
    rates["parquet_read_arrays"] = _rates(len(x), nbytes,
                                          time.perf_counter() - t0)
    t0 = time.perf_counter()
    shards = read_parquet("xshards", path, num_shards=ORCA_SHARDS)
    rates["parquet_read_xshards"] = _rates(len(x), nbytes,
                                           time.perf_counter() - t0)
    if not (np.array_equal(arrays["image"], x)
            and np.array_equal(arrays["label"], y)):
        raise AssertionError("ingest-main: parquet gave other rows back")
    shards = shards.transform_shard(lambda s: {"x": s["image"],
                                               "y": s["label"]})
    m = resnet50(INGEST_CLASSES, INGEST_IMAGE)
    m.compile(optimizer=SGD(lr=0.1, momentum=0.9),
              loss="sparse_categorical_crossentropy",
              dtype_policy="mixed_bfloat16")
    start = tree_map(torch.clone, m.build(
        torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    n_train = len(tree_leaves(_split_state(start)[0]))
    n_conv = len(envelope_convs(m))
    want = {"conv2d": n_conv * steps, "fused_sgd": n_train * steps,
            "derive_keys": steps}
    runs = {}
    feeds = (("parquet_staged", "auto", (arrays["image"], arrays["label"])),
             ("xshards_staged", "auto", shards),
             ("parquet_pageable", "off", (arrays["image"], arrays["label"])),
             ("arrays_staged", "auto", (x, y)))
    for label, mode, data in feeds:
        with _staging(mode):
            runs[label] = _fit_run(torch, K, m, start, data, steps, B,
                                   device="cuda")
    first = runs["parquet_staged"]
    same = {label: _same_run(torch, first, r)
            for label, r in runs.items() if label != "parquet_staged"}
    counts = first["counts"]
    # a step on the same rows, kernels against plain: the loss (the
    # forward through conv2d) and fused_sgd on the step's own gradients;
    # the gradients' gap printed beside the one-ulp control's
    vs_plain = _step_against_plain(torch, K, m, m, start, x, y, B,
                                   control_x=x[:B] * np.float32(1 + 2 ** -23))
    # each feed's epoch timed without a profiler, in the order pinned,
    # pageable, pageable, pinned (the host's drift falls on both)
    timed_runs = {"pinned": [], "pageable": []}
    for label in ("pinned", "pageable", "pageable", "pinned"):
        with _staging("auto" if label == "pinned" else "off"):
            timed_runs[label].append(_fit_run(
                torch, K, m, start, (x, y), steps, B, device="cuda"))
    profiled = {}
    for label, mode in (("pinned", "auto"), ("pageable", "off")):
        with _staging(mode):
            profiled[label] = _profiled_fit(
                torch, K, m, start, x, y, B, INGEST_TRACED_STEPS,
                os.path.join(root, f"trace-{label}"), "conv_tc_kernel")
    numbers = {}
    for label in ("pinned", "pageable"):
        p, tr = profiled[label], timed_runs[label]
        r = tr[-1]
        c = p["copies"]
        device_ms = (c["kernel_ms"] + c["h2d_ms"] + c["other_copy_ms"]) \
            / INGEST_TRACED_STEPS
        walls = [t["seconds"] * 1e3 / steps for t in tr]
        wall_ms = sum(walls) / len(walls)
        numbers[label] = {
            "step_wall_ms": wall_ms, "step_wall_ms_runs": walls,
            "samples_per_s": B / wall_ms * 1e3,
            "step_device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "h2d_ms_per_step": c["h2d_ms"] / INGEST_TRACED_STEPS,
            "h2d_hidden_ms_per_step": c["h2d_hidden_ms"]
            / INGEST_TRACED_STEPS,
            "h2d_hidden_share": c["h2d_hidden_ms"] / c["h2d_ms"]
            if c["h2d_ms"] else None,
            "h2d_copies": c["h2d_copies"],
            "profiled_step_ms": p["phases"]["step"]["avg_ms"],
            "profiled_data_wait_ms": p["phases"]["data"]["avg_ms"],
            "overlap_ratio": r["overlap_ratio"],
            "feed_busy_s": r["feed_busy_s"], "pool": r["pool"],
            "trace_mb": p["trace_mb"]}
    emit({"phase": "ingest-main", "card": card,
          "model": f"resnet50({INGEST_CLASSES}, {INGEST_IMAGE})",
          "optimizer": "SGD(lr=0.1, momentum=0.9)",
          "policy": "mixed_bfloat16", "batch": B, "steps": steps,
          "images": TRAIN_IMG_N, "read_rates": rates,
          "losses": first["losses"].tolist(), "bit_equal": same,
          "launches": {k: v for k, v in counts.items() if v},
          "expected_launches": want,
          "vs_plain": dict(vs_plain, tol_loss=TOL_FEED_PLAIN_LOSS,
                           tol_update=TOL["update"]),
          "profiled": {k: {"phases": p["phases"],
                           "conv_traced": p["conv_traced"],
                           "conv_counted": p["conv_counted"],
                           "breakdown": p["breakdown"]}
                       for k, p in profiled.items()},
          "feeds": numbers})
    bad = [label for label, s in same.items() if not all(s.values())]
    if bad:
        raise AssertionError(f"ingest-main: {bad} differ from the staged "
                             f"parquet run: {same}")
    for label, r in runs.items():
        _launched_exactly(f"ingest-main {label}", r["counts"], want)
        _staged_pinned(f"ingest-main {label}", r["pool"],
                       label != "parquet_pageable")
    if not (vs_plain["loss_rel"] <= TOL_FEED_PLAIN_LOSS
            and vs_plain["update_max_abs_err"] <= TOL["update"]
            and not vs_plain["plain_launches"]
            and not vs_plain["plain_update_launches"]):
        raise AssertionError(f"ingest-main: a step against plain "
                             f"{vs_plain}")
    for label, p in profiled.items():
        ph = p["phases"]
        if not ({"data", "step"} <= set(ph)
                and ph["step"]["count"] == INGEST_TRACED_STEPS):
            raise AssertionError(f"ingest-main profiled {label}: phases "
                                 f"{ph}")
        _traced_as_counted(f"ingest-main profiled {label}",
                           p["conv_traced"], p["conv_counted"],
                           n_conv * INGEST_TRACED_STEPS)
    for label, tr in timed_runs.items():
        for r in tr:
            _launched_exactly(f"ingest-main timed {label}", r["counts"],
                              want)
            _staged_pinned(f"ingest-main timed {label}", r["pool"],
                           label == "pinned")
    del runs, profiled, timed_runs, m, start, arrays, shards
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want}, (x, y)


def _tfrecord_rows(x, y, root):
    """``x``'s token ids and ``y``'s labels as ``READER_SHARDS`` TFRecord
    files (one record a row: int32 ids then the int32 label)."""
    from zoo_tpu_torch.orca.data.tfrecord import write_tfrecord
    per = len(x) // READER_SHARDS
    for i in range(READER_SHARDS):
        rows = range(i * per, (i + 1) * per)
        write_tfrecord(os.path.join(root, f"part-{i:05d}.tfrecord"),
                       (x[r].astype("<i4").tobytes()
                        + y[r:r + 1].astype("<i4").tobytes()
                        for r in rows))
    return os.path.join(root, "part-*.tfrecord")


def _parse_row(rec):
    import numpy as np
    a = np.frombuffer(rec, "<i4")
    return a[:-1], a[-1]


def phase_readers_main(torch, K, card, root, images):
    """``readers-main``: the readers on the card. (a) BERT-base at
    estimator-bert's config (S=512, B=16, ``mixed_bfloat16``, fused
    AdamW, clipping 1.0), ``READER_BERT_STEPS`` steps from the same
    start, fed from ``READER_SHARDS`` TFRecord shards (the native reader,
    CRCs checked), from ``FeatureSet.ndarrays`` on the
    ``READER_CACHE_STORE`` DISK tier (half the bytes spilled) through
    ``DoubleBufferedIterator``, and from the arrays: bit-equal, the three
    flash bodies, AdamW and the key split launched as counted, a step
    held to the dense attention with the plain AdamW
    (:func:`_step_against_plain`: the loss, the gradients and AdamW on
    the step's own gradients), and the native route taken (never the
    Python one). The TFRecord shards and the cache hold
    ``READER_RATE_ROWS`` rows (269 MB), each read whole and timed; the
    fit takes their first rows. (b) NCF at ``NCF_CFG``, one epoch of
    ``NCF_STEPS`` at ``NCF_B``, fed from ``read_csv`` and
    ``read_parquet`` into XShards of DataFrames: bit-equal to the
    array-fed epoch, the key split only.
    (c) ``NNClassifier`` fits ResNet-50 for ``NNCLASSIFIER_STEPS`` steps
    from a pandas DataFrame of ingest-main's images: equal to ``fit`` on
    the same arrays, and its ``transform`` to ``predict``. Read rates
    (rows/s, MB/s) for each reader. Returns the launches of the first
    feed of each."""
    import numpy as np
    from zoo_tpu_torch import native
    from zoo_tpu_torch.feature.common import FeatureSet
    from zoo_tpu_torch.models.image import resnet50
    from zoo_tpu_torch.models.recommendation import NeuralCF
    from zoo_tpu_torch.orca.data.cache import DoubleBufferedIterator
    from zoo_tpu_torch.orca.data.pandas import read_csv, read_parquet
    from zoo_tpu_torch.orca.data.tfrecord import read_tfrecord_shards
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
        _split_state)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import (
        SGD,
        Adam,
        AdamWeightDecay,
    )
    from zoo_tpu_torch.pipeline.nnframes import (NNClassifier,
                                                 RowToImageFeature)

    if not native.available():
        raise AssertionError("readers-main: the native library did not "
                             "build (g++); the Python route is not taken")
    native.reset_routes()
    rates, launches = {}, {}
    # (a) BERT-base from TFRecord, the tiered cache and arrays: each
    # reader reads READER_RATE_ROWS rows (timed), the fit takes the first
    # N of each
    S, B, steps = BERT_S, BERT_B, READER_BERT_STEPS
    N = steps * B
    rs = np.random.RandomState(0)
    xa = rs.randint(0, BERT_CFG["vocab"],
                    (READER_RATE_ROWS, S)).astype(np.int32)
    ya = rs.randint(0, 2, READER_RATE_ROWS).astype(np.int32)
    x, y = xa[:N], ya[:N]
    tdir = os.path.join(root, "tfrecord")
    os.makedirs(tdir)
    nbytes = xa.nbytes + ya.nbytes
    t0 = time.perf_counter()
    pattern = _tfrecord_rows(xa, ya, tdir)
    rates["tfrecord_write"] = _rates(READER_RATE_ROWS, nbytes,
                                     time.perf_counter() - t0)
    t0 = time.perf_counter()
    parts = read_tfrecord_shards(pattern, parse_fn=_parse_row,
                                 check_crc=True).collect()
    rows = [r for part in parts for r in part]
    tx = np.stack([r[0] for r in rows])
    ty = np.asarray([r[1] for r in rows])
    rates["tfrecord_read"] = _rates(READER_RATE_ROWS, nbytes,
                                    time.perf_counter() - t0)
    del parts, rows
    # the DISK tier, fed the fit's batches of every row
    batches = [{"x": xa[i:i + B], "y": ya[i:i + B]}
               for i in range(0, READER_RATE_ROWS, B)]
    t0 = time.perf_counter()
    fs = FeatureSet.ndarrays(batches, READER_CACHE_STORE)
    rates["cache_put"] = _rates(READER_RATE_ROWS, nbytes,
                                time.perf_counter() - t0)
    t0 = time.perf_counter()
    with DoubleBufferedIterator(iter(fs)) as it:
        replay = list(it)
    cx = np.concatenate([b["x"] for b in replay])
    cy = np.concatenate([b["y"] for b in replay])
    rates["cache_replay"] = _rates(READER_RATE_ROWS, nbytes,
                                   time.perf_counter() - t0)
    del replay, batches
    cache = fs.dataset.cache
    tiers = {"dram_used": cache.dram_used(), "spilled": cache.spilled(),
             "store": READER_CACHE_STORE, "bytes": nbytes}
    if not (np.array_equal(tx, xa) and np.array_equal(ty, ya)
            and np.array_equal(cx, xa) and np.array_equal(cy, ya)):
        raise AssertionError("readers-main: a reader gave other rows back")
    tx, ty, cx, cy = tx[:N], ty[:N], cx[:N], cy[:N]
    del xa, ya

    def bert():
        m = _bert_sequential(S, "auto", **BERT_CFG)
        m.compile(optimizer=AdamWeightDecay(lr=1e-4, fused=True), loss=LOSS,
                  dtype_policy="mixed_bfloat16")
        return m.set_gradient_clipping_by_l2_norm(1.0)

    m = bert()
    start = tree_map(torch.clone, m.build(
        torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    runs = {}
    for label, (fx, fy) in (("tfrecord", (tx, ty)), ("cache", (cx, cy)),
                            ("arrays", (x, y))):
        runs[label] = _fit_run(torch, K, m, start, (fx, fy), steps, B,
                               device="cuda")
    n_leaves = len(tree_leaves(start))
    L = BERT_CFG["n_block"]
    want = {"flash_attention": L * steps, "flash_attention_dkdv": L * steps,
            "flash_attention_dq": L * steps,
            "fused_adam": n_leaves * steps, "derive_keys": steps}
    first = runs["tfrecord"]
    same = {label: _same_run(torch, first, r)
            for label, r in runs.items() if label != "tfrecord"}
    # a step on the first rows, the kernels against the dense attention
    # and the plain AdamW, from the same start: the loss (the flash
    # forward), the gradients (the dK/dV and dQ bodies) and the fused
    # AdamW on the step's own gradients
    dense = _bert_sequential(S, "dense", **BERT_CFG)
    dense.compile(optimizer=AdamWeightDecay(lr=1e-4, fused=True),
                  loss=LOSS, dtype_policy="mixed_bfloat16")
    dense.set_gradient_clipping_by_l2_norm(1.0)
    vs_plain = _step_against_plain(torch, K, m, dense, start, x, y, B)
    routes = native.routes()
    emit({"phase": "readers-main", "run": "bert", "card": card,
          "config": dict(BERT_CFG, seq_len=S), "batch": B, "steps": steps,
          "shards": READER_SHARDS, "tiers": tiers,
          "losses": first["losses"].tolist(), "bit_equal": same,
          "launches": {k: v for k, v in first["counts"].items() if v},
          "expected_launches": want,
          "vs_plain": dict(vs_plain, tol_loss=TOL_FEED_PLAIN_LOSS,
                           tol_grad=TOL_FEED_GRAD, tol_update=TOL["update"]),
          "routes": routes,
          "route": {"tfrecord": "native" if set(routes.get(
              "tfrecord_read", {})) == {"native"} else "python",
                    "cache": cache.route}})
    bad = [label for label, s_ in same.items() if not all(s_.values())]
    if bad:
        raise AssertionError(f"readers-main bert: {bad} differ: {same}")
    for label, r in runs.items():
        _launched_exactly(f"readers-main bert {label}", r["counts"], want)
    if not (vs_plain["loss_rel"] <= TOL_FEED_PLAIN_LOSS
            and vs_plain["grad_gap"] <= TOL_FEED_GRAD
            and vs_plain["update_max_abs_err"] <= TOL["update"]
            and not vs_plain["plain_launches"]
            and not vs_plain["plain_update_launches"]):
        raise AssertionError(f"readers-main bert: a step against plain "
                             f"{vs_plain}")
    if not (tiers["spilled"] and cache.route == "native"
            and all(set(v) == {"native"} for v in routes.values())
            and routes.get("tfrecord_read", {}).get("native")
            == READER_SHARDS):
        raise AssertionError(f"readers-main: routes {routes}, cache "
                             f"{cache.route}, tiers {tiers}")
    launches["bert"] = first["counts"]
    fs.dataset.close()
    del runs, m, dense, start
    torch.cuda.empty_cache()

    # (b) NCF from csv and parquet into XShards of DataFrames
    pd = _module("pandas")
    B, n = NCF_B, NCF_B * NCF_STEPS
    rs = np.random.RandomState(0)
    ids = np.stack([rs.randint(0, NCF_CFG["user_count"], n),
                    rs.randint(0, NCF_CFG["item_count"], n)], axis=1)
    labels = rs.randint(0, NCF_CFG["class_num"], n)
    frame = pd.DataFrame({"user": ids[:, 0], "item": ids[:, 1],
                          "label": labels})
    nbytes = int(frame.memory_usage(index=False).sum())
    for kind in ("csv", "parquet"):
        d = os.path.join(root, f"ncf-{kind}")
        os.makedirs(d)
        per = n // ORCA_SHARDS
        for i in range(ORCA_SHARDS):
            part = frame.iloc[i * per:(i + 1) * per]
            if kind == "csv":
                part.to_csv(os.path.join(d, f"part-{i:05d}.csv"),
                            index=False)
            else:
                part.to_parquet(os.path.join(d, f"part-{i:05d}.parquet"),
                                index=False)

    def ncf():
        mm = NeuralCF(**NCF_CFG)
        return mm.compile(optimizer=Adam(lr=0.001),
                          loss="sparse_categorical_crossentropy",
                          metrics=["accuracy"])

    m = ncf()
    start = tree_map(torch.clone, m.build(
        torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    runs, shard_counts = {}, {}
    for kind, reader in (("csv", read_csv), ("parquet", read_parquet)):
        t0 = time.perf_counter()
        shards = reader(os.path.join(root, f"ncf-{kind}"),
                        num_shards=ORCA_SHARDS)
        rates[f"ncf_{kind}_read"] = _rates(n, nbytes,
                                           time.perf_counter() - t0)
        shard_counts[kind] = shards.num_partitions()
        runs[kind] = _fit_run(torch, K, m, start, shards, NCF_STEPS, B,
                              device="cuda", feature_cols=["user", "item"],
                              label_cols=["label"])
    runs["arrays"] = _fit_run(torch, K, m, start,
                              (ids.astype(np.int32),
                               labels.astype(np.int32)), NCF_STEPS, B,
                              device="cuda")
    first = runs["csv"]
    same = {label: _same_run(torch, first, r)
            for label, r in runs.items() if label != "csv"}
    numbers = {label: {"epoch_s": r["seconds"],
                       "samples_per_s": n / r["seconds"],
                       "overlap_ratio": r["overlap_ratio"],
                       "pool": r["pool"]} for label, r in runs.items()}
    emit({"phase": "readers-main", "run": "ncf", "card": card,
          "config": NCF_CFG, "batch": B, "steps": NCF_STEPS,
          "shards": shard_counts,
          "losses_first_last": [float(first["losses"][0]),
                                float(first["losses"][-1])],
          "bit_equal": same, "timing": numbers,
          "launches": {k: v for k, v in first["counts"].items() if v}})
    bad = [label for label, s_ in same.items() if not all(s_.values())]
    if bad or not all(_only_the_key_chain(r["counts"], NCF_STEPS)
                      for r in runs.values()):
        raise AssertionError(f"readers-main ncf: {same}, "
                             f"{[r['counts'] for r in runs.values()]}")
    launches["ncf"] = first["counts"]
    del runs, m, start
    torch.cuda.empty_cache()

    # (c) NNClassifier: ResNet-50 from a pandas DataFrame of images
    pd = _module("pandas")
    B, steps = TRAIN_IMG_B, NNCLASSIFIER_STEPS
    ix, iy = images[0][:B * steps], images[1][:B * steps]
    df = pd.DataFrame({"image": list(ix), "label": iy})
    m = resnet50(INGEST_CLASSES, INGEST_IMAGE)
    m.compile(optimizer=SGD(lr=0.1, momentum=0.9),
              loss="sparse_categorical_crossentropy",
              dtype_policy="mixed_bfloat16")
    start = tree_map(torch.clone, m.build(
        torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    clf = (NNClassifier(m, features_col="image", label_col="label",
                        device="cuda")
           .setSamplePreprocessing(RowToImageFeature())
           .setBatchSize(B).setMaxEpoch(1))
    m.params = tree_map(torch.clone, start)
    m._opt_state = None
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with _recorded_steps(m) as losses:
        model = clf.fit(df)
    torch.cuda.synchronize()
    nn_s = time.perf_counter() - t0
    nn_counts = K.launch_counts()
    nn_run = {"losses": torch.stack(losses), "counts": nn_counts,
              "params": _est_leaves(torch, m.params),
              "opt": _est_leaves(torch, m._opt_state)}
    out = model.transform(df)
    direct = m.predict(ix, batch_size=256, device="cuda")
    arrays_run = _fit_run(torch, K, m, start, (ix, iy), steps, B,
                          device="cuda")
    same = _same_run(torch, nn_run, arrays_run)
    agree = bool((out["prediction"].to_numpy()
                  == np.argmax(direct, -1)).all())
    emit({"phase": "readers-main", "run": "nnclassifier", "card": card,
          "model": f"resnet50({INGEST_CLASSES}, {INGEST_IMAGE})",
          "batch": B, "steps": steps, "losses": nn_run["losses"].tolist(),
          "bit_equal": same, "transform_equals_predict": agree,
          "fit_s": nn_s,
          "launches": {k: v for k, v in nn_counts.items() if v}})
    if not (all(same.values()) and agree):
        raise AssertionError(f"readers-main nnclassifier: {same}, "
                             f"transform {agree}")
    for label, counts in (("nnclassifier", nn_counts),
                          ("arrays", arrays_run["counts"])):
        _launched_exactly(
            f"readers-main {label}", counts,
            {"conv2d": len(envelope_convs(m)) * steps,
             "fused_sgd": len(tree_leaves(_split_state(start)[0])) * steps,
             "derive_keys": steps})
    launches["nnclassifier"] = nn_counts
    emit({"phase": "readers-main", "run": "rates", "card": card,
          "read_rates": rates})
    del m, start, model, df
    torch.cuda.empty_cache()
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            if v:
                total[k] = total.get(k, 0) + v
    return total


def _module(name):
    """A module imported by name when a phase runs (pandas: the card's
    machine has it; the port's own modules never import it at import
    time)."""
    import importlib
    return importlib.import_module(name)


def make_shapes(n, size=64, seed=0):
    """``examples/object_detection_ssd.py``'s synthetic shapes (``:14``):
    bright squares (class 1) and blue bars (class 2) on dim noise, one
    object an image with its normalized box."""
    import numpy as np
    rs = np.random.RandomState(seed)
    imgs = rs.rand(n, size, size, 3).astype(np.float32) * 0.2
    boxes, labels = [], []
    for i in range(n):
        cls = 1 + rs.randint(2)
        if cls == 1:
            w = h = rs.randint(16, 28)
        else:
            w, h = rs.randint(24, 36), rs.randint(8, 14)
        x1 = rs.randint(0, size - w)
        y1 = rs.randint(0, size - h)
        color = (np.array([0.9, 0.8, 0.2]) if cls == 1
                 else np.array([0.2, 0.3, 0.9]))
        imgs[i, y1:y1 + h, x1:x1 + w] = color + 0.05 * rs.randn(h, w, 3)
        boxes.append(np.array([[x1 / size, y1 / size, (x1 + w) / size,
                                (y1 + h) / size]], np.float32))
        labels.append(np.array([cls], np.int32))
    return imgs, boxes, labels


def _conv_event(name):
    n = name.lower()
    return any(s in n for s in ("conv", "cudnn", "xmma", "implicit",
                                "fprop", "dgrad", "wgrad", "winograd"))


def _split_ms(by_name):
    conv = sum(v for k, v in by_name.items() if _conv_event(k))
    return conv, sum(by_name.values()) - conv


def _ssd_margin(torch, model, image, top_k, iou_thr, score_thr):
    """The CPU route's smallest margin on one image: between adjacent
    scores of its top ``top_k + 1``, of an IoU among its top ``top_k``
    boxes against ``iou_thr``, of a top score against ``score_thr``."""
    from zoo_tpu_torch.models.image.objectdetection import (
        decode_boxes,
        iou_matrix,
        top_k_stable,
    )
    x = torch.from_numpy(image[None])
    with torch.no_grad():
        cls, box = model._forward(model.params, [x], training=False)
        best = torch.amax(torch.softmax(cls, -1)[0, :, 1:], -1)
        decoded = decode_boxes(torch.from_numpy(model.anchors), box[0])
        vals, idx = top_k_stable(best, top_k + 1)
        ious = iou_matrix(decoded[idx[:top_k]], decoded[idx[:top_k]])
        upper = torch.triu(torch.ones_like(ious, dtype=torch.bool), 1)
    return float(min((vals[:-1] - vals[1:]).min(),
                     (ious[upper] - iou_thr).abs().min(),
                     (vals[:top_k] - score_thr).abs().min()))


def phase_detect_main(torch, K, card):
    """``detect-main``: ``SSD(n_classes=21, input_size=300)`` (SSD300 on
    PASCAL VOC's classes, feature maps 38/19/10, 5715 anchors) on
    ``make_shapes`` at 300 px from seed 0, 512 images. Two
    ``fit_detection`` steps at B=32 on one batch on the card against the
    CPU route on the same weights (both losses within ``TOL_SSD_LOSS``);
    one step's params against the CPU route's within ``TOL_SSD_PARAM``
    but for the counted near-zero-gradient elements
    (:func:`_ssd_one_step`); then 2 epochs at B=32 on the card (finite, falling losses; no kernel
    of the port on this path: every count 0); ``predict_detections`` on
    64 images against the CPU route on the trained weights (kept rows
    and labels equal apart from recorded near-ties, scores and boxes
    within ``TOL_SSD_DETECT``); ``ObjectDetector.predict_image_set`` on
    uint8 images of other sizes equal to resizing and predicting
    directly. Prints the fit's ms a step and images/s; a step on
    targets already on the card (wall and device ms, busy share, device
    launches, device ms split into convs and the rest: the multibox loss
    and Adam), beside the host's target encoding and the batch's copy to
    the card; and a detection's (convs against NMS and decoding)."""
    import numpy as np
    from zoo_tpu_torch.feature.image import ImageSet, resize_linear
    from zoo_tpu_torch.models.image import SSD, ObjectDetector
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (
        tree_leaves,
        tree_map,
    )

    size = SSD_CFG["input_size"]
    imgs, boxes, labels = make_shapes(SSD_IMAGES, size=size, seed=0)
    first = SSD(**SSD_CFG)
    start = tree_map(lambda t: t.detach().clone(), first.build(
        torch.Generator(device="cuda").manual_seed(0), device="cuda"))

    def holding(params, dev):
        m = SSD(**SSD_CFG)
        m.params = tree_map(lambda t: t.detach().to(dev).clone(), params)
        return m

    one = {}
    for dev in ("cuda", "cpu"):
        m = holding(start, dev)
        losses = m.fit_detection(imgs[:SSD_B], boxes[:SSD_B],
                                 labels[:SSD_B], epochs=2,
                                 batch_size=SSD_B, lr=SSD_LR, device=dev)
        one[dev] = (losses, [t.detach().cpu() for t in
                             tree_leaves(m.params)])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(one["cuda"][0],
                                                       one["cpu"][0]))
    one_step = _ssd_one_step(torch, holding, start, imgs[:SSD_B],
                             boxes[:SSD_B], labels[:SSD_B])
    K.reset_launch_counts()
    model = holding(start, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = model.fit_detection(imgs, boxes, labels, epochs=SSD_EPOCHS,
                               batch_size=SSD_B, lr=SSD_LR, device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = K.launch_counts()
    steps = SSD_EPOCHS * (SSD_IMAGES // SSD_B)
    # predictions, card against the CPU route on the trained weights
    px = make_shapes(SSD_PREDICT, size=size, seed=1)[0]
    cpu = holding(model.params, "cpu")
    card_det = model.predict_detections(px, score_threshold=SSD_SCORE,
                                        device="cuda")
    cpu_det = cpu.predict_detections(px, score_threshold=SSD_SCORE,
                                     device="cpu")
    det_err, near_ties, unexplained, kept = 0.0, [], [], 0
    for i, (a, b) in enumerate(zip(card_det, cpu_det)):
        kept += len(b)
        if a.shape == b.shape and np.array_equal(a[:, 0], b[:, 0]):
            det_err = max(det_err, float(np.abs(a[:, 1:] - b[:, 1:]).max())
                          if len(a) else 0.0)
            continue
        margin = _ssd_margin(torch, cpu, px[i], 50, 0.45, SSD_SCORE)
        (near_ties if margin < SSD_NEAR_TIE else unexplained).append(
            {"image": i, "rows": [len(a), len(b)], "margin": margin})
    # ObjectDetector on uint8 images of other sizes
    u8 = [resize_linear((np.clip(px[i], 0, 1) * 255).astype(np.uint8), w, h)
          for i, (h, w) in enumerate(((240, 320), (300, 300), (256, 341),
                                      (480, 640)))]
    iset = ObjectDetector(model).predict_image_set(
        ImageSet.from_arrays([a.copy() for a in u8]),
        score_threshold=SSD_SCORE)
    direct = model.predict_detections(
        np.stack([resize_linear(a, size, size).astype(np.float32) / 255.0
                  for a in u8]), score_threshold=SSD_SCORE)
    detector_equal = all(np.array_equal(f["predict"], d) for f, d in
                         zip(iset.features, direct))
    # timing: the host's target encoding and the batch's copy, a step on
    # targets already on the card, and a detection of the 64 images
    t0 = time.perf_counter()
    ct, bt = _ssd_targets(model, boxes[:SSD_B], labels[:SSD_B])
    encode_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xb = torch.from_numpy(imgs[:SSD_B]).cuda()
    ctb, btb = torch.from_numpy(ct).cuda(), torch.from_numpy(bt).cuda()
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    t_step = timed(torch, _ssd_step(torch, model, xb, ctb, btb), iters=3,
                   warmup=1)
    xd = torch.from_numpy(px).cuda()
    t_det = timed(torch, lambda: model.detect(xd, SSD_SCORE), iters=3,
                  warmup=1)
    conv_s, rest_s = _split_ms(t_step["by_name"])
    conv_d, rest_d = _split_ms(t_det["by_name"])
    emit({"phase": "detect-main", "card": card, "config": SSD_CFG,
          "feature_sizes": model.feature_sizes,
          "anchors": int(model.anchors.shape[0]), "images": SSD_IMAGES,
          "batch": SSD_B, "epochs": SSD_EPOCHS, "losses": hist,
          "two_steps": {"losses_card": one["cuda"][0],
                        "losses_cpu": one["cpu"][0],
                        "loss_max_rel_err": loss_err, "tol": TOL_SSD_LOSS},
          "one_step": one_step,
          "fit_s": fit_s, "fit_step_ms": fit_s * 1e3 / steps,
          "fit_images_per_s": steps * SSD_B / fit_s,
          "step": {"encode_ms": encode_ms, "copy_ms": copy_ms,
                   "wall_ms": t_step["wall_ms"],
                   "host_ms": t_step["host_ms"],
                   "device_ms": t_step["device_ms"],
                   "device_busy_share": t_step["device_busy_share"],
                   "device_launches": t_step["device_launches"],
                   "conv_ms": conv_s, "loss_and_adam_ms": rest_s,
                   "images_per_s": SSD_B / (t_step["wall_ms"] / 1e3)},
          "detect": {"images": SSD_PREDICT, "wall_ms": t_det["wall_ms"],
                     "device_ms": t_det["device_ms"],
                     "device_busy_share": t_det["device_busy_share"],
                     "device_launches": t_det["device_launches"],
                     "conv_ms": conv_d, "nms_and_decode_ms": rest_d,
                     "images_per_s": SSD_PREDICT / (t_det["wall_ms"] / 1e3)},
          "predict": {"kept_rows_cpu": kept, "max_abs_err": det_err,
                      "tol": TOL_SSD_DETECT, "near_ties": near_ties,
                      "unexplained": unexplained},
          "object_detector_equal": detector_equal,
          "launches": {k: v for k, v in counts.items() if v}})
    if not (loss_err <= TOL_SSD_LOSS and one_step["ok"]
            and all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"detect-main: two steps {loss_err}, one "
                             f"step {one_step}, losses {hist}")
    if any(counts.values()):
        raise AssertionError(f"detect-main: kernels launched {counts}; "
                             "SSD's path runs none of the port's")
    if unexplained or det_err > TOL_SSD_DETECT or not detector_equal:
        raise AssertionError(f"detect-main: detections {unexplained}, "
                             f"err {det_err}, detector {detector_equal}")
    del model, first, cpu, xd, xb
    torch.cuda.empty_cache()
    return counts


def _ssd_targets(model, boxes, labels):
    """The anchors' class and box targets of a batch, as
    ``fit_detection`` encodes them on the host."""
    import numpy as np
    from zoo_tpu_torch.models.image.objectdetection import encode_targets

    ct, bt = zip(*(encode_targets(model.anchors, np.asarray(b, np.float32),
                                  np.asarray(lab, np.int32))
                   for b, lab in zip(boxes, labels)))
    return np.stack(ct), np.stack(bt)


def _ssd_grads(torch, model, x, ct, bt):
    """The multibox loss's gradients at the model's params, as a
    ``fit_detection`` step takes them."""
    from zoo_tpu_torch.models.image.objectdetection import multibox_loss
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves

    with torch.enable_grad():
        cls, box = model._forward(model.params, [x], training=True)
        loss = multibox_loss(cls, box, ct, bt)
    return torch.autograd.grad(loss, tree_leaves(model.params))


def _ssd_step(torch, model, x, ct, bt):
    """A ``fit_detection`` step on a batch whose targets are already on
    the card: the gradients, then optax's Adam (continuing the count)."""
    from zoo_tpu_torch.models.image.objectdetection import _adam_update
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves

    leaves = tree_leaves(model.params)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    count = [0]

    def step():
        grads = _ssd_grads(torch, model, x, ct, bt)
        count[0] += 1
        _adam_update(leaves, grads, mu, nu, count[0], SSD_LR)
    return step


def _ssd_one_step(torch, holding, start, imgs, boxes, labels):
    """One ``fit_detection`` step from ``start`` on the card and on the
    CPU route, the params held elementwise within ``TOL_SSD_PARAM`` but
    for elements whose CPU-route gradient (at ``start``, on the step's
    batch order) is within ``SSD_GRAD_NEAR_ZERO`` of its leaf's largest;
    the count of those past the tolerance at most ``SSD_EXCUSED_MAX`` of
    the params. The controls (params before the step, half the CPU
    route's step) must fail the check. Returns the figures and
    ``ok``."""
    import numpy as np
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves

    after = {}
    for dev in ("cuda", "cpu"):
        m = holding(start, dev)
        m.fit_detection(imgs, boxes, labels, epochs=1, batch_size=len(imgs),
                        lr=SSD_LR, device=dev)
        after[dev] = [t.detach().cpu() for t in tree_leaves(m.params)]
    # fit_detection's batch order: RandomState(seed=0)'s permutation
    order = np.random.RandomState(0).permutation(len(imgs))
    grads = {}
    for dev in ("cuda", "cpu"):
        m = holding(start, dev)
        m._on(dev)
        ct, bt = _ssd_targets(m, [boxes[i] for i in order],
                              [labels[i] for i in order])
        grads[dev] = [g.detach().cpu() for g in _ssd_grads(
            torch, m, torch.from_numpy(imgs[order]).to(dev),
            torch.from_numpy(ct).to(dev), torch.from_numpy(bt).to(dev))]
    before = [t.detach().cpu() for t in tree_leaves(start)]
    near = [g.abs() <= SSD_GRAD_NEAR_ZERO * g.abs().max()
            for g in grads["cpu"]]

    def worst(got, want):
        return max(float(torch.where(e, 0.0, (a - b).abs()).max())
                   for a, b, e in zip(got, want, near))

    err = worst(after["cuda"], after["cpu"])
    skipped = worst(before, after["cpu"])
    halved = worst([(a + b) / 2 for a, b in zip(before, after["cpu"])],
                   after["cpu"])
    n_excused = sum(int((e & ((a - b).abs() > TOL_SSD_PARAM)).sum())
                    for a, b, e in zip(after["cuda"], after["cpu"], near))
    n = sum(e.numel() for e in near)
    grad_rel = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(grads["cuda"], grads["cpu"]))
    return {"params_max_abs_err": err, "tol": TOL_SSD_PARAM,
            "params_max_abs_err_all": max(
                float((a - b).abs().max())
                for a, b in zip(after["cuda"], after["cpu"])),
            "excused": n_excused, "params": n,
            "near_zero_elements": sum(int(e.sum()) for e in near),
            "excused_max": SSD_EXCUSED_MAX,
            "near_zero": SSD_GRAD_NEAR_ZERO,
            "grad_max_err_over_leaf_max": grad_rel,
            "control_skipped_err": skipped, "control_halved_err": halved,
            "ok": (err <= TOL_SSD_PARAM
                   and n_excused <= SSD_EXCUSED_MAX * n
                   and skipped > TOL_SSD_PARAM
                   and halved > TOL_SSD_PARAM)}


def _vgg16_layers():
    """``VGG_ILSVRC_16_layers_deploy``: 13 3x3 convs (pad 1) with ReLUs,
    5 MAX pools (2, stride 2), fc6/fc7 (4096, ReLU, Dropout 0.5), fc8
    (1000), Softmax; input 3 x 224 x 224."""
    out, cin = [], 3
    for stage, (width, n) in enumerate(((64, 2), (128, 2), (256, 3),
                                        (512, 3), (512, 3)), 1):
        for j in range(1, n + 1):
            out.append(("conv", f"conv{stage}_{j}", dict(
                num_output=width, pad=1, kernel_size=3), (width, cin, 3, 3)))
            out.append(("relu", f"relu{stage}_{j}", {}, None))
            cin = width
        out.append(("pool", f"pool{stage}", dict(pool="MAX", kernel_size=2,
                                                 stride=2), None))
    fan = 512 * 7 * 7
    for name, width in (("fc6", 4096), ("fc7", 4096), ("fc8", 1000)):
        out.append(("fc", name, dict(num_output=width), (width, fan)))
        fan = width
        if name != "fc8":
            out.append(("relu", "relu" + name[2:], {}, None))
            out.append(("drop", "drop" + name[2:], dict(dropout_ratio=0.5),
                        None))
    return "VGG_ILSVRC_16_layers", (3, 224, 224), out


def _caffenet_layers():
    """BVLC CaffeNet (``bvlc_reference_caffenet/deploy.prototxt``): conv1
    96x11x11 stride 4, pool, LRN (5, alpha 1e-4, beta 0.75), conv2
    256x5x5 pad 2 group 2, pool, LRN, conv3 384x3x3, conv4 384x3x3 group
    2, conv5 256x3x3 group 2, pool, fc6/fc7 4096 with Dropout, fc8 1000,
    Softmax; input 3 x 227 x 227."""
    pool = dict(pool="MAX", kernel_size=3, stride=2)
    lrn = dict(local_size=5, alpha=0.0001, beta=0.75)
    out = []
    for name, cout, cin, k, extra in (
            ("conv1", 96, 3, 11, dict(stride=4)),
            ("conv2", 256, 96, 5, dict(pad=2, group=2)),
            ("conv3", 384, 256, 3, dict(pad=1)),
            ("conv4", 384, 384, 3, dict(pad=1, group=2)),
            ("conv5", 256, 384, 3, dict(pad=1, group=2))):
        g = extra.get("group", 1)
        out.append(("conv", name, dict(num_output=cout, kernel_size=k,
                                       **extra), (cout, cin // g, k, k)))
        out.append(("relu", "relu" + name[4:], {}, None))
        if name in ("conv1", "conv2", "conv5"):
            out.append(("pool", "pool" + name[4:], pool, None))
        if name in ("conv1", "conv2"):
            out.append(("lrn", "norm" + name[4:], lrn, None))
    fan = 256 * 6 * 6
    for name, width in (("fc6", 4096), ("fc7", 4096), ("fc8", 1000)):
        out.append(("fc", name, dict(num_output=width), (width, fan)))
        fan = width
        if name != "fc8":
            out.append(("relu", "relu" + name[2:], {}, None))
            out.append(("drop", "drop" + name[2:], dict(dropout_ratio=0.5),
                        None))
    return "CaffeNet", (3, 227, 227), out


_CAFFE_TYPES = {"conv": ("Convolution", "convolution_param"),
                "relu": ("ReLU", None), "pool": ("Pooling", "pooling_param"),
                "lrn": ("LRN", "lrn_param"),
                "fc": ("InnerProduct", "inner_product_param"),
                "drop": ("Dropout", "dropout_param")}


def _write_caffe(root, spec, seed):
    """The net's deploy prototxt (written from ``spec``) and a V2
    ``NetParameter`` binary of seeded blobs in Caffe's layouts (conv
    (out, in/group, kh, kw), InnerProduct (out, in); He-scaled normals,
    small biases; data packed), encoded with the port's wire helpers.
    Returns the two paths."""
    import numpy as np
    from zoo_tpu_torch.tensorboard import proto as wire

    name, shape, layers = spec
    lines = [f'name: "{name}"', 'input: "data"',
             "input_dim: 10 " + " ".join(f"input_dim: {d}" for d in shape)]
    rng = np.random.default_rng(seed)
    parts = [wire.field_bytes(1, name.encode())]
    bottom = "data"
    for kind, lname, params, wshape in layers:
        ltype, group = _CAFFE_TYPES[kind]
        inplace = kind in ("relu", "drop")
        top = bottom if inplace else lname
        body = "".join(
            f" {k}: {v}" if not isinstance(v, str) or v.isupper() else
            f' {k}: "{v}"' for k, v in params.items())
        lines.append(f'layer {{ name: "{lname}" type: "{ltype}" bottom: '
                     f'"{bottom}" top: "{top}"'
                     + (f" {group} {{{body} }}" if group else "") + " }")
        bottom = top
        if wshape is None:
            continue
        fan_in = int(np.prod(wshape[1:]))
        w = rng.standard_normal(wshape, dtype=np.float32) * np.float32(
            math.sqrt(2.0 / fan_in))
        b = rng.standard_normal(wshape[:1], dtype=np.float32) * \
            np.float32(0.01)
        blobs = b"".join(wire.field_bytes(7, wire.field_bytes(7, b"".join(
            wire.field_varint(1, d) for d in a.shape)) + wire.field_bytes(
                5, a.astype("<f4").tobytes())) for a in (w, b))
        parts.append(wire.field_bytes(100, wire.field_bytes(1, lname.encode())
                                      + wire.field_bytes(2, ltype.encode())
                                      + blobs))
    lines.append(f'layer {{ name: "prob" type: "Softmax" bottom: "{bottom}" '
                 'top: "prob" }')
    deploy = os.path.join(root, name + "_deploy.prototxt")
    model = os.path.join(root, name + ".caffemodel")
    with open(deploy, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(model, "wb") as f:
        for p in parts:
            f.write(p)
    return deploy, model, shape


def _caffe_fine_tune(torch, net, shape):
    """``CAFFE_STEPS`` steps of Keras ``SGD`` (momentum 0.9) at B =
    ``CAFFE_B`` through the fused kernel, each step held to the same
    step through the plain update from the same params and momentum:
    the loss within ``TOL_CAFFE_STEP_LOSS``, params and momentum within
    ``TOL["update"]``
    (a step, not a trajectory: a seeded VGG-16 at its first steps
    carries a rounding far within a few steps). Controls, each step: the
    plain step's largest move of a param, what a skipped step would miss
    by, and from the second step the momentum's share of it,
    ``lr * 0.9 * max|buf|``, what a step without momentum would miss by,
    must each pass ``10 * TOL["update"]``. ``fused_sgd`` must launch once
    a leaf a step, the key split once a step, nothing else."""
    import numpy as np
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (
        tree_leaves,
        tree_map,
    )
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD

    rs = np.random.RandomState(1)
    xt = rs.randn(CAFFE_B, *shape).astype(np.float32)
    yt = rs.randint(0, 1000, CAFFE_B).astype(np.int32)
    net.compile(SGD(lr=CAFFE_LR, momentum=0.9),
                "sparse_categorical_crossentropy")
    n_leaves = len(net.params["caffe"]["w"])
    counts = None
    losses, plain_losses, update_err, ms = [], [], 0.0, []
    moved, momentum_gap = [], []
    for _ in range(CAFFE_STEPS):
        snap = tree_map(lambda a: a.detach().clone(), net.params)
        opt = None if net._opt_state is None else \
            tree_map(torch.clone, net._opt_state)
        results = {}
        for label in ("plain", "kernels"):
            net.params = tree_map(torch.clone, snap)
            net._opt_state = None if opt is None else \
                tree_map(torch.clone, opt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, c = _fit_losses(net, xt, yt, CAFFE_B, 1,
                                  plain=label == "plain")
            torch.cuda.synchronize()
            results[label] = (loss[0], _est_leaves(torch, net.params)
                              + _est_leaves(torch, net._opt_state))
            if label == "kernels":
                ms.append((time.perf_counter() - t0) * 1e3)
                counts = c if counts is None else \
                    {k: counts[k] + v for k, v in c.items()}
        before = _est_leaves(torch, snap)
        moved.append(max(float((a - b).abs().max()) for a, b in
                         zip(results["plain"][1], before)))
        if opt is not None:
            momentum_gap.append(CAFFE_LR * 0.9 * max(
                float(b.abs().max()) for b in tree_leaves(opt["momentum"])))
        losses.append(results["kernels"][0])
        plain_losses.append(results["plain"][0])
        update_err = max(update_err, max(
            float((a.float() - b.float()).abs().max()) for a, b in
            zip(results["kernels"][1], results["plain"][1])))
    want = dict(dict.fromkeys(counts, 0), fused_sgd=n_leaves * CAFFE_STEPS,
                derive_keys=CAFFE_STEPS)
    out = {"leaves": n_leaves, "steps": CAFFE_STEPS, "lr": CAFFE_LR,
           "losses": losses, "losses_plain": plain_losses,
           "update_max_abs_err": update_err, "tol_update": TOL["update"],
           "control_moved": moved, "control_momentum_gap": momentum_gap,
           "fit_step_ms": ms, "counts": counts,
           "launches": {k: v for k, v in counts.items() if v}}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    out["loss_max_rel"] = loss_rel
    if not (counts == want and n_leaves == 32
            and loss_rel <= TOL_CAFFE_STEP_LOSS
            and update_err <= TOL["update"] and all(np.isfinite(losses))
            and len(momentum_gap) == CAFFE_STEPS - 1
            and min(moved + momentum_gap) > 10 * TOL["update"]):
        raise AssertionError(f"caffe-main fine-tune: {out}, expected "
                             f"launches {want}")
    return out


def phase_caffe_main(torch, K, card):
    """``caffe-main``: two public deploy nets written from code, VGG-16
    (``VGG_ILSVRC_16_layers_deploy``, 138.4 M params) and BVLC CaffeNet
    (LRN, ``group: 2`` convs), with seeded blobs as V2 ``NetParameter``
    binaries. Each through ``InferenceModel.load_caffe(def, model)`` on
    the card (load seconds), a batch of 32 against the CPU route's
    ``load_caffe(..., device="cpu")`` (softmax outputs within
    ``TOL_CAFFE_PROB``, top-1 equal), images/s. Then the VGG-16
    ``CaffeNet`` fine-tuned 4 steps at B=32 with Keras ``SGD`` (momentum
    0.9; :func:`_caffe_fine_tune`): ``fused_sgd`` launched exactly once a
    leaf a step (32 x 4), the key split once a step and nothing else,
    each step's loss and update against the same step through the plain
    update. Returns the fine-tune's launches and VGG-16's top-1 of its
    batch."""
    import shutil
    import tempfile

    import numpy as np
    from zoo_tpu_torch.models.caffe_loader import load_caffe
    from zoo_tpu_torch.pipeline.inference import InferenceModel

    root = tempfile.mkdtemp(prefix="zoo-caffe-")
    fit_counts = vgg_top1 = None
    try:
        for spec, seed in ((_vgg16_layers(), 16), (_caffenet_layers(), 7)):
            deploy, path, shape = _write_caffe(root, spec, seed)
            size_mb = os.path.getsize(path) / 2 ** 20
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            im = InferenceModel().load_caffe(deploy, path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            net = im.model
            n_params = sum(t.numel() for t in
                           net.params["caffe"]["w"].values())
            x = np.random.RandomState(seed).randn(CAFFE_B, *shape).astype(
                np.float32)
            got = im.predict(x)
            t0 = time.perf_counter()
            cpu_net = load_caffe(deploy, path, device="cpu")
            cpu_load_s = time.perf_counter() - t0
            want = cpu_net.predict(x, batch_size=CAFFE_B, device="cpu")
            del cpu_net
            err = float(np.abs(got - want).max())
            rel = err / float(np.abs(want).max())
            top1 = bool((got.argmax(1) == want.argmax(1)).all())
            srt = np.sort(want, axis=1)
            t = timed(torch, lambda: im.predict(x), iters=3, warmup=1)
            line = {"phase": "caffe-main", "net": spec[0], "card": card,
                    "params": n_params, "binary_mb": size_mb,
                    "layers": len(net.caffe_layers), "load_s": load_s,
                    "cpu_load_s": cpu_load_s, "batch": CAFFE_B,
                    "input": list(shape), "max_abs_err": err,
                    "err_over_max_prob": rel,
                    "tol": TOL_CAFFE_PROB, "top1_equal": top1,
                    "top1_min_gap": float((srt[:, -1] - srt[:, -2]).min()),
                    "images_per_s": CAFFE_B / (t["wall_ms"] / 1e3),
                    "device_ms": t["device_ms"],
                    "device_busy_share": t["device_busy_share"]}
            if spec[0].startswith("VGG"):
                vgg_top1 = got.argmax(1).tolist()
                line.update(_caffe_fine_tune(torch, net, shape))
                fit_counts = line.pop("counts")
            emit(line)
            if not (err <= TOL_CAFFE_PROB and top1):
                raise AssertionError(f"caffe-main {spec[0]}: max abs err "
                                     f"{err}, top-1 equal {top1}")
            del im, net
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return fit_counts, vgg_top1


# torch-main: bert-base-uncased's published config (vocab 30522, hidden
# 768, 12 layers, 12 heads, intermediate 3072, 512 positions, 2 token
# types, erf GELU, LayerNorm eps 1e-12) with a 2-label head, as a plain
# nn.Module, fine-tuned by the BERT paper's GLUE recipe: S=128, B=32,
# AdamW(2e-5, weight decay 0.01), cross-entropy
TORCH_BERT_CFG = dict(vocab=30522, hidden=768, layers=12, heads=12,
                      intermediate=3072, positions=512, types=2, eps=1e-12,
                      labels=2)
TORCH_BERT_S, TORCH_BERT_B, TORCH_BERT_STEPS = 128, 32, 8
TORCH_BERT_LR, TORCH_BERT_WD = 2e-5, 0.01
TORCH_SGD_STEPS, TORCH_SGD_LR = 4, 1e-3
TORCH_AUTO_WIDTHS, TORCH_AUTO_STEPS = (64, 256), 4
# predict before fit, against the module's own eval forward on the card
# and against the CPU route: f32 with TF32 off, 12 blocks of sums in
# other orders, logits of O(1)
TOL_TORCH_PREDICT = 1e-4
# the kernel route's step losses against the plain route's: the first
# bit-equal, the rest within estimator-tiny's AdamW bar, relative
TOL_TORCH_STEP = 1e-4
# gan-main: TF-GAN's MNIST example networks (tensorflow_gan/examples/
# mnist/networks.py: unconditional_generator, unconditional_discriminator)
# on MNIST-shaped images in [-1, 1], Adam(1e-3, beta_1 0.5) for both
GAN_NOISE, GAN_B, GAN_IMAGES, GAN_LR, GAN_BETA1 = 64, 32, 2048, 1e-3, 0.5
# one iteration on the card against the CPU route: the losses within
# TOL_GAN_LOSS relative; a param element may differ past TOL_GAN_PARAM
# only where Adam's first step normalizes a gradient within rounding of
# zero to a full step of either sign: at most GAN_DIFF_SHARE_MAX of them
TOL_GAN_LOSS, TOL_GAN_PARAM, GAN_DIFF_SHARE_MAX = 1e-4, 1e-5, 1e-3
TOL_GAN_GENERATE = 1e-5
# infer-est-main: infer-main's 1024 images at its batch of 128, from the
# array and from 8 shards
INFER_EST_SHARDS = 8
# continuous-main: chronos-main's LSTM on chronos_series; the incumbent
# trains one epoch on the first 40 % of the windows, the candidate one on
# the first 80 %; the gate mirrors 256 held-out windows
CONTINUOUS_GATE_WINDOWS = 256
CONTINUOUS_B = CHRONOS_B


def _torch_bert(torch, seed=0, **cfg):
    """BERT for sequence classification as a plain ``nn.Module`` (the
    card's machine has no ``transformers``): post-LN blocks, a padding
    mask from the ids (id 0), the pooler's tanh over [CLS], dropout 0.1
    (an eval-mode trace drops it); BERT's init (normal 0.02, zero
    biases), drawn on the CPU from ``seed``."""
    nn, F = torch.nn, torch.nn.functional
    h, n_head = cfg["hidden"], cfg["heads"]
    d = h // n_head

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.q, self.k, self.v, self.o = (nn.Linear(h, h)
                                              for _ in range(4))
            self.ln1 = nn.LayerNorm(h, eps=cfg["eps"])
            self.fc1 = nn.Linear(h, cfg["intermediate"])
            self.fc2 = nn.Linear(cfg["intermediate"], h)
            self.ln2 = nn.LayerNorm(h, eps=cfg["eps"])
            self.drop = nn.Dropout(0.1)

        def forward(self, x, bias):
            b, t, _ = x.shape

            def heads(y):
                return y.view(b, t, n_head, d).transpose(1, 2)
            att = heads(self.q(x)) @ heads(self.k(x)).transpose(-1, -2)
            att = self.drop((att / math.sqrt(d) + bias).softmax(-1))
            ctx = (att @ heads(self.v(x))).transpose(1, 2).reshape(b, t, h)
            x = self.ln1(x + self.drop(self.o(ctx)))
            return self.ln2(x + self.drop(self.fc2(F.gelu(self.fc1(x)))))

    class Bert(nn.Module):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(cfg["vocab"], h)
            self.pos = nn.Embedding(cfg["positions"], h)
            self.token_type = nn.Embedding(cfg["types"], h)
            self.ln = nn.LayerNorm(h, eps=cfg["eps"])
            self.blocks = nn.ModuleList(Block()
                                        for _ in range(cfg["layers"]))
            self.pooler = nn.Linear(h, h)
            self.classifier = nn.Linear(h, cfg["labels"])
            self.drop = nn.Dropout(0.1)

        def forward(self, ids):
            pos = torch.arange(ids.shape[1], device=ids.device)
            x = self.word(ids) + self.pos(pos)[None] + \
                self.token_type(torch.zeros_like(ids))
            x = self.drop(self.ln(x))
            bias = (1.0 - (ids != 0).float())[:, None, None, :] * -10000.0
            for block in self.blocks:
                x = block(x, bias)
            pooled = torch.tanh(self.pooler(x[:, 0]))
            return self.classifier(self.drop(pooled))

    g = torch.Generator().manual_seed(seed)
    m = Bert()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=g)
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
    return m


def _glue_rows(n, seed):
    """``n`` seeded GLUE-shaped rows: token ids padded with 0 after a
    length drawn from [16, S], labels 0/1."""
    import numpy as np
    rs = np.random.RandomState(seed)
    S = TORCH_BERT_S
    ids = rs.randint(1, TORCH_BERT_CFG["vocab"], (n, S)).astype(np.int64)
    lengths = rs.randint(16, S + 1, n)
    ids[np.arange(S)[None, :] >= lengths[:, None]] = 0
    return ids, rs.randint(0, 2, n).astype(np.int64)


def _forward_devices(torch, fn):
    """``fn()`` under a dispatch mode: the (device, op) of every tensor
    an op of it returns."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Devices(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor):
                    self.seen.add((t.device.type, str(func)))
            return out

    mode = Devices()
    with torch.no_grad(), mode:
        fn()
    return mode.seen


@contextlib.contextmanager
def _fused_optim(on):
    """``ZOO_FUSED_OPTIM`` set to 1 (``on``) or unset, then restored."""
    saved = os.environ.pop("ZOO_FUSED_OPTIM", None)
    if on:
        os.environ["ZOO_FUSED_OPTIM"] = "1"
    try:
        yield
    finally:
        os.environ.pop("ZOO_FUSED_OPTIM", None)
        if saved is not None:
            os.environ["ZOO_FUSED_OPTIM"] = saved


def _only(counts, **want):
    """Raise unless every kernel launched as ``want`` says (others 0)."""
    if counts != dict(dict.fromkeys(counts, 0), **want):
        raise AssertionError("launches " + str(
            {k: v for k, v in counts.items() if v}) + f", expected {want}")


def _restart(torch, est, start, optimizer):
    """The estimator back at its first epoch from ``start`` (its traced
    weights), its model compiled again with ``optimizer`` (fresh
    optimizer state): the next ``fit`` replays the same batches."""
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map
    m = est.model
    m._place_params(tree_map(lambda t: t.detach().clone(), start),
                    m._params_device())
    m.compile(optimizer=optimizer, loss=m.loss_fn,
              dtype_policy=m.dtype_policy)
    est._epoch = 0


def phase_torch_main(torch, K, card):
    """``torch-main``: BERT-base as a plain ``nn.Module``
    (:func:`_torch_bert`, ``TORCH_BERT_CFG``, the user's module on the
    card) through ``orca.learn.pytorch.Estimator.from_torch`` with
    ``torch.optim.AdamW(2e-5, weight_decay=0.01)`` and
    ``nn.CrossEntropyLoss()``, the default guard, no ``device=``. The
    trace (a CPU copy of the module, 2 rows) and its seconds and ops;
    no tensor of a converted forward created off the card; ``predict``
    before ``fit`` against the module's own eval forward and the CPU
    route (``TOL_TORCH_PREDICT``); 8 steps at S=128, B=32 with
    ``ZOO_FUSED_OPTIM=1`` (the AdamW kernel once a leaf a step, the key
    split once a step, nothing else); ``get_model()``'s parameters
    bit-equal to the estimator's; a timed fit of 4 steps. Then the same
    estimator replays the 8 steps from the traced weights with the
    torch AdamW converted again with the knob unset (the plain update):
    the first loss bit-equal, the rest within ``TOL_TORCH_STEP``; and 4
    steps with a converted ``torch.optim.SGD(momentum=0.9)`` (the SGD
    kernel once a leaf a step). The replays reuse the one trace, which
    takes the card's host tens of seconds. Last, a 2-trial
    ``AutoEstimator.from_torch`` grid over a torch MLP's hidden width,
    each trial on the card. Returns the launches of the AdamW fit and of
    the SGD fit."""
    import numpy as np
    from zoo_tpu_torch.orca.automl import AutoEstimator, hp
    from zoo_tpu_torch.orca.learn.pytorch import Estimator
    from zoo_tpu_torch.orca.learn.pytorch.estimator import (
        _convert_optimizer,
    )
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map

    nn = torch.nn
    cfg = TORCH_BERT_CFG
    S, B, steps = TORCH_BERT_S, TORCH_BERT_B, TORCH_BERT_STEPS
    t0 = time.perf_counter()
    bert = _torch_bert(torch, seed=0, **cfg).cuda()
    build_s = time.perf_counter() - t0
    leaves = len(list(bert.named_parameters()))
    x, y = _glue_rows(B * steps, seed=0)
    x_eval = _glue_rows(16, seed=1)[0]

    def adamw():
        return torch.optim.AdamW(bert.parameters(), lr=TORCH_BERT_LR,
                                 weight_decay=TORCH_BERT_WD)

    with _fused_optim(True):
        est = Estimator.from_torch(model=bert, optimizer=adamw(),
                                   loss=nn.CrossEntropyLoss())
    t0 = time.perf_counter()
    est._ensure_converted([x_eval])   # what the first call does
    convert_s = time.perf_counter() - t0
    net = est.model
    start = tree_map(lambda t: t.detach().clone(), net.params)
    if not net.optimizer.fused:
        raise AssertionError("torch-main: ZOO_FUSED_OPTIM=1 left "
                             "AdamWeightDecay unfused")
    pred = est.predict(x_eval, batch_size=B)
    with torch.no_grad():
        own = bert.eval()(torch.from_numpy(x_eval).cuda()).cpu().numpy()
    cpu = net.predict(x_eval[:4], batch_size=B, device="cpu")
    xb = torch.from_numpy(x_eval).cuda()
    step = net._build_pred_step(torch.device("cuda"))
    seen = _forward_devices(torch, lambda: step(xb))
    off = sorted(op for dev, op in seen if dev != "cuda")
    predict = {"vs_module": float(np.abs(pred - own).max()),
               "vs_cpu": float(np.abs(pred[:4] - cpu).max()),
               "logit_spread": float(np.abs(own).max()),
               "ops_off_the_card": off, "forward_ops": len(seen)}
    emit({"phase": "torch-main", "run": "convert", "card": card,
          "config": dict(cfg, seq_len=S), "leaves": leaves,
          "build_s": build_s, "trace_and_convert_s": convert_s,
          "torch": torch.__version__, "ops": net.converted.ops,
          "n_ops": len(net.converted.ops),
          "graph_nodes": len(net.converted.gm.graph.nodes),
          "predict": predict, "tol": TOL_TORCH_PREDICT})
    if off or predict["vs_module"] > TOL_TORCH_PREDICT or \
            predict["vs_cpu"] > TOL_TORCH_PREDICT:
        raise AssertionError(f"torch-main predict: {predict}")

    def fit(rows):
        K.reset_launch_counts()
        with _recorded_steps(net) as losses:
            est.fit({"x": x[:rows], "y": y[:rows]}, epochs=1, batch_size=B)
        torch.cuda.synchronize()
        return torch.stack(losses).tolist(), K.launch_counts()

    kern, adam_counts = fit(B * steps)
    _only(adam_counts, fused_adam=leaves * steps, derive_keys=steps)
    w = net.params["torch_graph"]["w"]
    back = dict(est.get_model().named_parameters())
    written_back = sorted(back) == sorted(w) and all(
        back[k].device == w[k].device and torch.equal(back[k], w[k])
        for k in w)
    # timing: a fit of 4 steps' rows, its launches per step
    rows = 4 * B
    t = timed(torch, lambda: est.fit({"x": x[:rows], "y": y[:rows]},
                                     epochs=1, batch_size=B),
              iters=1, warmup=1)
    numbers = dict(_run_numbers(t, rows, 4),
                   device_launches_per_step=(t["device_launches"] or 0) / 4)
    # the plain route: the torch AdamW converted with the knob unset
    with _fused_optim(False):
        plain_opt = _convert_optimizer(adamw())
    _restart(torch, est, start, plain_opt)
    plain, plain_counts = fit(B * steps)
    _only(plain_counts, derive_keys=steps)
    rel = [abs(a - b) / abs(b) for a, b in zip(kern[1:], plain[1:])]
    emit({"phase": "torch-main", "run": "adamw", "card": card,
          "batch": B, "steps": steps, "leaves": leaves,
          "losses_kernels": kern, "losses_plain": plain,
          "plain_fused": plain_opt.fused,
          "first_bit_equal": kern[0] == plain[0],
          "loss_max_rel": max(rel), "tol": TOL_TORCH_STEP,
          "written_back_bit_equal": written_back, "timing": numbers,
          "launches": {k: v for k, v in adam_counts.items() if v}})
    if kern[0] != plain[0] or max(rel) > TOL_TORCH_STEP or \
            not written_back or plain_opt.fused or \
            not np.isfinite(kern).all():
        raise AssertionError(f"torch-main adamw: {kern} vs {plain}, "
                             f"written back {written_back}")
    # SGD with momentum: the fused SGD kernel
    _restart(torch, est, start, _convert_optimizer(torch.optim.SGD(
        bert.parameters(), lr=TORCH_SGD_LR, momentum=0.9)))
    sgd_losses, sgd_counts = fit(TORCH_SGD_STEPS * B)
    emit({"phase": "torch-main", "run": "sgd", "card": card,
          "steps": TORCH_SGD_STEPS, "losses": sgd_losses,
          "optimizer": type(net.optimizer).__name__,
          "device": str(net._params_device()),
          "launches": {k: v for k, v in sgd_counts.items() if v}})
    _only(sgd_counts, fused_sgd=leaves * TORCH_SGD_STEPS,
          derive_keys=TORCH_SGD_STEPS)
    del est, net, start
    torch.cuda.empty_cache()
    # AutoEstimator: two trials over a torch MLP's hidden width
    rs = np.random.RandomState(2)
    xa = rs.randn(TORCH_AUTO_STEPS * B, 64).astype(np.float32)
    ya = (xa[:, :8].sum(1, keepdims=True) > 0).astype(np.float32)

    def mlp(config):
        torch.manual_seed(0)
        return nn.Sequential(nn.Linear(64, config["hidden"]), nn.ReLU(),
                             nn.Linear(config["hidden"], 1))

    mlp_leaves = len(list(mlp({"hidden": 8}).parameters()))
    auto = AutoEstimator.from_torch(
        model_creator=mlp, loss=nn.BCEWithLogitsLoss(),
        optimizer=lambda m, c: torch.optim.SGD(m.parameters(), lr=0.05,
                                               momentum=0.9))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    auto.fit({"x": xa, "y": ya}, epochs=1, batch_size=B,
             search_space={"hidden": hp.grid_search(
                 list(TORCH_AUTO_WIDTHS))}, metric="loss")
    auto_s = time.perf_counter() - t0
    auto_counts = K.launch_counts()
    best = auto.get_best_model()
    trials = len(TORCH_AUTO_WIDTHS)
    emit({"phase": "torch-main", "run": "auto", "card": card,
          "trials": trials, "best_config": auto.get_best_config(),
          "best_metric": auto.best_metric, "seconds": auto_s,
          "best_device": str(best.model._params_device()),
          "launches": {k: v for k, v in auto_counts.items() if v}})
    _only(auto_counts, fused_sgd=mlp_leaves * TORCH_AUTO_STEPS * trials,
          derive_keys=TORCH_AUTO_STEPS * trials)
    if best.model._params_device().type != "cuda":
        raise AssertionError("torch-main: the best trial is off the card")
    return adam_counts, sgd_counts


def _tfgan_generator(L, Sequential):
    """TF-GAN's ``unconditional_generator`` from the Keras layers: FC 1024
    and FC 7*7*256 (batch norm, ReLU), two 4x4 stride-2 transposed convs
    to 64 and 32 channels (TF's SAME: VALID then a 1-pixel crop; batch
    norm, ReLU), a 4x4 conv to 1 channel with tanh."""
    g = Sequential()
    g.add(L.Dense(1024, input_shape=(GAN_NOISE,), bias=False))
    for layer in (L.BatchNormalization(), L.Activation("relu"),
                  L.Dense(7 * 7 * 256, bias=False), L.BatchNormalization(),
                  L.Activation("relu"), L.Reshape((7, 7, 256))):
        g.add(layer)
    for width in (64, 32):
        for layer in (L.Deconvolution2D(width, 4, 4, subsample=(2, 2),
                                        bias=False, dim_ordering="tf"),
                      L.Cropping2D(((1, 1), (1, 1)), dim_ordering="tf"),
                      L.BatchNormalization(), L.Activation("relu")):
            g.add(layer)
    g.add(L.Convolution2D(1, 4, 4, border_mode="same", activation="tanh",
                          dim_ordering="tf"))
    return g


def _tfgan_discriminator(L, Sequential):
    """TF-GAN's ``unconditional_discriminator``: 4x4 stride-2 convs to 64
    and 128 channels (leaky ReLU 0.01), flatten, FC 1024 (batch norm,
    leaky ReLU), a linear logit."""
    d = Sequential()
    d.add(L.Convolution2D(64, 4, 4, subsample=(2, 2), border_mode="same",
                          dim_ordering="tf", input_shape=(28, 28, 1)))
    for layer in (L.LeakyReLU(0.01),
                  L.Convolution2D(128, 4, 4, subsample=(2, 2),
                                  border_mode="same", dim_ordering="tf"),
                  L.LeakyReLU(0.01), L.Flatten(), L.Dense(1024, bias=False),
                  L.BatchNormalization(), L.LeakyReLU(0.01), L.Dense(1)):
        d.add(layer)
    return d


def _kernel_convs(net):
    """The Conv2D layers of a Sequential inside the conv kernel's
    envelope."""
    from zoo_tpu_torch.ops.kernels.conv import pallas_conv_supported
    from zoo_tpu_torch.pipeline.api.keras.layers import Convolution2D
    return sum(isinstance(layer, Convolution2D) and pallas_conv_supported(
        layer.kernel, layer.subsample) for layer in net.layers)


def phase_gan_main(torch, K, card):
    """``gan-main``: ``GANEstimator`` over TF-GAN's MNIST networks
    (:func:`_tfgan_generator`, :func:`_tfgan_discriminator`; noise 64),
    Adam(1e-3, beta_1 0.5) for both, on 2048 seeded MNIST-shaped images
    in [-1, 1] at B=32: one iteration on the card against the CPU route
    from the same seed weights (losses, params: ``TOL_GAN_*``, with the
    unmoved params as a control that must fail); the 64-step epoch with
    exact launches (the key split twice an iteration; ``conv2d`` as many
    times as the nets' convs inside its envelope run, which for TF-GAN's
    4x4 convs is none); ``generate(64, seed)`` against the CPU route; a
    NaN batch under the guard leaves the whole state bit-equal. Returns
    the epoch's launches."""
    import numpy as np
    from zoo_tpu_torch.orca.learn.gan import GANEstimator
    from zoo_tpu_torch.pipeline.api.keras import layers as L
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.engine.topology import Sequential
    from zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    rs = np.random.RandomState(0)
    real = rs.uniform(-1.0, 1.0, (GAN_IMAGES, 28, 28, 1)).astype(np.float32)
    nets = {}
    for dev in ("cuda", "cpu"):
        g = _tfgan_generator(L, Sequential)
        d = _tfgan_discriminator(L, Sequential)
        if dev == "cuda":
            g.build(torch.Generator(device="cuda").manual_seed(0),
                    [(None, GAN_NOISE)], device="cuda")
            d.build(torch.Generator(device="cuda").manual_seed(1),
                    [(None, 28, 28, 1)], device="cuda")
        else:
            g.params = tree_map(lambda t: t.detach().cpu().clone(),
                                nets["cuda"][0].params)
            d.params = tree_map(lambda t: t.detach().cpu().clone(),
                                nets["cuda"][1].params)
        nets[dev] = (g, d)
    start = [t.detach().cpu().clone() for net in nets["cpu"]
             for t in tree_leaves(net.params)]

    def gan(dev):
        g, d = nets[dev]
        return GANEstimator(g, d, g_optimizer=Adam(lr=GAN_LR,
                                                   beta_1=GAN_BETA1),
                            d_optimizer=Adam(lr=GAN_LR, beta_1=GAN_BETA1),
                            noise_dim=GAN_NOISE, device=dev)

    def params(est):
        return [t.detach().cpu() for net in (est.g, est.d)
                for t in tree_leaves(net.params)]

    def diff_share(a, b):
        n = sum(t.numel() for t in a)
        return sum(int(((x - y).abs() > TOL_GAN_PARAM).sum())
                   for x, y in zip(a, b)) / n

    ests = {dev: gan(dev) for dev in ("cuda", "cpu")}
    one = {dev: e.fit(real[:GAN_B], epochs=1, batch_size=GAN_B, seed=3)
           for dev, e in ests.items()}
    after = {dev: params(e) for dev, e in ests.items()}
    share = diff_share(after["cuda"], after["cpu"])
    control = diff_share(start, after["cpu"])
    loss_rel = max(abs(one["cuda"][k][0] - one["cpu"][k][0])
                   / abs(one["cpu"][k][0]) for k in ("d_loss", "g_loss"))
    # generate from the same generator weights on both routes
    ests["cpu"].g.params = tree_map(lambda t: t.detach().cpu().clone(),
                                    ests["cuda"].g.params)
    gen = {dev: e.generate(64, seed=5) for dev, e in ests.items()}
    gen_err = float(np.abs(gen["cuda"] - gen["cpu"]).max())
    step = {"losses_card": one["cuda"], "losses_cpu": one["cpu"],
            "loss_max_rel": loss_rel, "param_diff_share": share,
            "control_unmoved_share": control,
            "max_param_diff": max(float((x - y).abs().max())
                                  for x, y in zip(after["cuda"],
                                                  after["cpu"])),
            "generate_max_abs": gen_err}
    emit({"phase": "gan-main", "run": "one_step", "card": card, **step,
          "tol": [TOL_GAN_LOSS, TOL_GAN_PARAM, GAN_DIFF_SHARE_MAX,
                  TOL_GAN_GENERATE]})
    if not (loss_rel <= TOL_GAN_LOSS and share <= GAN_DIFF_SHARE_MAX
            and control > GAN_DIFF_SHARE_MAX
            and gen_err <= TOL_GAN_GENERATE and gen["cuda"].shape ==
            (64, 28, 28, 1) and np.isfinite(gen["cuda"]).all()):
        raise AssertionError(f"gan-main: one step vs the CPU route {step}")
    del ests["cpu"], nets["cpu"]
    # the epoch of 64 steps on the card
    est = ests["cuda"]
    n_steps = GAN_IMAGES // GAN_B
    g_convs, d_convs = _kernel_convs(est.g), _kernel_convs(est.d)
    per_step_convs = (est.d_steps * (g_convs + 2 * d_convs)
                      + est.g_steps * (g_convs + d_convs))
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = est.fit(real, epochs=1, batch_size=GAN_B, seed=4)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = K.launch_counts()
    keys = (est.d_steps + est.g_steps) * n_steps
    rows = 8 * GAN_B
    t = timed(torch, lambda: est.fit(real[:rows], epochs=1,
                                     batch_size=GAN_B), iters=1, warmup=1)
    # a NaN batch: the whole iteration folds away
    before = [t_.detach().clone() for part in est._state
              for t_ in tree_leaves(part)]
    poisoned = real[:GAN_B].copy()
    poisoned[5, 14, 14, 0] = np.nan
    nan_hist = est.fit(poisoned, epochs=1, batch_size=GAN_B)
    now = [t_ for part in est._state for t_ in tree_leaves(part)]
    unchanged = len(now) == len(before) and all(
        torch.equal(a, b) for a, b in zip(before, now))
    emit({"phase": "gan-main", "run": "epoch", "card": card,
          "images": GAN_IMAGES, "batch": GAN_B, "steps": n_steps,
          "d_loss": hist["d_loss"], "g_loss": hist["g_loss"],
          "epoch_s": epoch_s, "step_ms": epoch_s / n_steps * 1e3,
          "timing": dict(_run_numbers(t, rows, 8),
                         device_launches_per_step=(
                             t["device_launches"] or 0) / 8),
          "convs_in_the_kernel_envelope": [g_convs, d_convs],
          "nan_batch": {"state_bit_equal": unchanged,
                        "losses": nan_hist},
          "launches": {k: v for k, v in counts.items() if v}})
    _only(counts, conv2d=per_step_convs * n_steps, derive_keys=keys)
    if not (unchanged and nan_hist == {"d_loss": [0.0], "g_loss": [0.0]}
            and np.isfinite(hist["d_loss"] + hist["g_loss"]).all()):
        raise AssertionError(f"gan-main: NaN batch {unchanged} {nan_hist}, "
                             f"losses {hist}")
    return counts


def phase_infer_est_main(torch, K, card, resnet_file, vgg_top1):
    """``infer-est-main``: ``orca.learn.inference.Estimator.from_model``
    over infer-main's saved ResNet-50 (seed weights, BatchNorm refreshed,
    head calibrated; mixed bf16), float and int8 (``ZOO_INT8_MODE=force``,
    ``quantize=True``), ``predict`` over infer-main's 1024 images at
    B=128 from 8 XShards (XShards of prediction dicts back) and from the
    array: both feeds bit-equal to each other and to the estimator's
    ``InferenceModel.predict``; the conv kernel 49 times a forward
    (float), the int8 conv 49 and the fused int8 GEMM once (int8); then
    ``from_caffe`` on caffe-main's VGG-16 files (written again from the
    same seed) gives caffe-main's top-1. Returns the launches of both
    routes' predicts."""
    import shutil
    import tempfile

    import numpy as np
    from zoo_tpu_torch.orca.data import XShards
    from zoo_tpu_torch.orca.learn.inference import Estimator

    B, n = INFER_B, INFER_B * INFER_STEPS
    rs = np.random.RandomState(0)                          # infer-main's
    x = np.concatenate([rs.randn(B, 224, 224, 3).astype(np.float32)
                        for _ in range(INFER_STEPS)])
    shards = XShards.partition({"x": x}, num_shards=INFER_EST_SHARDS)
    total = {}
    saved = os.environ.get("ZOO_INT8_MODE")
    try:
        for route, want in (("float", {"conv2d": 49}),
                            ("int8", {"conv2d_int8": 49,
                                      "fused_quantized_matmul": 1})):
            if route == "int8":
                os.environ["ZOO_INT8_MODE"] = "force"
            t0 = time.perf_counter()
            est = Estimator.from_model(resnet_file, batch_size=B,
                                       quantize=route == "int8")
            load_s = time.perf_counter() - t0
            out, numbers = {}, {}
            for feed, data in (("xshards", shards), ("array", x)):
                K.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = est.predict(data, batch_size=B)
                wall = time.perf_counter() - t0
                counts = K.launch_counts()
                if feed == "xshards":
                    parts = got.collect()
                    if len(parts) != INFER_EST_SHARDS or any(
                            set(p) != {"prediction"} for p in parts):
                        raise AssertionError("infer-est-main: XShards out "
                                             f"{[set(p) for p in parts]}")
                    got = np.concatenate([p["prediction"] for p in parts])
                out[feed] = got
                numbers[feed] = {"wall_s": wall, "images_per_s": n / wall}
                _only(counts, **{k: v * INFER_STEPS
                                 for k, v in want.items()})
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
            direct = est.get_model().predict(x, batch_size=B)
            same = {"feeds": bool(np.array_equal(out["xshards"],
                                                 out["array"])),
                    "inference_model": bool(np.array_equal(out["array"],
                                                           direct))}
            emit({"phase": "infer-est-main", "route": route, "card": card,
                  "images": n, "batch": B, "shards": INFER_EST_SHARDS,
                  "load_s": load_s,
                  "quant_path": getattr(est.get_model().model,
                                        "_quant_path", None),
                  "bit_equal": same, "timing": numbers,
                  "top1_classes": int(len(set(direct.argmax(1))))})
            if not all(same.values()) or direct.shape != (n, 1000):
                raise AssertionError(f"infer-est-main {route}: {same}")
            del est
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("ZOO_INT8_MODE", None)
        if saved is not None:
            os.environ["ZOO_INT8_MODE"] = saved
    root = tempfile.mkdtemp(prefix="zoo-infer-est-")
    try:
        deploy, path, shape = _write_caffe(root, _vgg16_layers(), 16)
        xc = np.random.RandomState(16).randn(CAFFE_B, *shape).astype(
            np.float32)
        t0 = time.perf_counter()
        est = Estimator.from_caffe(deploy, path, batch_size=CAFFE_B)
        load_s = time.perf_counter() - t0
        top1 = est.predict(xc).argmax(1).tolist()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "infer-est-main", "route": "caffe", "card": card,
          "net": "VGG_ILSVRC_16_layers", "load_s": load_s,
          "top1_equal_caffe_main": top1 == vgg_top1})
    if top1 != vgg_top1:
        raise AssertionError(f"infer-est-main: from_caffe top-1 {top1}, "
                             f"caffe-main's {vgg_top1}")
    return total


def phase_continuous_main(torch, K, card):
    """``continuous-main``: the online-learning loop over chronos-main's
    LSTM forecaster (hidden 32, dropout 0.1, lookback 48, B=64) on
    :func:`chronos_series`'s windows, published into a ``ModelRegistry``
    in a temporary directory. An incumbent (one epoch on the first 40 %
    of the windows, no gate: promoted directly), then the measured turn:
    ``chronos_train_fn`` trains a candidate (one epoch on the first 80
    %), publishes it on ``canary``, and a ``PromotionGate`` mirrors 256
    held-out windows with ground truth to incumbent and canary, both
    loaded back as ``InferenceModel``s on the card; the turn must end
    ``promoted`` with ``prod`` on the candidate. Then a poisoned window
    (every input NaN) must end ``demoted`` with ``prod`` unchanged.
    ``dropout`` launches twice a training step and ``derive_keys`` twice
    (the step's split and the dropout site's key); inference launches
    neither. Returns the loop's launches."""
    import shutil
    import tempfile

    import numpy as np
    from zoo_tpu_torch.chronos.data import roll_windows
    from zoo_tpu_torch.chronos.forecaster import LSTMForecaster
    from zoo_tpu_torch.orca.learn.continuous import (ContinuousTrainingLoop,
                                                     PromotionGate,
                                                     chronos_train_fn)
    from zoo_tpu_torch.serving.ha import resolve_model_spec
    from zoo_tpu_torch.serving.registry import ModelRegistry

    series = chronos_series()
    x, y = roll_windows(series, series[:, :1], CHRONOS_LOOKBACK, 1)
    n = len(x) - CONTINUOUS_GATE_WINDOWS
    made = []

    def factory():
        f = LSTMForecaster(CHRONOS_LOOKBACK, 3, 1, hidden_dim=32,
                           dropout=0.1, device="cuda")
        made.append(f)
        return f

    root = tempfile.mkdtemp(prefix="zoo-continuous-")
    try:
        reg = ModelRegistry(os.path.join(root, "registry"))
        K.reset_launch_counts()
        first = ContinuousTrainingLoop(chronos_train_fn(
            factory, epochs=1, batch_size=CONTINUOUS_B,
            out_dir=os.path.join(root, "v1")), reg)
        out1 = first.step((x[:int(n * 0.4)], y[:int(n * 0.4)]))

        def gate_factory(candidate):
            spec = f"registry:{reg.root}:"
            inc = resolve_model_spec(spec + "prod", batch_size=1,
                                     device="cuda")[0]
            can = resolve_model_spec(spec + candidate, batch_size=1,
                                     device="cuda")[0]
            return PromotionGate(inc.predict, can.predict,
                                 candidate=candidate, registry=reg,
                                 sample=1.0, window=CONTINUOUS_GATE_WINDOWS,
                                 rng=np.random.RandomState(0))

        loop = ContinuousTrainingLoop(chronos_train_fn(
            factory, epochs=1, batch_size=CONTINUOUS_B,
            out_dir=os.path.join(root, "v2")), reg,
            gate_factory=gate_factory)
        traffic = [(x[i:i + 1], y[i:i + 1]) for i in range(n, len(x))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out2 = loop.step((x[:int(n * 0.8)], y[:int(n * 0.8)]), traffic)
        torch.cuda.synchronize()
        turn_s = time.perf_counter() - t0
        prod_after = reg.alias_version("prod")
        poisoned = x[:int(n * 0.4)].copy()
        poisoned[:] = np.nan
        t0 = time.perf_counter()
        out3 = loop.step((poisoned, y[:int(n * 0.4)]), traffic)
        demote_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = K.launch_counts()
        versions = reg.versions()
        prod_final = reg.alias_version("prod")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    train_steps = sum(f.model._step for f in made)
    gate = out2.get("gate", {})
    emit({"phase": "continuous-main", "card": card,
          "windows": [int(n * 0.4), int(n * 0.8)], "lookback":
          CHRONOS_LOOKBACK, "batch": CONTINUOUS_B,
          "incumbent": {k: out1[k] for k in ("outcome", "version",
                                             "train_seconds")},
          "turn": {"outcome": out2["outcome"], "version": out2["version"],
                   "reason": out2.get("reason"), "seconds": turn_s,
                   "train_seconds": out2["train_seconds"], "gate": gate},
          "poisoned": {"outcome": out3["outcome"], "seconds": demote_s,
                       "error": out3.get("error")},
          "versions": versions, "prod": [prod_after, prod_final],
          "train_steps": train_steps,
          "launches": {k: v for k, v in counts.items() if v}})
    if not (out1["outcome"] == "promoted" and out2["outcome"] == "promoted"
            and prod_after == out2["version"] == "v2"
            and gate.get("mirrored") == CONTINUOUS_GATE_WINDOWS
            and out3["outcome"] == "demoted" and prod_final == "v2"
            and versions == [1, 2]):
        raise AssertionError(f"continuous-main: {out1}, {out2}, {out3}, "
                             f"versions {versions}, prod {prod_final}")
    _only(counts, dropout=2 * train_steps, derive_keys=2 * train_steps)
    return counts


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import zoo_tpu_torch.ops.kernels as K
        from zoo_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the zoo_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    # full-f32 products everywhere (TF32 keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import shutil
    import tempfile
    scratch = tempfile.mkdtemp(prefix="zoo-smoke-")
    # infer-main's calibrated ResNet-50, read again by infer-est-main
    resnet_file = os.path.join(scratch, "resnet50.zoo")
    try:
        t_start = time.perf_counter()
        name = torch.cuda.get_device_name(0)
        cap = torch.cuda.get_device_capability(0)
        card = nvidia_smi_line()
        emit({"phase": "device", "name": name, "capability": list(cap),
              "count": torch.cuda.device_count(), "nvidia_smi": card,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "host": host_facts()})
        if tuple(cap) != (9, 0):
            raise AssertionError(f"{name} is compute capability {cap}; the "
                                 "kernels are built for sm_90a (Hopper)")
        t0 = time.perf_counter()
        built = staged("build", _build.build)
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "kernels": {k: {"reused": r.reused,
                              "ptxas": ptxas_lines(r.ptxas)}
                          for k, r in built.items()}})
        check_no_spills(built)
        mma, f32_mma = staged("sass", phase_sass, built)

        timing = staged("kernels", phase_kernels, torch)
        staged("tiny", phase_tiny, torch, K)
        staged("train-tiny", phase_train_tiny, torch, K)
        staged("train-bert-tiny", phase_train_bert_tiny, torch, K)
        moe_tiny = staged("moe-tiny", phase_moe_tiny, torch, K)
        staged("estimator-tiny", phase_estimator_tiny, torch, K)
        # each main path's launches, counted from 0 just before it runs
        staged("infer-tiny", phase_infer_tiny, torch, K)
        staged("predict-tiny", phase_predict_tiny, torch, K)
        staged("cluster-tiny", phase_cluster_tiny, torch, K)
        staged("train-image-tiny", phase_train_image_tiny, torch, K)
        serve, serve_spec, serve_wire, serve_disagg, serve_tenancy, \
            serve_obs = staged("main", phase_main, torch, K, card)
        by_path = {"serve": serve, "serve_spec": serve_spec,
                   "serve_wire": serve_wire, "serve_disagg": serve_disagg,
                   "serve_tenancy": serve_tenancy, "serve_obs": serve_obs}
        by_path["train"] = staged("train-main", phase_train_main, torch, K,
                                  card)
        by_path["infer"] = staged("infer-main", phase_infer_main, torch, K,
                                  card, resnet_file)
        for path, phase, fn in (
                ("block", "bottleneck-main", phase_bottleneck_main),
                ("train_image", "train-image-main",
                 phase_train_image_main),
                ("train_f32", "train-f32-main", phase_train_f32_main)):
            by_path[path] = staged(phase, fn, torch, K, card)
        staged("train-rec-main", phase_train_rec_main, torch, K, card)
        by_path["train_bert"] = staged("train-bert-main",
                                       phase_train_bert_main, torch, K,
                                       card)
        by_path["train_bert_dropout"] = staged(
            "train-bert-dropout", phase_train_bert_dropout, torch, K, card)
        by_path.update(staged("text-main", phase_text_main, torch, K, card))
        by_path.update(staged("seq-tiny", phase_seq_tiny, torch, K, card))
        by_path.update(staged("chronos-main", phase_chronos_main, torch, K,
                              card))
        by_path["zoo_predict"], by_path["zoo_fit"] = staged(
            "zoo-main", phase_zoo_main, torch, K, card)
        by_path["moe_tiny"] = moe_tiny
        by_path["moe_train"], timing["fused_adam"]["expert_leaf"] = staged(
            "moe-main", phase_moe_main, torch, K, card)
        by_path["seam_models"] = staged("seam-models-main",
                                        phase_seam_models_main, torch, K,
                                        card)
        by_path["estimator_ncf"] = staged("estimator-main",
                                          phase_estimator_main, torch, K,
                                          card)
        by_path["estimator_bert"] = staged("estimator-bert",
                                           phase_estimator_bert, torch, K,
                                           card)
        staged("bench-guard", phase_bench_guard, torch, card)
        staged("predict-mlp", phase_predict_mlp, torch, card)
        by_path["predict"] = staged("predict-main", phase_predict_main,
                                    torch, K, card)
        by_path["cluster"] = staged("cluster-main", phase_cluster_main,
                                    torch, K, card)
        by_path["orca_ncf"], by_path["orca_bert"] = staged(
            "orca-main", phase_orca_main, torch, K, card)
        feed_root = os.path.join(scratch, "feed")
        by_path["ingest"], images = staged(
            "ingest-main", phase_ingest_main, torch, K, card, feed_root)
        by_path["readers"] = staged("readers-main", phase_readers_main,
                                    torch, K, card, feed_root, images)
        del images
        by_path["detect"] = staged("detect-main", phase_detect_main, torch,
                                   K, card)
        by_path["caffe_fit"], vgg_top1 = staged("caffe-main",
                                                phase_caffe_main, torch, K,
                                                card)
        by_path["torch_bert"], by_path["torch_sgd"] = staged(
            "torch-main", phase_torch_main, torch, K, card)
        by_path["gan"] = staged("gan-main", phase_gan_main, torch, K, card)
        by_path["infer_est"] = staged("infer-est-main", phase_infer_est_main,
                                      torch, K, card, resnet_file, vgg_top1)
        by_path["continuous"] = staged("continuous-main",
                                       phase_continuous_main, torch, K, card)

        src = "zoo_tpu_torch/csrc/"
        pallas = "zoo_tpu/ops/pallas/"
        # dropout and the key chain replace no Pallas kernel: the JAX
        # package's bernoulli masks under jnp.where, and its step's split
        keras = "zoo_tpu/pipeline/api/keras/"
        sources = {
            "dropout": ("dropout.cu", keras + "layers/core.py:102"),
            "derive_keys": ("dropout.cu", keras + "engine/topology.py:455"),
            "flash_attention": ("flash_attention_fwd.cu",
                                "flash_attention.py:35"),
            "flash_attention_dkdv": ("flash_attention_bwd.cu",
                                     "flash_attention.py:151"),
            "flash_attention_dq": ("flash_attention_bwd.cu",
                                   "flash_attention.py:213"),
            "fused_bottleneck": ("fused_block.cu", "fused_block.py:80"),
            "fused_adam": ("fused_optim.cu", "fused_optim.py:87"),
            "fused_sgd": ("fused_optim.cu", "fused_optim.py:49"),
            "paged_decode": ("paged_decode.cu", "paged_decode.py:55"),
            "paged_prefill": ("paged_prefill.cu", "paged_prefill.py:54"),
            "conv2d": ("conv2d.cu", "conv.py:114"),
            "conv2d_int8": ("conv2d_int8_tc.cuh", "conv.py:128"),
            "quantized_matmul": ("quant_matmul.cu", "quant.py:42"),
            "fused_quantized_matmul": ("quant_matmul.cu", "quant.py:122")}
        kernels = []
        for k in K.KERNELS:
            t = timing[k]
            paths = {p: c[k] for p, c in by_path.items() if k in c}
            kernels.append({
                "name": k, "route": "cuda", "source": src + sources[k][0],
                "replaces": sources[k][1] if sources[k][1].startswith(
                    keras) else pallas + sources[k][1],
                "launches": sum(paths.values()), "launches_by_path": paths,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "kernel_ms": t["kernel_ms"], "wall_ms": t["wall_ms"],
                "mma": mma[k]["mma"],
                **{key: t[key] for key in ("composition_ms", "tflops",
                                           "bound_ratio", "library_ratio",
                                           "composition_ratio", "shape",
                                           "plan", "device_launches_per_call",
                                           "vgg_first_conv", "served_fc6",
                                           "zoo_shapes",
                                           "moe_shape",
                                           "long_context_shape",
                                           "expert_leaf",
                                           "interface", "shapes")
                   if key in t},
                **({"verify_shape": {key: t["verify_shape"][key] for key in (
                    "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "tflops", "bound_ratio", "shape", "plan",
                    "max_abs_err")}} if "verify_shape" in t else {}),
                **({"bert_shape": {key: t["bert_shape"][key] for key in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "tflops", "bound_ratio", "library_ratio", "shape")}}
                   if "bert_shape" in t else {}),
                **({"f32_route": dict(
                    {key: t["f32_route"][key] for key in (
                        "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "tflops", "bound_ratio",
                        "library_ratio", "shape", "max_abs_err")},
                    **{key: t["f32_route"][key] for key in (
                        "plan", "device_launches_per_call",
                        "bound_fma_ms", "bound_fma_ratio", "b64")
                       if key in t["f32_route"]},
                    mma=f32_mma[k]["mma"])}
                   if "f32_route" in t else {})})
        emit({"phase": "done", "seconds": time.perf_counter() - t_start})
        emit({"kernels": kernels})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
