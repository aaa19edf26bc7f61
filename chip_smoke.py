#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` with
``nvcc`` (one process per source, started together) and runs every phase
on ``cuda``; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``), the build time and
   ptxas's register and spill report per kernel instantiation;
2. each decode kernel against its plain torch version, in float32 and
   bfloat16, at the serving slice's attention shape (Llama-300M: H=16,
   Hkv=8, D=64, b=8, window 256, paged block 16) and at Llama-8B's
   (H=32, Hkv=8, D=128, b=8, window 4096), and at MOE_SMALL's (H=12,
   Hkv=6, D=64, window 384, b=8 and b=32: the MoE generation example's
   shapes), plus a scrambled block table
   against the identity table, bitwise. Times (CUDA events, median over
   launches, L2 flushed before each) of the kernel, the plain version and
   ``scaled_dot_product_attention`` on the gathered window (a yardstick
   only; the port never calls it), beside the memory/compute bound. The
   split window's edges: group 8 at D=128 over a window that is no
   multiple of the chunk, bounds on and around the chunk edges, against
   the plain versions, scrambled against identity tables and a wider
   table against a narrower one, bitwise;
3. ``generate()`` at Llama-300M full width and depth in float32
   (TF32 off), b=8, prompt 128, 32 new tokens: tokens equal those of
   ``decode_kernel_disabled()``, and the contiguous kernel launched
   16 layers x 31 steps times;
4. ``ServingEngine`` at Llama-300M in float32 over 12 mixed requests:
   each request's tokens equal ``generate()`` alone, and the paged
   kernel launched 16 x steps times;
5. the same engine in bfloat16, timed: tokens/s, TTFT and TPOT p50/p99,
   with the decode step as the engine's CUDA graph and as the eager step
   in turns; then 36 (b);
6. the three flash-attention kernels (forward, dq, dk/dv) against their
   plain versions in float32 and bfloat16 on thirteen cases: the training
   slice's shape (b=8, S=1024, H=16, Hkv=8, D=64, causal), a key-masked
   causal case at an awkward length with a fully masked row, causal with
   sq=256 < sk=1024, Llama-8B's width (b=1, S=4096, H=32, Hkv=8, D=128),
   the TMA kernels' edges (b=3, sq=197, sk=261: ragged last tiles and
   a diagonal offset of 64, H=16 over Hkv=2, D=128, key mask with a fully
   masked row), and three non-causal cases at group 1: BERT-base's
   (b=32, S=512, H=Hkv=12, D=64, the last quarter of the keys masked in
   every other sequence), the same without the mask, and ViT-B/16's
   (b=8, S=197, no mask); then the MoE LM's training shape (MOE_SMALL:
   b=8, S=1024, H=12, Hkv=6, D=64, causal) and ViT-S/16's at batch 64
   (S=197, H=Hkv=6, D=64, non-causal). The key-mask path: each masked
   case's bitmap (``flash_mask_words``, built once and read by all three
   kernels) bitwise against its plain version, and its kernel timed
   alone; ``bert_alltrue`` (BERT's shape, an all-true mask) bitwise
   equal to the kernels without a mask; ``bert_padded`` (lengths drawn
   from 64-512, sequence 1 fully padded: zeros) and, in bfloat16, NaN in
   K and V at every key of a fully masked 128-key tile, which must leave
   out, lse, dq and the allowed keys' dk, dv bitwise the clean run's (0
   at the masked keys); ``masked_causal_tiles`` (b4 S1024 H16/8 causal,
   whole 64- and 128-key tiles out). float32 at TOL;
   bfloat16 at SCALED_TOL (each output held to its own magnitude), and
   faults planted in the plain outputs (the last key or query tile
   skipped; causal at the slice, non-causal at BERT's) must fail that
   check. Times as in 2; the yardstick is
   ``scaled_dot_product_attention`` (``is_causal``, or the key mask as
   ``attn_mask``, ``enable_gqa=True``): its forward, and its backward
   alone (``autograd.grad`` on a saved forward), which covers dq and
   dk/dv together;
7. ``init()`` under a launcher environment of size 1: a real NCCL group
   on ``cuda:0``; collectives on card tensors return their inputs;
8. training parity at Llama-300M full size in float32: two SGD steps
   through the kernels equal two through ``use_flash=False`` (loss and
   every weight), with 16 launches per kernel per step;
9. the training example (``horovod_tpu_torch.examples.llama_training``)
   in bfloat16, seq 1024, batch 8, AdamW, 10 timed steps: tokens/s, step
   ms, falling loss, peak memory, and one profiled step's device split;
10. ResNet-50 in float32 (TF32 off), 224², batch 4: two SGD-momentum
   steps on the card (``channels_last``, cuDNN) against the same module,
   weights and batch on the CPU (loss, every weight's change, every
   running statistic, at ``RESNET_TOL``);
11. the synthetic benchmark (``examples.synthetic_benchmark``) at
   ResNet-50, bf16, batch 128, 224²: one warm-up step, 5 windows of 10
   steps (img/s per window and median), step ms, peak memory, the share
   of the bf16 dense peak (FLOPs counted from the model) and one profiled
   step's device split (convolutions, BatchNorm, optimizer, the rest);
   then ResNet-101, Inception V3 (299²) and VGG-16, 3 steps each;
12. BERT-base in float32 at seq 512, batch 4, padded-tail key mask: two
   SGD steps through ``make_attention_fn()`` (the flash kernels,
   non-causal) against ``use_flash=False``, 12 launches per kernel and
   12 mask bitmaps per step (phase 8's Llama steps: none);
13. the BERT example (``examples.bert_pretraining``), base, bf16, seq
   512, batch 32, AdamW, 10 timed steps: sequences/s, step ms, falling
   loss, peak memory, the dense-peak share and a profiled step's split,
   one mask bitmap a flash forward (``BertEncoder``'s all-true mask);
   then 10 timed steps of the same model over ``bert_padded``'s mask:
   sequences/s and the profiled flash ms a step.

14. the kernels' operand range: the decode kernels (contiguous and
   paged) at Llama-tiny's heads (H=4, Hkv=2, D=16), at D=32, at group
   16 (H=16, Hkv=1, D=64), at D=256 and at group 3; the flash kernels at
   D=16, at D=32 (BERT-tiny, non-causal, tail mask), at group 16
   (causal), at D=192 and at D=256, through the wrappers' zero-padding.
   float32 at TOL, bfloat16 at SCALED_TOL,
   timed as 2 and 6. Then ``generate()`` at LLAMA_TINY on the card in
   float32 equals ``decode_kernel_disabled()``;
15. the generation example (``examples.llama_generation``) at the JAX
   bench's two decode rows: Llama-300M bf16, prompt 128, 256 new tokens,
   batch 8 and 32: decode tokens/s and peak memory;
16. the load generator (``examples.serving_loadgen``), one engine, with
   the arguments of the JAX row ``llama_300m_serving_b8_loadgen``: its
   record (tok/s, TTFT and TPOT p50/p99, preemptions, block peak, and
   ``health``, the cluster doctor's summary over the serving series);
   every request finishes; then once more with the eager decode step;
17. fleet parity: Llama-300M float32, three replicas over one model
   behind the Router, 12 requests on a shared 64-token prefix, the
   replica serving them hard-killed once half are submitted: every
   request (replays included) equals ``generate()`` alone, affinity hits,
   and the ``hvd_serving_tokens_generated_total`` and
   ``hvd_router_requests_total`` totals agree with the engines and the
   handles;
18. the JAX fleet row ``llama_serving_fleet_prefix_loadgen`` through the
   load generator with its arguments (tiny, 320 requests, 3 replicas,
   prefix sharing), then the same trace with ``--chaos-kill`` (and
   ``--no-warmup``: the process is warm by then): no request fails;
   warm and cold TTFT and the live block peak against the no-sharing
   baseline are logged, and each record's ``health``; then the first
   pass once more with the eager decode step;
19. MoE parity: ``MOE_SMALL`` (249.7M parameters, top-2 of 8 experts on
   every other layer) in float32 at seq 1024, batch 8: two SGD steps
   through the flash kernels equal two through ``use_flash=False`` (loss
   to 1e-4 relative, every weight within TOL, as phase 8), then two AdamW
   steps (the loss held at each; step 0's gradients within TOL and its
   weights within TOL plus AdamW's first-update spread of the two
   gradients; the weights outside TOL after the last step counted, with
   their step-0 gradients); every routing decision of the two runs
   compared, and at every step a flip at the first routed layer with
   flips at a probability gap above ``MOE_FLIP_GAP`` fails;
20. the MoE training example (``examples.moe_lm_training``), moe-small,
   bf16, seq 1024, batch 8, AdamW, 10 timed steps: tokens/s, step ms,
   peak memory, the share of the bf16 dense peak (useful FLOPs, and the
   capacity-padded count beside them) and a profiled pair of steps split
   into flash, matmuls, routing and gathers, and the rest;
21. ``generate()`` at ``MOE_SMALL`` in float32 through the decode kernel
   equals the einsum path, then the generation example at
   ``--model moe-small``, bf16, prompt 128, 64 new, batch 8 and 32, and
   its model's greedy tokens at b=8 against the einsum path's (reported);
22. ``ServingEngine`` at ``MOE_SMALL`` in float32 over 12 requests: each
   equals ``generate()`` alone, through the paged kernel;
23. the ViT example (``examples.vit_training``) at the JAX row
   ``vit_s16_224_b64_adamw_spc8``: ViT-S/16 bf16, batch 64, 8 steps a
   call, ``--attention xla`` and ``flash``: img/s;
24. the ring paths' kernel calls against the plain versions with a
   random cotangent on lse (ring attention's merge gives it one; float32
   at TOL, bf16 at SCALED_TOL), timed as 6: Llama-300M's ring blocks at
   seq 2048 over 2 ranks, b4 (the causal diagonal, a past block, the
   zigzag half-blocks, Ulysses' full sequence at H/2), and the
   long-context example's block. Then, on two processes sharing the card
   as a gloo group (NCCL refuses two ranks on one device): the training
   example ``--seq-parallel 2`` at Llama-300M, seq 2048, float32, two SGD
   steps equal to the single-process run at the same global batch (loss
   to 1e-4 relative, every weight within TOL), then bf16 timed (tok/s);
   ``examples.long_context_ring_attention`` at its defaults (S 8192, H 8,
   D 64), both layouts;
25. tensor parallelism over the two processes: ``generate()`` (b8,
   prompt 128, 32 new) and ``ServingEngine`` (8 requests) at Llama-300M
   float32 (``PARITY_LAYERS`` deep) give the unsharded model's tokens through both decode kernels
   on each rank's heads (H 8, Hkv 4; phase 2 holds the kernels at that
   shape), then ``examples.tp_decode_profile`` in bf16 (tok/s, two ranks
   sharing one card);
26. GPipe and 1F1B over the two processes (one stage each, residual MLP
   stages of width 1024) equal the sequential stages: outputs, loss and
   gradients within TOL;
27. FSDP (``examples.llama_fsdp_training``'s pieces) at Llama-300M over
   the two processes, seq 1024: two float32 momentum-SGD steps (b2 a
   rank) equal one process at the same global batch (loss to 1e-4
   relative, every weight within TOL); each rank's parameter, gradient
   and momentum bytes equal ``sharded_size_bytes``; the flash kernels on
   every layer (the forward twice: each block is recomputed in the
   backward). Then the example in bf16, b8 a rank, Adam, timed (tok/s,
   step ms split into gathers, reduce-scatters and the rest, each
   rank's peak memory), beside replicated ``DistributedOptimizer`` at
   the same batch, with and without block recompute;
28. ZeRO-1 at Llama-300M over the two processes: two float32 Adam steps
   with ``zero_sharded_optimizer`` equal ``DistributedOptimizer``, each
   rank's moments half the replicated optimizer's; then bf16 timed as
   27;
29. checkpoints: ``State.commit`` with the sharded writer on, after 27's
   float32 steps, writes the gathered weights; the files restore whole
   and every shard's digest recomputed from the restored leaves equals
   the manifest's. Then ``examples.imagenet_resnet50`` (ResNet-50 bf16,
   b64, 224²) saves at step 2 of 3 and is run again: the restored tree
   equals what was saved, and the resumed run's step 3 equals the
   first run's (cuDNN deterministic for the check);
30. the eager-tier controller, two ranks sharing the card, launched by
   the port's launcher (``python -m horovod_tpu_torch.run -np 2 ...
   chip_smoke.py --controller-worker OUT``; each rank builds a gloo
   group before ``init(device="cuda:0")``, which starts the controller):
   (a) float32, bfloat16 and int32 allreduce (sum and average), in-place
   allreduce, an allgather of uneven first dims, a broadcast from root 1
   and a grouped allreduce of 64 tensors, all on CUDA tensors, equal bit
   for bit to the same ops on CPU copies through the controller and to
   the gloo group's, the 64 in fewer fused responses; (b) Llama-300M
   float32, seq 1024, b2 a rank, two AdamW steps of
   ``DistributedOptimizer`` through the controller equal to the same
   through the gloo group (loss to 1e-4 relative, every weight within
   TOL); (c) Llama-300M bf16, seq 1024, b8 a rank, AdamW, one warm and
   two timed steps through the controller: tok/s, each step's host
   wall time split into negotiation, pack + D2H, star exchange and
   H2D + unpack, its responses and cache hits (every gradient from the
   first timed step) and flash launches (16 a kernel a rank); rank 0's
   timeline parses and holds the fusion-buffer copies, the card's copies
   and the star exchange of every allreduce response, and negotiations;
   and the host's one-thread HMAC-SHA256 rate. The job is pinned to the
   star (``HOROVOD_CPU_OPS=star``): the launcher exports ring addresses;
31. the native data plane, the same two ranks under the port's launcher
   (``chip_smoke.py --controller-worker OUT MODE``): 30's (a)-(c) once
   with ``HOROVOD_ENGINE=python`` (the Python controller on the native
   TCP ring) and once on the default, the native C++ engine, with (a)
   also held to the star's arithmetic (rank-order sums of the ranks'
   inputs), (b) to a maximum weight difference of 0, and (c) one warm and
   two timed steps split by the plane's counters (the engine's bytes,
   cycles, busy seconds, cache hits and pipeline stalls, and the staging
   seconds on either side of it), the engine's own timeline parsed (its
   activities, no card copies); (d) one native step pair under
   ``HOROVOD_RING_WIRE_DTYPE=int8``: the loss falls and the int8 wire's
   error-feedback residuals are non-zero; (e) four ranks on the card as
   two groups of two (``-H localhost:2,127.0.0.1:2``,
   ``HOROVOD_HIERARCHICAL_ALLREDUCE/ALLGATHER=1``): 30's collectives on
   the engine's two-level plane (the /dev/shm local plane and a ring of
   the group roots), bitwise against the CPU copies and the two-level
   sum order;
32. elastic membership: ``python -m horovod_tpu_torch.run --elastic -np
   2 --min-ranks 1 --max-ranks 2 --elastic-respawns 1`` over
   ``examples.elastic_llama_training`` (Llama-300M float32, seq 1024,
   b2 a rank, AdamW, ``DistributedOptimizer`` through the Python
   controller on the star, ``State(step=, model=, optimizer=)``
   committed every step), the ranks and the respawned joiner sharing
   the card. Rank 1 SIGKILLs itself in step 3 after its backward; the
   shrink must land at epoch 2 (size 1) and the grow at epoch 3 (size
   2), at least one step must roll back, the joiner must fetch every
   shard over the p2p plane while rank 0 moves none, both ranks' commits
   hashed on the card after the grow must equal rank 0's digests, the
   final float32 weights must equal a one-process replay of rank 0's
   logged schedule (TOL), and flash forward, dq and dk/dv must launch in
   every process, the joiner included. The job runs under both runtime
   monitors (``HOROVOD_PROTOCHECK=1``, ``HOROVOD_LOCKCHECK=1``, with
   ``HOROVOD_METRICS=1`` so telemetry's locks nest under the wire's):
   rank 0's and the joiner's protocol reports must be ``ok`` with
   transitions, their lock graphs acyclic (rank 0's with an edge), and
   ``python -m horovod_tpu_torch.tools.protocheck --runtime ...
   --lockgraph ...`` must exit 0 on the artifacts (the killed rank
   leaves none). Logged: the transitions and lock graphs, each reshape's seconds,
   kill to the first step at epochs 2 and 3, the joiner's restore
   seconds and bytes, the digest pass per commit, rank 0's peak memory,
   tok/s before and after; then ``examples.elastic_restore_probe`` (3
   ranks on the card, 16 and 64 MiB, p2p and broadcast restores);
33. the eager tier's tuning and tracing loop, two ranks sharing the card
   under the port's launcher (``chip_smoke.py --tune-worker OUT MODE``,
   a gloo group built first): (a) ``horovodrun -np 2 --trace DIR`` with
   ``HOROVOD_AUTOTUNE=1`` and ``HOROVOD_AUTOTUNE_LOG`` over
   ``examples.llama_training`` (Llama-300M bf16, f32 weights, seq 1024,
   b8 a rank, AdamW, one warm and ``TUNE_ITERS`` timed steps) on the
   default native engine: the autotune log holds at least two scored
   configurations, both ranks adopted the same tuned bucket size (not
   the default), ``merged_trace.json``, ``clock_offsets.json`` and
   ``straggler_report.json`` are written, every gradient carries the
   same sequence ids on both ranks, rank 1's clock offset is within its
   uncertainty plus 1 ms (one host, one clock), and flash forward, dq
   and dk/dv launch in both processes; tok/s logged beside 31's untuned
   engine row; (b) ``HOROVOD_ENGINE=python`` in float32 at
   ``PARITY_LAYERS``, two AdamW steps, b2 a rank: with the autotuner and
   tracing on, the weights equal those of the same job with both off
   (difference 0: a two-rank sum is exact in either order, so fusion
   grouping cannot change it), both jobs under the runtime monitors as
   in 32 (the traced one's clock pings ride HEARTBEAT frames), both
   ranks' artifacts required; (c) ``examples.overlap_probe`` on CUDA
   tensors: the bucketed results equal the unbucketed ones bit for bit
   on both ranks; measured and predicted overlap and the stall split
   logged;
34. the static gates on the card host: ``python -m
   horovod_tpu_torch.tools.check --format json`` (hvdlint over the port,
   the aux lint over its examples and tests, protocheck with the native
   engine's frame coverage, the static lock graph with the C++ mutexes,
   hvdabi) exits 0; its summary and seconds logged;
35. the cluster doctor: (a) Llama-300M bf16 (full width and depth, seq
   1024, b8 a rank, AdamW) on three ranks sharing the card under the
   port's launcher (``chip_smoke.py --doctor-worker OUT live``), the
   Python controller on the ring, the response cache off, with the
   exporter (``HOROVOD_METRICS_PORT``), the piggyback every 5 cycles, a
   sweep every 20, 2 s windows, the trace directory and the flight
   recorder, under the JAX acceptance plan (rank 1's every
   ``wire_send`` from the 5th on 50 ms late): rank 0's own ``GET
   /doctor`` must name rank 1 ``persistent_straggler`` from the tick
   lateness (p99 at least 30 ms) while the job runs, with
   ``hvd_doctor_findings{rule="persistent_straggler"}`` at least 1 on
   ``/metrics``; its log must hold a periodic ``doctor:`` line naming
   rank 1, ``/metrics?window=recent`` a windowed view, the live
   calibration a window, and the cluster view both workers' snapshots;
   flash launches on every rank; after the shutdown ``python -m
   horovod_tpu_torch.tools.doctor`` over the trace exits 0, every
   ``persistent_straggler`` finding names rank 1 and rank 1 is the
   straggler report's worst rank (every rank builds its model before
   the parameter broadcast, so a rank that built last is not charged
   with the 147 broadcasts). Logged: the cycles and seconds to the first live finding, a
   sweep's seconds, the step time with and without the delay's share
   (rank 0's wait past its allowance for rank 1's ticks, from
   ``hvd_controller_tick_lateness_seconds{rank="1"}``), every offline
   finding, each rank's last arrivals by kind of collective. The live
   rule compares a worker's lateness
   with the other workers', so it needs two of them: three ranks. (b)
   33 (b)'s tuned and traced job runs with the doctor's stack on: its
   weights still equal the plain job's and its last ``/doctor`` report
   has no ``persistent_straggler`` and no critical finding. (c), beside
   (a): Llama-300M float32 at ``PARITY_LAYERS``, two ranks on the star
   under the flight recorder: rank 1 installs a fault plan after its second
   step that kills it at its next send; the job exits non-zero, rank 0's
   ``fail_all`` dump holds the ``abort`` naming rank 1, and
   ``tools.doctor`` over the directory exits 0 with rank 0 observed.
36. the profiler and the decode step's CUDA graph: (a) in phase 27's
   replicated run, one more step under ``hvd.profiler.trace``, its
   collectives read back from the trace (``utils/comm_accounting``): one
   allreduce a gradient under ``hvd.allreduce.DistributedOptimizer.<i>``
   at the group's 2 ranks, the payload the gradients' bytes exactly; (b)
   ``examples/decode_phase_profile.py --engine`` at Llama-300M bf16 b8
   in phase 5: the eager step's buckets and its ``hvd.decode.*`` markers
   (``paged`` > 0, ``einsum`` 0), the graphed step's kernels as CUPTI
   sees them in a replay (as many a step as the eager step's), each
   step's host ms against its device busy ms; (c) after phase 5, 12
   seeded requests through an engine whose decode step is its CUDA graph
   and through one with the eager step: equal tokens and equal paged
   launches at float32 (``PARITY_LAYERS``; greedy, and sampled from one
   engine seed) and at bfloat16 on all 16 layers (greedy). Every engine
   of the other phases runs its CUDA graph. The training profiles of 9,
   11, 13 and 20 are read by the port's readers
   (``utils/hlo_phases.step_split``).
37. the last optimizer, flag and example gaps, then the simulated
   cluster: (a) the training example with ``--optimizer adafactor`` (the
   port's ``torch/optim.Adafactor``, ``optax.adafactor(3e-4)``) at
   Llama-300M bf16 seq 1024 b8, 16 layers, 5 timed steps beside phase 9's
   AdamW (tokens/s, step, peak memory, flash launches), and its float32
   parity at ``PARITY_LAYERS`` against ``use_flash=False`` (step 0's
   gradients, then phase 8's tolerance); (b) one float32 step at
   ``PARITY_LAYERS`` under ``HOROVOD_FLASH_XLA_BWD``: its gradients
   within TOL of the kernels' backward, kernel 1 launched once a layer
   and kernels 2 and 3 never (phase 24's parity adds a third step,
   flagged); (c) Llama-300M
   bf16 weights saved with ``utils.checkpoint.save_checkpoint`` and
   decoded through the generation example's ``--checkpoint``: the tokens
   of ``generate()`` on the saved model, through the contiguous decode
   kernel; (d) the word2vec example at its defaults: the loss falls,
   pairs/s by window; (e) host only, in the second lane: the 64-rank
   seeded storm through ``tools.simcluster``, ``capacity_probe`` at
   ``PROBE_SMOKE`` and ``tools.capacity --ranks 4096`` over its record,
   and (after 33 (a)) ``tools.straggler`` over 33 (a)'s trace directory,
   which gives the job's own report;
38. the probe examples: (a) ``flash_attention_benchmark`` at the kernel
   table's shape (b8 S1024 H16/8 D64 causal, bf16): ``fwd_ms``,
   ``train_ms`` and SDPA's row, kernels 1-3 launched, and
   ``flash_attention(block_q=, block_k=)`` at the compiled pair bit-equal
   to the call without it; (b) ``headpack_probe`` parts A and F: the
   K=64 / K=128 GEMM ratio and the H8/D64 against H4/D128 flash ratios,
   kernels 1-3 launched; (c) ``decode_floor_probe`` at Llama-300M bf16
   b8, prompt 128, 64 new tokens: the empty loop eager and as one CUDA
   graph, ``generate(unroll=1)`` and ``unroll=4`` (four steps a graph
   replay) with equal tokens, the contiguous decode kernel launched, the
   weights-plus-cache roofline share; (d) ``resnet50_roofline`` over 2
   traced steps of the ImageNet example's ResNet-50 b128 bf16 step: the
   aggregate ratio in (0, 1] and no op over 1.05 of its ideal; (e) host
   only, in the third lane: ``wire_bandwidth_probe`` at 2 ranks (4 MiB,
   each wire dtype), ``autotune_efficacy`` A and C at 2 ranks for one
   window, ``scaling_efficiency`` on gloo ranks 1 and 2 with the MLP.
39. the TensorFlow and Keras front ends, host only, in the third lane: in
   a child process, ``horovod_tpu_torch.tensorflow`` and
   ``horovod_tpu_torch.keras`` imported and the nine TF and Keras
   examples launched through ``runpy`` with their smallest flags. Where
   tensorflow is absent (the card machine) each must fail with its
   front end's own message naming tensorflow; where it is present, the
   custom op's size-1 allreduce and broadcast on the port's native engine
   must return their inputs. The branch that ran and the phase's time
   are logged. No CUDA kernel lies on these paths: TF tensors stay in
   host memory.

The float32 parity runs of phases 24, 25, 27, 28, 30 and 31 build
Llama-300M at 2 of its 16 layers (``PARITY_LAYERS``), to keep the script
inside its time limit; their timed runs keep the full depth.

Phases 3-5, 9, 13, 15-18, 20-25, 27, 28, 30-33 and 35-37 are the main
paths: the launch counts in the kernels' JSON line come from them (the flash
kernels' are the sum of 9, 13, 20, 23's flash run, 24's seq-parallel
training, 27's and 28's timed training, 30's and 31's (c), 32's
three processes, 33 (a)'s two, 35 (a)'s three, 37 (a) and 38 (a)-(b),
plus the forward-only long-context runs of 24 and the flagged steps of
24 and 37 (b); the contiguous decode kernel's of 3, 15, 21, 25's
``generate()`` and profile, 37 (c) and 38 (c), the paged
one's of 4, 16-18 (each also eager), 22, 25's engine and 36 (c); a
two-process path's counts are
its two ranks' sum; each path's on a line of its own). Each phase logs
its wall time.

Three lanes share the card and the host. After the kernels' timings
(2, 6, 14 and 24's ring kernels, alone), a second lane, a thread of this
process that only starts jobs and reads their files, runs 32's job and
restore probe, 30, 31 (e), 33 (b)-(c) and 37 (e), and a third one 31
(d)'s job, 38 (e), 39 and 34, while this lane runs 3-5, 7-13, 15-23, 37
(a)-(d) and 38 (a)-(d);
both are joined before 32's replay, which runs here, then 24-29, 31
(a)-(c), 33 (a) and 35 (a), (c) run alone. The numbers of 3-5, 7-13, 15-23 and of the other lanes'
phases are taken with the other lanes' work on the same card and cores;
those of 31 (c) and 33 (a), compared with each other, are not. A
failure on any lane stops every job the script started and exits
non-zero.

The line before the last is that JSON object; the last line is
``{"ok": true, "device": {...}}``. The whole run logs its wall time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
# bfloat16 flash outputs (forward and gradients) are far smaller than
# TOL's atol at these shapes, so each is held to its own scale: every
# element within REL of (its own magnitude + the tensor's RMS), and the
# mean error within REL / 2 of the mean magnitude. REL is five bf16 ulps.
SCALED_TOL = dict(rel=2e-2, of="|ref| + rms(ref)", mean_rel=1e-2)
SOURCES = {
    "decode_attention": "horovod_tpu_torch/csrc/decode_attention.cu",
    "paged_decode_attention": "horovod_tpu_torch/csrc/decode_attention.cu",
    "flash_forward": "horovod_tpu_torch/csrc/flash_attention.cu",
    "flash_backward_dq": "horovod_tpu_torch/csrc/flash_attention.cu",
    "flash_backward_dkdv": "horovod_tpu_torch/csrc/flash_attention.cu",
    "flash_mask_words": "horovod_tpu_torch/csrc/flash_attention.cu",
}
REPLACES = {
    "decode_attention": "horovod_tpu/ops/decode_attention.py:47",
    "paged_decode_attention": "horovod_tpu/ops/decode_attention.py:217",
    "flash_forward": "horovod_tpu/ops/attention.py:125",
    "flash_backward_dq": "horovod_tpu/ops/attention.py:296",
    "flash_backward_dkdv": "horovod_tpu/ops/attention.py:343",
    # No Pallas kernel: the JAX package's per-call mask conversion in
    # ``_fold_heads`` (an XLA op), which its three kernels read.
    "flash_mask_words": "horovod_tpu/ops/attention.py:216",
}
LAYERS = 16                          # Llama-300M
# The float32 parity runs of the two-process paths (24, 25, 27, 28, 30,
# 31) build their models at 2 of the 16 layers: the script's time limit
# holds phase 32 too. Their timed runs, and every other path, keep all
# 16 layers.
PARITY_LAYERS = 2
# Kernel names as ptxas and the profiler report them.
FLASH_KERNELS = (r"(?:(?:bf16|fma)_(?:fwd|dq|dkdv)(?:_tma)?|flash_mask_words)"
                 r"_kernel")
DECODE_KERNELS = r"decode_(?:combine_)?kernel"


def log(msg: str) -> None:
    # One write a line: the second lane logs too.
    sys.stdout.write(f"{msg}\n")
    sys.stdout.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing


def time_ms(fn, flush, repeats: int = 25) -> float:
    """Median device time of ``fn()`` over ``repeats`` calls, each timed
    alone with CUDA events after the L2 was flushed (a decode step finds
    each layer's cache cold)."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, ops: int, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, dtype: str, what: str):
    """Max abs/rel error; raise if outside the stated tolerance."""
    import torch

    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs()
    tol = TOL[dtype]
    limit = tol["atol"] + tol["rtol"] * want.abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    if not bool(torch.isfinite(got).all()) or bool((err > limit).any()):
        raise AssertionError(
            f"{what}: kernel disagrees with plain (max abs {max_abs:.3g}, "
            f"max rel {max_rel:.3g}, tolerance {tol})")
    return max_abs, max_rel


def compare_scaled(got, want, what: str, check: bool = True):
    """``got`` against ``want`` at :data:`SCALED_TOL`. Returns the max abs
    error, the reference's RMS and max, the mean error over the mean
    magnitude, and ``worst``: the largest error over its limit (above 1
    fails). ``check=False`` only measures."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    ref = want.abs()
    rms = float(want.pow(2).mean().sqrt())
    limit = SCALED_TOL["rel"] * (ref + rms)
    stats = {"max_abs": float(err.max()), "ref_rms": rms,
             "ref_max": float(ref.max()),
             "mean_err_over_mean_ref": float(err.mean())
             / max(float(ref.mean()), 1e-30),
             "worst": float((err / limit.clamp_min(1e-30)).max())}
    bad = (not bool(torch.isfinite(got).all()) or stats["worst"] > 1
           or stats["mean_err_over_mean_ref"] > SCALED_TOL["mean_rel"])
    if check and bad:
        raise AssertionError(
            f"{what}: kernel disagrees with plain ({json.dumps(stats)}, "
            f"tolerance {SCALED_TOL})")
    stats["fails"] = bad
    return stats


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions


def kernel_cases():
    """Yield (label, dtype, shape dict): the serving slice's attention
    shape, Llama-8B's attention width at a 4096 window, and MOE_SMALL's
    (H=12, Hkv=6, D=64) at the MoE generation example's window (prompt
    128 + 256 new) and batches."""
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        yield ("llama300m", dtype,
               dict(b=8, h=16, hkv=8, d=64, window=256, bs=16,
                    lens=[0, 15, 16, 47, 100, 191, 240, 255]))
        yield ("llama8b", dtype,
               dict(b=8, h=32, hkv=8, d=128, window=4096, bs=16,
                    lens=[0, 15, 511, 1023, 2047, 3000, 4000, 4095]))
        yield ("moe_small_b8", dtype,
               dict(b=8, h=12, hkv=6, d=64, window=384, bs=16,
                    lens=[0, 15, 16, 127, 128, 200, 300, 383]))
        yield ("moe_small_b32", dtype,
               dict(b=32, h=12, hkv=6, d=64, window=384, bs=16,
                    lens=list(range(0, 372, 12)) + [383]))
        # One rank's heads of Llama-300M under tensor parallelism over 2
        # (phase 25): H 16/2, Hkv 8/2.
        yield ("llama300m_tp2", dtype,
               dict(b=8, h=8, hkv=4, d=64, window=256, bs=16,
                    lens=[0, 15, 16, 47, 100, 191, 240, 255]))


def decode_accuracy(q, k, v, idx: int, hkv: int, got):
    """RMS error of the bf16 contiguous decode kernel's output ``got`` and
    of the model's einsum path (``models.llama``: q.k in bf16, the
    probabilities rounded to bf16, P.V in bf16) against float32 math on
    the same bf16 inputs."""
    import torch

    b, _, h, d = q.shape
    window = k.shape[1]
    scale = d ** -0.5
    qg = q.reshape(b, 1, hkv, h // hkv, d)
    k4, v4 = k.view(b, window, hkv, d), v.view(b, window, hkv, d)
    mask = (torch.arange(window, device=q.device) <= idx)[
        None, None, None, None, :]

    def attend(qx, kx, vx, rounded: bool):
        logits = torch.einsum("bshgd,blhd->bshgl", qx, kx).float() * scale
        probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        if rounded:
            probs = probs.to(qx.dtype)
        return torch.einsum("bshgl,blhd->bshgd", probs, vx).reshape(
            b, 1, h, d).float()

    exact = attend(qg.float(), k4.float(), v4.float(), False)
    einsum = attend(qg, k4, v4, True)
    return {name: float((x.float() - exact).pow(2).mean().sqrt())
            for name, x in (("kernel", got), ("einsum_path", einsum))}


def paged_pool(k, v, tables, bs, slots):
    """Scatter logical windows (B, L, F) into a pool through the first
    ``L / bs`` slots of ``tables``; every other block (the null block 0
    among them) holds garbage that must never reach a sum."""
    import torch

    b, window, f = k.shape
    used = tables[:, :window // bs].reshape(-1).long()
    kp = torch.full((int(tables.max()) + 1, bs, f), 9.0, dtype=k.dtype,
                    device=k.device)
    vp = torch.full_like(kp, -9.0)
    kp[used] = k.reshape(-1, bs, f)
    vp[used] = v.reshape(-1, bs, f)
    return kp, vp


def check_kernels(device, flush):
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import decode_attention as ops

    results = {}
    for label, dtype, s in kernel_cases():
        dname = str(dtype).replace("torch.", "")
        itemsize = torch.tensor([], dtype=dtype).element_size()
        b, h, hkv, d, window, bs = (s["b"], s["h"], s["hkv"], s["d"],
                                    s["window"], s["bs"])
        f = hkv * d
        gen = torch.Generator(device=device).manual_seed(0)

        def randn(*shape):
            return (torch.randn(*shape, generator=gen, device=device)
                    * 0.5).to(dtype)

        q = randn(b, 1, h, d)
        k = randn(b, window, f)
        v = randn(b, window, f)
        scale = d ** -0.5

        # Contiguous kernel at a mid index and at the last row.
        for idx in (window // 2 + 3, window - 1):
            got = ops.decode_attention(q, k, v, idx, hkv)
            want = ops.decode_attention_plain(q, k, v, idx, hkv)
            torch.cuda.synchronize()
            err = compare(got, want, dname,
                          f"decode_attention {label} {dname} idx={idx}")
        idx = window - 1
        accuracy = None
        if dtype == torch.bfloat16:
            accuracy = decode_accuracy(q, k, v, idx, hkv,
                                       ops.decode_attention(q, k, v, idx,
                                                            hkv))
        k_win = k.view(b, window, hkv, d).transpose(1, 2)
        v_win = v.view(b, window, hkv, d).transpose(1, 2)
        q_sdpa = q.transpose(1, 2)
        n_rows = b * (idx + 1)
        c_bytes = (2 * n_rows * f + 2 * b * h * d) * itemsize
        c_ops = 4 * n_rows * h * d
        c_bound, c_by = bound(c_bytes, c_ops, dname)
        row = dict(
            name="decode_attention", shape=label, dtype=dname,
            max_abs_err=err[0], max_rel_err=err[1],
            tolerance=TOL[dname],
            ms=time_ms(lambda: ops.decode_attention(q, k, v, idx, hkv),
                       flush),
            plain_ms=time_ms(
                lambda: ops.decode_attention_plain(q, k, v, idx, hkv),
                flush),
            bound_ms=c_bound, bound_by=c_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q_sdpa, k_win, v_win, scale=scale, enable_gqa=True),
                flush),
            rms_err_vs_float32_math=accuracy)
        log(f"kernel {json.dumps(row)}")
        results[("decode_attention", label, dname)] = row

        # Paged kernel over a scrambled pool, against the identity table.
        slots = window // bs
        lens = torch.tensor(s["lens"], dtype=torch.int32, device=device)
        n_phys = b * slots
        order = torch.randperm(n_phys, generator=gen, device=device) + 1
        tables = order.view(b, slots).to(torch.int32)
        ident = (torch.arange(n_phys, device=device) + 1).view(
            b, slots).to(torch.int32)
        (kp, vp), (kp_i, vp_i) = (paged_pool(k, v, tbl, bs, slots)
                                  for tbl in (tables, ident))
        got = ops.paged_decode_attention(q, kp, vp, tables, lens, hkv)
        want = ops.paged_decode_attention_plain(q, kp, vp, tables, lens, hkv)
        got_i = ops.paged_decode_attention(q, kp_i, vp_i, ident, lens, hkv)
        torch.cuda.synchronize()
        err = compare(got, want, dname, f"paged_decode_attention {label} "
                                        f"{dname}")
        if not torch.equal(got, got_i):
            raise AssertionError(
                f"paged {label} {dname}: scrambled table differs from the "
                "identity table")
        n_rows = int((lens.long() + 1).sum())
        p_bytes = ((2 * n_rows * f + 2 * b * h * d) * itemsize
                   + tables.numel() * 4 + lens.numel() * 4)
        p_ops = 4 * n_rows * h * d
        p_bound, p_by = bound(p_bytes, p_ops, dname)
        k_g = kp[tables.long()].view(b, window, hkv, d).transpose(1, 2)
        v_g = vp[tables.long()].view(b, window, hkv, d).transpose(1, 2)
        mask = (torch.arange(window, device=device)[None, :]
                <= lens[:, None].long())[:, None, None, :]
        row = dict(
            name="paged_decode_attention", shape=label, dtype=dname,
            max_abs_err=err[0], max_rel_err=err[1],
            tolerance=TOL[dname],
            ms=time_ms(lambda: ops.paged_decode_attention(
                q, kp, vp, tables, lens, hkv), flush),
            plain_ms=time_ms(lambda: ops.paged_decode_attention_plain(
                q, kp, vp, tables, lens, hkv), flush),
            bound_ms=p_bound, bound_by=p_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q_sdpa, k_g, v_g, attn_mask=mask, scale=scale,
                enable_gqa=True), flush))
        log(f"kernel {json.dumps(row)}")
        results[("paged_decode_attention", label, dname)] = row
    return results


def check_chunk_edges(device):
    """The split window at its edges: group 8 at D=128 over a window that
    is no multiple of the chunk, bounds C-1, C, C+1, 2C and window-1 (and a
    sequence of one position), in float32 and bfloat16. Both kernels
    against their plain versions; a scrambled table against the identity
    table, the same rows in a table twice as wide (more chunks), and in a
    table of one chunk (no combine) for the sequences it holds, bitwise."""
    import torch

    from horovod_tpu_torch.ops import decode_attention as ops

    c, bs = ops.DECODE_CHUNK, 16
    b, h, hkv, d = 6, 32, 4, 128
    window = 3 * c + 80
    bounds = [0, c - 1, c, c + 1, 2 * c, window - 1]
    plans = [ops.decode_plan(b, h, d, w) for w in (window, 2 * window)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=device).manual_seed(4)

        def randn(*shape):
            return (torch.randn(*shape, generator=gen, device=device)
                    * 0.5).to(dtype)

        q = randn(b, 1, h, d)
        k, v = randn(b, window, hkv * d), randn(b, window, hkv * d)
        for idx in bounds:
            got = ops.decode_attention(q, k, v, idx, hkv)
            want = ops.decode_attention_plain(q, k, v, idx, hkv)
            torch.cuda.synchronize()
            compare(got, want, dname, f"decode_attention edge {dname} "
                                      f"idx={idx}")
        slots = window // bs
        lens = torch.tensor(bounds, dtype=torch.int32, device=device)
        # Tables twice as wide: the extra slots point at blocks past the
        # window's, which hold garbage.
        scrambled = (torch.randperm(2 * b * slots, generator=gen,
                                    device=device) + 1).view(b, 2 * slots)
        ident = (torch.arange(2 * b * slots, device=device) + 1).view(
            b, 2 * slots)
        outs = {}
        for name, tbl in (("scrambled", scrambled), ("identity", ident)):
            tbl = tbl.to(torch.int32)
            kp, vp = paged_pool(k, v, tbl, bs, slots)
            for width in (slots, 2 * slots):
                t = tbl[:, :width].contiguous()
                outs[name, width] = ops.paged_decode_attention(
                    q, kp, vp, t, lens, hkv)
                want = ops.paged_decode_attention_plain(q, kp, vp, t, lens,
                                                        hkv)
                torch.cuda.synchronize()
                compare(outs[name, width], want, dname,
                        f"paged edge {dname} {name} width {width * bs}")
        base = outs["identity", slots]
        for key, out in outs.items():
            if not torch.equal(out, base):
                raise AssertionError(
                    f"paged edge {dname}: {key[0]} table of width "
                    f"{key[1] * bs} differs from the identity table of "
                    f"width {window}")
        # A table of one chunk (the block writes the output, no combine)
        # against the wide one, for the sequences it holds whole.
        short = [i for i, n in enumerate(bounds) if n < c]
        narrow = ops.paged_decode_attention(
            q, kp, vp, tbl[:, :c // bs].contiguous(), lens, hkv)
        if not torch.equal(narrow[short], outs["identity", slots][short]):
            raise AssertionError(
                f"paged edge {dname}: a one-chunk table differs from the "
                f"width-{window} table for bounds < {c}")
    log(f"decode chunk edges: H={h} Hkv={hkv} D={d}, window {window} "
        f"(chunk {c}: {plans[0].chunks} chunks, {plans[1].chunks} at twice "
        f"the width), bounds {bounds}: both kernels match plain in float32 "
        f"and bfloat16; scrambled == identity, width {window} == "
        f"{2 * window} == {c} (one chunk, bounds < {c}), bitwise")


# ---------------------------------------------------------------------------
# Phases 3-5: the main path


def random_prompts(rng, n, vocab, lo, hi):
    return [rng.randint(0, vocab, (int(rng.randint(lo, hi + 1)),))
            .astype(np.int32) for _ in range(n)]


def run_generate(cfg, model_cls=None, what: str = "llama300m"):
    """``generate()`` in float32 at ``cfg`` (``model_cls``, default
    ``LlamaLM``), b=8, prompt 128, 32 new: the kernel's tokens equal the
    einsum path's; returns the model and the decode kernel's launches."""
    import torch

    from horovod_tpu_torch.models.llama import (
        LlamaLM, decode_kernel_disabled, generate)
    from horovod_tpu_torch.ops import decode_attention as ops

    layers = cfg.num_layers
    model = (model_cls or LlamaLM)(cfg, seed=0)
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (8, 128)))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(model, prompt, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["decode_attention"]
    paged = ops.LAUNCHES["paged_decode_attention"]
    with decode_kernel_disabled():
        tokens_einsum = generate(model, prompt, max_new_tokens=32)
    if tokens.shape != (8, 160) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generate: bad output {tuple(tokens.shape)}")
    if not torch.equal(tokens, tokens_einsum):
        diff = (tokens != tokens_einsum).nonzero()[:4].tolist()
        raise AssertionError(
            f"generate: kernel tokens differ from decode_kernel_disabled() "
            f"at {diff}")
    if launches != layers * 31 or paged != 0:
        raise AssertionError(
            f"generate: decode kernel launched {launches} times (paged "
            f"{paged}); expected {layers * 31}")
    with torch.inference_mode():
        logits = model(prompt[:1, :16].to(model.device))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("forward logits are not finite")
    log(f"generate: {what} f32 b=8 p=128 n=32 tokens equal einsum path; "
        f"decode_attention launches {launches}; wall {wall:.3f} s "
        f"(first call, {8 * 32 / wall:.1f} tok/s)")
    return model, launches


def run_engine_parity(model, cfg, what: str = "llama300m"):
    """``ServingEngine`` in float32 over 12 seeded requests: each equals
    ``generate()`` alone; the paged kernel launched once per layer per
    step. Returns its launches."""
    import torch

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models.llama import generate
    from horovod_tpu_torch.ops import decode_attention as ops

    rng = np.random.RandomState(1)
    prompts = random_prompts(rng, 12, cfg.vocab_size, 32, 128)
    news = [int(rng.randint(16, 65)) for _ in prompts]
    scfg = serving.ServingConfig(max_batch=8, block_size=16, num_blocks=0,
                                 queue_depth=64, max_seq_len=256)
    engine = serving.serve(model, scfg, start=False)
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    ops.reset_launch_counts()
    engine.run_until_idle()
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["paged_decode_attention"]
    contiguous = ops.LAUNCHES["decode_attention"]
    stats = engine.stats()
    if launches != cfg.num_layers * stats["steps"] or contiguous != 0:
        raise AssertionError(
            f"engine: paged kernel launched {launches} times (contiguous "
            f"{contiguous}) over {stats['steps']} steps")
    for i, (p, n, handle) in enumerate(zip(prompts, news, handles)):
        got = handle.result(timeout=0)
        ref = generate(model, torch.from_numpy(p[None]), max_new_tokens=n)
        want = ref[0, len(p):].tolist()
        if got != want:
            raise AssertionError(
                f"engine request {i} (prompt {len(p)}, {n} new) differs "
                f"from generate():\n got={got}\nwant={want}")
    engine.shutdown()
    log(f"engine: {what} f32 12 requests equal generate(); steps "
        f"{stats['steps']}, paged_decode_attention launches {launches}, "
        f"preemptions {stats['preemptions']}")
    return launches


def run_engine_timing(card: str):
    """Phase 5, with the decode step as the engine's CUDA graph and as
    the eager step (``_eager_decode``), in turns in this one run: tok/s,
    TTFT and TPOT of the 32 timed requests, then 36 (b), the decode
    phase profile of each."""
    import torch

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM
    from horovod_tpu_torch.serving import engine as engine_mod

    model = LlamaLM(LLAMA_300M, seed=0)          # bfloat16
    scfg = serving.ServingConfig(max_batch=8, block_size=16, num_blocks=0,
                                 queue_depth=128, max_seq_len=256)
    warm = serving.ServingEngine(model, scfg)
    warm.submit(np.arange(40, dtype=np.int32), 8)
    warm.run_until_idle()
    warm.shutdown()
    numbers = {}
    for mode in ("graph", "eager"):
        rng = np.random.RandomState(9)
        prompts = random_prompts(rng, 32, LLAMA_300M.vocab_size, 32, 128)
        news = [int(rng.randint(32, 129)) for _ in prompts]
        if mode == "graph":
            engine = serving.serve(model, scfg, start=True)
        else:
            with engine_mod._eager_decode():
                engine = serving.serve(model, scfg, start=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
        for handle in handles:
            handle.result(timeout=600)
        wall = time.perf_counter() - t0
        stats = engine.stats()
        graphed = engine._graphs is not None
        engine.shutdown()
        if graphed != (mode == "graph"):
            raise AssertionError(f"engine timing: {mode} engine graphed "
                                 f"{graphed}")
        tok_s = stats["tokens_generated"] / wall
        log(f"serving bf16 llama300m 32 requests (prompts 32-128, new "
            f"32-128, max_batch 8), decode step {mode}: "
            f"{stats['tokens_generated']} tokens in {wall:.3f} s = "
            f"{tok_s:.1f} tok/s; TTFT p50/p99 {stats['ttft_p50_seconds']}"
            f"/{stats['ttft_p99_seconds']} s; TPOT p50/p99 "
            f"{stats['tpot_p50_seconds']}/{stats['tpot_p99_seconds']} s; "
            f"steps {stats['steps']} [{card}]")
        numbers[mode] = dict(
            tokens_per_s=tok_s, ttft_p50_s=stats["ttft_p50_seconds"],
            ttft_p99_s=stats["ttft_p99_seconds"],
            tpot_p50_s=stats["tpot_p50_seconds"],
            tpot_p99_s=stats["tpot_p99_seconds"], steps=stats["steps"],
            tokens=stats["tokens_generated"], wall_s=wall)
    numbers["decode_step_profile"] = profile_decode_steps(model, card)
    return numbers


def profile_decode_steps(model, card: str, steps: int = 20):
    """36 (b): ``examples/decode_phase_profile.py --engine`` at
    Llama-300M bf16 b8 (prompts of 128): the eager decode step by
    provenance, with its ``hvd.decode.*`` markers (``paged`` > 0,
    ``einsum`` 0), and the step captured as a CUDA graph by kernel name
    (CUPTI must see the kernels inside a replay); for each, the host wall
    ms of a step without the profiler against the device busy ms. Both
    must see time in the decode kernels, with as many kernels a step."""
    from horovod_tpu_torch.examples import decode_phase_profile as dpp

    out = dpp.engine_profile("300m", 8, 128, steps, trace_dir("decode"),
                             model=model)
    markers = out["eager"]["markers"]
    if not (markers["hvd.decode.paged"] > 0 and markers[
            "hvd.decode.einsum"] == 0 and markers["hvd.decode.kernel"] == 0):
        raise AssertionError(f"decode phase profile markers: {markers}")
    for mode in ("eager", "graph"):
        if not out[mode]["decode_kernel_ms_per_step"] > 0:
            raise AssertionError(
                f"decode phase profile ({mode}): no device time in the "
                f"decode kernels: {json.dumps(out[mode])}")
    if out["graph"]["launches_per_step"] != out["eager"][
            "launches_per_step"]:
        raise AssertionError(
            "decode phase profile: a graph replay shows "
            f"{out['graph']['launches_per_step']} kernels a step, the eager "
            f"step {out['eager']['launches_per_step']}")
    for mode in ("graph", "eager"):
        row = out[mode]
        log(f"decode step profile ({mode}, bf16 llama300m, 8 sequences at "
            f"~130-170 positions): step {row['step_ms']:.3f} ms, device "
            f"busy {row['device_busy_ms_per_step']:.3f} ms (idle share of "
            f"the unprofiled step "
            f"{1 - row['device_busy_over_unprofiled_step']:.3f}), "
            f"{row['kernels_per_step']} kernels a step, decode kernel "
            f"{row['decode_kernel_ms_per_step']:.4f} ms [{card}]")
    eager = out["eager"]
    log(f"36 (b) decode phase profile buckets (eager step, ms a step): "
        f"{json.dumps({p: b['ms'] for p, b in eager['decode_phases'].items()})}"
        f"; markers {json.dumps(markers)}")
    for mode in ("eager", "graph"):
        out[mode].pop("decode_phases", None)
    return out


def run_graph_checks(card: str):
    """36 (c): the engine's decode step as its CUDA graph against the
    eager step (``_eager_decode``), 12 seeded requests each way: equal
    tokens and equal paged-kernel launches (the capture's launches are
    counted at each replay) at float32 on ``PARITY_LAYERS`` layers,
    greedy and sampled from the same engine seed, and at bfloat16 on all
    16 layers, greedy. Returns the graphed runs' launches."""
    import torch

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM
    from horovod_tpu_torch.ops import decode_attention as ops
    from horovod_tpu_torch.serving import engine as engine_mod

    f32 = dataclasses.replace(LLAMA_300M, dtype=torch.float32,
                              num_layers=PARITY_LAYERS)
    cases = (("float32 2 layers greedy", f32, 0.0),
             ("float32 2 layers sampled", f32, 0.8),
             ("bfloat16 16 layers greedy", LLAMA_300M, 0.0))
    scfg = serving.ServingConfig(max_batch=8, block_size=16, num_blocks=0,
                                 queue_depth=64, max_seq_len=256)
    model, built, total = None, None, 0
    for label, cfg, temperature in cases:
        if built is not cfg:
            del model
            torch.cuda.empty_cache()
            model, built = LlamaLM(cfg, seed=0), cfg
        runs = {}
        for graphed in (True, False):
            rng = np.random.RandomState(4)
            prompts = random_prompts(rng, 12, cfg.vocab_size, 32, 128)
            news = [int(rng.randint(16, 65)) for _ in prompts]
            if graphed:
                engine = serving.ServingEngine(model, scfg, seed=7)
            else:
                with engine_mod._eager_decode():
                    engine = serving.ServingEngine(model, scfg, seed=7)
            if (engine._graphs is not None) != graphed:
                raise AssertionError(f"36 (c) {label}: graphed "
                                     f"{engine._graphs is not None}")
            handles = [engine.submit(p, n, temperature)
                       for p, n in zip(prompts, news)]
            ops.reset_launch_counts()
            engine.run_until_idle()
            torch.cuda.synchronize()
            runs[graphed] = ([h.result(timeout=0) for h in handles],
                             ops.LAUNCHES["paged_decode_attention"],
                             engine.stats()["steps"])
            engine.shutdown()
        (tokens, launches, steps), eager = runs[True], runs[False]
        if tokens != eager[0]:
            bad = [i for i, (a, b) in enumerate(zip(tokens, eager[0]))
                   if a != b]
            raise AssertionError(f"36 (c) {label}: graphed tokens differ "
                                 f"from the eager step's in requests {bad}")
        if (launches, steps) != eager[1:] or launches != \
                cfg.num_layers * steps:
            raise AssertionError(
                f"36 (c) {label}: paged launches / steps graphed "
                f"{launches} / {steps}, eager {eager[1]} / {eager[2]}")
        total += launches
        log(f"36 (c) {label}: 12 requests, graphed tokens equal the eager "
            f"step's; paged_decode_attention launches {launches} both "
            f"ways over {steps} steps [{card}]")
    del model
    release_serving()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Build report


def ptxas_report(name: str):
    """(kernel instantiation, registers line, spill line) from the ptxas
    output of ``name``'s last build, the instantiation read off the
    mangled entry name (``bf16_fwd_tma_kernel<bf16,64>``)."""
    from horovod_tpu_torch.ops import _build

    rows, label, spill = [], None, ""
    for line in _build.log_path(name).read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            kernel = re.search(f"({FLASH_KERNELS}|{DECODE_KERNELS})[IE]",
                               mangled)
            dtype = "bf16" if "__nv_bfloat16" in mangled else "f32"
            ints = re.findall(r"Li(\d+)E", mangled)
            label = (f"{kernel.group(1) if kernel else mangled}"
                     f"<{','.join([dtype] + ints)}>")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and label:
            rows.append((label, line.split(":", 1)[-1].strip(), spill))
            label, spill = None, ""
    return rows


# ---------------------------------------------------------------------------
# Phase 6: flash-attention kernels against their plain versions


def flash_cases():
    """(label, b, sq, sk, h, hkv, d, mask, causal). ``mask``: None, a
    random key mask with a fully masked row (``"random"``), BERT's
    padded tails, the last quarter of the keys masked in every other
    sequence (``"tail"``), all true (``"alltrue"``, what ``BertEncoder``
    passes when its caller gives none), real padding (``"padded"``,
    :func:`padded_mask`) or whole key tiles masked (``"tiles"``,
    :func:`tile_mask`)."""
    return [("slice", 8, 1024, 1024, 16, 8, 64, None, True),
            ("masked", 2, 333, 333, 16, 8, 64, "random", True),
            ("sq256_sk1024", 8, 256, 1024, 16, 8, 64, None, True),
            ("llama8b", 1, 4096, 4096, 32, 8, 128, None, True),
            ("edge", 3, 197, 261, 16, 2, 128, "random", True),
            ("bert", 32, 512, 512, 12, 12, 64, "tail", False),
            # BERT's shape without the mask: what the key mask costs.
            ("bert_nomask", 32, 512, 512, 12, 12, 64, None, False),
            # The key-mask path: all true, bitwise equal to
            # bert_nomask; real padding; whole tiles out under causal.
            ("bert_alltrue", 32, 512, 512, 12, 12, 64, "alltrue", False),
            ("bert_padded", 32, 512, 512, 12, 12, 64, "padded", False),
            ("masked_causal_tiles", 4, 1024, 1024, 16, 8, 64, "tiles",
             True),
            ("vit", 8, 197, 197, 12, 12, 64, None, False),
            # The MoE LM's training shape (MOE_SMALL, seq 1024, b8) and
            # ViT-S/16's at the JAX row's batch of 64.
            ("moe_small", 8, 1024, 1024, 12, 6, 64, None, True),
            ("vit_s16", 64, 197, 197, 6, 6, 64, None, False)]


def tail_mask(b: int, s: int, device):
    """BERT's padded tails: the last quarter of the keys masked in every
    other sequence."""
    import torch

    mask = torch.ones(b, s, dtype=torch.bool, device=device)
    mask[::2, s - s // 4:] = False
    return mask


PADDED_SEED = 20


def padded_mask(b: int, s: int, device):
    """Real padding: each sequence's length drawn uniformly from 64..s
    (a generator seeded with ``PADDED_SEED``), sequence 1 fully padded."""
    import torch

    gen = torch.Generator().manual_seed(PADDED_SEED)
    lengths = torch.randint(64, s + 1, (b,), generator=gen)
    lengths[1] = 0
    mask = torch.arange(s)[None, :] < lengths[:, None]
    return mask.to(device)


def tile_mask(b: int, s: int, device):
    """Whole key tiles out (causal, so sequence 3's first 128 rows have no
    allowed key): sequence 1 keys 128-255 and 512-639 (two forward
    tiles), sequence 2 keys 320-383 (a dq tile inside a mixed forward
    tile), sequence 3 keys 0-127; sequence 0 all true."""
    import torch

    mask = torch.ones(b, s, dtype=torch.bool, device=device)
    mask[1, 128:256] = False
    mask[1, 512:640] = False
    mask[2, 320:384] = False
    mask[3, :128] = False
    return mask


def nan_skipped_tiles(k, v, mask, tile=128):
    """K and V with NaN at the keys of every ``tile``-key tile the mask
    wholly leaves out, and that key mask (B, Sk): a kernel that reads
    such a tile turns its outputs NaN."""
    import torch

    b, sk = mask.shape
    tiles = -(-sk // tile)
    padded = torch.zeros(b, tiles * tile, dtype=torch.bool,
                         device=mask.device)
    padded[:, :sk] = mask
    empty = ~padded.view(b, tiles, tile).any(-1)
    keys = empty[:, :, None].expand(b, tiles, tile).reshape(b, -1)[:, :sk]
    nan = float("nan")
    return (k.masked_fill(keys[:, :, None, None], nan),
            v.masked_fill(keys[:, :, None, None], nan), keys)


def planted_faults(A, label, q, k, v, mask, causal, g, p_lse, delta, got,
                   tile=64):
    """Show that the bf16 check catches a kernel that drops work: out and
    dq from the plain versions with the last key tile skipped (masked
    out), dk and dv with the last query tile skipped (its p zeroed by an
    lse of +1e30). Each must fail :func:`compare_scaled` against the true
    plain output; returns each fault's ``worst`` (above 1 fails)."""
    import torch

    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    drop_keys = torch.ones(b, sk, dtype=torch.bool, device=q.device)
    drop_keys[:, sk - tile:] = False
    if mask is not None:
        drop_keys &= mask
    f_out, _ = A.flash_attention_forward_plain(q, k, v, drop_keys, causal)
    f_dq = A.flash_backward_dq_plain(q, k, v, drop_keys, g, p_lse, delta,
                                     causal)
    lse_f = p_lse.clone()
    lse_f[..., sq - tile:] = 1e30
    f_dk, f_dv = A.flash_backward_dkdv_plain(q, k, v, mask, g, lse_f, delta,
                                             causal)
    worst = {}
    for key, faulty in (("out", f_out), ("dq", f_dq), ("dk", f_dk),
                        ("dv", f_dv)):
        stats = compare_scaled(faulty, got[key][1], "planted", check=False)
        if not stats["fails"]:
            raise AssertionError(
                f"planted fault in {key} (last {tile}-row tile skipped, "
                f"{label}) passes the bf16 check: {json.dumps(stats)}")
        worst[key] = stats["worst"]
    log(f"planted faults (last {tile}-row tile skipped, bf16 {label} shape, "
        f"{'causal' if causal else 'non-causal'}) fail the check: worst "
        f"error/limit {json.dumps(worst)}")
    return worst


def same_as_unmasked(A, q, k, v, g, p_lse, delta, causal, got, what):
    """An all-true key mask costs nothing and changes nothing: the kernels'
    out, lse, dq, dk and dv without a mask, bit for bit."""
    import torch

    out, lse = A._flash_forward(q, k, v, None, causal)
    dq = A.flash_backward_dq(q, k, v, None, g, p_lse, delta, causal)
    dk, dv = A.flash_backward_dkdv(q, k, v, None, g, p_lse, delta, causal)
    torch.cuda.synchronize()
    want = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    differ = [key for key in want if not torch.equal(got[key], want[key])]
    if differ:
        raise AssertionError(f"{what}: an all-true mask changes {differ} "
                             "against no mask")
    log(f"{what}: out, lse, dq, dk and dv bitwise equal to no mask")


def skipped_tiles_unread(A, q, k, v, mask, words, g, p_lse, delta, got,
                         what):
    """The key tiles the mask wholly leaves out are never read: with NaN
    in K and V at their keys, out, lse and dq are bitwise the clean run's,
    and so are dk and dv at the allowed keys; at the masked keys dk and dv
    are exactly 0. Returns the count of NaN keys."""
    import torch

    k_nan, v_nan, keys = nan_skipped_tiles(k, v, mask)
    out, lse = A._flash_forward(q, k_nan, v_nan, mask, False, words=words)
    dq = A.flash_backward_dq(q, k_nan, v_nan, mask, g, p_lse, delta, False,
                             words=words)
    dk, dv = A.flash_backward_dkdv(q, k_nan, v_nan, mask, g, p_lse, delta,
                                   False, words=words)
    torch.cuda.synchronize()
    bad = [key for key, x in (("out", out), ("lse", lse), ("dq", dq))
           if not torch.equal(x, got[key])]
    for key, x in (("dk", dk), ("dv", dv)):
        if not torch.equal(x[mask], got[key][mask]):
            bad.append(f"{key} at allowed keys")
        if bool(x[~mask].ne(0).any()):
            bad.append(f"{key} at masked keys not 0")
    n_nan = int(keys.sum())
    if n_nan == 0 or bad:
        raise AssertionError(
            f"{what}: NaN in {n_nan} keys of fully masked tiles reached "
            f"{bad or 'nothing (no tile to skip)'}")
    log(f"{what}: NaN K/V at the {n_nan} keys of fully masked 128-key "
        f"tiles; every output bitwise the clean run's, dk/dv 0 at masked "
        f"keys")
    return n_nan


def ring_flash_cases():
    """The ring paths' kernel calls (phase 24), in :func:`flash_cases`'
    format: Llama-300M at seq 2048 over 2 ranks, batch 4 — the causal
    diagonal block, a past block (non-causal), the zigzag half-blocks of
    512 (a triangle, and the late half over a whole block) and Ulysses'
    full sequence at H/2, Hkv/2; and the long-context example's
    contiguous block (S 8192 over 2 ranks, H 8, D 64, non-causal)."""
    return [("ring_diag", 4, 1024, 1024, 16, 8, 64, None, True),
            ("ring_past", 4, 1024, 1024, 16, 8, 64, None, False),
            ("ring_zigzag_tri", 4, 512, 512, 16, 8, 64, None, True),
            ("ring_zigzag_hi", 4, 512, 1024, 16, 8, 64, None, False),
            ("ulysses", 4, 2048, 2048, 8, 4, 64, None, True),
            ("long_context", 1, 4096, 4096, 8, 8, 64, None, False)]


def check_flash(device, flush, cases=None, with_dlse: bool = False):
    """The flash kernels against their plain versions on ``cases``
    (default :func:`flash_cases`), timed; returns (label, dtype) -> row.
    ``with_dlse``: the backward gets a random cotangent on lse as well
    (ring attention's merge gives it one), folded into delta."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        item = torch.tensor([], dtype=dtype).element_size()
        for label, b, sq, sk, h, hkv, d, mask_kind, causal in (
                cases or flash_cases()):
            gen = torch.Generator(device=device).manual_seed(0)

            def randn(*shape):
                return (torch.randn(*shape, generator=gen, device=device)
                        * 0.5).to(dtype)

            q, k, v, g = (randn(b, sq, h, d), randn(b, sk, hkv, d),
                          randn(b, sk, hkv, d), randn(b, sq, h, d))
            mask = None
            if mask_kind == "random":
                mask = torch.rand(b, sk, generator=gen, device=device) > 0.3
                mask[:, 0] = True
                # Query row 0 of batch 0 attends keys <= sk - sq: none.
                mask[0, :sk - sq + 1] = False
            elif mask_kind is not None:
                mask = {"tail": tail_mask, "padded": padded_mask,
                        "tiles": tile_mask,
                        "alltrue": lambda *a: torch.ones(
                            *a[:2], dtype=torch.bool, device=device)}[
                    mask_kind](b, sk, device)
            what = f"flash {label} {dname}"
            # One bitmap a call, as ``_Flash`` builds it: the three
            # kernels read the same words.
            words = None if mask is None else A.flash_mask_words(mask)
            if words is not None and not torch.equal(
                    words, A.mask_words_plain(mask)):
                raise AssertionError(f"{what}: the mask's words differ from "
                                     "mask_words_plain's (bitwise)")
            out, lse = A._flash_forward(q, k, v, mask, causal, words=words)
            p_out, p_lse = A.flash_attention_forward_plain(q, k, v, mask,
                                                           causal)
            dlse = (torch.randn(b * h, 1, sq, generator=gen, device=device)
                    if with_dlse else None)
            delta = A.flash_delta(p_out, g, dlse)
            dq = A.flash_backward_dq(q, k, v, mask, g, p_lse, delta, causal,
                                     words=words)
            dk, dv = A.flash_backward_dkdv(q, k, v, mask, g, p_lse, delta,
                                           causal, words=words)
            p_dq = A.flash_backward_dq_plain(q, k, v, mask, g, p_lse, delta,
                                             causal)
            p_dk, p_dv = A.flash_backward_dkdv_plain(q, k, v, mask, g, p_lse,
                                                     delta, causal)
            torch.cuda.synchronize()
            got = {"out": (out, p_out), "dq": (dq, p_dq), "dk": (dk, p_dk),
                   "dv": (dv, p_dv)}
            if dtype == torch.float32:
                errs = {key: {"max_abs": compare(a, b, dname,
                                                 f"{what} {key}")[0]}
                        for key, (a, b) in got.items()}
            else:
                errs = {key: compare_scaled(a, b, f"{what} {key}")
                        for key, (a, b) in got.items()}
            errs["lse"] = {"max_abs": compare(lse, p_lse, "float32",
                                              f"{what} lse")[0]}
            planted = None
            if label in ("slice", "bert") and dtype == torch.bfloat16:
                planted = planted_faults(A, label, q, k, v, mask, causal, g,
                                         p_lse, delta, got)
            if mask_kind == "random" and (
                    bool(out[0, 0].ne(0).any())
                    or float(lse[0, 0, 0]) > -1e29
                    or bool(dq[0, 0].ne(0).any())):
                raise AssertionError(
                    f"{what}: the fully masked row is not zero "
                    f"(lse {float(lse[0, 0, 0])})")
            if mask_kind == "padded" and (
                    any(bool(x[1].ne(0).any()) for x in (out, dq, dk, dv))
                    or float(lse[h:2 * h].max()) > -1e29):
                raise AssertionError(
                    f"{what}: the fully padded sequence is not zero")
            kernel_out = {"out": out, "lse": lse, "dq": dq, "dk": dk,
                          "dv": dv}
            if mask_kind == "alltrue":
                same_as_unmasked(A, q, k, v, g, p_lse, delta, causal,
                                 kernel_out, what)
            unread = None
            if mask_kind == "padded" and dtype == torch.bfloat16:
                unread = skipped_tiles_unread(A, q, k, v, mask, words, g,
                                              p_lse, delta, kernel_out,
                                              what)

            # The work this run's data needs: allowed (query, key) pairs.
            allowed = torch.ones(1, sq, sk, dtype=torch.bool, device=device)
            if causal:
                qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
                allowed = (torch.arange(sk, device=device)[None, :]
                           <= qi)[None]
            if mask is not None:
                allowed = allowed & mask[:, None, :]
            pairs = int(allowed.expand(b, sq, sk).sum()) * h
            q_bytes, kv_bytes = q.numel() * item, k.numel() * item
            stats = 4 * b * h * sq
            extra = 0 if words is None else words.numel() * 8
            fwd_bound = bound(2 * q_bytes + 2 * kv_bytes + stats + extra,
                              4 * d * pairs, dname)
            dq_bound = bound(3 * q_bytes + 2 * kv_bytes + 2 * stats + extra,
                             6 * d * pairs, dname)
            dkdv_bound = bound(2 * q_bytes + 4 * kv_bytes + 2 * stats
                               + extra, 8 * d * pairs, dname)
            times = {
                "flash_forward": time_ms(
                    lambda: A._flash_forward(q, k, v, mask, causal,
                                             words=words), flush),
                "flash_backward_dq": time_ms(
                    lambda: A.flash_backward_dq(q, k, v, mask, g, p_lse,
                                                delta, causal, words=words),
                    flush),
                "flash_backward_dkdv": time_ms(
                    lambda: A.flash_backward_dkdv(q, k, v, mask, g, p_lse,
                                                  delta, causal, words=words),
                    flush)}
            mask_words = None
            if words is not None:
                # The bitmap's own kernel: B * Sk bytes in, its words out.
                words_bound = bound(mask.numel() + words.numel() * 8, 0,
                                    dname)
                mask_words = {
                    "max_abs_err": 0.0,   # bitwise equal, checked above
                    "ms": time_ms(lambda: A.flash_mask_words(mask), flush),
                    "plain_ms": time_ms(lambda: A.mask_words_plain(mask),
                                        flush, repeats=10),
                    "bound_ms": words_bound[0], "bound_by": words_bound[1]}
            plain = {
                "flash_forward": time_ms(
                    lambda: A.flash_attention_forward_plain(q, k, v, mask,
                                                            causal),
                    flush, repeats=10),
                "flash_backward_dq": time_ms(
                    lambda: A.flash_backward_dq_plain(q, k, v, mask, g,
                                                      p_lse, delta, causal),
                    flush, repeats=10),
                "flash_backward_dkdv": time_ms(
                    lambda: A.flash_backward_dkdv_plain(q, k, v, mask, g,
                                                        p_lse, delta, causal),
                    flush, repeats=10)}
            sdpa_fwd = sdpa_bwd = None
            if mask_kind != "random" and (sq == sk or not causal):
                # The yardstick (the port never calls it): SDPA on the same
                # inputs in (B, H, S, D), causal or with the key mask as
                # attn_mask: its forward, and its backward alone on one
                # saved forward (dq, dk and dv).
                qt, kt, vt, gt = (x.transpose(1, 2).contiguous()
                                  for x in (q, k, v, g))
                qr, kr, vr = (x.detach().requires_grad_()
                              for x in (qt, kt, vt))
                attn_mask = None if mask is None else mask[:, None, None, :]
                is_causal = causal
                if mask is not None and causal:
                    # SDPA takes a mask or is_causal, not both.
                    attn_mask, is_causal = allowed[:, None], False

                def sdpa(qs=qt, ks=kt, vs=vt):
                    return F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=attn_mask, is_causal=is_causal,
                        enable_gqa=True)

                o_saved = sdpa(qr, kr, vr)

                def sdpa_bwd_only():
                    return torch.autograd.grad(o_saved, (qr, kr, vr), gt,
                                               retain_graph=True)

                sdpa_fwd = time_ms(sdpa, flush, repeats=10)
                sdpa_bwd = time_ms(sdpa_bwd_only, flush, repeats=10)
                del o_saved
            row = dict(case=label, dtype=dname, shape=[b, sq, sk, h, hkv, d],
                       mask=mask_kind, causal=causal, pairs=pairs,
                       dlse=with_dlse,
                       max_abs_err={key: e["max_abs"]
                                    for key, e in errs.items()},
                       errors=errs, planted_faults=planted,
                       tolerance=(TOL[dname] if dtype == torch.float32
                                  else SCALED_TOL), ms=times, plain_ms=plain,
                       bound_ms={"flash_forward": fwd_bound[0],
                                 "flash_backward_dq": dq_bound[0],
                                 "flash_backward_dkdv": dkdv_bound[0]},
                       bound_by={"flash_forward": fwd_bound[1],
                                 "flash_backward_dq": dq_bound[1],
                                 "flash_backward_dkdv": dkdv_bound[1]},
                       sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_ms=sdpa_bwd,
                       mask_words=mask_words, skipped_tiles_unread=unread)
            log(f"flash {json.dumps(row)}")
            results[(label, dname)] = row
            del q, k, v, g, out, lse, p_out, p_lse, dq, dk, dv, got
            del kernel_out, words
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 14: the kernels' operand range


def operand_decode_cases():
    """(label, shape dict): Llama-tiny's attention (H=4, Hkv=2, D=16), a
    D=32 case, group 16 (H=16, Hkv=1, D=64), D=256 and group 3, at the
    serving window."""
    lens = [0, 15, 16, 47, 100, 191, 240, 255]
    return [("llama_tiny_d16", dict(b=8, h=4, hkv=2, d=16, window=256,
                                    bs=16, lens=lens)),
            ("d32", dict(b=8, h=8, hkv=4, d=32, window=256, bs=16,
                         lens=lens)),
            ("group16", dict(b=8, h=16, hkv=1, d=64, window=256, bs=16,
                             lens=lens)),
            # head_dim 256 (two 16-byte pieces a lane in
            # float32), and group 3, which no block width equals (one
            # query head a block).
            ("d256", dict(b=8, h=8, hkv=4, d=256, window=256, bs=16,
                          lens=lens)),
            ("group3", dict(b=8, h=12, hkv=4, d=64, window=256, bs=16,
                            lens=lens))]


def operand_flash_cases():
    """Flash cases outside the kernels' first instantiations: Llama-tiny's
    D=16 (causal), BERT-tiny's D=32 (non-causal, the padded-tail mask),
    group 16 (H=16 over Hkv=1, causal), D=192 and D=256."""
    return [("llama_tiny_d16", 8, 256, 256, 4, 2, 16, None, True),
            ("bert_tiny_d32", 8, 128, 128, 2, 2, 32, "tail", False),
            ("group16", 2, 1024, 1024, 16, 1, 64, None, True),
            # head_dim 192 (padded to 256) and 256, the FMA
            # family at 32 rows a block, causal and with a tail mask.
            ("d192", 2, 512, 512, 8, 4, 192, None, True),
            ("d256", 2, 512, 512, 8, 2, 256, "tail", False)]


def check_operand_range(device, flush):
    """The decode kernels (contiguous and paged) and the flash kernels at
    operands outside the widths and groups they were first built for,
    float32 at TOL and bfloat16 at SCALED_TOL against the plain versions,
    timed as phases 2 and 6; then ``generate()`` at LLAMA_TINY on the card
    in float32 gives the tokens of ``decode_kernel_disabled()``."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models.llama import (LLAMA_TINY, LlamaLM,
                                                decode_kernel_disabled,
                                                generate)
    from horovod_tpu_torch.ops import decode_attention as ops

    rows = []
    for label, s in operand_decode_cases():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            item = torch.tensor([], dtype=dtype).element_size()
            b, h, hkv, d, window, bs = (s["b"], s["h"], s["hkv"], s["d"],
                                        s["window"], s["bs"])
            f = hkv * d
            gen = torch.Generator(device=device).manual_seed(5)

            def randn(*shape):
                return (torch.randn(*shape, generator=gen, device=device)
                        * 0.5).to(dtype)

            q, k, v = randn(b, 1, h, d), randn(b, window, f), \
                randn(b, window, f)
            slots = window // bs
            lens = torch.tensor(s["lens"], dtype=torch.int32, device=device)
            tables = (torch.randperm(b * slots, generator=gen,
                                     device=device) + 1).view(
                b, slots).to(torch.int32)
            kp, vp = paged_pool(k, v, tables, bs, slots)
            idx = window - 1
            calls = {
                "decode_attention": (
                    lambda: ops.decode_attention(q, k, v, idx, hkv),
                    lambda: ops.decode_attention_plain(q, k, v, idx, hkv),
                    b * (idx + 1)),
                "paged_decode_attention": (
                    lambda: ops.paged_decode_attention(q, kp, vp, tables,
                                                       lens, hkv),
                    lambda: ops.paged_decode_attention_plain(
                        q, kp, vp, tables, lens, hkv),
                    int((lens.long() + 1).sum()))}
            for name, (kernel, plain, n_rows) in calls.items():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                what = f"{name} {label} {dname}"
                if dtype == torch.float32:
                    err = {"max_abs": compare(got, want, dname, what)[0]}
                else:
                    err = compare_scaled(got, want, what)
                nbytes = (2 * n_rows * f + 2 * b * h * d) * item
                if name == "paged_decode_attention":
                    nbytes += tables.numel() * 4 + lens.numel() * 4
                    k_g = kp[tables.long()].view(b, window, hkv, d)
                    v_g = vp[tables.long()].view(b, window, hkv, d)
                    mask = (torch.arange(window, device=device)[None, :]
                            <= lens[:, None].long())[:, None, None, :]
                else:
                    k_g = k.view(b, window, hkv, d)
                    v_g = v.view(b, window, hkv, d)
                    mask = None
                k_g, v_g = k_g.transpose(1, 2), v_g.transpose(1, 2)
                q_sdpa = q.transpose(1, 2)
                t_bound, by = bound(nbytes, 4 * n_rows * h * d, dname)
                row = dict(
                    name=name, shape=label, dtype=dname,
                    dims=dict(b=b, h=h, hkv=hkv, d=d, window=window),
                    errors=err, tolerance=(TOL[dname] if dname == "float32"
                                           else SCALED_TOL),
                    ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
                    bound_ms=t_bound, bound_by=by,
                    library_ms=time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q_sdpa, k_g, v_g, attn_mask=mask,
                            scale=d ** -0.5, enable_gqa=True), flush))
                log(f"operand range {json.dumps(row)}")
                rows.append(row)
    flash_rows = check_flash(device, flush, operand_flash_cases())

    cfg = dataclasses.replace(LLAMA_TINY, dtype=torch.float32)
    model = LlamaLM(cfg, seed=0)
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (8, 40)))
    ops.reset_launch_counts()
    tokens = generate(model, prompt, max_new_tokens=24)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["decode_attention"]
    with decode_kernel_disabled():
        einsum = generate(model, prompt, max_new_tokens=24)
    if not torch.equal(tokens, einsum) or launches != cfg.num_layers * 23:
        raise AssertionError(
            f"generate at LLAMA_TINY on the card: kernel tokens equal "
            f"einsum: {bool(torch.equal(tokens, einsum))}; decode "
            f"launches {launches}, expected {cfg.num_layers * 23}")
    log(f"generate: llama-tiny (H=4, Hkv=2, D=16) f32 b=8 p=40 n=24 on the "
        f"card: tokens equal decode_kernel_disabled(); decode_attention "
        f"launches {launches}")
    return {"decode": rows, "flash": {f"{k[0]} {k[1]}": v
                                      for k, v in flash_rows.items()},
            "generate_llama_tiny_launches": launches}


# ---------------------------------------------------------------------------
# Phases 15-18: the serving fleet and its examples


def release_serving():
    """Drop the serving module's default engine and fleet (``serve()`` and
    ``fleet()`` register them), and with them their models and pools."""
    from horovod_tpu_torch import serving

    serving._default_engine = serving._default_router = None


def run_generation_example(card: str):
    """The generation example at the JAX bench's two decode rows:
    Llama-300M bf16, prompt 128, 256 new tokens, batch 8 then 32. Returns
    the numbers and the contiguous decode kernel's launches over both
    runs (each run: one unmeasured call, one timed)."""
    import torch

    from horovod_tpu_torch.examples import llama_generation
    from horovod_tpu_torch.ops import decode_attention as ops

    rows = {}
    ops.reset_launch_counts()
    for batch in (8, 32):
        out = llama_generation.main([
            "--model", "300m", "--prompt-len", "128", "--max-new-tokens",
            "256", "--batch-size", str(batch)])
        tokens = out["out"]
        if tuple(tokens.shape) != (batch, 384) or not bool(
                ((tokens >= 0) & (tokens < 32000)).all()):
            raise AssertionError(
                f"generation example b={batch}: bad output "
                f"{tuple(tokens.shape)}")
        rows[f"b{batch}"] = {
            "tokens_per_s": out["tokens_per_s"], "seconds": out["seconds"],
            "peak_memory_gib": out["peak_memory_bytes"] / 2 ** 30}
        log(f"generation example llama-300m bf16 p=128 n=256 b={batch}: "
            f"{out['tokens_per_s']:.1f} decode tokens/s "
            f"({out['seconds']:.3f} s), peak memory "
            f"{rows[f'b{batch}']['peak_memory_gib']:.3f} GiB [{card}]")
        del out, tokens
        torch.cuda.empty_cache()
    launches = ops.LAUNCHES["decode_attention"]
    if launches != 2 * 2 * LAYERS * 255:
        raise AssertionError(f"generation example: decode_attention "
                             f"launched {launches} times, expected "
                             f"{2 * 2 * LAYERS * 255}")
    return rows, launches


def run_loadgen(argv, what: str, card: str, eager: bool = False):
    """One load-generator run; fails unless every request finished.
    ``eager``: its engines run the eager decode step instead of their
    CUDA graphs. Returns its record and the paged decode kernel's
    launches."""
    import contextlib

    import torch

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.examples import serving_loadgen
    from horovod_tpu_torch.ops import decode_attention as ops
    from horovod_tpu_torch.serving import engine as engine_mod

    ops.reset_launch_counts()
    with engine_mod._eager_decode() if eager else contextlib.nullcontext():
        record = serving_loadgen.main(argv)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["paged_decode_attention"]
    metrics.reset_for_tests()
    if record["failed"] != 0 or record["rejected"] != 0 or \
            record["finished"] != record["requests"]:
        raise AssertionError(f"{what}: not every request finished: "
                             f"{json.dumps(record)}")
    if record["substrate"] != "cuda" or record["path"] != "kernel":
        raise AssertionError(f"{what}: ran on {record['substrate']} "
                             f"through the {record['path']} path")
    health = record["health"]
    if not isinstance(health, dict) or set(health) != {
            "findings", "rules_hit", "worst_rank", "worst_hint"}:
        raise AssertionError(f"{what}: health {health!r}")
    log(f"loadgen {what} health (35d, the doctor's summary over the "
        f"serving series): {json.dumps(health)}")
    log(f"loadgen {what}: {record['value']} tok/s, TTFT p50/p99 "
        f"{record['ttft_p50_s']}/{record['ttft_p99_s']} s, TPOT p50/p99 "
        f"{record['tpot_p50_s']}/{record['tpot_p99_s']} s, preemptions "
        f"{record['preemptions']}, blocks peak {record['blocks_peak']}, "
        f"paged_decode_attention launches {launches} [{card}]")
    log(f"loadgen {what} record: {json.dumps(record)}")
    return record, launches


LOADGEN_300M = ["--model", "300m", "--requests", "32", "--seed", "9",
                "--rate", "64", "--min-prompt", "32", "--max-prompt", "128",
                "--min-new", "32", "--max-new", "128", "--max-seq-len",
                "256"]
LOADGEN_FLEET_TINY = ["--model", "tiny", "--requests", "320", "--seed",
                      "11", "--rate", "30", "--prefix-share", "8",
                      "--prefix-len", "192", "--min-prompt", "200",
                      "--max-prompt", "224", "--min-new", "16",
                      "--max-new", "32", "--max-seq-len", "256",
                      "--replicas", "3"]


def run_fleet_parity(model, cfg):
    """Three replicas over one float32 Llama-300M behind the Router, 12
    requests sharing a 64-token prefix with unique tails, the replica
    serving them hard-killed once half are submitted and it has produced
    tokens: every request finishes with the tokens of ``generate()`` of
    its prompt alone (replays included), prefix affinity hit, and the
    metrics' totals agree with the engines and the handles."""
    import torch

    from horovod_tpu_torch import metrics, serving
    from horovod_tpu_torch.models.llama import generate
    from horovod_tpu_torch.ops import decode_attention as ops

    metrics.reset_for_tests()
    metrics.enable()
    rng = np.random.RandomState(12)
    shared = rng.randint(0, cfg.vocab_size, (64,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(
        0, cfg.vocab_size, (int(rng.randint(8, 40)),)).astype(np.int32)])
        for _ in range(12)]
    news = [int(rng.randint(24, 49)) for _ in prompts]
    scfg = serving.ServingConfig(max_batch=8, block_size=16, num_blocks=0,
                                 queue_depth=64, max_seq_len=256)
    router = serving.fleet(model, replicas=3, config=scfg)
    ops.reset_launch_counts()
    handles = [router.submit(p, n) for p, n in zip(prompts[:6], news[:6])]
    victim = handles[0].replica_id
    deadline = time.monotonic() + 300
    while router.engine(victim).stats()["tokens_generated"] < 6:
        if time.monotonic() > deadline:
            raise AssertionError("fleet parity: the victim made no progress")
        time.sleep(0.002)
    victim_engine = router.engine(victim)
    victim_engine.shutdown()
    handles += [router.submit(p, n) for p, n in zip(prompts[6:], news[6:])]
    results = [h.result(timeout=600) for h in handles]
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["paged_decode_attention"]
    rstats = router.router_stats()
    with router._lock:
        affinity_hits = router._affinity_hits
    engines = [router.engine(rid) for rid in range(3)]
    engine_tokens = [e.stats()["tokens_generated"] for e in engines]
    snap = metrics.snapshot()
    router.shutdown()
    for i, (p, n, got) in enumerate(zip(prompts, news, results)):
        want = generate(model, torch.from_numpy(p[None]),
                        max_new_tokens=n)[0, len(p):].tolist()
        if got != want:
            raise AssertionError(
                f"fleet request {i} (replays {handles[i].replays}, replica "
                f"{handles[i].replica_id}) differs from generate():\n"
                f" got={got}\nwant={want}")
    replays = sum(h.replays for h in handles)
    if not (rstats["router_reroutes"] > 0 and replays > 0
            and rstats["router_replica_departures"] == 1
            and affinity_hits > 0):
        raise AssertionError(f"fleet parity: reroutes/replays/departures/"
                             f"affinity {rstats} {replays} {affinity_hits}")
    # Tokens: the counter is every engine's own count, and that is what
    # the handles returned plus what the killed replica made for the
    # requests it lost (their replays start over).
    counter = snap["hvd_serving_tokens_generated_total"]["values"][0][1]
    kept_on_victim = sum(len(r) for h, r in zip(handles, results)
                         if h.replica_id == victim and h.replays == 0)
    lost = victim_engine.stats()["tokens_generated"] - kept_on_victim
    placed = sum(v for _, v in snap["hvd_router_requests_total"]["values"])
    if not (counter == sum(engine_tokens) == sum(news) + lost
            and sum(len(r) for r in results) == sum(news)
            and placed == rstats["router_requests"] == 12 + replays):
        raise AssertionError(
            f"fleet parity: metrics disagree: tokens counter {counter}, "
            f"engines {engine_tokens}, returned {sum(news)} + lost {lost}; "
            f"placements {placed} vs {rstats} (+{replays} replays)")
    metrics.reset_for_tests()
    numbers = {"requests": 12, "victim": victim, "replays": replays,
               "affinity_hits": affinity_hits, "router": rstats,
               "tokens_counter": counter, "tokens_lost_on_victim": lost,
               "paged_launches": launches}
    log(f"fleet parity: llama300m f32, 3 replicas over one model, 12 "
        f"requests on a 64-token prefix, replica {victim} killed mid-run: "
        f"every request equals generate(); {json.dumps(numbers)}")
    return numbers, launches


# ---------------------------------------------------------------------------
# Phase 7: collectives on the card


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# Jobs started by run_child / start_job, each the leader of its own
# process group (the launcher and its ranks), for stop_children(); once
# that has run, no job starts.
_CHILDREN = set()
_CHILDREN_LOCK = threading.Lock()
_STOPPING = threading.Event()


def start_child(cmd, **kwargs) -> subprocess.Popen:
    with _CHILDREN_LOCK:
        if _STOPPING.is_set():
            raise RuntimeError(f"the script is stopping: {cmd[:4]} not "
                               "started")
        proc = subprocess.Popen(cmd, start_new_session=True, **kwargs)
        _CHILDREN.add(proc)
    return proc


def run_child(cmd, timeout: float, **kwargs) -> subprocess.CompletedProcess:
    """``subprocess.run`` for a job of the script: the child leads a
    process group of its own, which :func:`stop_children` ends if the
    script fails while it runs (on the second lane, see :class:`Lane`)."""
    proc = start_child(cmd, **kwargs)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _stop_group(proc)
        raise
    finally:
        _CHILDREN.discard(proc)
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _stop_group(proc) -> None:
    """SIGTERM to the job's group (the launcher stops its ranks), then
    SIGKILL to whatever is left of it after 15 s."""
    try:
        os.killpg(proc.pid, signal.SIGTERM)
        proc.wait(timeout=15.0)
    except subprocess.TimeoutExpired:
        pass
    except ProcessLookupError:
        return
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def stop_children() -> None:
    with _CHILDREN_LOCK:
        _STOPPING.set()
        procs = list(_CHILDREN)
    for proc in procs:
        _stop_group(proc)
        _CHILDREN.discard(proc)


class Lane:
    """A second lane of phases beside the main one: a thread that runs
    ``(label, fn, *args)`` steps in order and logs each one's wall time.
    Its steps only start jobs (:func:`run_child`) and read their files:
    nothing on the card in this process, so the main lane's launch
    counts and phases stay its own. :meth:`join` returns the results by
    label and raises the first step's failure."""

    def __init__(self, steps, name: str = "second lane"):
        self.results, self.error, self.name = {}, None, name
        self.thread = threading.Thread(target=self._run, args=(steps,),
                                       name="chip-smoke-lane", daemon=True)
        self.thread.start()

    def _run(self, steps) -> None:
        try:
            for label, fn, *args in steps:
                t = time.perf_counter()
                self.results[label] = fn(*args)
                log(f"phase {label} ({self.name}): "
                    f"{time.perf_counter() - t:.1f} s")
        except BaseException as exc:  # re-raised by join()
            self.error = exc

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.results


def run_collectives():
    """``init()`` under a launcher environment of size 1 builds an NCCL
    group on ``cuda:0``; the collectives are the identity there."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    os.environ.update(HOROVOD_RANK="0", HOROVOD_SIZE="1",
                      HOROVOD_LOCAL_RANK="0", HOROVOD_LOCAL_SIZE="1",
                      HOROVOD_SPMD_COORDINATOR=f"127.0.0.1:{free_port()}")
    hvd.init()
    if not dist.is_initialized() or dist.get_backend() != "nccl" \
            or hvd.device() != torch.device("cuda", 0):
        raise AssertionError(
            f"init: no NCCL group on cuda:0 (initialized "
            f"{dist.is_initialized()}, device {hvd.device()})")
    x = torch.arange(1024, dtype=torch.float32, device=hvd.device())
    raw = x.clone()
    dist.all_reduce(raw)                     # the group itself runs
    outs = {"allreduce": hvd.allreduce(x), "allgather": hvd.allgather(x),
            "broadcast": hvd.broadcast(x, 0),
            "allreduce_async": hvd.synchronize(hvd.allreduce_async(x)),
            "nccl all_reduce": raw}
    hvd.barrier()
    torch.cuda.synchronize()
    for name, out in outs.items():
        if not torch.equal(out, x):
            raise AssertionError(f"{name} at size 1 is not the identity")
    log(f"collectives: NCCL group of size 1 on {hvd.device()}; "
        f"{', '.join(outs)} return their inputs")


# ---------------------------------------------------------------------------
# Phases 8-9: training


def run_training_parity(steps: int = 2):
    """Llama-300M f32 at seq 1024, batch 8: ``steps`` SGD steps through
    the flash kernels against as many through ``use_flash=False`` from the
    same weights and batch."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.ops import attention as A

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32)
    ids = ex.batch_ids(cfg, 8, 1024, "cuda")
    loss_fn = ex.make_loss_fn(0)
    runs = {}
    for use_flash in (True, False):
        model = ex.make_model(cfg, no_flash=not use_flash, device="cuda")
        opt = ex.make_optimizer("sgd", model)
        losses = []
        for step in range(steps):
            A.reset_launch_counts()
            losses.append(float(ex.train_step(model, opt, ids, loss_fn)))
            want = LAYERS if use_flash else 0
            if set(A.LAUNCHES.values()) != {want} or \
                    A.MASK_LAUNCHES["flash_mask_words"]:
                raise AssertionError(
                    f"training step {step} (use_flash={use_flash}): flash "
                    f"launches {A.LAUNCHES}, expected {want} each; mask "
                    f"bitmaps {A.MASK_LAUNCHES}, expected 0 (no key mask)")
        runs[use_flash] = (model, losses)
        del opt
    (kmodel, klosses), (pmodel, plosses) = runs[True], runs[False]
    for a, b in zip(klosses, plosses):
        if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(
                f"training parity: losses {klosses} vs {plosses}")
    worst = 0.0
    with torch.no_grad():
        for (name, p), (_, r) in zip(kmodel.named_parameters(),
                                     pmodel.named_parameters()):
            worst = max(worst, float((p - r).abs().max()))
            compare(p, r, "float32", f"training parity weight {name}")
    log(f"training parity: llama300m f32 seq 1024 b=8, {steps} SGD steps; "
        f"losses kernel {klosses} vs plain {plosses}; every weight within "
        f"{TOL['float32']} (max abs diff {worst:.3g}); flash launches "
        f"{LAYERS} per kernel per step")
    del kmodel, pmodel, runs
    torch.cuda.empty_cache()
    return {"losses_kernel": klosses, "losses_plain": plosses,
            "max_abs_weight_diff": worst}


def run_training_timed(card: str):
    """The training example's main path, bf16, seq 1024, batch 8, AdamW,
    10 timed steps; returns its numbers and the flash launch counts of
    the run."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.ops import attention as A

    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    out = ex.main(["--model", "300m", "--seq-len", "1024",
                   "--batch-size", "8", "--num-iters", "10"])
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    losses = out["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    numbers = {"tokens_per_s": out["tokens_per_s"],
               "step_ms": out["step_ms"], "losses": losses,
               "peak_memory_gib": peak, "flash_launches": launches}
    log(f"training bf16 llama300m seq 1024 b=8 adamw: "
        f"{out['tokens_per_s']:.1f} tokens/s, step {out['step_ms']:.3f} ms, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, peak memory "
        f"{peak:.2f} GiB, flash launches {launches} over 11 steps [{card}]")
    numbers["step_profile"] = profile_step(
        lambda: ex.train_step(out["model"], out["optimizer"], out["ids"],
                              out["loss_fn"]),
        out["step_ms"], TRANSFORMER_SPLIT, "flash", "llama300m")
    return numbers


# ---------------------------------------------------------------------------
# Phase 37: Adafactor, HOROVOD_FLASH_XLA_BWD, --checkpoint, word2vec, and
# the simulated cluster's tools


class flagged:
    """``HOROVOD_FLASH_XLA_BWD=1`` inside the block (the port reads it at
    each backward call)."""

    def __enter__(self):
        os.environ["HOROVOD_FLASH_XLA_BWD"] = "1"

    def __exit__(self, *exc):
        os.environ.pop("HOROVOD_FLASH_XLA_BWD", None)


def run_adafactor_parity(steps: int = 2):
    """37 (a) parity: Llama-300M f32 at ``PARITY_LAYERS``, seq 1024, b8,
    ``steps`` Adafactor steps (``optax.adafactor(3e-4)``) through the flash
    kernels against as many through ``use_flash=False`` from the same
    weights and batch: step 0's gradients within TOL (Adafactor's update
    is normalised per block and moves a weight by about lr * rms(w), under
    TOL, so the weights alone would hide a gradient off by a scale), the
    loss to 1e-4 relative, every weight within TOL."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.torch.optim import Adafactor

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32,
                              num_layers=PARITY_LAYERS)
    ids = ex.batch_ids(cfg, 8, 1024, "cuda")
    loss_fn = ex.make_loss_fn(0)
    runs, grads0 = {}, {}
    for use_flash in (True, False):
        model = ex.make_model(cfg, no_flash=not use_flash, device="cuda")
        opt = ex.make_optimizer("adafactor", model)
        if not isinstance(opt, Adafactor):
            raise AssertionError(f"adafactor: the example built {opt!r}")
        losses = []
        for step in range(steps):
            A.reset_launch_counts()
            losses.append(float(ex.train_step(model, opt, ids, loss_fn)))
            if step == 0:
                grads0[use_flash] = [p.grad.detach().clone()
                                     for p in model.parameters()]
            want = PARITY_LAYERS if use_flash else 0
            if set(A.LAUNCHES.values()) != {want}:
                raise AssertionError(
                    f"adafactor step {step} (use_flash={use_flash}): flash "
                    f"launches {A.LAUNCHES}, expected {want} each")
        runs[use_flash] = (model, losses)
        del opt
    (kmodel, klosses), (pmodel, plosses) = runs[True], runs[False]
    grad_diff = 0.0
    for (name, _), gk, gp in zip(kmodel.named_parameters(), grads0[True],
                                 grads0[False]):
        grad_diff = max(grad_diff, float((gk - gp).abs().max()))
        compare(gk, gp, "float32", f"adafactor parity step-0 gradient {name}")
    del grads0
    for a, b in zip(klosses, plosses):
        if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(
                f"adafactor parity: losses {klosses} vs {plosses}")
    worst = 0.0
    with torch.no_grad():
        for (name, p), (_, r) in zip(kmodel.named_parameters(),
                                     pmodel.named_parameters()):
            worst = max(worst, float((p - r).abs().max()))
            compare(p, r, "float32", f"adafactor parity weight {name}")
    log(f"adafactor parity: llama300m f32 ({PARITY_LAYERS} layers) seq 1024 "
        f"b=8, {steps} Adafactor steps; losses kernel {klosses} vs plain "
        f"{plosses}; every step-0 gradient (max abs diff {grad_diff:.3g}) "
        f"and every weight (max abs diff {worst:.3g}) within "
        f"{TOL['float32']}")
    del kmodel, pmodel, runs
    torch.cuda.empty_cache()
    return {"losses_kernel": klosses, "losses_plain": plosses,
            "max_abs_grad_diff_step0": grad_diff,
            "max_abs_weight_diff": worst}


def run_adafactor_timed(card: str, adamw):
    """37 (a): the training example's main path with ``--optimizer
    adafactor``, bf16, seq 1024, batch 8, all 16 layers, 5 timed steps;
    its numbers beside phase 9's AdamW run (``adamw``)."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.ops import attention as A

    iters = 5
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    out = ex.main(["--model", "300m", "--seq-len", "1024", "--batch-size",
                   "8", "--num-iters", str(iters), "--optimizer",
                   "adafactor"])
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    losses = out["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"adafactor training: loss did not fall: "
                             f"{losses}")
    if set(launches.values()) != {LAYERS * (iters + 1)}:
        raise AssertionError(f"adafactor training: flash launches "
                             f"{launches}, expected {LAYERS * (iters + 1)} "
                             "each")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    numbers = {"tokens_per_s": out["tokens_per_s"],
               "step_ms": out["step_ms"], "losses": losses,
               "peak_memory_gib": peak, "flash_launches": launches}
    log(f"training bf16 llama300m seq 1024 b=8 adafactor: "
        f"{out['tokens_per_s']:.1f} tokens/s, step {out['step_ms']:.3f} ms, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, peak memory "
        f"{peak:.2f} GiB, flash launches {launches} over {iters + 1} steps; "
        f"phase 9's adamw: {adamw['tokens_per_s']:.1f} tokens/s, step "
        f"{adamw['step_ms']:.3f} ms, peak memory "
        f"{adamw['peak_memory_gib']:.2f} GiB [{card}]")
    del out
    torch.cuda.empty_cache()
    return numbers


def run_flag_step():
    """37 (b): one f32 step of Llama-300M at ``PARITY_LAYERS`` (seq 1024,
    b8) under ``HOROVOD_FLASH_XLA_BWD``, against the same step through the
    kernels' backward: every gradient within TOL; the flagged step
    launches kernel 1 once a layer and neither kernel 2 nor 3."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.ops import attention as A

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32,
                              num_layers=PARITY_LAYERS)
    ids = ex.batch_ids(cfg, 8, 1024, "cuda")
    loss_fn = ex.make_loss_fn(0)
    grads, counts, losses = {}, {}, {}
    for flag in (False, True):
        model = ex.make_model(cfg, device="cuda")
        A.reset_launch_counts()
        if flag:
            with flagged():
                loss = loss_fn(model, ids)
                loss.backward()
        else:
            loss = loss_fn(model, ids)
            loss.backward()
        torch.cuda.synchronize()
        counts[flag] = dict(A.LAUNCHES)
        losses[flag] = float(loss.detach())
        grads[flag] = {n: p.grad for n, p in model.named_parameters()}
        del model, loss
    want = {"flash_forward": PARITY_LAYERS, "flash_backward_dq": 0,
            "flash_backward_dkdv": 0}
    if counts[True] != want or set(counts[False].values()) != \
            {PARITY_LAYERS}:
        raise AssertionError(f"flagged step launches {counts[True]} "
                             f"(want {want}); kernel step {counts[False]}")
    worst = 0.0
    for name, g in grads[True].items():
        ref = grads[False][name]
        worst = max(worst, float((g - ref).abs().max()))
        compare(g, ref, "float32", f"flagged gradient {name}")
    log(f"HOROVOD_FLASH_XLA_BWD: llama300m f32 ({PARITY_LAYERS} layers) seq "
        f"1024 b=8, one step: loss {losses[True]} (kernels "
        f"{losses[False]}); every gradient within {TOL['float32']} of the "
        f"kernels' backward (max abs diff {worst:.3g}); launches flagged "
        f"{counts[True]}, kernels {counts[False]}")
    del grads
    torch.cuda.empty_cache()
    return {"launches": counts[True], "kernel_launches": counts[False],
            "max_abs_grad_diff": worst}


def run_checkpoint_generation(card: str, new: int = 64):
    """37 (c): Llama-300M bf16 weights (seed 1, not the example's seed 0)
    saved with ``utils.checkpoint.save_checkpoint`` and decoded by the
    generation example through ``--checkpoint`` (b8, prompt 128, ``new``
    tokens): its greedy tokens equal ``generate()`` of the saved model in
    memory, through the contiguous decode kernel."""
    import tempfile

    import torch

    from horovod_tpu_torch.examples import llama_generation
    from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM, generate
    from horovod_tpu_torch.ops import decode_attention as ops
    from horovod_tpu_torch.utils.checkpoint import save_checkpoint

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        path = os.path.join(out_dir, "llama300m")
        model = LlamaLM(LLAMA_300M, device="cuda", seed=1)
        t = time.perf_counter()
        save_checkpoint(path, model.state_dict())
        save_s = time.perf_counter() - t
        prompt = torch.from_numpy(np.random.RandomState(0).randint(
            0, LLAMA_300M.vocab_size, (8, 128)))
        want = generate(model, prompt, max_new_tokens=new).cpu()
        del model
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        out = llama_generation.main([
            "--model", "300m", "--prompt-len", "128", "--max-new-tokens",
            str(new), "--batch-size", "8", "--checkpoint", path])
        launches = ops.LAUNCHES["decode_attention"]
        got = out["out"].cpu()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if not torch.equal(got, want):
        raise AssertionError(
            f"--checkpoint: {int((got != want).sum())} tokens differ from "
            "the saved model's generate()")
    if launches != 2 * LAYERS * (new - 1):
        raise AssertionError(f"--checkpoint: decode_attention launched "
                             f"{launches} times, expected "
                             f"{2 * LAYERS * (new - 1)}")
    log(f"generation --checkpoint llama-300m bf16 p=128 n={new} b=8: tokens "
        f"equal the saved model's generate(); {out['tokens_per_s']:.1f} "
        f"decode tokens/s; save {save_s:.2f} s; decode_attention launches "
        f"{launches} [{card}]")
    return {"tokens_per_s": out["tokens_per_s"], "save_s": save_s,
            "launches": launches}


def run_word2vec(card: str):
    """37 (d): the word2vec example at its defaults (vocab 10,000, dim 128,
    batch 1024, 8 negatives, 200 steps of Adagrad) on the card: the loss
    falls; pairs/s of each 50-step window."""
    import torch

    from horovod_tpu_torch.examples import word2vec

    t = time.perf_counter()
    out = word2vec.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    losses = out["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"word2vec: loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    rates = out["pairs_per_s"]
    log(f"word2vec defaults (vocab 10000, dim 128, b1024, 8 negatives, 200 "
        f"Adagrad steps): loss {losses[0]:.4f} -> {losses[-1]:.4f}; pairs/s "
        f"by 50-step window {[round(r) for r in rates]}; {wall:.1f} s "
        f"[{card}]")
    return {"loss_first": losses[0], "loss_last": losses[-1],
            "pairs_per_s": rates, "seconds": wall}


SIM_STORM_PLAN = {"seed": 13, "faults": [
    {"site": "cycle", "action": "delay", "rank": 5, "at": 1, "times": 30,
     "seconds": 0.03},
    {"site": "cycle", "action": "kill", "rank": 9, "at": 6},
    {"site": "cycle", "action": "leave", "rank": 20, "at": 10},
    {"site": "cycle", "action": "group_kill", "ranks": [40, 41, 42, 43],
     "at": 14},
    {"site": "cycle", "action": "join", "rank": 1, "at": 16},
    {"site": "cycle", "action": "join", "rank": 1, "at": 18},
    {"site": "cycle", "action": "kill", "rank": 9, "at": 22},
]}
# capacity_probe at reduced settings (the committed calibration's are in
# horovod_tpu_torch/calibration/capacity_port.json): every size on the
# serial driver, 128 again on the threaded one.
PROBE_SMOKE = ["--sizes", "8,16,32,64,128", "--threaded-sizes", "",
               "--driver-check", "128", "--cycles", "5", "--repeats", "1"]


def _tool(args, timeout: float) -> subprocess.CompletedProcess:
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = here
    res = run_child([sys.executable, "-m", *args], timeout, cwd=here,
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
    if res.returncode != 0:
        raise AssertionError(f"{args[0]} exited {res.returncode}: "
                             f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    return res


def run_sim_tools(card: str):
    """37 (e), host only (the second lane): the 64-rank seeded storm
    through ``tools.simcluster`` (exit 0: consistent collectives, zero
    protocol violations, the doctor naming straggler 5 and the
    most-departed rank 9); ``capacity_probe`` at ``PROBE_SMOKE``, then
    ``tools.capacity --ranks 4096`` over its record, which names a first
    bottleneck."""
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sim_")
    try:
        plan = os.path.join(out_dir, "storm.json")
        with open(plan, "w") as f:
            json.dump(SIM_STORM_PLAN, f)
        t = time.perf_counter()
        res = _tool(["horovod_tpu_torch.tools.simcluster", "--ranks", "64",
                     "--steps", "34", "--plan", f"@{plan}", "--json"], 300)
        storm_s = time.perf_counter() - t
        verdict = json.loads(res.stdout)
        names = {(f["rule"], f.get("rank")) for f in verdict["findings"]}
        if verdict["final_size"] != 59 or verdict["problems"] or \
                verdict["violations"] or \
                ("persistent_straggler", 5) not in names or \
                ("membership_churn", 9) not in names:
            raise AssertionError(f"simcluster storm: {json.dumps(verdict)}")
        t = time.perf_counter()
        _tool(["horovod_tpu_torch.examples.capacity_probe", *PROBE_SMOKE,
               "--card", card, "--out",
               os.path.join(out_dir, "capacity_port.json")], 600)
        probe_s = time.perf_counter() - t
        res = _tool(["horovod_tpu_torch.tools.capacity", "--ranks", "4096",
                     "--artifacts", out_dir, "--json"], 120)
        plan_out = json.loads(res.stdout)
        first = plan_out["first_bottleneck"]
        if first is None:
            raise AssertionError(f"capacity: no first bottleneck "
                                 f"{json.dumps(plan_out)}")
        with open(os.path.join(out_dir, "capacity_port.json")) as f:
            record = json.load(f)
        cal = record["calibration"]
        check = {key: row["ratio"] for key, row in sorted(
            record["threaded_driver"]["vs_fit"]["128"].items())}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"simcluster storm (64 ranks, 34 steps): epoch "
        f"{verdict['final_epoch']}, size {verdict['final_size']}, "
        f"{verdict['transitions']} conformant transitions, 0 violations, "
        f"doctor {sorted(names, key=str)}; {storm_s:.1f} s. capacity_probe "
        f"{' '.join(PROBE_SMOKE)}: negotiation "
        f"{cal['negotiation_per_rank_s'] * 1e6:.2f} us/rank, reshape "
        f"{cal['reshape_per_rank_s'] * 1e6:.2f} us/rank, 128 ranks on "
        f"the threaded driver / the serial fit {json.dumps(check)}; "
        f"{probe_s:.1f} s; tools.capacity --ranks 4096: first bottleneck "
        f"{first['plane']} [host beside {card}]")
    return {"storm": {k: verdict[k] for k in ("final_epoch", "final_size",
                                              "transitions")},
            "storm_s": storm_s, "probe_s": probe_s, "calibration": cal,
            "threaded_driver_ratio": check,
            "first_bottleneck": first["plane"]}


# Device-time buckets of a profiled step: (bucket, kernel-name test), the
# first that matches wins, the rest is "other" (the elementwise tail).
TRANSFORMER_SPLIT = (
    ("flash", lambda n: re.search(FLASH_KERNELS, n)),
    ("matmul", lambda n: any(t in n for t in ("nvjet", "gemm", "gemv",
                                              "cutlass", "xmma"))))
CONV_SPLIT = (
    ("batchnorm", lambda n: "batch_norm" in n or "batchnorm" in n),
    ("conv", lambda n: any(t in n for t in ("conv", "xmma", "implicit_gemm",
                                            "cudnn", "wgrad", "dgrad",
                                            "fprop", "nhwc", "nchw"))),
    ("optimizer", lambda n: "multi_tensor_apply" in n or "foreach" in n),
    ("matmul", lambda n: any(t in n for t in ("nvjet", "gemm", "gemv",
                                              "cutlass"))))


def profile_step(step, step_ms: float, buckets, required: str, what: str,
                 steps: int = 2, listed=None):
    """Where a bf16 training step's device time goes, by ``buckets`` plus
    "other" (which must see time in bucket ``required``): ``steps`` steps
    under ``hvd.profiler.trace``, read by the port's own readers
    (``utils/hlo_phases.kernel_rows`` and ``step_split``: the kernel
    count, every kernel of bucket ``listed`` (if given) with its time,
    the idle share of the profiled window, which the profiler's
    per-launch host cost stretches, and busy time over the step's wall
    time without the profiler, ``step_ms``)."""
    import torch

    from horovod_tpu_torch.common import profiler
    from horovod_tpu_torch.utils.hlo_phases import kernel_rows, step_split

    torch.cuda.synchronize()
    with profiler.trace(trace_dir("step")) as path:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    result = step_split(kernel_rows(path), steps, buckets, step_ms,
                        profiled_ms, listed)
    os.remove(path)
    if not result[f"{required}_ms_per_step"] > 0:
        raise AssertionError(
            f"{what} profile: no device time matched the {required} "
            f"kernels' names: {json.dumps(result)}")
    log(f"{what} step profile (bf16, {steps} steps): {json.dumps(result)}")
    return result


def trace_dir(what: str) -> str:
    """A directory for the profiler traces of ``what`` (each removed
    once read)."""
    import tempfile

    return os.path.join(tempfile.gettempdir(), f"chip_smoke_traces_{what}")


# ---------------------------------------------------------------------------
# Phase 38: the probe examples

PROBE_FLASH = ["--batch", "8", "--seq-len", "1024", "--heads", "16",
               "--kv-heads", "8", "--head-dim", "64", "--iters", "25"]
PROBE_DECODE = ["--model", "300m", "--batch-size", "8", "--prompt-len",
                "128", "--max-new-tokens", "64", "--unrolls", "1,4",
                "--reps", "2"]
PROBE_HOST = {
    "wire": ["horovod_tpu_torch.examples.wire_bandwidth_probe", "--ranks",
             "2", "--sizes-mib", "4", "--chunks-kib", "1024", "--reps",
             "3"],
    "autotune": ["horovod_tpu_torch.examples.autotune_efficacy", "--runs",
                 "A,C", "--steps", "10", "--window", "10"],
    "scaling": ["horovod_tpu_torch.examples.scaling_efficiency", "--sizes",
                "1,2", "--steps", "10", "--warmup", "2"],
}


def _delta(counts, before):
    return {k: counts[k] - before[k] for k in before}


def run_probe_phase(card: str):
    """38 (a)-(d) on the main lane: the probes' own ``main`` in this
    process, each path's launch counts taken around it."""
    import torch

    from horovod_tpu_torch.examples import (decode_floor_probe,
                                            flash_attention_benchmark,
                                            headpack_probe,
                                            resnet50_roofline)
    from horovod_tpu_torch.ops import attention as flash_ops
    from horovod_tpu_torch.ops import decode_attention as decode_ops

    out = {}
    before = dict(flash_ops.LAUNCHES)
    rows = flash_attention_benchmark.main(PROBE_FLASH)
    out["a_launches"] = _delta(flash_ops.LAUNCHES, before)
    out["a"] = {r["metric"]: {k: r[k] for k in ("fwd_ms", "train_ms")}
                for r in rows}
    tile = flash_ops.flash_tiles(torch.bfloat16, 64)["forward"]
    q, k, v = flash_attention_benchmark.make_qkv(8, 1024, 16, 8, 64,
                                                 torch.bfloat16, "cuda")
    out["a_blocks_bit_equal"] = torch.equal(
        flash_ops.flash_attention(q, k, v, causal=True),
        flash_ops.flash_attention(q, k, v, causal=True, block_q=tile[0],
                                  block_k=tile[1]))
    del q, k, v
    if not out["a_blocks_bit_equal"]:
        raise AssertionError(f"38 (a): flash_attention(block_q={tile[0]}, "
                             f"block_k={tile[1]}) differs from the default")
    before = dict(flash_ops.LAUNCHES)
    head = headpack_probe.main(["--parts", "AF", "--iters", "25"])
    out["b_launches"] = _delta(flash_ops.LAUNCHES, before)
    out["b"] = {k: v for k, v in head.items() if k != "rows"}
    out["b_rows"] = [{k: r[k] for k in r if k not in ("device", "launches")}
                     for r in head["rows"]]
    before = dict(decode_ops.LAUNCHES)
    floor = decode_floor_probe.main(PROBE_DECODE)
    out["c_launches"] = _delta(decode_ops.LAUNCHES, before)[
        "decode_attention"]
    out["c"] = {k: floor[k] for k in (
        "empty_loop", "decode_tok_s", "decode_launches", "tokens_equal",
        "roofline_bytes_per_step", "roofline_tok_s", "pct_of_roofline")}
    if not floor["tokens_equal"] or min(
            floor["decode_launches"].values()) <= 0:
        raise AssertionError(f"38 (c): unroll 1 and 4 tokens equal "
                             f"{floor['tokens_equal']}, launches "
                             f"{floor['decode_launches']}")
    torch.cuda.empty_cache()
    roof = resnet50_roofline.main(["--steps", "2", "--trace-dir",
                                   trace_dir("resnet50_roofline")])
    result = roof["roofline"]
    out["d"] = {k: result[k] for k in (
        "measured_ms_per_step", "max_bound_ms_per_step", "max_bound_ratio",
        "sum_bound_ratio", "max_bound_ratio_all_bytes_hbm",
        "unattributed_ms_per_step", "by_kind", "ops_over_max_ratio",
        "worst_ops")}
    out["d"]["capture_img_s"] = roof["capture_img_s"]
    shutil.rmtree(trace_dir("resnet50_roofline"), ignore_errors=True)
    ratio = result["max_bound_ratio"]
    if not (ratio and 0 < ratio <= 1) or result["ops_over_max_ratio"]:
        raise AssertionError(f"38 (d): aggregate ratio {ratio}, ops over "
                             f"1.05: {result['ops_over_max_ratio']}")
    for key in ("a_launches", "b_launches"):
        if min(out[key].values()) <= 0:
            raise AssertionError(f"38: a flash kernel never ran: {out}")
    log(f"38 (a) flash fwd {out['a']['flash_fwd_ms']['fwd_ms']:.5f} ms, "
        f"train {out['a']['flash_fwd_ms']['train_ms']:.5f} ms (SDPA "
        f"{out['a']['sdpa_fwd_ms']['fwd_ms']:.5f} / "
        f"{out['a']['sdpa_fwd_ms']['train_ms']:.5f}); (b) A K64/K128 "
        f"{out['b']['A_k64_over_k128_ms']:.4f}, F D64/D128 fwd "
        f"{out['b']['F_d64_over_d128_fwd']:.4f} train "
        f"{out['b']['F_d64_over_d128_train']:.4f}; (c) "
        f"{json.dumps(out['c']['decode_tok_s'])} tok/s, "
        f"{json.dumps(out['c']['pct_of_roofline'])} % of the roofline; "
        f"(d) ratio {ratio:.4f} [{card}]")
    return out


def _probe_record(args, timeout: float) -> dict:
    res = _tool(args, timeout)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    return {"last": json.loads(lines[-1]),
            "lines": [json.loads(ln) for ln in lines[:-1]]}


def run_host_probes(card: str):
    """38 (e), host only (the second lane): the wire probe, autotune
    efficacy A and C and scaling efficiency (MLP), three jobs at once."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(PROBE_HOST)) as pool:
        futures = {name: pool.submit(_probe_record, args, 300.0)
                   for name, args in sorted(PROBE_HOST.items())}
        out = {name: f.result() for name, f in sorted(futures.items())}
    wire = out["wire"]["last"]
    if wire["wire_stats_rank0"]["tx_bytes"]["int8"] <= 0:
        raise AssertionError(f"38 (e): no int8 wire bytes: {wire}")
    scaling = out["scaling"]["last"]
    if scaling["efficiency"]["1"] != 1.0 or scaling["sizes"] != [1, 2]:
        raise AssertionError(f"38 (e): scaling record {scaling}")
    runs = [r for r in out["autotune"]["lines"] if "run" in r]
    if [r["run"] for r in runs] != ["A", "C"] or not runs[1]["autotune"]:
        raise AssertionError(f"38 (e): autotune runs {runs}")
    log(f"38 (e) wire {json.dumps(wire['best_by_size_and_wire'])}; "
        f"autotune last windows {json.dumps(out['autotune']['last'])}; "
        f"scaling {json.dumps(scaling['efficiency'])} [{card}]")
    return {"wire": {k: wire[k] for k in ("best_by_size_and_wire",
                                          "speedup_vs_none_at_best_chunk")},
            "wire_int8_tx_bytes": wire["wire_stats_rank0"]["tx_bytes"][
                "int8"],
            "autotune": out["autotune"]["last"],
            "scaling": {k: scaling[k] for k in ("img_sec", "efficiency")}}


# ---------------------------------------------------------------------------
# Phase 39: the TensorFlow and Keras front ends

# The nine examples and their smallest flags (those of their tests).
TF_EXAMPLES = {
    "tensorflow_mnist": ["--epochs", "1", "--batch-size", "256"],
    "tensorflow_mnist_eager": ["--steps", "5", "--batch-size", "32"],
    "tensorflow_keras_mnist": ["--epochs", "1", "--batch-size", "256"],
    "tensorflow_synthetic_benchmark": [
        "--model", "MobileNetV2", "--batch-size", "4", "--image-size", "32",
        "--num-classes", "10", "--num-warmup-batches", "1",
        "--num-batches-per-iter", "2", "--num-iters", "2"],
    "tensorflow_word2vec": ["--steps", "10", "--batch-size", "64",
                            "--vocab-size", "500", "--embedding-dim", "16"],
    "keras_mnist": ["--epochs", "1", "--batch-size", "256"],
    "keras_mnist_advanced": ["--epochs", "2", "--batch-size", "256",
                             "--warmup-epochs", "1"],
    "keras_imagenet_resnet50": ["--epochs", "1", "--steps-per-epoch", "2",
                                "--batch-size", "2", "--image-size", "32",
                                "--num-classes", "10"],
    "keras_spark_rossmann": ["--epochs", "1", "--rows", "1024"],
}

# The child of phase 39: prints one JSON line.
TF_PHASE_CHILD = r"""
import ctypes
import json
import runpy
import sys

examples = json.loads(sys.argv[1])
try:
    import tensorflow  # noqa: F401
except ImportError:
    out = {"branch": "absent", "errors": {}}
    for name in ("tensorflow", "keras"):
        try:
            __import__("horovod_tpu_torch." + name)
            out["errors"][name] = None
        except ImportError as exc:
            out["errors"][name] = str(exc)
    for name, flags in sorted(examples.items()):
        sys.argv = [name] + flags
        try:
            runpy.run_module("horovod_tpu_torch.examples." + name,
                             run_name="__main__", alter_sys=True)
            out["errors"][name] = None
        except ImportError as exc:
            out["errors"][name] = str(exc)
    print(json.dumps(out), flush=True)
    sys.exit(0)

import numpy as np

from horovod_tpu_torch.core import bindings
from horovod_tpu_torch.tensorflow import tf_ops

lib = bindings.load()
key = (ctypes.c_uint8 * 32).from_buffer_copy(b"\x01" * 32)
if lib.hvd_eng_init(0, 1, b"", key, 32, 1.0, 1 << 20, 64, 1, 60.0, -1.0,
                    b"", 0, 0, 0, 0, 1) != 0:
    raise SystemExit(lib.hvd_eng_last_error().decode())
x = tensorflow.constant(np.arange(6, dtype=np.float32) - 2.5)
summed = tf_ops.allreduce_sum(x, name="chip.tf.ar").numpy().tolist()
root = tf_ops.broadcast(x, root_rank=0, name="chip.tf.bc").numpy().tolist()
lib.hvd_eng_shutdown()
print(json.dumps({"branch": "present", "allreduce": summed,
                  "broadcast": root, "want": x.numpy().tolist()}),
      flush=True)
"""


def run_tf_front_ends(card: str):
    """Phase 39 (third lane, host only): see the module docstring."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = here
    t = time.perf_counter()
    proc = run_child([sys.executable, "-c", TF_PHASE_CHILD,
                      json.dumps(TF_EXAMPLES)], 300, cwd=here, env=env,
                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                     text=True)
    seconds = time.perf_counter() - t
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"39: the child exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    out = json.loads(lines[-1])
    if out["branch"] == "absent":
        wrong = {}
        for name, msg in sorted(out["errors"].items()):
            front = "keras" if name.startswith("keras") else "tensorflow"
            if not (msg or "").startswith(
                    f"horovod_tpu_torch.{front} requires the 'tensorflow' "
                    "package"):
                wrong[name] = msg
        if wrong or len(out["errors"]) != len(TF_EXAMPLES) + 2:
            raise AssertionError(f"39: without tensorflow, not the front "
                                 f"ends' messages: {wrong or out}")
        detail = (f"the two front ends and the {len(TF_EXAMPLES)} examples "
                  "failed with their front end's message")
    else:
        if not out["allreduce"] == out["broadcast"] == out["want"]:
            raise AssertionError(f"39: size-1 custom op: {out}")
        detail = "the size-1 custom-op allreduce and broadcast returned " \
                 "their inputs on the native engine"
    log(f"39 TF and Keras front ends: tensorflow {out['branch']}; {detail}; "
        f"{seconds:.1f} s [{card}]")
    return {"branch": out["branch"], "seconds": seconds}


# ---------------------------------------------------------------------------
# Phases 10-13: the model zoo (ResNet-50 and BERT-base)

# The card-vs-CPU ResNet-50 check (float32 on both, TF32 off): the loss
# to ``loss_rtol``; each weight's change over the steps and each running
# statistic by its relative L2 error, ||card - cpu|| / ||cpu||, within
# ``update_rel`` / ``stat_rel``. Not element by element: ReLU and max-pool
# route each gradient by a comparison, and where two values tie within
# rounding the two devices route it to different elements, so single
# entries of a weight's gradient may differ by one position's whole term
# while the tensor agrees. How far float32 rounding carries here is
# measured in the same run: a CPU run with float64 activations
# (parameters and head float32) is the reference, and each tensor's limit
# is the larger of ``*_rel`` and 3x the CPU's own float32 error against
# it (two float32 runs each within e of the reference differ by up to 2e;
# 3e allows the card's error to be twice the CPU's, no more).
RESNET_TOL = {"loss_rtol": 1e-4, "update_rel": 1e-3, "stat_rel": 1e-4,
              "of_cpu_f32_error": 3.0}


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    norm = float(want.norm())
    diff = float((got - want).norm())
    return diff / norm if norm else diff


def run_resnet_parity(steps: int = 2, batch: int = 4, lr: float = 0.01):
    """ResNet-50 in float32 at 224², batch 4: ``steps`` SGD-momentum
    steps of the synthetic benchmark's train_step on the card
    (``channels_last``, cuDNN) against the same module, weights and batch
    on the CPU: the losses, every weight's change and every running
    statistic (:data:`RESNET_TOL`), each also against a float64 CPU run.
    ``lr`` is 0.01, not the example's 0.1: at 0.1 one step nearly fits a
    batch of 4, and the second step's gradients shrink to differences
    that float32 does not resolve, so the two devices drift apart by a
    large share of some weights' change. Weights
    whose change stays small at 0.01 too (each block's residual branch
    behind its zero-initialised third norm) are what the float64
    reference's per-tensor limit is for."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import synthetic_benchmark as ex
    from horovod_tpu_torch.models import ResNet50

    runs = {}
    for label, dev, dtype in (("card", "cuda", torch.float32),
                              ("cpu", "cpu", torch.float32),
                              ("cpu_f64", "cpu", torch.float64)):
        model = ResNet50(dtype=dtype, device=dev, seed=0)
        start = {n: p.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
            named_parameters=model.named_parameters())
        x, y = ex.batch(224, batch, dev)
        t0 = time.perf_counter()
        losses = [float(ex.train_step(model, opt, x, y))
                  for _ in range(steps)]
        state = {f"{n} change": (p.detach().cpu() - start[n], "update")
                 for n, p in model.named_parameters()}
        state.update({n: (t.cpu(), "stat")
                      for n, t in model.named_buffers()})
        runs[label] = (losses, state, time.perf_counter() - t0)
        if label == "card" and not model.conv_init.weight.is_contiguous(
                memory_format=torch.channels_last):
            raise AssertionError("ResNet-50 on the card is not channels_last")
        del model, opt
    torch.cuda.empty_cache()
    (c_losses, card, c_s), (p_losses, cpu, p_s), (r_losses, ref, _) = (
        runs["card"], runs["cpu"], runs["cpu_f64"])
    worst = {}
    failures = []
    for name, (got, kind) in card.items():
        want = cpu[name][0]
        err = rel_l2(got, want)
        cpu_err = rel_l2(want, ref[name][0])
        limit = max(RESNET_TOL[f"{kind}_rel"],
                    RESNET_TOL["of_cpu_f32_error"] * cpu_err)
        for key, e in ((f"{kind}_card_vs_cpu", err),
                       (f"{kind}_card_vs_f64", rel_l2(got, ref[name][0])),
                       (f"{kind}_cpu_vs_f64", cpu_err),
                       (f"{kind}_card_vs_cpu_over_limit", err / limit)):
            if e > worst.get(key, (-1.0, ""))[0]:
                worst[key] = (e, name)
        if not bool(torch.isfinite(got).all()) or err > limit:
            failures.append((name, err, limit))
    log(f"resnet50 parity: f32 224x224 b={batch}, {steps} SGD-momentum "
        f"(lr {lr}) steps, card (channels_last, cuDNN, TF32 off) vs CPU; losses "
        f"card {c_losses}, CPU {p_losses}, CPU float64 activations "
        f"{r_losses}; worst relative L2 error per tensor (and where): "
        f"{json.dumps(worst)}; card {c_s:.2f} s, CPU {p_s:.2f} s")
    for a, b in zip(c_losses, p_losses):
        if not np.isfinite(a) or abs(a - b) > RESNET_TOL["loss_rtol"] * abs(b):
            raise AssertionError(
                f"resnet50 parity: losses card {c_losses} vs CPU {p_losses}")
    if failures:
        raise AssertionError(
            f"resnet50 parity: {len(failures)} tensors outside {RESNET_TOL}: "
            f"{failures[:6]}")
    return {"losses_card": c_losses, "losses_cpu": p_losses,
            "losses_cpu_f64": r_losses, "worst_rel_l2": worst,
            "tolerance": RESNET_TOL}


def run_synthetic_benchmark(card: str):
    """The synthetic benchmark's main path: ResNet-50 bf16, batch 128,
    224², one warm-up step, then 5 windows of 10 steps; img/s, step ms,
    peak memory, the step's share of the bf16 dense peak (FLOPs counted
    from the model's own convolutions and dense layers) and one profiled
    step's device split. Then ResNet-101, Inception V3 and VGG-16, one
    warm-up and 3 steps each."""
    import torch

    from horovod_tpu_torch.examples import synthetic_benchmark as ex

    torch.cuda.reset_peak_memory_stats()
    out = ex.main(["--model", "resnet50", "--batch-size", "128",
                   "--num-iters", "10", "--num-batches", "5"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"resnet50 benchmark: loss {out['losses']}")
    macs = ex.forward_macs(out["model"], 224)
    flops = 3 * 2 * macs * 128
    bound_ms = flops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    numbers = {"img_per_s": out["img_per_s"],
               "img_per_s_windows": out["img_per_s_windows"],
               "spread": out["spread"], "step_ms": out["step_ms"],
               "peak_memory_gib": peak, "forward_gmac_per_image": macs / 1e9,
               "tflop_per_step": flops / 1e12, "bound_ms": bound_ms,
               "dense_peak_share": bound_ms / out["step_ms"],
               "losses": out["losses"]}
    log(f"synthetic benchmark resnet50 bf16 b=128 224x224 sgd-momentum: "
        f"{out['img_per_s']:.1f} img/s median (windows "
        f"{[round(v, 1) for v in out['img_per_s_windows']]}), step "
        f"{out['step_ms']:.3f} ms, peak memory {peak:.2f} GiB; "
        f"{macs / 1e9:.4f} GMAC/image forward, {flops / 1e12:.3f} TFLOP per "
        f"step, bf16 bound {bound_ms:.3f} ms = "
        f"{bound_ms / out['step_ms']:.3f} of the step [{card}]")
    numbers["step_profile"] = profile_step(
        lambda: ex.train_step(out["model"], out["optimizer"], out["x"],
                              out["y"]),
        out["step_ms"], CONV_SPLIT, "conv", "resnet50")
    del out
    torch.cuda.empty_cache()
    for name in ("resnet101", "inception3", "vgg16"):
        torch.cuda.reset_peak_memory_stats()
        other = ex.main(["--model", name, "--batch-size", "128",
                         "--num-iters", "3", "--num-batches", "1"])
        torch.cuda.synchronize()
        if not all(np.isfinite(other["losses"])):
            raise AssertionError(f"{name} benchmark: loss {other['losses']}")
        numbers[name] = {
            "img_per_s": other["img_per_s"], "step_ms": other["step_ms"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "image_size": other["image_size"]}
        log(f"synthetic benchmark {name} bf16 b=128 "
            f"{other['image_size']}x{other['image_size']}, 3 steps: "
            f"{json.dumps(numbers[name])} [{card}]")
        del other
        torch.cuda.empty_cache()
    return numbers


def run_bert_parity(steps: int = 2, batch: int = 4, seq: int = 512):
    """BERT-base in float32 at seq 512, batch 4, key mask with padded
    tails: ``steps`` SGD steps through ``make_attention_fn()`` (flash
    from 512 rows up: the three kernels, non-causal, masked, group 1)
    against as many through ``use_flash=False``, from the same weights
    and batch; the loss and every weight at the Llama parity phase's
    tolerances, 12 launches per kernel per step."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import bert_pretraining as ex
    from horovod_tpu_torch.models.bert import BERT_BASE, BertEncoder, mlm_loss
    from horovod_tpu_torch.ops import attention as A

    cfg = dataclasses.replace(BERT_BASE, dtype=torch.float32)
    ids, mlm = ex.batch(cfg, batch, seq, "cuda")
    key_mask = tail_mask(batch, seq, "cuda")
    runs = {}
    for use_flash in ("auto", False):
        model = BertEncoder(cfg, A.make_attention_fn(use_flash=use_flash),
                            device="cuda", seed=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        losses = []
        for step in range(steps):
            A.reset_launch_counts()
            opt.zero_grad(set_to_none=True)
            loss = mlm_loss(model(ids, attention_mask=key_mask), ids, mlm)
            loss.backward()
            opt.step()
            losses.append(float(loss))
            want = cfg.num_layers if use_flash else 0
            # One bitmap a layer's forward, read by its three kernels.
            if set(A.LAUNCHES.values()) != {want} or \
                    A.MASK_LAUNCHES["flash_mask_words"] != want:
                raise AssertionError(
                    f"bert step {step} (use_flash={use_flash}): flash "
                    f"launches {A.LAUNCHES}, mask bitmaps "
                    f"{A.MASK_LAUNCHES}, expected {want} each")
        runs[use_flash] = (model, losses)
        del opt
    (kmodel, klosses), (pmodel, plosses) = runs["auto"], runs[False]
    for a, b in zip(klosses, plosses):
        if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"bert parity: losses {klosses} vs {plosses}")
    worst = 0.0
    with torch.no_grad():
        for (name, p), (_, r) in zip(kmodel.named_parameters(),
                                     pmodel.named_parameters()):
            worst = max(worst, float((p - r).abs().max()))
            compare(p, r, "float32", f"bert parity weight {name}")
    log(f"bert parity: bert-base f32 seq {seq} b={batch}, key mask with "
        f"the last quarter masked in every other row, {steps} SGD steps; "
        f"losses flash {klosses} vs plain {plosses}; every weight within "
        f"{TOL['float32']} (max abs diff {worst:.3g}); flash launches "
        f"{cfg.num_layers} per kernel and mask bitmaps {cfg.num_layers} per "
        f"step")
    del kmodel, pmodel, runs
    torch.cuda.empty_cache()
    return {"losses_flash": klosses, "losses_plain": plosses,
            "max_abs_weight_diff": worst}


def run_bert_timed(card: str):
    """The BERT example's main path: base, bf16, seq 512, batch 32, AdamW,
    10 timed steps; sequences/s, step ms, falling loss, peak memory, the
    step's share of the bf16 dense peak and one profiled step's device
    split. Returns its numbers and the flash launch counts of the run
    (the example passes no mask, so ``BertEncoder``'s all-true one: a
    bitmap a layer's forward). Then :func:`run_bert_padded` over real
    padding."""
    import torch

    from horovod_tpu_torch.examples import bert_pretraining as ex
    from horovod_tpu_torch.models.layers import Dense
    from horovod_tpu_torch.ops import attention as A

    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    out = ex.main(["--model", "base", "--seq-len", "512", "--batch-size",
                   "32", "--num-iters", "10"])
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    mask_launches = A.MASK_LAUNCHES["flash_mask_words"]
    if mask_launches != launches["flash_forward"]:
        raise AssertionError(
            f"bert training: {mask_launches} mask bitmaps for "
            f"{launches['flash_forward']} flash forwards (one each)")
    losses = out["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bert training: loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = out["model"].config
    dense = sum(m.weight.numel() for m in out["model"].modules()
                if isinstance(m, Dense))
    b, s = out["ids"].shape
    # 6 FLOPs per dense weight per token; attention's four S x S x hidden
    # products (QK^T, PV and their backward: twelve in all) per layer.
    flops = 6 * dense * b * s + 12 * b * s * s * cfg.hidden_size \
        * cfg.num_layers
    bound_ms = flops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    numbers = {"sequences_per_s": out["sequences_per_s"],
               "step_ms": out["step_ms"], "losses": losses,
               "peak_memory_gib": peak, "flash_launches": launches,
               "mask_launches": mask_launches,
               "dense_params": dense, "tflop_per_step": flops / 1e12,
               "bound_ms": bound_ms,
               "dense_peak_share": bound_ms / out["step_ms"]}
    log(f"bert training bf16 base seq 512 b=32 adamw: "
        f"{out['sequences_per_s']:.1f} sequences/s, step "
        f"{out['step_ms']:.3f} ms, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"peak memory {peak:.2f} GiB, {flops / 1e12:.3f} TFLOP per step "
        f"({dense / 1e6:.1f} M dense weights), bf16 bound {bound_ms:.3f} ms "
        f"= {bound_ms / out['step_ms']:.3f} of the step, flash launches "
        f"{launches} over 11 steps [{card}]")
    numbers["step_profile"] = profile_step(
        lambda: ex.train_step(out["model"], out["optimizer"], out["ids"],
                              out["mlm"]),
        out["step_ms"], TRANSFORMER_SPLIT, "flash", "bert-base")
    numbers["padded"] = run_bert_padded(out, card)
    del out
    torch.cuda.empty_cache()
    return numbers


def run_bert_padded(out, card: str, steps: int = 10):
    """BERT-base bf16 steps over real padding (:func:`padded_mask`, the
    ``bert_padded`` case's mask) through the example's model, optimizer
    and batch: one warm-up step, ``steps`` timed, sequences/s, and the
    profiled flash ms a step. One bitmap and one launch of each flash
    kernel a layer a step."""
    import torch

    from horovod_tpu_torch.models.bert import mlm_loss
    from horovod_tpu_torch.ops import attention as A

    model, opt, ids, mlm = (out[key] for key in ("model", "optimizer",
                                                   "ids", "mlm"))
    b, s = ids.shape
    padded = padded_mask(b, s, ids.device)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = mlm_loss(model(ids, attention_mask=padded,
                              deterministic=True), ids, mlm)
        loss.backward()
        opt.step()
        return loss.detach()

    float(step())
    A.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {**A.LAUNCHES, **A.MASK_LAUNCHES}
    want = model.config.num_layers * steps
    if set(launches.values()) != {want}:
        raise AssertionError(f"bert padded steps: launches {launches}, "
                             f"expected {want} each")
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bert padded steps: losses {losses}")
    allowed = int(padded.sum())
    numbers = {"sequences_per_s": b * 1e3 / step_ms, "step_ms": step_ms,
               "losses": losses, "launches": launches,
               "allowed_keys": allowed, "keys": padded.numel()}
    log(f"bert padded steps bf16 base seq {s} b={b} adamw ({allowed} of "
        f"{padded.numel()} keys allowed): {numbers['sequences_per_s']:.1f} "
        f"sequences/s, step {step_ms:.3f} ms, launches {launches} over "
        f"{steps} steps [{card}]")
    numbers["step_profile"] = profile_step(
        step, step_ms, TRANSFORMER_SPLIT, "flash", "bert-base padded")
    return numbers


# ---------------------------------------------------------------------------
# Phases 19-23: the MoE LM (MOE_SMALL) and the ViT example

# Device-time buckets of the MoE step: flash, matmuls (the experts' bmm,
# the dense projections, the head), routing and the row permutations
# (argmax, the integer cumsum, index/gather kernels), then "other". The
# name match also takes the embedding's lookup and backward and any
# indexing in the loss, so the profile lists every kernel of that bucket.
MOE_SPLIT = (
    ("flash", lambda n: re.search(FLASH_KERNELS, n)),
    ("matmul", lambda n: any(t in n for t in ("nvjet", "gemm", "gemv",
                                              "cutlass", "xmma"))),
    ("routing_gather", lambda n: any(t in n for t in (
        "index", "gather", "scatter", "scan", "cumsum", "argmax",
        "argm", "one_hot", "nonzero"))))


def moe_step_flops(cfg, b: int, s: int):
    """FLOPs of one MoE LM training step (forward and backward, 6 per
    weight per token; attention's QK^T and PV over the causal pairs, 12
    per pair per head width): ``(useful, padded)``. Useful counts the k
    routed assignments of every token; padded every capacity slot the
    experts compute (E x C rows at the training capacity factor)."""
    from horovod_tpu_torch.parallel.moe import _capacity

    d, hd = cfg.dim, cfg.dim // cfg.num_heads
    tokens = b * s
    attn_w = d * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    dense_ffn = 3 * d * cfg.ffn_hidden
    expert = 2 * d * cfg.expert_hidden
    routed = sum(cfg.routed(i) for i in range(cfg.num_layers))
    dense = cfg.num_layers * attn_w + (cfg.num_layers - routed) * dense_ffn \
        + routed * d * cfg.num_experts + d * cfg.vocab_size
    attn = 12 * b * (s * (s + 1) // 2) * cfg.num_heads * hd * cfg.num_layers
    slots = cfg.num_experts * _capacity(tokens, cfg.num_experts,
                                        cfg.capacity_factor,
                                        cfg.num_selected)
    base = 6 * dense * tokens + attn
    return (base + 6 * expert * routed * cfg.num_selected * tokens,
            base + 6 * expert * routed * slots)


class RoutingLog:
    """Each routed layer's decisions in a forward pass, taken from its
    input by a forward hook: the float32 router probabilities and each
    round's expert, as ``parallel.moe._route`` picks them."""

    def __init__(self, model):
        from horovod_tpu_torch.models.moe_lm import MoeFFN
        from horovod_tpu_torch.parallel.moe import _route

        self.calls = []
        cfg = model.config

        def hook(module, args, _out):
            import torch

            with torch.no_grad():
                x = args[0]
                probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                      @ module.gate.float(), -1)
                routing, _ = _route(probs, 1 << 30, cfg.num_selected, True,
                                    torch.float32)
            self.calls.append((probs, torch.stack(routing.expert_idx)))

        self.handles = [m.register_forward_hook(hook)
                        for m in model.modules() if isinstance(m, MoeFFN)]

    def close(self):
        for h in self.handles:
            h.remove()


def routing_flips(kernel_log, plain_log):
    """Per forward call of a routed layer, in order (steps x routed
    layers): ``(flips, decisions, smallest gap, largest gap)``, a flip
    being a decision (token, round) whose expert differs between the two
    runs and its gap the two experts' probability difference in the
    kernel run."""
    if len(kernel_log.calls) != len(plain_log.calls):
        raise AssertionError("routing logs of unequal length")
    rows = []
    for (pk, ek), (_, ep) in zip(kernel_log.calls, plain_log.calls):
        diff = (ek != ep).nonzero().tolist()
        gaps = [float((pk[t, ek[r, t]] - pk[t, ep[r, t]]).abs())
                for r, t in diff]
        rows.append((len(diff), ek.numel(), min(gaps) if gaps else None,
                     max(gaps) if gaps else None))
    return rows


# A routing flip at a larger probability gap fails. Held at the first
# routed layer of a step that has flips: a flip changes its token's
# output, and a capacity drop its neighbours', so the later layers' inputs
# differ by more than rounding and their flips follow from the first.
MOE_FLIP_GAP = 1e-5


def adamw_first_update(grad, eps: float):
    """AdamW's first step, bias-corrected, per unit of lr: g / (|g| + eps)
    (the sign of g wherever |g| >> eps)."""
    return grad / (grad.abs() + eps)


def run_moe_parity(steps: int = 2, batch: int = 8, seq: int = 1024):
    """MOE_SMALL float32 (TF32 off) at seq 1024, batch 8: ``steps`` steps
    through the flash kernels against as many through ``use_flash=False``
    from the same weights and batch, first with SGD (the loss to 1e-4
    relative and every weight within TOL, as phase 8), then with AdamW:
    the loss to 1e-4 relative at every step; at step 0, where both runs
    start from the same weights, every gradient within TOL, and every
    weight after the update within TOL plus AdamW's own spread of the
    two gradients, lr * |u_k - u_p| with u = g / (|g| + eps) (AdamW's first
    update is lr * u, the sign of g: a gradient element within rounding
    of zero can take either sign in the two runs and so moves its weight
    by up to 2 lr either way). After the last step the weights outside
    TOL are counted, by parameter, and their step-0 |g| and relative
    gradient difference reported beside every element's. Every routing decision of both
    runs is compared: at every step, a flip at the first routed layer
    with flips whose probability gap exceeds MOE_FLIP_GAP fails."""
    import torch

    from horovod_tpu_torch.examples import llama_training, moe_lm_training
    from horovod_tpu_torch.models.moe_lm import MOE_SMALL
    from horovod_tpu_torch.ops import attention as A

    cfg = dataclasses.replace(MOE_SMALL, dtype=torch.float32)
    ids = llama_training.batch_ids(cfg, batch, seq, "cuda")
    loss_fn = moe_lm_training.make_loss_fn(0.01)
    layers = cfg.num_layers
    tol = TOL["float32"]
    report = {}
    for opt_name in ("sgd", "adamw"):
        runs = {}
        step0, hyper = {}, None
        for use_flash in (True, False):
            model = moe_lm_training.make_model(cfg, no_flash=not use_flash,
                                               device="cuda")
            opt = llama_training.make_optimizer(opt_name, model)
            if opt_name == "adamw":
                hyper = {k: opt.param_groups[0][k] for k in ("lr", "eps")}
            routing = RoutingLog(model)
            losses = []
            for step in range(steps):
                A.reset_launch_counts()
                losses.append(float(llama_training.train_step(
                    model, opt, ids, loss_fn)))
                want = layers if use_flash else 0
                if set(A.LAUNCHES.values()) != {want}:
                    raise AssertionError(
                        f"moe parity step {step} (use_flash={use_flash}): "
                        f"flash launches {A.LAUNCHES}, expected {want}")
                if step == 0 and opt_name == "adamw":
                    # Both runs' gradients and weights after step 0.
                    step0[use_flash] = [
                        (name, p.grad.detach().clone(), p.detach().clone())
                        for name, p in model.named_parameters()]
            routing.close()
            runs[use_flash] = (model, losses, routing)
            del opt
        (kmodel, klosses, klog), (pmodel, plosses, plog) = (runs[True],
                                                            runs[False])
        rows = routing_flips(klog, plog)
        routed = len(rows) // steps
        first_flips = []
        for step in range(steps):
            hit = [r for r in rows[step * routed:(step + 1) * routed] if r[0]]
            first_flips.append(hit[0] if hit else None)
            if hit and hit[0][3] > MOE_FLIP_GAP:
                raise AssertionError(
                    f"moe parity ({opt_name}) step {step}: {hit[0][0]} "
                    f"routing flips at the first routed layer with any, "
                    f"the largest at a probability gap of {hit[0][3]:.3g} "
                    f"(> {MOE_FLIP_GAP})")
        flips = sum(r[0] for r in rows)
        decisions = sum(r[1] for r in rows)
        gaps = [g for r in rows for g in r[2:] if g is not None]
        gap_min = min(gaps) if gaps else None
        gap_max = max(gaps) if gaps else None
        for a, b in zip(klosses, plosses):
            if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(
                    f"moe parity ({opt_name}): losses {klosses} vs {plosses}")
        adamw = None
        if opt_name == "adamw":
            adamw = check_adamw_step0(step0, kmodel, pmodel, **hyper)
        del step0
        worst, outside, total = 0.0, 0, 0
        with torch.no_grad():
            for (name, p), (_, r) in zip(kmodel.named_parameters(),
                                         pmodel.named_parameters()):
                worst = max(worst, float((p - r).abs().max()))
                bad = (p - r).abs() > tol["atol"] + tol["rtol"] * r.abs()
                outside += int(bad.sum())
                total += p.numel()
                if opt_name == "sgd":
                    compare(p, r, "float32", f"moe parity weight {name}")
        report[opt_name] = {
            "losses_kernel": klosses, "losses_plain": plosses,
            "max_abs_weight_diff": worst,
            "weights_outside_tol": outside, "weights": total,
            "routing_decisions": decisions, "routing_flips": flips,
            "flip_gap_min": gap_min, "flip_gap_max": gap_max,
            "routing_by_layer": rows,
            "first_flipping_layer_by_step": first_flips, "adamw": adamw}
        log(f"moe parity: moe-small f32 seq {seq} b={batch}, {steps} "
            f"{opt_name} steps; losses kernel {klosses} vs plain {plosses}; "
            f"max abs weight diff {worst:.3g}, {outside} of {total} weights "
            f"outside {TOL['float32']} after the last step"
            f"{' (held: 0 allowed)' if opt_name == 'sgd' else ''}"
            f"; routing: {flips} of {decisions} decisions differ (gap "
            f"min {gap_min}, max {gap_max}; per step, the first routed "
            f"layer with flips: {first_flips}); flash launches {layers} "
            f"per kernel per step")
        if adamw is not None:
            log(f"moe parity adamw: {json.dumps(adamw)}")
        del kmodel, pmodel, runs, klog, plog
        torch.cuda.empty_cache()
    return report


def check_adamw_step0(step0, kmodel, pmodel, lr: float, eps: float):
    """Phase 19's AdamW holds (see :func:`run_moe_parity`): step 0's
    gradients within TOL, and step 0's weights within TOL plus
    lr * |u_k - u_p|. Then, for the weights outside TOL after the last
    step, their step-0 |g| (kernel run) and the two runs' relative
    gradient difference there, against every element's."""
    import torch

    tol = TOL["float32"]
    grad_diff = spread_excess = 0.0
    outside0 = 0
    by_param0, by_param = {}, {}
    g_abs, g_out, rel, rel_out = [], [], [], []
    with torch.no_grad():
        for (name, gk, wk), (_, gp, wp), (_, p), (_, r) in zip(
                step0[True], step0[False], kmodel.named_parameters(),
                pmodel.named_parameters()):
            compare(gk, gp, "float32", f"moe parity adamw step-0 gradient "
                                       f"{name}")
            grad_diff = max(grad_diff, float((gk - gp).abs().max()))
            limit = tol["atol"] + tol["rtol"] * wp.abs()
            spread = lr * (adamw_first_update(gk, eps)
                           - adamw_first_update(gp, eps)).abs()
            err = (wk - wp).abs()
            n0 = int((err > limit).sum())
            outside0 += n0
            if n0:
                by_param0[name] = n0
            spread_excess = max(spread_excess,
                                float((err - limit - spread).max()))
            # |g_k - g_p| / |g_k|: above 1 where the two signs may differ.
            ratio = ((gk - gp).abs() / gk.abs().clamp_min(1e-30)).flatten()
            bad = ((p - r).abs()
                   > tol["atol"] + tol["rtol"] * r.abs()).flatten()
            if bool(bad.any()):
                by_param[name] = [int(bad.sum()), p.numel()]
            g_abs.append(gk.abs().flatten())
            g_out.append(gk.abs().flatten()[bad])
            rel.append(ratio)
            rel_out.append(ratio[bad])
        if spread_excess > 0:
            raise AssertionError(
                f"moe parity adamw step 0: a weight differs by "
                f"{spread_excess:.3g} beyond TOL + lr |u_k - u_p|")
        g_abs, g_out = torch.cat(g_abs), torch.cat(g_out)
        rel, rel_out = torch.cat(rel), torch.cat(rel_out)

        def spread(t):
            return None if not t.numel() else {
                "median": float(t.median()), "max": float(t.max())}

        return {
            "lr": lr, "eps": eps,
            "step0_max_abs_grad_diff": grad_diff,
            "step0_grads_outside_tol": 0,
            "step0_weights_outside_tol": outside0,
            "step0_weights_beyond_tol_plus_lr_spread": 0,
            "step0_outside_by_param": by_param0,
            "last_step_weights_outside_tol": int(g_out.numel()),
            # [outside, size] of the 12 parameters with the most.
            "last_step_outside_by_param": dict(sorted(
                by_param.items(), key=lambda kv: -kv[1][0])[:12]),
            "last_step_params_with_outside": len(by_param),
            "step0_abs_grad": {"all": spread(g_abs), "at_outside":
                               spread(g_out)},
            "step0_rel_grad_diff": {"all": spread(rel),
                                    "at_outside": spread(rel_out)}}


def run_moe_training_timed(card: str):
    """The MoE training example's main path: moe-small, bf16, seq 1024,
    batch 8, AdamW, 10 timed steps: tokens/s, step ms, falling loss, peak
    memory, the share of the bf16 dense peak (useful FLOPs: the routed
    assignments; the capacity-padded count beside it) and a profiled pair
    of steps split into flash, matmuls, routing and gathers, and the rest.
    Returns its numbers and the flash launch counts of the run."""
    import torch

    from horovod_tpu_torch.examples import llama_training
    from horovod_tpu_torch.examples import moe_lm_training as ex
    from horovod_tpu_torch.ops import attention as A

    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    out = ex.main(["--model", "small", "--seq-len", "1024",
                   "--batch-size", "8", "--num-iters", "10"])
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    losses = out["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe training: loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    useful, padded = moe_step_flops(out["model"].config, 8, 1024)
    bound_ms = useful / PEAK_OPS_PER_S["bfloat16"] * 1e3
    numbers = {"tokens_per_s": out["tokens_per_s"],
               "step_ms": out["step_ms"], "losses": losses,
               "peak_memory_gib": peak, "flash_launches": launches,
               "tflop_per_step_useful": useful / 1e12,
               "tflop_per_step_capacity_padded": padded / 1e12,
               "bound_ms": bound_ms,
               "dense_peak_share": bound_ms / out["step_ms"],
               "dense_peak_share_padded": padded / useful * bound_ms
               / out["step_ms"]}
    log(f"moe training bf16 moe-small seq 1024 b=8 adamw: "
        f"{out['tokens_per_s']:.1f} tokens/s, step {out['step_ms']:.3f} ms, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, peak memory "
        f"{peak:.2f} GiB, {useful / 1e12:.3f} TFLOP per step useful "
        f"({padded / 1e12:.3f} capacity-padded), bf16 bound "
        f"{bound_ms:.3f} ms = {numbers['dense_peak_share']:.4f} of the step "
        f"({numbers['dense_peak_share_padded']:.4f} padded), flash launches "
        f"{launches} over 11 steps [{card}]")
    numbers["step_profile"] = profile_step(
        lambda: llama_training.train_step(out["model"], out["optimizer"],
                                          out["ids"], out["loss_fn"]),
        out["step_ms"], MOE_SPLIT, "flash", "moe-small",
        listed="routing_gather")
    del out
    torch.cuda.empty_cache()
    return numbers


# New tokens of phase 21's generation example runs (cut to 64 for the
# script's time limit; phase 15's Llama-300M rows keep the bench's 256).
MOE_GEN_NEW = 64


def run_moe_generation(card: str):
    """``generate()`` at MOE_SMALL in float32 through the decode kernel
    (tokens equal the einsum path's), then the generation example at
    ``--model moe-small``, bf16, prompt 128, ``MOE_GEN_NEW`` new, batch 8
    and 32: tokens/s and peak memory. Returns the numbers and the contiguous
    decode kernel's launches of the example's runs and of generate()."""
    import torch

    from horovod_tpu_torch.examples import llama_generation
    from horovod_tpu_torch.models.moe_lm import MOE_SMALL, MoeLM
    from horovod_tpu_torch.ops import decode_attention as ops

    cfg = dataclasses.replace(MOE_SMALL, dtype=torch.float32)
    model, gen_launches = run_generate(cfg, MoeLM, "moe-small")
    rows = {}
    ops.reset_launch_counts()
    for batch in (8, 32):
        out = llama_generation.main([
            "--model", "moe-small", "--prompt-len", "128",
            "--max-new-tokens", str(MOE_GEN_NEW), "--batch-size",
            str(batch)])
        tokens = out["out"]
        if tuple(tokens.shape) != (batch, 128 + MOE_GEN_NEW) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"moe generation example b={batch}: bad "
                                 f"output {tuple(tokens.shape)}")
        rows[f"b{batch}"] = {
            "tokens_per_s": out["tokens_per_s"], "seconds": out["seconds"],
            "peak_memory_gib": out["peak_memory_bytes"] / 2 ** 30}
        log(f"generation example moe-small bf16 p=128 n={MOE_GEN_NEW} "
            f"b={batch}: "
            f"{out['tokens_per_s']:.1f} decode tokens/s "
            f"({out['seconds']:.3f} s), peak memory "
            f"{rows[f'b{batch}']['peak_memory_gib']:.3f} GiB [{card}]")
        del out, tokens
        torch.cuda.empty_cache()
    launches = ops.LAUNCHES["decode_attention"]
    want = 2 * 2 * cfg.num_layers * (MOE_GEN_NEW - 1)
    if launches != want:
        raise AssertionError(f"moe generation example: decode_attention "
                             f"launched {launches} times, expected {want}")
    rows["bf16_tokens_vs_einsum"] = bf16_token_agreement()
    return model, rows, gen_launches, launches


def bf16_token_agreement(batch: int = 8, new: int = 32):
    """The generation example's bf16 model and prompt (MOE_SMALL, seed 0,
    prompt 128), ``new`` greedy tokens through the decode kernel and
    through ``decode_kernel_disabled()``: how many rows agree, and where
    each other row first differs. Reported, not held: in bf16 two
    logits within rounding of each other pick either token, and the rows
    part from there (the kernel itself is held at this shape in phase 2,
    ``moe_small_b8``)."""
    import torch

    from horovod_tpu_torch.examples.llama_generation import CONFIGS
    from horovod_tpu_torch.models.llama import (decode_kernel_disabled,
                                                generate)

    model_cls, cfg = CONFIGS["moe-small"]
    model = model_cls(cfg, device="cuda", seed=0)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, 128)))
    got = generate(model, prompt, max_new_tokens=new)[:, 128:]
    with decode_kernel_disabled():
        want = generate(model, prompt, max_new_tokens=new)[:, 128:]
    first = [None if torch.equal(g, w) else int((g != w).nonzero()[0])
             for g, w in zip(got, want)]
    # The first decode step's logits (a full forward over the prompt and
    # the first token, which both paths take from the same prefill): each
    # row's top-two gap in bf16 spacings at the top logit.
    with torch.inference_mode():
        logits = model(torch.cat([prompt.to(model.device), want[:, :1]],
                                 1))[:, -1]
    top2 = logits.float().topk(2, dim=-1).values
    _, exp = torch.frexp(top2[:, 0])
    spacing = torch.ldexp(torch.full_like(top2[:, 0], torch.finfo(
        logits.dtype).eps), exp - 1)
    out = {"dtype": str(cfg.dtype).replace("torch.", ""),
           "logits_dtype": str(logits.dtype).replace("torch.", ""),
           "batch": batch, "new_tokens": new,
           "rows_equal": first.count(None),
           "first_difference_by_row": first,
           "first_decode_top2_gap_in_spacings": (
               (top2[:, 0] - top2[:, 1]) / spacing).tolist(),
           "first_decode_step_vs_float32": first_step_against_float32(
               model)}
    log(f"moe-small bf16 greedy tokens, kernel vs einsum path: "
        f"{json.dumps(out)}")
    del model
    torch.cuda.empty_cache()
    return out


def first_step_against_float32(model, batch: int = 64, prompt_len=128):
    """One decode step of the bf16 ``model`` (``batch`` seeded prompts,
    then one seeded token each) through the decode kernel and through
    the einsum path, each against a float32 copy of the same weights
    (einsum path): the logits' max and RMS difference, the rows whose
    argmax agrees, the routing decisions of the new token that differ
    (of batch x top-k x routed layers), and layer 0's attention output,
    whose inputs the two bf16 paths share."""
    import torch

    from horovod_tpu_torch.models.llama import (decode_kernel_disabled,
                                                init_kv_cache)

    cfg32 = dataclasses.replace(model.config, dtype=torch.float32)
    ref = type(model)(cfg32, device="cuda", seed=0)
    ref.load_state_dict(model.state_dict())
    draw = np.random.RandomState(1).randint(
        0, cfg32.vocab_size, (batch, prompt_len + 1))
    ids = torch.from_numpy(draw[:, :-1]).to(model.device)
    token = torch.from_numpy(draw[:, -1]).to(model.device)
    s = prompt_len

    def step(m, kernel: bool):
        log_ = RoutingLog(m)
        # Layer 0's attention output: both bf16 paths share its inputs.
        seen = []
        hook = m.layers[0].attention.register_forward_hook(
            lambda _m, _a, o: seen.append(o.float()))
        with torch.inference_mode():
            cache = init_kv_cache(m.config, ids.shape[0], s + 1,
                                  device=m.device)
            m(ids, cache=cache, cache_index=0)
            log_.calls.clear()
            if kernel:
                logits, _ = m(token[:, None], cache=cache, cache_index=s)
            else:
                with decode_kernel_disabled():
                    logits, _ = m(token[:, None], cache=cache,
                                  cache_index=s)
        log_.close()
        hook.remove()
        return (logits[:, -1].float(), [e for _, e in log_.calls],
                seen[-1])

    want, want_routes, want_attn = step(ref, False)
    out = {"batch": batch, "routing_decisions": sum(
        r.numel() for r in want_routes)}
    for path in ("kernel", "einsum"):
        got, routes, attn = step(model, path == "kernel")
        err = got - want
        out[path] = {
            "layer0_attention_rms_diff": float(
                (attn - want_attn).pow(2).mean().sqrt()),
            "logits_max_abs_diff": float(err.abs().max()),
            "logits_rms_diff": float(err.pow(2).mean().sqrt()),
            "argmax_rows_equal": int((got.argmax(-1)
                                      == want.argmax(-1)).sum()),
            "routing_decisions_differing": int(sum(
                int((a != b).sum()) for a, b in zip(routes, want_routes)))}
    del ref
    torch.cuda.empty_cache()
    return out


def run_vit_timed(card: str):
    """The ViT example at the JAX row ``vit_s16_224_b64_adamw_spc8``:
    ViT-S/16, bf16, batch 64, 8 steps per call, one warm-up call and 3
    timed, with ``--attention xla`` then ``flash`` (non-causal at S=197):
    img/s each, and the flash kernels' launches of the flash run."""
    import torch

    from horovod_tpu_torch.examples import vit_training as ex
    from horovod_tpu_torch.ops import attention as A

    rows = {}
    for attention in ("xla", "flash"):
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        out = ex.main(["--model", "s16", "--batch-per-chip", "64",
                       "--steps", "4", "--warmup-steps", "1",
                       "--steps-per-call", "8", "--attention", attention])
        torch.cuda.synchronize()
        launches = dict(A.LAUNCHES)
        if not all(np.isfinite(out["losses"])):
            raise AssertionError(f"vit {attention}: loss {out['losses']}")
        want = 12 * 4 * 8 if attention == "flash" else 0
        if set(launches.values()) != {want}:
            raise AssertionError(f"vit {attention}: flash launches "
                                 f"{launches}, expected {want} each")
        rows[attention] = {
            "images_per_s": out["images_per_s"], "step_ms": out["step_ms"],
            "losses": out["losses"], "flash_launches": launches,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f"vit example s16 224px bf16 b=64 spc=8 --attention "
            f"{attention}: {out['images_per_s']:.1f} img/s, step "
            f"{out['step_ms']:.3f} ms, loss {out['losses'][0]:.4f} -> "
            f"{out['losses'][-1]:.4f}, peak memory "
            f"{rows[attention]['peak_memory_gib']:.2f} GiB, flash launches "
            f"{launches} [{card}]")
        del out
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phases 24-26: the parallel modes, on two ranks sharing the card
#
# NCCL refuses two ranks on one device, so the two worker processes form
# a gloo group on cuda:0 themselves (init_process_group before hvd.init,
# which then adopts it; HOROVOD_LOCAL_RANK=0 binds both to cuda:0). gloo
# carries CUDA tensors for allreduce, allgather, broadcast and alltoall;
# the neighbour exchange stages them through host memory (see
# horovod_tpu_torch/parallel/exchange.py).

PARALLEL_SP = ["--model", "300m", "--seq-len", "2048", "--seq-parallel",
               "2"]
PARALLEL_TP_PROFILE = ["--model", "300m", "--tp", "2", "--batch-size", "8",
                       "--prompt-len", "128", "--max-new-tokens", "64"]


def _counts():
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import decode_attention as D

    return {**A.LAUNCHES, **D.LAUNCHES}


def _reset_counts():
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import decode_attention as D

    A.reset_launch_counts()
    D.reset_launch_counts()


def _path(fn):
    """Run one main path with every launch count set to 0 just before
    and read just after; returns (its result, the counts)."""
    import torch

    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _counts()


def worker_sp_parity(rank: int, batch: int = 2, steps: int = 2):
    """Phase 24 parity: the pieces of ``llama_training --seq-parallel
    2`` (``make_model`` with ring attention over ``seq``,
    ``make_sp_loss_fn``, ``batch_ids`` and ``train_step``) in float32,
    SGD, ``steps`` steps through the kernels' backward and one more under
    ``HOROVOD_FLASH_XLA_BWD``, against the single-process run at the same
    global batch (rank 0 runs it after, on the full sequence): the loss
    to 1e-4 relative at every step, every weight within TOL."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.parallel import make_mesh

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32,
                              num_layers=PARITY_LAYERS)
    seq_len = int(PARALLEL_SP[PARALLEL_SP.index("--seq-len") + 1])
    mesh = make_mesh({"data": 1, "seq": 2})
    seq = mesh.group("seq")
    ring = ex.make_model(cfg, device="cuda", seq_group=seq)
    ring_opt = ex.make_optimizer("sgd", ring, mesh.group("data"))
    sp_loss = ex.make_sp_loss_fn(seq)
    ids = ex.batch_ids(cfg, batch, seq_len, "cuda", mesh)
    # One more step runs under HOROVOD_FLASH_XLA_BWD on both sides (37 b):
    # the ring's block pairs and the single process's flash differentiate
    # their dense forms, and no backward kernel launches.
    losses, counts = _path(lambda: [
        float(ex.train_step(ring, ring_opt, ids, sp_loss, seq))
        for _ in range(steps)])
    with flagged():
        flagged_loss, flagged_counts = _path(lambda: float(
            ex.train_step(ring, ring_opt, ids, sp_loss, seq)))
    losses.append(flagged_loss)
    if flagged_counts["flash_backward_dq"] or \
            flagged_counts["flash_backward_dkdv"] or \
            not flagged_counts["flash_forward"]:
        raise AssertionError(f"seq-parallel flagged step: launches "
                             f"{flagged_counts}")
    row = {"losses_ring": losses, "launches": counts,
           "flagged": {"launches": flagged_counts}}
    if rank == 0:
        model = ex.make_model(cfg, device="cuda")
        opt = ex.make_optimizer("sgd", model, mesh.group("data"))
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (batch, seq_len))).cuda()
        loss_fn = ex.make_loss_fn(0)
        ref = [float(ex.train_step(model, opt, ids, loss_fn))
               for _ in range(steps)]
        with flagged():
            ref.append(float(ex.train_step(model, opt, ids, loss_fn)))
        for a, b in zip(losses, ref):
            if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(f"seq-parallel parity: losses "
                                     f"{losses} vs {ref}")
        worst = 0.0
        with torch.no_grad():
            for (name, p), (_, r) in zip(ring.named_parameters(),
                                         model.named_parameters()):
                worst = max(worst, float((p - r).abs().max()))
                compare(p, r, "float32", f"seq-parallel parity weight {name}")
        row.update(losses_single=ref, max_abs_weight_diff=worst)
        del model, opt
    del ring, ring_opt
    dist.barrier()
    torch.cuda.empty_cache()
    return row


def _wall_ms(fn, repeats: int = 3) -> float:
    """Median host wall time of ``fn()`` with the card synchronised
    around it."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def sp_step_split(out):
    """Where a seq-parallel step's wall time goes: the forward alone,
    the gradient sum over ``seq`` alone (a float32 allreduce per
    parameter over gloo), and one K/V hop of a layer (host-staged), each timed apart
    on this rank."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.parallel.exchange import ring_exchange

    model, ids, group = out["model"], out["ids"], out["mesh"].group("seq")
    cfg = model.config
    kv = torch.zeros(ids.shape[0], ids.shape[1], cfg.num_kv_heads,
                     cfg.dim // cfg.num_heads, dtype=cfg.dtype,
                     device=ids.device)
    with torch.no_grad():
        forward = _wall_ms(lambda: out["loss_fn"](model, ids))
    return {"forward": forward,
            "gradient_sum": _wall_ms(lambda: ex.sum_gradients(model,
                                                              group)),
            "kv_hop": _wall_ms(lambda: ring_exchange([kv, kv], group))}


def worker_sp_timed(steps: int = 3, batch: int = 4):
    """Phase 24 timing: the seq-parallel example in bf16 (two ranks on
    one card), and the long-context example at its defaults, both
    layouts; the flash launches of each path."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.examples import long_context_ring_attention as lc

    out, counts = _path(lambda: ex.main(
        PARALLEL_SP + ["--batch-size", str(batch), "--num-iters",
                       str(steps)]))
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"seq-parallel bf16: losses {out['losses']}")
    row = {"tokens_per_s": out["tokens_per_s"], "step_ms": out["step_ms"],
           "losses": out["losses"], "batch": batch, "launches": counts,
           "split_ms": sp_step_split(out)}
    del out
    torch.cuda.empty_cache()
    for layout in ("contiguous", "zigzag"):
        rec, counts = _path(lambda: lc.main(["--layout", layout]))
        if not rec["finite"] or rec["out_shape"] != [1, 8192, 8, 64]:
            raise AssertionError(f"long context {layout}: {rec}")
        row[f"long_context_{layout}"] = {**rec, "launches": counts}
    return row


def tp_step_split(mesh, batch: int = 8, prompt_len: int = 128):
    """Where a TP token step's wall time goes: one bf16 Llama-300M token
    step over ``mesh``'s ``model`` axis (b8, after a 128-token prefill),
    and the collectives that step issues, recorded during one step and
    replayed alone on the same tensors (gloo, CUDA tensors)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM

    model = LlamaLM(LLAMA_300M, seed=0, mesh=mesh)
    cfg = model.config
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, prompt_len))).to(model.device)
    token = prompt[:, -1:]
    real = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}
    calls = []

    def recording(name):
        def fn(*args, **kwargs):
            calls.append((name, args, kwargs))
            return real[name](*args, **kwargs)
        return fn

    def step():
        model(token, cache=cache, cache_index=prompt_len)

    def collectives():
        for name, args, kwargs in calls:
            real[name](*args, **kwargs)

    with torch.inference_mode(), llama.decode_path_context("kernel_tp"):
        cache = llama.init_kv_cache(cfg, batch, prompt_len + 1,
                                    device=model.device,
                                    kv_heads=model.kv_heads)
        model(prompt, cache=cache, cache_index=0)
        step()
        for name in real:
            setattr(dist, name, recording(name))
        try:
            step()
        finally:
            for name, fn in real.items():
                setattr(dist, name, fn)
        issued = len(calls)
        step_ms = _wall_ms(step, repeats=9)
        collectives_ms = _wall_ms(collectives, repeats=9)
    del model, cache, calls[:]
    torch.cuda.empty_cache()
    return {"batch": batch, "step_ms": step_ms,
            "collectives_ms": collectives_ms, "collectives": issued}


def worker_tp(rank: int):
    """Phase 25: Llama-300M float32 (``PARITY_LAYERS`` deep) with tensor
    parallelism over the two ranks: ``generate()`` (b8, prompt 128, 32 new) and the engine (8
    requests) give the unsharded model's tokens, through both decode
    kernels on each rank's heads; then ``tp_decode_profile`` in bf16."""
    import torch

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.examples import tp_decode_profile
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM
    from horovod_tpu_torch.parallel import make_mesh

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32,
                              num_layers=PARITY_LAYERS)
    mesh = make_mesh({"data": 1, "model": 2})
    base = LlamaLM(cfg, seed=0)
    tp = LlamaLM(cfg, seed=0, mesh=mesh)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 128)))
    want = llama.generate(base, prompt, 32)
    got, gen_counts = _path(lambda: llama.generate(tp, prompt, 32))
    info = llama.LAST_DECODE_PATH
    if info.path != "kernel_tp" or not torch.equal(got, want):
        raise AssertionError(f"tp generate: path {info.path}; tokens equal "
                             f"{torch.equal(got, want)}")
    if gen_counts["decode_attention"] != cfg.num_layers * 31:
        raise AssertionError(f"tp generate: launches {gen_counts}")
    rng = np.random.RandomState(1)
    prompts = random_prompts(rng, 8, cfg.vocab_size, 32, 128)
    news = [int(rng.randint(8, 33)) for _ in prompts]
    scfg = serving.ServingConfig(max_batch=4, block_size=16, num_blocks=0,
                                 queue_depth=64, max_seq_len=256)
    engine = serving.ServingEngine(tp, scfg)
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    _, engine_counts = _path(engine.run_until_idle)
    steps = engine.stats()["steps"]
    if engine.decode_path.path != "kernel_tp" or \
            engine_counts["paged_decode_attention"] != cfg.num_layers * steps:
        raise AssertionError(f"tp engine: path {engine.decode_path.path}, "
                             f"launches {engine_counts} over {steps} steps")
    for i, (p, n, h) in enumerate(zip(prompts, news, handles)):
        ref = llama.generate(base, torch.from_numpy(p[None]), n)
        if h.result(timeout=0) != ref[0, len(p):].tolist():
            raise AssertionError(f"tp engine request {i} differs from the "
                                 "unsharded generate()")
    engine.shutdown()
    del base, tp, engine
    torch.cuda.empty_cache()
    profile, profile_counts = _path(
        lambda: tp_decode_profile.main(PARALLEL_TP_PROFILE))
    if profile["path"] != "kernel_tp":
        raise AssertionError(f"tp_decode_profile: {profile}")
    # One of the ~35 collectives of a TP decode step, alone: the sum
    # after a block's attention at b8 in bf16 (gloo, CUDA tensors).
    x = torch.ones(8, 1, cfg.dim, dtype=torch.bfloat16, device="cuda")
    profile["allreduce_ms"] = _wall_ms(
        lambda: torch.distributed.all_reduce(x, group=mesh.group("model")),
        repeats=25)
    profile["step_split"] = tp_step_split(mesh)
    return {"generate": {"path": info.path, "reason": info.reason,
                         "launches": gen_counts},
            "engine": {"requests": len(prompts), "steps": steps,
                       "launches": engine_counts},
            "profile": {**profile, "launches": profile_counts}}


def worker_pipeline(rank: int, features: int = 1024, layers: int = 2,
                    microbatches: int = 8, rows: int = 32):
    """Phase 26: GPipe and 1F1B over the two ranks (one stage each) equal
    the sequential stages on one rank: outputs, loss and every gradient
    in float32 within TOL."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.examples.pipeline_parallel import (make_stages,
                                                              stage_fn)
    from horovod_tpu_torch.parallel import make_mesh
    from horovod_tpu_torch.parallel.pipeline import (collect_from_last_stage,
                                                     pipeline_apply,
                                                     pipeline_loss)

    mesh = make_mesh({"pipe": 2})
    pipe, stage = mesh.group("pipe"), mesh.axis_index("pipe")
    rng = np.random.RandomState(0)
    stages = [{k: v.cuda() for k, v in s.items()}
              for s in make_stages(rng, 2, layers, features)]
    x = torch.from_numpy(rng.randn(microbatches, rows, features).astype(
        np.float32)).cuda()

    def mine():
        return {k: v.clone().requires_grad_() for k, v in stages[stage].items()}

    p = mine()
    out = pipeline_apply(stage_fn, p, x, group=pipe)
    full = collect_from_last_stage(out, pipe)
    loss = pipeline_loss((out ** 2).mean(dim=(1, 2)), pipe)
    loss.backward()
    gpipe_grads = {k: v.grad for k, v in p.items()}
    f1b_loss, f1b_grads = pipeline_apply(
        stage_fn, mine(), x, group=pipe, schedule="1f1b",
        loss_fn=lambda y: (y ** 2).mean())
    # The sequential reference, on every rank.
    ref_p = [{k: v.clone().requires_grad_() for k, v in s.items()}
             for s in stages]
    h = x
    for sp in ref_p:
        h = stage_fn(sp, h)
    ref_loss = (h ** 2).mean()
    ref_loss.backward()
    compare(full.detach(), h.detach(), "float32", "gpipe outputs")
    ref = float(ref_loss.detach())
    for what, got in (("gpipe", float(loss.detach())),
                      ("1f1b", float(f1b_loss))):
        if abs(got - ref) > 1e-6 * abs(ref):
            raise AssertionError(f"{what} loss {got} vs sequential {ref}")
    for k in ("w", "b"):
        compare(gpipe_grads[k], ref_p[stage][k].grad, "float32",
                f"gpipe grad {k} stage {stage}")
        compare(f1b_grads[k], ref_p[stage][k].grad, "float32",
                f"1f1b grad {k} stage {stage}")
    dist.barrier()
    return {"stages": 2, "features": features, "layers_per_stage": layers,
            "microbatches": microbatches, "rows": rows,
            "loss": ref}


# ---------------------------------------------------------------------------
# Phases 27-29: sharded training state

SHARDED_BATCH = 8                    # per rank, bf16 timed runs
SHARDED_SEQ = 1024
SHARDED_ITERS = 2                    # timed steps after one warm-up step


def _drop(model, *optimizers) -> None:
    """Release a finished run's card memory: every parameter, gradient
    and optimizer state emptied in place. ``del`` alone is not enough:
    ``DistributedOptimizer``'s gradient hooks and FSDP's units tie the
    objects into cycles that stay alive past ``gc.collect()`` here."""
    import torch

    for opt in optimizers:
        opt.state.clear()
        for group in opt.param_groups:
            for q in group["params"]:
                q.grad = None
                q.data = q.data.new_empty(0)
    for q in model.parameters():
        q.grad = None
        q.data = q.data.new_empty(0)
    torch.cuda.empty_cache()


def _fresh_peak() -> float:
    """Reset the peak; returns the GiB still allocated, which a run's
    peak is reported above."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 30


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _state_bytes(optimizer, matrices_only: bool = False) -> int:
    """Bytes of the tensor state ``optimizer`` holds on this rank
    (``matrices_only``: without the 0-d entries, Adam's ``step``)."""
    import torch

    return sum(v.numel() * v.element_size()
               for entry in optimizer.state.values() for v in entry.values()
               if torch.is_tensor(v) and (v.ndim > 0 or not matrices_only))


def expected_fsdp_bytes(cfg, specs, make_optimizer, n: int):
    """(parameter, state) bytes a rank holds under ``specs`` over ``n``
    ranks, from the spec functions on the model built on ``meta``."""
    import torch

    from horovod_tpu_torch.models.llama import LlamaLM
    from horovod_tpu_torch.torch.fsdp import (fsdp_state_specs,
                                              sharded_size_bytes)
    from horovod_tpu_torch.torch.partition import abstract_state

    with torch.device("meta"):
        model = LlamaLM(cfg, device="meta", param_dtype=torch.float32)
    params = dict(model.named_parameters())
    optimizer = make_optimizer(model.named_parameters())
    state = abstract_state(optimizer, {k: (p, tuple(p.shape), p.dtype)
                                       for k, p in params.items()})
    sspecs = fsdp_state_specs(optimizer, specs)
    axes = {"data": n}
    return (sharded_size_bytes(params, specs, axes),
            sharded_size_bytes(state, sspecs, axes))


def fsdp_step_split(model, optimizer, ids, step_ms: float):
    """Where an FSDP step's time goes, timed apart on this rank (both
    ranks run it: the collectives need their peer): one all-gather of
    every unit's shards, one reduce-scatter of every unit's gradient
    buffer, and the step's rest. A step gathers each block twice (its
    forward and its recompute) and the root once, and reduce-scatters
    each unit once."""
    import torch

    from horovod_tpu_torch.torch import fsdp
    from horovod_tpu_torch.torch.partition import reduce_scatter_rows

    units = [u for u in model._fsdp_units if u.entries]
    blocks = [u for u in units if u.recompute]
    root = [u for u in units if not u.recompute]

    def gather(us):
        with torch.no_grad():
            for u in us:
                fsdp._GatherFn.apply(u, *u.shards())

    bufs = [torch.zeros(u.n, sum(s.numel() for s in u.shards()),
                        device=ids.device) for u in units]

    def scatter():
        for u, b in zip(units, bufs):
            reduce_scatter_rows(b.clone(), u.group)

    g_blocks, g_root = _wall_ms(lambda: gather(blocks)), \
        _wall_ms(lambda: gather(root))
    rs = _wall_ms(scatter)
    gathers = 2 * g_blocks + g_root
    return {"step": step_ms, "gathers": gathers, "reduce_scatters": rs,
            "rest": step_ms - gathers - rs,
            "one_pass_gather_blocks": g_blocks, "gather_root": g_root}


def worker_fsdp(rank: int, ckpt_dir: str, batch: int = 2, steps: int = 2):
    """Phase 27 (and 29's commit): Llama-300M FSDP over the two ranks.
    Float32, two momentum-SGD steps through the example's pieces equal
    one process at the same global batch (rank 0 runs it after): the
    loss to 1e-4 relative, every weight within TOL; each rank's
    parameter, gradient and state bytes equal ``sharded_size_bytes``;
    the flash kernels on every layer (the forward twice: the block's
    recompute). ``State.commit`` with the sharded writer on saves the
    gathered weights after the last step (rank 0 checks the files in
    phase 29). Then the example in bf16, timed, with the per-rank peak
    memory, beside replicated ``DistributedOptimizer`` at the same batch."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import llama_fsdp_training as fx
    from horovod_tpu_torch.examples import llama_training as lx
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.ops import attention as A

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32,
                              num_layers=PARITY_LAYERS)
    specs = fx.make_specs(cfg, 2)

    def sgd(params):
        return torch.optim.SGD(params, lr=0.1, momentum=0.9)

    model = fx.make_model(cfg, specs, "cuda")
    opt = sgd(model.named_parameters())
    ids = fx.batch_ids(cfg, batch, SHARDED_SEQ, 2, rank, "cuda")
    state = hvd.elastic.State(step=0, params=model.full_state_dict())
    state.enable_sharded_checkpoint(ckpt_dir)
    losses, counts = _path(lambda: [
        float(hvd.allreduce(fx.train_step(model, opt, ids)))
        for _ in range(steps)])
    per_step = {"flash_forward": 2 * cfg.num_layers * steps,
                "flash_backward_dq": cfg.num_layers * steps,
                "flash_backward_dkdv": cfg.num_layers * steps}
    if any(counts[k] != v for k, v in per_step.items()):
        raise AssertionError(f"fsdp parity: flash launches {counts}, "
                             f"expected {per_step}")
    want_p, want_s = expected_fsdp_bytes(cfg, specs, sgd, 2)
    got = {"params": _bytes(model.parameters()),
           "grads": _bytes(p.grad for p in model.parameters()),
           "state": _state_bytes(opt)}
    if got != {"params": want_p, "grads": want_p, "state": want_s}:
        raise AssertionError(f"fsdp bytes {got}, sharded_size_bytes "
                             f"params {want_p} state {want_s}")
    full = model.full_state_dict()
    state.params = full
    state.step = steps
    t = time.perf_counter()
    state.commit()
    commit_ms = (time.perf_counter() - t) * 1e3
    if not state.flush_checkpoints(300.0):
        raise AssertionError("fsdp: the sharded writer did not drain")
    row = {"losses_fsdp": losses, "launches": counts, "bytes": got,
           "commit_ms": commit_ms}
    dist.barrier()                   # both ranks' shards are on disk
    if rank == 0:
        row["checkpoint"] = check_sharded_commit(ckpt_dir, full, steps)
    if rank == 0:
        ref = lx.make_model(cfg, device="cuda")
        ropt = sgd(ref.parameters())
        ref_ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (2 * batch, SHARDED_SEQ))).cuda()
        ref_losses = [float(fx.train_step(ref, ropt, ref_ids))
                      for _ in range(steps)]
        for a, b in zip(losses, ref_losses):
            if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(f"fsdp parity: losses {losses} vs "
                                     f"{ref_losses}")
        worst = 0.0
        for name, r in ref.state_dict().items():
            worst = max(worst, float((full[name] - r).abs().max()))
            compare(full[name], r, "float32", f"fsdp parity weight {name}")
        row.update(losses_single=ref_losses, max_abs_weight_diff=worst)
        _drop(ref, ropt)
        del ref, ropt
    state.close()
    _drop(model, opt)
    del model, opt, state, full
    dist.barrier()

    # bf16, timed: the example's main path, then replicated data
    # parallelism at the same batch (the training example's pieces, Adam).
    timed_args = ["--model", "300m", "--seq-len", str(SHARDED_SEQ),
                  "--batch-per-shard", str(SHARDED_BATCH), "--num-iters",
                  str(SHARDED_ITERS)]
    before = _fresh_peak()
    out, timed_counts = _path(lambda: fx.main(timed_args))
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"fsdp bf16: losses {out['losses']}")
    row["timed"] = {"tokens_per_s": out["tokens_per_s"],
                    "step_ms": out["step_ms"], "losses": out["losses"],
                    "batch_per_rank": SHARDED_BATCH,
                    "peak_memory_gib":
                        torch.cuda.max_memory_allocated() / 2 ** 30 - before,
                    "allocated_before_gib": before,
                    "launches": timed_counts,
                    "split_ms": fsdp_step_split(out["model"],
                                                out["optimizer"], out["ids"],
                                                out["step_ms"])}
    _drop(out["model"], out["optimizer"])
    del out
    row["replicated"] = replicated_timed(rank)
    row["replicated_remat"] = replicated_timed(rank, remat=True)
    return row


def replicated_timed(rank: int, optimizer: str = "adam",
                     steps: int = SHARDED_ITERS,
                     remat: bool = False):
    """Llama-300M bf16, seq 1024, the same per-rank batch, replicated
    parameters: Adam(3e-4) under ``DistributedOptimizer`` (``adam``) or
    under the ZeRO-1 wrapper (``zero``); ``remat``: each block
    recomputed in the backward, as FSDP's are. tok/s over both ranks,
    step ms, this rank's peak memory and optimizer-state bytes."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import llama_fsdp_training as fx
    from horovod_tpu_torch.examples import llama_training as lx
    from horovod_tpu_torch.models.llama import LLAMA_300M

    before = _fresh_peak()
    model = lx.make_model(dataclasses.replace(LLAMA_300M, remat=remat),
                          device="cuda")
    inner = torch.optim.Adam(model.parameters(), lr=3e-4)
    opt = (hvd.zero_sharded_optimizer(inner) if optimizer == "zero" else
           hvd.DistributedOptimizer(
               inner, named_parameters=model.named_parameters()))
    ids = fx.batch_ids(LLAMA_300M, SHARDED_BATCH, SHARDED_SEQ, 2, rank,
                       "cuda")
    loss_fn = lx.make_loss_fn(0)

    def step():
        return lx.train_step(model, opt, ids, loss_fn)

    losses = [float(step())]
    t = time.perf_counter()
    losses += [step() for _ in range(steps)]
    losses[-1] = float(hvd.allreduce(losses[-1]))
    dt = time.perf_counter() - t
    out = {"optimizer": optimizer, "remat": remat, "tokens_per_s":
           2 * SHARDED_BATCH * SHARDED_SEQ * steps / dt,
           "step_ms": dt / steps * 1e3,
           "losses": [float(x) for x in losses],
           "peak_memory_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30 - before,
           "allocated_before_gib": before,
           "state_bytes": _state_bytes(opt)}
    if optimizer == "zero":
        out["split_ms"] = zero_step_split(opt, out["step_ms"])
    elif not remat:
        out["profiled_step"] = profiled_comm_step(step, model, rank)
    _drop(model, opt, inner)
    del model, opt, inner
    return out


def profiled_comm_step(step, model, rank: int):
    """36 (a): one more step under ``hvd.profiler.trace``, its
    collectives read back out of the trace
    (``utils/comm_accounting.collectives``): one allreduce a gradient
    under ``hvd.allreduce.DistributedOptimizer.<i>``, billed at the
    group's 2 ranks, their payload the gradients' bytes exactly."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils.comm_accounting import (
        collective_records, count_by_op, payload_by_op,
        wire_bytes_per_device)

    with hvd.profiler.trace(trace_dir(f"comm{rank}")) as path:
        step()
        torch.cuda.synchronize()
    records = collective_records(path)
    os.remove(path)
    colls = [c for _, c, _ in records]
    params = [p for p in model.parameters() if p.requires_grad]
    grad_bytes = sum(p.numel() * p.element_size() for p in params)
    labels = {label for _, _, label in records}
    row = {"payload_by_op": payload_by_op(colls),
           "count_by_op": count_by_op(colls),
           "group_sizes": sorted({c.group_size for c in colls}),
           "labels": len(labels), "grad_bytes": grad_bytes,
           "ring_wire_bytes_per_device": wire_bytes_per_device(colls, 2)}
    want = {f"hvd.allreduce.DistributedOptimizer.{i}"
            for i in range(len(params))}
    if (row["payload_by_op"] != {"all-reduce": grad_bytes}
            or row["count_by_op"] != {"all-reduce": len(params)}
            or row["group_sizes"] != [2] or labels != want):
        raise AssertionError(f"36 (a) rank {rank}: the profiled step's "
                             f"collectives {json.dumps(row)}")
    return row


def zero_step_split(opt, step_ms: float):
    """A ZeRO step's collectives timed apart on this rank: the
    reduce-scatter of every gradient (one flat buffer a dtype) and the
    all-gather of the updated slices."""
    import torch

    from horovod_tpu_torch.torch.partition import (gather_rows,
                                                   reduce_scatter_rows)

    n = opt._world
    rows = torch.zeros(n, sum(s.numel() for _, s in opt._pairs),
                       device="cuda")
    flat = torch.zeros(rows.shape[1], device="cuda")
    rs = _wall_ms(lambda: reduce_scatter_rows(rows.clone(), opt._group))
    ag = _wall_ms(lambda: gather_rows(flat, opt._group))
    return {"step": step_ms, "reduce_scatter": rs, "all_gather": ag,
            "rest": step_ms - rs - ag}


def worker_zero(rank: int, batch: int = 2, steps: int = 2):
    """Phase 28: ZeRO-1 at Llama-300M over the two ranks. Float32, two
    Adam steps with ``zero_sharded_optimizer`` equal two with
    ``DistributedOptimizer`` on the same rank's batch (every weight
    within TOL, the loss to 1e-4 relative); the moments a rank holds are
    half the replicated optimizer's. Then bf16 timed, beside the
    replicated run of phase 27."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import llama_fsdp_training as fx
    from horovod_tpu_torch.examples import llama_training as lx
    from horovod_tpu_torch.models.llama import LLAMA_300M

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32,
                              num_layers=PARITY_LAYERS)
    ids = fx.batch_ids(cfg, batch, SHARDED_SEQ, 2, rank, "cuda")
    loss_fn = lx.make_loss_fn(0)
    runs = {}
    for kind in ("zero", "replicated"):
        model = lx.make_model(cfg, device="cuda")
        inner = torch.optim.Adam(model.parameters(), lr=1e-4)
        opt = (hvd.zero_sharded_optimizer(inner) if kind == "zero" else
               hvd.DistributedOptimizer(
                   inner, named_parameters=model.named_parameters()))
        losses, counts = _path(lambda: [
            float(hvd.allreduce(lx.train_step(model, opt, ids, loss_fn)))
            for _ in range(steps)])
        runs[kind] = (model, opt, losses, counts)
    (zm, zo, zl, zc), (rm, ro, rl, _) = runs["zero"], runs["replicated"]
    for a, b in zip(zl, rl):
        if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"zero parity: losses {zl} vs {rl}")
    worst = 0.0
    with torch.no_grad():
        for (name, p), (_, r) in zip(zm.named_parameters(),
                                     rm.named_parameters()):
            worst = max(worst, float((p - r).abs().max()))
            compare(p, r, "float32", f"zero parity weight {name}")
    z_state, r_state = _state_bytes(zo, True), _state_bytes(ro, True)
    if 2 * z_state != r_state:
        raise AssertionError(f"zero: moments {z_state} bytes on rank "
                             f"{rank}, replicated {r_state}")
    row = {"losses_zero": zl, "losses_replicated": rl,
           "max_abs_weight_diff": worst, "launches": zc,
           "moment_bytes": {"zero": z_state, "replicated": r_state},
           "state_bytes": {"zero": _state_bytes(zo),
                           "replicated": _state_bytes(ro)}}
    _drop(zm, zo)
    _drop(rm, ro)
    del runs, zm, zo, rm, ro, model, inner, opt
    timed, counts = _path(lambda: replicated_timed(rank, "zero"))
    row["timed"] = {**timed, "launches": counts}
    return row


def check_sharded_commit(ckpt_dir: str, full, step: int):
    """Phase 29, the disk tier: the newest complete sharded step holds
    the committed weights; every shard's digest, recomputed from the
    restored leaves, equals the manifest's, and every leaf equals the
    gathered weight, bitwise."""
    import torch

    from horovod_tpu_torch.utils import checkpoint as ckpt

    t = time.perf_counter()
    latest = ckpt.latest_sharded_checkpoint(ckpt_dir)
    if latest is None:
        raise AssertionError(f"sharded checkpoint: nothing complete under "
                             f"{ckpt_dir}")
    saved_step, manifest = latest
    like = {"params": full, "step": 0}
    got_step, tree = ckpt.restore_latest_sharded(ckpt_dir, like)
    flat, _ = ckpt.tree_flatten(tree)
    digests = [ckpt.shard_digest([flat[i] for i in ids])
               for ids in manifest["layout"]]
    if digests != manifest["digests"] or got_step != saved_step:
        raise AssertionError(f"sharded checkpoint: digests {digests} vs "
                             f"manifest {manifest['digests']}")
    if tree["step"] != step or any(not torch.equal(tree["params"][k], v)
                                   for k, v in full.items()):
        raise AssertionError("sharded checkpoint: restored leaves differ "
                             "from the committed weights")
    return {"step": saved_step, "world_size": manifest["world_size"],
            "shards": len(manifest["layout"]), "leaves": len(flat),
            "bytes": sum(ckpt.leaf_nbytes(x) for x in flat
                         if ckpt.is_array(x)),
            "digests_equal": True, "restore_ms":
                (time.perf_counter() - t) * 1e3}


def _host_tree(tree):
    from horovod_tpu_torch.utils import checkpoint as ckpt

    leaves, structure = ckpt.tree_flatten(tree)
    return ckpt.tree_unflatten(structure, [
        leaf.detach().cpu().clone() if hasattr(leaf, "detach") else leaf
        for leaf in leaves])


def run_checkpoint_resume(card: str):
    """Phase 29: ``examples.imagenet_resnet50`` at ResNet-50 bf16, b64,
    224², 3 steps with a checkpoint at step 2, then the same command
    again, which resumes there: the restored tree equals what was saved,
    bitwise, and the resumed run's last step equals the first run's,
    with cuDNN deterministic for the check."""
    import shutil
    import tempfile

    import torch

    from horovod_tpu_torch.examples import imagenet_resnet50 as ex
    from horovod_tpu_torch.utils import checkpoint as ckpt

    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    args = ["--batch-per-chip", "64", "--steps", "3", "--checkpoint-every",
            "2", "--checkpoint-dir", directory]
    saved = {}
    save = ex.save_checkpoint

    def keep(path, tree):
        save(path, tree)
        saved[path] = _host_tree(tree)

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    ex.save_checkpoint = keep
    try:
        t = time.perf_counter()
        first = ex.main(args)
        first_s = time.perf_counter() - t
        ex.save_checkpoint = save
        (path, tree), = saved.items()
        t = time.perf_counter()
        restored = ckpt.restore_checkpoint(path)
        restore_s = time.perf_counter() - t
        a, sa = ckpt.tree_flatten(tree)
        b, sb = ckpt.tree_flatten(restored)
        if sa != sb or any(
                not (torch.equal(x, y) if torch.is_tensor(x) else x == y)
                for x, y in zip(a, b)):
            raise AssertionError("checkpoint: the restored tree differs "
                                 "from what was saved")
        nbytes = sum(x.numel() * x.element_size() for x in a
                     if torch.is_tensor(x))
        second = ex.main(args)
    finally:
        ex.save_checkpoint = save
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
        shutil.rmtree(directory, ignore_errors=True)
    if second["start_step"] != 2 or len(second["losses"]) != 1:
        raise AssertionError(f"checkpoint: the second run started at "
                             f"{second['start_step']}")
    worst, bitwise = 0.0, True
    with torch.no_grad():
        for (name, p), (_, q) in zip(first["model"].named_parameters(),
                                     second["model"].named_parameters()):
            bitwise &= torch.equal(p, q)
            worst = max(worst, float((p - q).abs().max()))
            compare(q, p, "float32", f"resumed step, weight {name}")
    row = {"saved_bytes": nbytes, "restore_s": restore_s,
           "first_run_s": first_s, "losses_first": first["losses"],
           "loss_resumed": second["losses"], "bitwise_equal": bitwise,
           "max_abs_weight_diff": worst}
    log(f"checkpoint resume: resnet50 bf16 b64, saved at step 2 "
        f"({nbytes / 2 ** 20:.1f} MiB, restored bitwise equal in "
        f"{restore_s:.2f} s); the resumed step 3 equals the first run's "
        f"(bitwise {bitwise}, max abs diff {worst:.3g}; cuDNN "
        f"deterministic) [{card}]")
    del first, second
    torch.cuda.empty_cache()
    return row


def parallel_worker(rank: int, port: int, out_path: str) -> int:
    """One of the two ranks of phases 24-26 (``chip_smoke.py
    --parallel-worker RANK PORT OUT``); rank 0 writes the JSON."""
    import datetime

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=600))
    hvd.init()
    if hvd.device() != torch.device("cuda", 0) or hvd.size() != 2:
        raise AssertionError(f"worker {rank}: device {hvd.device()}, "
                             f"size {hvd.size()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    ckpt_dir = os.path.join(os.path.dirname(out_path), "sharded_ckpt")
    for label, fn in (("24 sp parity", lambda: worker_sp_parity(rank)),
                      ("24 sp timed", worker_sp_timed),
                      ("25 tp", lambda: worker_tp(rank)),
                      ("26 pipeline", lambda: worker_pipeline(rank)),
                      ("27 fsdp", lambda: worker_fsdp(rank, ckpt_dir)),
                      ("28 zero", lambda: worker_zero(rank))):
        t = time.perf_counter()
        results[label] = fn()
        results[label]["wall_s"] = time.perf_counter() - t
        log(f"rank {rank} phase {label}: "
            f"{results[label]['wall_s']:.1f} s")
    # Every rank's launch counts, per path.
    results["counts_by_rank"] = hvd.allgather_object(
        {label: _launch_rows(row) for label, row in results.items()})
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
    log(f"rank {rank}: worker ok")
    return 0


def _launch_rows(row):
    """Every ``launches`` dict in a phase's result, by key path."""
    found = {}
    if isinstance(row, dict):
        for key, value in row.items():
            if key == "launches":
                found[""] = value
            else:
                for sub, counts in _launch_rows(value).items():
                    found[f"{key}/{sub}".rstrip("/")] = counts
    return found


def run_parallel_phases(card: str):
    """Phases 24-26 on two ranks sharing the card (see above): returns
    the workers' results."""
    import tempfile

    import torch

    torch.cuda.empty_cache()
    port = free_port()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    out_path = os.path.join(out_dir, "parallel.json")
    procs = []
    try:
        for rank in range(2):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
            env.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                       HOROVOD_LOCAL_RANK="0", HOROVOD_LOCAL_SIZE="1",
                       PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--parallel-worker", str(rank), str(port), out_path],
                env=env))
        codes = [proc.wait(timeout=900) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if codes != [0, 0]:
        raise AssertionError(f"parallel workers exited {codes}")
    with open(out_path) as f:
        results = json.load(f)
    shutil.rmtree(out_dir, ignore_errors=True)
    sp = results["24 sp parity"]
    log(f"seq-parallel parity: llama300m f32 ({PARITY_LAYERS} layers) seq "
        f"2048 sp 2 b=2, 2 SGD steps through the kernels' backward and "
        f"one under HOROVOD_FLASH_XLA_BWD; losses ring {sp['losses_ring']} "
        f"vs single process {sp['losses_single']}; every weight within "
        f"{TOL['float32']} (max abs diff {sp['max_abs_weight_diff']:.3g})")
    timed = results["24 sp timed"]
    log(f"seq-parallel training bf16 llama300m seq 2048 sp 2 b=4 (two "
        f"ranks sharing one card): {timed['tokens_per_s']:.1f} tokens/s, "
        f"step {timed['step_ms']:.1f} ms, losses {timed['losses']}; rank 0 "
        f"split (ms): {json.dumps(timed['split_ms'])} [{card}]")
    for layout in ("contiguous", "zigzag"):
        rec = timed[f"long_context_{layout}"]
        log(f"long context ring S=8192 H=8 D=64 bf16 {layout} (two ranks "
            f"sharing one card): {rec['ms_per_iter']:.2f} ms/iter, "
            f"{rec['tflops']:.2f} TFLOP/s [{card}]")
    tp = results["25 tp"]
    log(f"tp: llama300m f32 ({PARITY_LAYERS} layers) tp 2 generate and "
        f"engine ({tp['engine']['requests']} "
        f"requests, {tp['engine']['steps']} steps) equal the unsharded "
        f"model; path {tp['generate']['path']} ({tp['generate']['reason']})")
    prof = tp["profile"]
    log(f"tp_decode_profile bf16 llama300m b8 p128 n64, two ranks sharing "
        f"one card: tp {prof['tok_s_tp']:.1f} tok/s, unsharded "
        f"{prof['tok_s_single_device']:.1f} tok/s per rank, parity "
        f"mismatches {prof['token_parity_mismatches']}; one gloo allreduce "
        f"of (8, 1, 1024) bf16 {prof['allreduce_ms']:.3f} ms; rank 0 token "
        f"step split: {json.dumps(prof['step_split'])} [{card}]")
    log(f"pipeline: {json.dumps(results['26 pipeline'])}")
    log_sharded(results, card)
    return results


def log_sharded(results, card: str):
    """Phases 27-29's lines, from the two ranks' results."""
    fsdp, zero = results["27 fsdp"], results["28 zero"]
    log(f"fsdp parity: llama300m f32 ({PARITY_LAYERS} layers) seq "
        f"{SHARDED_SEQ} dp 2 b=2 a rank, 2 "
        f"momentum-SGD steps; losses fsdp {fsdp['losses_fsdp']} vs single "
        f"process {fsdp['losses_single']}; every weight within "
        f"{TOL['float32']} (max abs diff {fsdp['max_abs_weight_diff']:.3g});"
        f" rank 0 bytes {json.dumps(fsdp['bytes'])} == sharded_size_bytes; "
        f"flash launches {json.dumps(fsdp['launches'])}")
    ck = fsdp["checkpoint"]
    log(f"sharded checkpoint (phase 29): State.commit of the gathered "
        f"weights, step {ck['step']}, {ck['shards']} shards, "
        f"{ck['bytes'] / 2 ** 20:.1f} MiB; digests recomputed from the "
        f"restored leaves equal the manifest's; commit {fsdp['commit_ms']:.1f}"
        f" ms on the step loop")
    log(f"zero-1 parity: llama300m f32 ({PARITY_LAYERS} layers) dp 2, 2 "
        f"Adam steps; losses zero "
        f"{zero['losses_zero']} vs DistributedOptimizer "
        f"{zero['losses_replicated']}; max abs weight diff "
        f"{zero['max_abs_weight_diff']:.3g}; moments a rank "
        f"{json.dumps(zero['moment_bytes'])}")
    for label, row in (("fsdp", fsdp["timed"]),
                       ("replicated", fsdp["replicated"]),
                       ("replicated remat", fsdp["replicated_remat"]),
                       ("zero-1", zero["timed"])):
        log(f"{label} bf16 llama300m seq {SHARDED_SEQ} b{SHARDED_BATCH} a "
            f"rank, dp 2 (two ranks sharing one card): "
            f"{row['tokens_per_s']:.1f} tokens/s, step {row['step_ms']:.1f} "
            f"ms, rank 0 peak memory {row['peak_memory_gib']:.2f} GiB above "
            f"the {row['allocated_before_gib']:.2f} allocated before; "
            f"split (ms) {json.dumps(row.get('split_ms'))} [{card}]")
    log(f"36 (a) a profiled replicated step's collectives, read from the "
        f"trace (rank 0): "
        f"{json.dumps(fsdp['replicated']['profiled_step'])}")


# ---------------------------------------------------------------------------
# Phase 30: the eager-tier controller on the card (two ranks, horovodrun)


CONTROLLER_BATCH_PARITY = 2          # per rank, float32 parity
CONTROLLER_SEQ = 1024


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (floats compared as their bytes)."""
    import torch

    a, b = a.detach().cpu(), b.detach().cpu()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def pairwise_sum(x, average: bool):
    """The sum a plane of this job computes of every rank's ``x`` (CPU),
    gathered through the gloo group: adjacent ranks first, then adjacent
    pairs — at two ranks the star's rank-order sum, at four in two groups
    of two the two-level plane's (group sums, then their sum); each add
    rounds in the dtype as the planes' do. Averaged as the planes
    average."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.common.reduction import average as mean
    from horovod_tpu_torch.controller.controller import _host_sum

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    n = len(parts)
    while len(parts) > 1:
        parts = [_host_sum(parts[i], parts[i + 1])
                 for i in range(0, len(parts), 2)]
    return mean(parts[0], n) if average else parts[0]


def controller_collectives(rank: int, ctl):
    """Phase 30 (a), 31 (a) and (e): CUDA tensors through the eager tier
    against CPU copies through it, against the sum order of its plane
    (:func:`pairwise_sum`) and, at two ranks, against the gloo group,
    bitwise."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    world = dist.group.WORLD
    size = dist.get_world_size()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(300 + rank)
    checked = []

    def check(what, card, host, ref):
        if card.device != dev:
            raise AssertionError(f"{what}: result on {card.device}")
        if not (_same_bits(card, host) and _same_bits(host, ref)):
            raise AssertionError(
                f"{what}: card {card.flatten()[:4].tolist()} host "
                f"{host.flatten()[:4].tolist()} reference "
                f"{ref.flatten()[:4].tolist()}")
        checked.append(what)

    inputs = {
        "float32": torch.from_numpy(rng.randn(1 << 16).astype(np.float32)),
        "bfloat16": torch.from_numpy(
            rng.randn(1 << 16).astype(np.float32) * 3).bfloat16(),
        "int32": torch.from_numpy(
            rng.randint(-1000, 1000, 1 << 16).astype(np.int32)),
    }
    for dtype, x in inputs.items():
        for avg in (False, True):
            label = f"allreduce {dtype} {'average' if avg else 'sum'}"
            card = hvd.allreduce(x.to(dev), average=avg, name=label)
            host = hvd.allreduce(x, average=avg, name=label + " cpu")
            torch.cuda.synchronize()
            if card.dtype != x.dtype:
                raise AssertionError(f"{label}: dtype {card.dtype}")
            check(label, card, host, pairwise_sum(x, avg))
            if size == 2:
                check(label + " (gloo)", card, host,
                      hvd.allreduce(x, average=avg, group=world))
    x = inputs["float32"]
    y = x.to(dev, copy=True)
    got = hvd.allreduce_(y, average=False, name="in-place")
    if got is not y:
        raise AssertionError("allreduce_ returned a new tensor")
    check("allreduce_ in place", y,
          hvd.allreduce(x, average=False, name="in-place cpu"),
          pairwise_sum(x, False))
    part = torch.from_numpy(rng.randn(rank + 3, 5).astype(np.float32))
    check("allgather uneven first dims",
          hvd.allgather(part.to(dev), name="gather"),
          hvd.allgather(part, name="gather cpu"),
          hvd.allgather(part, group=world))
    ref = x.clone()
    dist.broadcast(ref, src=1)
    check("broadcast root 1", hvd.broadcast(x.to(dev), 1, name="bcast"),
          hvd.broadcast(x, 1, name="bcast cpu"), ref)
    small = [torch.from_numpy(rng.randn(100 + i).astype(np.float32))
             for i in range(64)]
    before = ctl.counters()
    cards = hvd.grouped_allreduce([t.to(dev) for t in small], name="g64")
    torch.cuda.synchronize()
    after = ctl.counters()
    fused = after["responses"] - before["responses"]
    hosts = hvd.grouped_allreduce(small, name="g64 cpu")
    for i, (card, host) in enumerate(zip(cards, hosts)):
        check(f"grouped {i}", card, host, pairwise_sum(small[i], True))
    if not fused < 64:
        raise AssertionError(f"64 tensors in {fused} responses")
    return {"checked": len(checked), "grouped_responses": fused,
            "grouped_tensors": after["tensors"] - before["tensors"]}


def controller_parity(rank: int, steps: int = 2):
    """Phase 30 (b): Llama-300M float32, seq 1024, b2 a rank, AdamW:
    ``DistributedOptimizer`` through the controller against the same
    steps through the gloo group."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.examples import llama_fsdp_training as fx
    from horovod_tpu_torch.examples import llama_training as lx
    from horovod_tpu_torch.models.llama import LLAMA_300M

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32,
                              num_layers=PARITY_LAYERS)
    ids = fx.batch_ids(cfg, CONTROLLER_BATCH_PARITY, CONTROLLER_SEQ, 2, rank,
                       "cuda")
    loss_fn = lx.make_loss_fn(0)
    runs = {}
    for label, group in (("controller", None),
                         ("group", dist.group.WORLD)):
        model = lx.make_model(cfg, device="cuda")
        opt = lx.make_optimizer("adamw", model, group=group)
        losses = [float(lx.train_step(model, opt, ids, loss_fn))
                  for _ in range(steps)]
        runs[label] = (losses, {n: p.detach().cpu()
                                for n, p in model.named_parameters()})
        _drop(model, opt)
        del model, opt
    (closs, cw), (gloss, gw) = runs["controller"], runs["group"]
    for a, b in zip(closs, gloss):
        if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"controller parity: losses {closs} vs "
                                 f"{gloss}")
    worst = 0.0
    for name in sorted(cw):
        worst = max(worst, float((cw[name] - gw[name]).abs().max()))
        compare(cw[name], gw[name], "float32",
                f"controller parity weight {name}")
    return {"losses_controller": closs, "losses_group": gloss,
            "max_abs_weight_diff": worst}


def controller_timed(rank: int, ctl, steps: int = 3):
    """Phase 30 (c): Llama-300M bf16 (f32 weights), seq 1024, b8 a rank,
    AdamW through the controller: one warm step, then ``steps`` timed
    ones, each with its host wall time, the controller's counters and
    the flash launches."""
    import torch

    from horovod_tpu_torch.examples import llama_fsdp_training as fx
    from horovod_tpu_torch.examples import llama_training as lx
    from horovod_tpu_torch.models.llama import LLAMA_300M

    model = lx.make_model(LLAMA_300M, device="cuda")
    opt = lx.make_optimizer("adamw", model)
    ids = fx.batch_ids(LLAMA_300M, SHARDED_BATCH, SHARDED_SEQ, 2, rank,
                       "cuda")
    loss_fn = lx.make_loss_fn(0)
    grads = sum(1 for p in model.parameters() if p.requires_grad)
    rows = []
    for step in range(steps + 1):
        torch.cuda.synchronize()
        before = ctl.counters()
        _reset_counts()
        t = time.perf_counter()
        loss = float(lx.train_step(model, opt, ids, loss_fn))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after = ctl.counters()
        rows.append({"step": step, "loss": loss, "wall_s": wall,
                     "launches": _counts(),
                     **{k: after[k] - before[k] for k in sorted(after)}})
    timed = rows[1:]
    wall = sum(r["wall_s"] for r in timed)
    for r in timed:
        if r["cache_hits"] != grads or r["tensors"] != grads:
            raise AssertionError(
                f"step {r['step']}: {r['cache_hits']} cache hits, "
                f"{r['tensors']} tensors, {grads} gradients")
    from horovod_tpu_torch.ops import attention as A

    for r in rows:
        if any(r["launches"][n] != LAYERS for n in A.LAUNCHES):
            raise AssertionError(f"step {r['step']}: flash launches "
                                 f"{r['launches']}")
    if not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"losses {[r['loss'] for r in rows]}")
    _drop(model, opt)
    del model, opt
    return {"gradients": grads, "steps": rows,
            "tokens_per_s": 2 * SHARDED_BATCH * SHARDED_SEQ * steps / wall,
            "step_s": wall / steps,
            "launches": {n: sum(r["launches"][n] for r in rows)
                         for n in rows[0]["launches"]}}


def int8_steps(rank: int, ctl, steps: int = 2):
    """Phase 31 (d): Llama-300M bf16 (f32 weights), seq 1024, b2 a rank,
    AdamW through the native engine under the int8 wire: the loss of the
    second step (after the first update, same batch) is below the
    first's, and the error-feedback residuals the engine's ring wrote are
    non-zero."""
    import torch

    from horovod_tpu_torch.examples import llama_fsdp_training as fx
    from horovod_tpu_torch.examples import llama_training as lx
    from horovod_tpu_torch.models.llama import LLAMA_300M

    model = lx.make_model(LLAMA_300M, device="cuda")
    opt = lx.make_optimizer("adamw", model)
    ids = fx.batch_ids(LLAMA_300M, CONTROLLER_BATCH_PARITY, CONTROLLER_SEQ,
                       2, rank, "cuda")
    loss_fn = lx.make_loss_fn(0)
    losses = [float(lx.train_step(model, opt, ids, loss_fn))
              for _ in range(steps)]
    torch.cuda.synchronize()
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    res = {n: ctl.residual(n) for n in names}
    nonzero = sum(1 for r in res.values()
                  if r is not None and float(r.abs().max()) > 0)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"int8 wire: losses {losses}")
    if nonzero == 0:
        raise AssertionError("int8 wire: every residual is zero or absent")
    from horovod_tpu_torch.core import bindings

    wire = bindings.wire_stats()
    _drop(model, opt)
    del model, opt
    return {"losses": losses, "gradients": len(names),
            "nonzero_residuals": nonzero,
            "residual_max": max(float(r.abs().max()) for r in res.values()
                                if r is not None),
            "tx_bytes_int8": wire["tx_bytes"]["int8"],
            "logical_bytes_int8": wire["logical_bytes"]["int8"]}


def controller_worker(out_path: str, mode: str = "train") -> int:
    """One rank of phases 30 and 31 (``horovodrun -np N ... chip_smoke.py
    --controller-worker OUT MODE``): the ranks share ``cuda:0`` over a
    gloo group built here (NCCL refuses two ranks on one device);
    ``init()`` adopts it and starts the eager tier the environment asks
    for. ``MODE``: ``train`` runs (a)-(c), ``int8`` phase 31 (d),
    ``collectives`` (a) alone, ``timed`` (c) alone with three timed steps
    (:func:`compare_planes`). Rank 0 writes the JSON."""
    import datetime

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics, config

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    rank = int(os.environ["HOROVOD_RANK"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{config.spmd_coordinator()}", rank=rank,
        world_size=int(os.environ["HOROVOD_SIZE"]),
        timeout=datetime.timedelta(seconds=600))
    hvd.init(device="cuda:0")
    ctl = basics.controller()
    if ctl is None or hvd.device() != torch.device("cuda", 0):
        raise AssertionError(f"rank {rank}: controller {ctl}, device "
                             f"{hvd.device()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Two timed steps on every plane: the script's time limit holds
    # phase 32 too.
    steps = 2
    parts = {
        "train": (("a", lambda: controller_collectives(rank, ctl)),
                  ("b", lambda: controller_parity(rank)),
                  ("c", lambda: controller_timed(rank, ctl, steps))),
        "int8": (("d", lambda: int8_steps(rank, ctl)),),
        "timed": (("c", lambda: controller_timed(rank, ctl, 3)),),
        "collectives": (("a", lambda: controller_collectives(rank, ctl)),),
    }[mode]
    results = {"engine": type(ctl).__name__,
               "ring": getattr(ctl, "_ring", None) is not None,
               "hierarchical": bool(
                   getattr(ctl, "hierarchical_active", False)
                   or getattr(ctl, "_local_ring", None) is not None)}
    for label, fn in parts:
        t = time.perf_counter()
        results[label] = fn()
        results[label]["wall_s"] = time.perf_counter() - t
        log(f"rank {rank} {mode} ({label}), {results['engine']}: "
            f"{results[label]['wall_s']:.1f} s")
    results["by_rank"] = hvd.allgather_object(
        {"c": results.get("c"), "counters": ctl.counters()})
    hvd.shutdown()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)
    log(f"rank {rank}: controller worker ok")
    return 0


TIMELINE_ACTIVITIES = ("MEMCPY_IN_FUSION_BUFFER", "TCP_COLLECTIVE",
                       "MEMCPY_OUT_FUSION_BUFFER")


def timeline_counts(path: str):
    """Rank 0's timeline, parsed: begin events by name."""
    with open(path) as f:
        events = json.load(f)
    counts = {}
    for ev in events:
        if ev.get("ph") == "B":
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    return counts


def check_timeline(counts):
    """Rank 0's timeline (the Python controller's) holds, per executed
    allreduce response, the fusion-buffer copies and the exchange; the
    card's responses also their copies to and from the host (the CPU
    copies of (a) have none); and negotiations."""
    allreduces = counts.get("ALLREDUCE", 0)
    card = counts.get("MEMCPY_D2H", 0)
    if not allreduces or any(counts.get(a, 0) != allreduces
                             for a in TIMELINE_ACTIVITIES) \
            or not 0 < card == counts.get("MEMCPY_H2D") < allreduces \
            or not counts.get("NEGOTIATE_ALLREDUCE"):
        raise AssertionError(f"timeline: {counts}")
    return counts


def hmac_rate(nbytes: int = 1 << 28) -> float:
    """GB/s of one thread's HMAC-SHA256 on this host: the wire's digest
    over each DATA frame's payload."""
    import hashlib
    import hmac

    data = bytes(nbytes)
    t = time.perf_counter()
    hmac.new(bytes(32), data, hashlib.sha256).digest()
    return nbytes / (time.perf_counter() - t) / 1e9


def launch_eager_job(mode: str, env_extra: dict, np_: int = 2,
                     launcher_args=(), timeline: bool = True):
    """``python -m horovod_tpu_torch.run -np N ... chip_smoke.py
    --controller-worker OUT MODE`` with ``env_extra``; returns rank 0's
    results and the timeline's begin events by name (or None)."""
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_eager_")
    out_path = os.path.join(out_dir, "results.json")
    path = os.path.join(out_dir, "timeline.json")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    here = os.path.dirname(os.path.abspath(__file__))
    env.update(PYTHONPATH=here, **env_extra)
    if timeline:
        env["HOROVOD_TIMELINE"] = path
    try:
        proc = run_child(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
             *launcher_args, sys.executable, os.path.abspath(__file__),
             "--controller-worker", out_path, mode], 600, cwd=here, env=env)
        if proc.returncode != 0:
            raise AssertionError(f"eager job {mode} {env_extra} exited "
                                 f"{proc.returncode}")
        with open(out_path) as f:
            results = json.load(f)
        return results, (timeline_counts(path) if timeline else None)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def run_controller_phase(card: str):
    """Phase 30: the Python controller on the TCP star; returns rank 0's
    results."""
    results, counts = launch_eager_job("train", {"HOROVOD_CPU_OPS": "star"})
    check_timeline(counts)
    results["hmac_sha256_gb_s"] = hmac_rate()
    a, b, c = results["a"], results["b"], results["c"]
    log(f"controller (a): {a['checked']} collectives of CUDA tensors "
        f"bitwise equal to CPU copies through the controller and to the "
        f"gloo group; 64 grouped tensors in {a['grouped_responses']} fused "
        f"responses")
    log(f"controller (b): llama300m f32 ({PARITY_LAYERS} layers) seq "
        f"{CONTROLLER_SEQ} "
        f"b{CONTROLLER_BATCH_PARITY} a rank, 2 AdamW steps; losses "
        f"controller {b['losses_controller']} vs gloo group "
        f"{b['losses_group']}; max abs weight diff "
        f"{b['max_abs_weight_diff']:.3g}")
    for r, row in enumerate(results["by_rank"]):
        for step in row["c"]["steps"]:
            log(f"controller (c) rank {r} step {step['step']}: wall "
                f"{step['wall_s'] * 1e3:.1f} ms, {step['responses']} "
                f"responses, {step['cache_hits']} cache hits of "
                f"{row['c']['gradients']} gradients, negotiate "
                f"{step['negotiate_s'] * 1e3:.1f} ms, pack+D2H "
                f"{step['pack_s'] * 1e3:.1f} ms, star exchange "
                f"{step['exchange_s'] * 1e3:.1f} ms, H2D+unpack "
                f"{step['unpack_s'] * 1e3:.1f} ms, flash "
                f"{json.dumps(step['launches'])}")
    log(f"controller (c): llama300m bf16 seq {SHARDED_SEQ} b{SHARDED_BATCH} "
        f"a rank, AdamW, dp 2 through the controller (two ranks sharing "
        f"one card): {c['tokens_per_s']:.1f} tokens/s, step "
        f"{c['step_s'] * 1e3:.1f} ms; timeline events {json.dumps(counts)}; "
        f"this host hashes HMAC-SHA256 (every DATA frame, at both ends) at "
        f"{results['hmac_sha256_gb_s']:.3f} GB/s on one thread [{card}]")
    results["timeline"] = counts
    return results


def check_engine_timeline(counts):
    """Rank 0's timeline as the native engine's C++ writer wrote it: its
    negotiations and allreduces, and no card copies (those are the
    Python side's)."""
    if not counts.get("ALLREDUCE") or not counts.get("NEGOTIATE_ALLREDUCE") \
            or counts.get("MEMCPY_D2H") or counts.get("MEMCPY_H2D"):
        raise AssertionError(f"engine timeline: {counts}")


# Phase 31 (c)'s split of a step, per plane: the counters that are
# seconds, and the counts beside them.
RING_SPLIT = {
    "python": (("negotiate_s", "negotiate"), ("pack_s", "pack+D2H"),
               ("exchange_s", "ring exchange"), ("unpack_s", "H2D+unpack")),
    "native": (("stage_s", "D2H staging"), ("busy_s", "engine busy"),
               ("unstage_s", "H2D issue")),
}
RING_COUNTS = {
    "python": ("responses", "cache_hits"),
    "native": ("responses", "cache_hits", "cycles", "processed_bytes",
               "pipeline_stall_us"),
}


def run_ring_phase(card: str):
    """Phase 31: (a)-(c) on the Python controller over the native ring and
    on the native engine ((d) is :func:`run_int8_phase`, (e)
    :func:`run_two_level_phase`); returns rank 0's results."""
    import torch

    from horovod_tpu_torch.core import bindings

    torch.cuda.empty_cache()
    lib = bindings.build()  # main() built it beside the kernels
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    log(f"native core: {lib.name} built by {gxx}")
    out = {"gxx": gxx}
    for plane, env in (("python", {"HOROVOD_ENGINE": "python"}),
                       ("native", {})):
        results, counts = launch_eager_job("train", env)
        want = "Controller" if plane == "python" else "NativeController"
        if results["engine"] != want or (plane == "python"
                                         and not results["ring"]):
            raise AssertionError(f"{plane}: ran {results['engine']}, "
                                 f"ring {results['ring']}")
        (check_timeline if plane == "python" else
         check_engine_timeline)(counts)
        a, b, c = results["a"], results["b"], results["c"]
        if b["max_abs_weight_diff"] != 0:
            raise AssertionError(f"{plane}: weights differ from the gloo "
                                 f"group's by {b['max_abs_weight_diff']}")
        log(f"ring {plane} (a): {a['checked']} collectives of CUDA tensors "
            f"bitwise equal to CPU copies, the star's sums and the gloo "
            f"group; 64 grouped tensors in {a['grouped_responses']} fused "
            f"responses")
        log(f"ring {plane} (b): llama300m f32 ({PARITY_LAYERS} layers) seq "
            f"{CONTROLLER_SEQ} "
            f"b{CONTROLLER_BATCH_PARITY} a rank, 2 AdamW steps; losses "
            f"{b['losses_controller']} vs gloo group {b['losses_group']}; "
            f"max abs weight diff {b['max_abs_weight_diff']}")
        for r, row in enumerate(results["by_rank"]):
            for step in row["c"]["steps"]:
                split = ", ".join(f"{what} {step[k] * 1e3:.1f} ms"
                                  for k, what in RING_SPLIT[plane])
                tally = ", ".join(f"{k} {step[k]}"
                                  for k in RING_COUNTS[plane])
                log(f"ring {plane} (c) rank {r} step {step['step']}: wall "
                    f"{step['wall_s'] * 1e3:.1f} ms, {split}; {tally}; "
                    f"flash {json.dumps(step['launches'])}")
        log(f"ring {plane} (c): llama300m bf16 seq {SHARDED_SEQ} "
            f"b{SHARDED_BATCH} a rank, AdamW, dp 2 (two ranks sharing one "
            f"card): {c['tokens_per_s']:.1f} tokens/s, step "
            f"{c['step_s'] * 1e3:.1f} ms; timeline events "
            f"{json.dumps(counts)} [{card}]")
        results["timeline"] = counts
        out[plane] = results
    return out


def run_int8_phase(card: str):
    """Phase 31 (d): the int8 wire on the engine (third lane: its checks
    do not depend on timing); returns rank 0's results."""
    d, _ = launch_eager_job("int8", {"HOROVOD_RING_WIRE_DTYPE": "int8"},
                            timeline=False)
    dd = d["d"]
    log(f"ring native (d) int8 wire: llama300m bf16 b{CONTROLLER_BATCH_PARITY}"
        f" a rank, losses {dd['losses']}; {dd['nonzero_residuals']} of "
        f"{dd['gradients']} residuals non-zero (max {dd['residual_max']:.3g});"
        f" int8 wire bytes {dd['tx_bytes_int8']} for "
        f"{dd['logical_bytes_int8']} f32 bytes [{card}]")
    return d


def run_two_level_phase():
    """Phase 31 (e): four ranks as two groups of two on the engine's
    two-level plane; returns rank 0's results (second lane)."""
    e, _ = launch_eager_job(
        "collectives", {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                        "HOROVOD_HIERARCHICAL_ALLGATHER": "1"}, np_=4,
        launcher_args=("-H", "localhost:2,127.0.0.1:2"), timeline=False)
    if e["engine"] != "NativeController" or not e["hierarchical"]:
        raise AssertionError(f"(e) ran {e['engine']}, two-level "
                             f"{e['hierarchical']}")
    log(f"ring native (e) four ranks as 2x2, two-level plane: "
        f"{e['a']['checked']} collectives of CUDA tensors bitwise equal to "
        f"CPU copies and the two-level sum order")
    return e


# The deadline bounds the whole job (the example's default is 200 s): the
# job runs on the second lane, beside the main lane's phases.
ELASTIC_ARGS = ("--model", "300m", "--seq-len", "1024", "--batch-size",
                "2", "--device", "cuda:0", "--deadline", "300")


def _median(values):
    return statistics.median(values) if values else None


def monitor_env(out_dir: str, job: str = "") -> dict:
    """The protocol monitor and the lock-order detector on, each rank's
    artifact in ``out_dir`` (``protocheck[.JOB].json.rank<r>``,
    ``lockgraph[.JOB].json.rank<r>``: jobs that share a directory are
    told apart by ``job``)."""
    os.makedirs(out_dir, exist_ok=True)
    stem = f".{job}.json" if job else ".json"
    return {"HOROVOD_PROTOCHECK": "1",
            "HOROVOD_PROTOCHECK_OUTPUT":
                os.path.join(out_dir, "protocheck" + stem),
            "HOROVOD_LOCKCHECK": "1",
            "HOROVOD_LOCKCHECK_OUTPUT":
                os.path.join(out_dir, "lockgraph" + stem)}


def check_monitors(out_dir: str, required, what: str) -> dict:
    """Monitored jobs' artifacts in ``out_dir``: every protocol report
    ``ok``, every lock graph acyclic, those of ``required`` (role -> the
    name after ``protocheck.``/``lockgraph.``, e.g. ``json.rank0``) there
    with transitions, then one ``python -m
    horovod_tpu_torch.tools.protocheck --runtime ... --lockgraph ...``
    over all of them exits 0 (the static x runtime join included).
    Returns, per artifact, the transitions and the lock graph's nodes and
    edges, and the CLI's seconds."""
    names = sorted(os.listdir(out_dir))
    reports = {}
    for name in names:
        if ".tmp" not in name:
            with open(os.path.join(out_dir, name)) as f:
                reports[name] = json.load(f)
    out = {"protocol": {}, "locks": {}}
    for name, rep in reports.items():
        if name.startswith("protocheck."):
            if not rep["ok"]:
                raise AssertionError(f"{what}: protocol violations in "
                                     f"{name}: {rep['violations']}")
            out["protocol"][name] = rep["transitions"]
        else:
            if not rep["acyclic"]:
                raise AssertionError(f"{what}: lock-order cycles in {name}: "
                                     f"{rep['cycles']}")
            out["locks"][name] = {"nodes": len(rep["locks"]),
                                  "edges": [[e["from"], e["to"]]
                                            for e in rep["edges"]]}
    for role, stem in sorted(required.items()):
        if not out["protocol"].get(f"protocheck.{stem}") or \
                f"lockgraph.{stem}" not in out["locks"]:
            raise AssertionError(f"{what}: {role}'s artifacts missing or "
                                 f"without transitions: {names}")
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = here
    t = time.perf_counter()
    cli = run_child(
        [sys.executable, "-m", "horovod_tpu_torch.tools.protocheck",
         "--runtime", *[os.path.join(out_dir, n) for n in out["protocol"]],
         "--lockgraph", *[os.path.join(out_dir, n) for n in out["locks"]]],
        120, cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    out["protocheck_s"] = time.perf_counter() - t
    if cli.returncode != 0:
        raise AssertionError(f"{what}: protocheck exited {cli.returncode}:"
                             f"\n{cli.stdout[-3000:]}")
    out["protocheck_tail"] = cli.stdout.strip().splitlines()[-2:]
    return out


def run_elastic_job():
    """Phase 32's job under the port's launcher and its checks, then the
    restore probe (second lane: nothing on the card in this process).
    Returns the records, rank 0's final weights on the host and the
    probe's record, for :func:`run_elastic_phase`."""
    import tempfile

    import torch

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here
    # Under both runtime monitors, with telemetry on (its locks nest
    # under the wire's, so the lock graph has edges to hold).
    monitor_dir = os.path.join(out_dir, "monitor")
    job_env = {**env, **monitor_env(monitor_dir), "HOROVOD_METRICS": "1"}
    try:
        t0 = time.perf_counter()
        proc = run_child(
            [sys.executable, "-m", "horovod_tpu_torch.run", "--elastic",
             "-np", "2", "--min-ranks", "1", "--max-ranks", "2",
             "--elastic-respawns", "1", sys.executable, "-m",
             "horovod_tpu_torch.examples.elastic_llama_training",
             *ELASTIC_ARGS, "--out", out_dir], 420, cwd=here, env=job_env)
        job_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"elastic job exited {proc.returncode}")
        # Rank 1 dies by SIGKILL and writes nothing; its respawned slot,
        # the joiner, runs as rank 1.
        monitors = check_monitors(monitor_dir, {"rank 0": "json.rank0",
                                                "joiner": "json.rank1"},
                                  "elastic (32)")
        if not any(lg["edges"] for lg in monitors["locks"].values()):
            raise AssertionError(f"elastic (32): no lock-order edge "
                                 f"observed: {monitors['locks']}")
        log(f"elastic (32) monitors: transitions "
            f"{json.dumps(monitors['protocol'])}; lock graphs "
            f"{json.dumps(monitors['locks'])}; protocheck "
            f"{monitors['protocheck_s']:.1f} s: "
            f"{' / '.join(monitors['protocheck_tail'])}")
        recs = {}
        for role in ("rank0", "joiner", "kill"):
            with open(os.path.join(out_dir, f"{role}.json")) as f:
                recs[role] = json.load(f)
        r0, joiner, kill = recs["rank0"], recs["joiner"], recs["kill"]
        for rec in (r0, joiner):
            log(f"elastic (32) {rec['role']}: restores "
                f"{json.dumps(rec['restores'])}; steps "
                f"{json.dumps(rec['steps'])}; reshapes "
                f"{json.dumps(rec['reshapes'])}; digest passes "
                f"{rec['digest_seconds']}; started {rec['started']}; "
                f"start-up {json.dumps(rec['startup_s'])}")
        log(f"elastic (32) kill: {json.dumps(kill)}")
        shapes = [(r["epoch"], r["size"], r["lost"], r["joined"])
                  for r in r0["reshapes"]]
        if shapes != [(2, 1, [1], 0), (3, 2, [], 1)]:
            raise AssertionError(f"elastic: reshapes {shapes}, expected a "
                                 "shrink to 1 at epoch 2, a grow to 2 at 3")
        rolled_back = r0["started"] - r0["final_step"]
        if rolled_back < 1 or joiner["final_step"] != r0["final_step"]:
            raise AssertionError(
                f"elastic: {rolled_back} steps rolled back; final steps "
                f"{r0['final_step']} vs the joiner's {joiner['final_step']}")
        grow_r0 = [r for r in r0["restores"] if r["epoch"] == 3][0]
        grow_j = [r for r in joiner["restores"] if r["epoch"] == 3][0]
        if grow_r0["fetched_bytes"] != 0 or grow_j["fetched_shards"] != \
                grow_j["shards"] or grow_j["fetched_bytes"] != \
                joiner["commit_bytes"] or grow_j["local_bytes"] != 0:
            raise AssertionError(f"elastic: grow restores rank 0 {grow_r0} "
                                 f"joiner {grow_j}")
        authority = r0["grow_entry"]["authority"]
        for rec in (r0, joiner):
            if rec["grow_entry"]["digests"] != authority:
                raise AssertionError(
                    f"elastic: {rec['role']}'s commit hashes to "
                    f"{rec['grow_entry']['digests']}, rank 0 published "
                    f"{authority}")
        processes = {"rank0": r0["launches"], "rank1": kill["launches"],
                     "joiner": joiner["launches"]}
        if any(n <= 0 for counts in processes.values()
               for n in counts.values()):
            raise AssertionError(f"elastic: flash launches {processes}")
        final = torch.load(os.path.join(out_dir, "final.pt"),
                           map_location="cpu")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    t2 = time.perf_counter()
    probe = run_child(
        [sys.executable, "-m", "horovod_tpu_torch.examples."
         "elastic_restore_probe", "--device", "cuda:0", "--small-mib", "16",
         "--factor", "4", "--reps", "3", "--timeout", "200"], 240, cwd=here,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    if probe.returncode != 0:
        raise AssertionError(f"restore probe exited {probe.returncode}: "
                             f"{probe.stdout[-2000:]}{probe.stderr[-2000:]}")
    return {"r0": r0, "joiner": joiner, "kill": kill, "job_s": job_s,
            "monitors": monitors, "rolled_back": rolled_back,
            "grow_r0": grow_r0,
            "grow_j": grow_j, "processes": processes, "final": final,
            "probe": json.loads(probe.stdout.strip().splitlines()[-1]),
            "probe_s": time.perf_counter() - t2}


def run_elastic_phase(job, card: str):
    """Phase 32 on the main lane: the job's final weights (from
    :func:`run_elastic_job`) against a one-process replay of rank 0's
    schedule on the card, and the phase's numbers."""
    import torch

    from horovod_tpu_torch.examples import elastic_llama_training as ex

    r0, joiner, kill = job["r0"], job["joiner"], job["kill"]
    grow_r0, grow_j = job["grow_r0"], job["grow_j"]
    rolled_back, processes = job["rolled_back"], job["processes"]
    job_s, probe_s, probe_rec = job["job_s"], job["probe_s"], job["probe"]
    monitors = job["monitors"]
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    want = ex.replay("300m", r0["schedule"], 2, 1024, 0, "cuda")
    got = job.pop("final")
    worst = 0.0
    for name in sorted(want):
        compare(got[name], want[name], "float32",
                f"elastic replay weight {name}")
        worst = max(worst, float((got[name] - want[name]).abs().max()))
    replay_s = time.perf_counter() - t1
    del want, got
    torch.cuda.empty_cache()

    def first(epoch):
        return min(s["t_done"] for s in r0["steps"]
                   if s["epoch"] == epoch) - kill["t_kill"]

    def tok_s(epoch):
        """Rank 0's tok/s over an epoch's steps after its first (which
        carries the restore wait and the warm-up), with every step's
        seconds: epochs 1 and 3 commit two steps each, so the rate is
        one host-timed step."""
        secs = [s["seconds"] for s in r0["steps"] if s["epoch"] == epoch]
        return 2 * 2 * 1024 / _median(secs[1:]), secs

    before, before_steps = tok_s(1)
    after, after_steps = tok_s(3)
    out = {
        "job_s": job_s, "replay_s": replay_s, "probe_s": probe_s,
        "schedule": r0["schedule"], "rolled_back": rolled_back,
        "reshapes": r0["reshapes"],
        "kill_to_first_step_s": {"epoch2": first(2), "epoch3": first(3)},
        "joiner_restore": {k: grow_j[k] for k in (
            "seconds", "fetched_shards", "fetched_bytes", "shards")},
        "rank0_grow_restore": {k: grow_r0[k] for k in (
            "seconds", "fetched_bytes", "local_bytes")},
        "digest_seconds": {"rank0": r0["digest_seconds"],
                           "joiner": joiner["digest_seconds"]},
        "peak_gib": {"rank0": r0["peak_bytes"] / 2**30,
                     "joiner": joiner["peak_bytes"] / 2**30},
        "commit_gib": r0["commit_bytes"] / 2**30,
        "tokens_per_s": {"epoch1": before, "epoch3": after},
        "step_s": {"epoch1": before_steps, "epoch3": after_steps,
                   "epoch2": [s["seconds"] for s in r0["steps"]
                              if s["epoch"] == 2]},
        "max_abs_weight_diff": worst, "launches": processes,
        "monitors": monitors, "probe": probe_rec}
    log(f"elastic (32): llama300m f32 seq 1024 b2 a rank, AdamW, dp 2 on "
        f"the star; schedule {r0['schedule']} (world size per committed "
        f"step), {rolled_back} step(s) rolled back; reshapes "
        + ", ".join(f"epoch {r['epoch']} size {r['size']} in "
                    f"{r['seconds']:.4f} s" for r in r0["reshapes"])
        + f"; kill to the first step at epoch 2 {first(2):.2f} s, at "
        f"epoch 3 {first(3):.2f} s; joiner restore {grow_j['seconds']:.2f} s "
        f"fetching {grow_j['fetched_shards']}/{grow_j['shards']} shards, "
        f"{grow_j['fetched_bytes'] / 2**30:.3f} GiB, rank 0 "
        f"{grow_r0['fetched_bytes']} bytes in {grow_r0['seconds']:.2f} s; "
        f"digest pass per commit {_median(r0['digest_seconds']):.2f} s "
        f"(median of {len(r0['digest_seconds'])}); commit "
        f"{out['commit_gib']:.2f} GiB; rank 0 peak "
        f"{out['peak_gib']['rank0']:.2f} GiB; {before:.1f} tok/s before "
        f"(one step; epoch 1 step seconds {before_steps}), {after:.1f} after "
        f"(one step; epoch 3 step seconds {after_steps}); replay max abs "
        f"weight diff {worst:.3g}; flash "
        f"launches {json.dumps(processes)}; job {job_s:.1f} s under both "
        f"runtime monitors (protocol transitions "
        f"{sum(monitors['protocol'].values())}), replay "
        f"{replay_s:.1f} s [{card}]")
    log(f"elastic restore probe (32): {json.dumps(probe_rec)} "
        f"({probe_s:.1f} s) [{card}]")
    return out


# Phase 33 (a): the training example's arguments (one warm step, then
# TUNE_ITERS timed ones). The native tuner scores a configuration every
# 13 samples of its 10 ms poll that see rank 0's engine busy move; a step
# gives it ~5, fewer once it has lengthened the cycle (on the card 5
# steps scored 1-2 configurations, 11 steps 2-3).
TUNE_ITERS = 16
TUNE_ARGS = ["--model", "300m", "--seq-len", "1024", "--batch-size", "8",
             "--num-iters", str(TUNE_ITERS)]


def _card_rank():
    """A launched rank's set-up for the jobs that share ``cuda:0``: a
    gloo group over the launcher's store, built before
    ``hvd.init(device="cuda:0")`` (which adopts it). Returns the rank, or
    None without a card."""
    import datetime

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import config

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return None
    torch.cuda.set_device(0)
    rank = int(os.environ["HOROVOD_RANK"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{config.spmd_coordinator()}", rank=rank,
        world_size=int(os.environ["HOROVOD_SIZE"]),
        timeout=datetime.timedelta(seconds=600))
    hvd.init(device="cuda:0")
    return rank


def _http(port: int, path: str) -> str:
    """``GET http://127.0.0.1:PORT/PATH``: a rank's own metrics
    endpoint."""
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=30).read().decode()


def tune_worker(out_path: str, mode: str) -> int:
    """One rank of phase 33 (``horovodrun -np 2 ... chip_smoke.py
    --tune-worker OUT MODE``), sharing ``cuda:0`` over a gloo group
    built here. ``train``: the training example's ``main`` (33 a);
    ``parity``: float32 at ``PARITY_LAYERS``, two AdamW steps through the
    controller, rank 0 saving the weights to ``OUT.pt`` (33 b) and, when
    the job serves metrics (35 b), its last ``GET /doctor`` report. Every
    rank writes ``OUT.rank<r>.json``: its flash launches, the bucket size
    it adopted, and on rank 0 the tuner's state."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.controller import bucket_scheduler as bs
    from horovod_tpu_torch.examples import llama_fsdp_training as fx
    from horovod_tpu_torch.examples import llama_training as lx
    from horovod_tpu_torch.models.llama import LLAMA_300M

    rank = _card_rank()
    if rank is None:
        return 2
    ctl = basics.controller()
    out = {"engine": type(ctl).__name__}
    if mode == "train":
        _reset_counts()
        res = lx.main(TUNE_ARGS)
        torch.cuda.synchronize()
        out.update(tokens_per_s=res["tokens_per_s"], step_ms=res["step_ms"],
                   losses=res["losses"], launches=_counts(),
                   gradients=[n for n, p in res["model"].named_parameters()
                              if p.requires_grad])
        del res
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32,
                                  num_layers=PARITY_LAYERS)
        ids = fx.batch_ids(cfg, CONTROLLER_BATCH_PARITY, CONTROLLER_SEQ, 2,
                           rank, "cuda")
        model = lx.make_model(cfg, device="cuda")
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = lx.make_optimizer("adamw", model)
        loss_fn = lx.make_loss_fn(0)
        out["losses"] = [float(lx.train_step(model, opt, ids, loss_fn))
                         for _ in range(2)]
        if rank == 0:
            torch.save({n: p.detach().cpu()
                        for n, p in model.named_parameters()},
                       out_path + ".pt")
        _drop(model, opt)
        exporter = basics._state.metrics_exporter
        if rank == 0 and exporter is not None:
            out["doctor"] = json.loads(_http(exporter.port, "/doctor"))
    pm = getattr(ctl, "_param_manager", None)
    if pm is not None:
        out["tuner"] = pm.state()
    hvd.shutdown()
    dist.destroy_process_group()
    # Read after the shutdown: the native engine's last reply is drained.
    out["bucket_bytes"] = bs.current_bucket_bytes()
    with open(f"{out_path}.rank{rank}.json", "w") as f:
        json.dump(out, f)
    log(f"rank {rank}: tune worker ({mode}) ok")
    return 0


def start_job(mode: str, env_extra: dict, out_dir: str, trace: bool,
              ranks: int = 2, worker: str = "--tune-worker"):
    """Start ``python -m horovod_tpu_torch.run -np RANKS [--trace
    DIR/trace] ... chip_smoke.py WORKER DIR/MODE MODE``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    here = os.path.dirname(os.path.abspath(__file__))
    env.update(PYTHONPATH=here, **env_extra)
    out_path = os.path.join(out_dir, mode)
    args = ("--trace", os.path.join(out_dir, "trace")) if trace else ()
    proc = start_child(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(ranks),
         *args, sys.executable, os.path.abspath(__file__), worker,
         out_path, mode], cwd=here, env=env)
    return proc, out_path, f"{mode} {env_extra}", time.perf_counter(), ranks


def finish_job(job):
    """Wait for a job of :func:`start_job`; returns its exit code and
    seconds."""
    proc, _, what, t, _ = job
    try:
        code = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        _stop_group(proc)
        raise AssertionError(f"job {what} timed out")
    finally:
        _CHILDREN.discard(proc)
    return code, time.perf_counter() - t


def job_records(job, code: int):
    """Every rank's records of a finished job of :func:`start_job`,
    which must have exited 0."""
    _, out_path, what, _, ranks = job
    if code != 0:
        raise AssertionError(f"job {what} exited {code}")
    recs = []
    for r in range(ranks):
        with open(f"{out_path}.rank{r}.json") as f:
            recs.append(json.load(f))
    return recs


def check_trace(trace_dir: str, gradients):
    """Phase 33 (a)'s trace: the three artifacts, every gradient's
    sequence ids the same on both ranks, rank 1's offset within its
    uncertainty plus 1 ms."""
    from horovod_tpu_torch import trace as tr

    with open(os.path.join(trace_dir, tr.MERGED_TRACE_FILE)) as f:
        events = json.load(f)
    with open(os.path.join(trace_dir, tr.OFFSETS_FILE)) as f:
        clock = json.load(f)
    with open(os.path.join(trace_dir, tr.REPORT_FILE)) as f:
        report = json.load(f)
    seqs = [{}, {}]
    phases = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        phases[e["name"]] = phases.get(e["name"], 0) + 1
        seq = e["args"].get("seq")
        if e["name"] == "enqueue" and seq is not None:
            seqs[e["pid"]].setdefault(e["args"]["op"], set()).add(seq)
    missing = [n for n in gradients if not seqs[0].get(n)
               or seqs[0].get(n) != seqs[1].get(n)]
    if missing or set(phases) != set(tr.PHASES):
        raise AssertionError(f"trace: gradients without the same seq ids on "
                             f"both ranks {missing[:8]}; phases {phases}")
    entry = clock["1"]
    if not entry["synced"] or abs(entry["offset_seconds"]) > \
            entry["uncertainty_seconds"] + 1e-3:
        raise AssertionError(f"clock offsets {clock}")
    return {"phases": phases, "clock": entry, "report": {
        k: report[k] for k in ("collectives", "slack_p50_seconds",
                               "slack_p99_seconds", "slack_max_seconds",
                               "worst_rank", "per_rank")},
        "gradients": len(gradients),
        "seq_ids_per_gradient": len(seqs[0][gradients[0]])}


def run_tools_straggler(trace_dir: str, report):
    """37 (e): ``tools.straggler`` over 33 (a)'s trace directory
    (``--remerge``, no report file written): exit 0 and the job's own
    attribution (``report``: :func:`check_trace`'s keys) again."""
    t = time.perf_counter()
    res = _tool(["horovod_tpu_torch.tools.straggler", trace_dir,
                 "--remerge", "--no-report-file"], 120)
    seconds = time.perf_counter() - t
    got = json.loads(res.stdout)
    if {k: got[k] for k in report} != report:
        raise AssertionError(f"tools.straggler: {json.dumps(got)} against "
                             f"the job's {json.dumps(report)}")
    log(f"tools.straggler over 33 (a)'s trace: {got['collectives']} "
        f"collectives, worst rank {got['worst_rank']}, as the job's own "
        f"report; {seconds:.1f} s")
    return {"collectives": got["collectives"],
            "worst_rank": got["worst_rank"], "seconds": seconds}


def scored_rows(path: str):
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()
                 if ln and not ln.startswith("#")]
    header = lines[0].split(",")
    return [dict(zip(header, ln.split(","))) for ln in lines[1:]]


def run_tune_phase(card: str, untuned_tok_s: float):
    """Phase 33 (a): tuned and traced Llama-300M training on the native
    engine ((b) and (c) are :func:`run_tune_checks`)."""
    import tempfile

    import torch

    from horovod_tpu_torch.ops import attention as A

    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        log_path = os.path.join(out_dir, "autotune.csv")
        job = start_job("train", {"HOROVOD_AUTOTUNE": "1",
                                  "HOROVOD_AUTOTUNE_LOG": log_path},
                        out_dir, True)
        code, a_s = finish_job(job)
        r0, r1 = job_records(job, code)
        rows = scored_rows(log_path)
        if len(rows) < 2:
            raise AssertionError(f"autotune log: {len(rows)} scored rows")
        if {r0["engine"], r1["engine"]} != {"NativeController"} or \
                r0["bucket_bytes"] != r1["bucket_bytes"] or \
                r0["bucket_bytes"] == 8 << 20:
            raise AssertionError(f"(a): engines {r0['engine']}, "
                                 f"{r1['engine']}; buckets "
                                 f"{r0['bucket_bytes']}, {r1['bucket_bytes']}")
        for r, rec in enumerate((r0, r1)):
            if min(rec["launches"][n] for n in A.LAUNCHES) <= 0:
                raise AssertionError(f"(a) rank {r}: flash launches "
                                     f"{rec['launches']}")
        trace = check_trace(os.path.join(out_dir, "trace"), r0["gradients"])
        trace["tools_straggler"] = run_tools_straggler(
            os.path.join(out_dir, "trace"), trace["report"])
        tuner = r0["tuner"]
        a = {"tokens_per_s": r0["tokens_per_s"], "step_ms": r0["step_ms"],
             "losses": r0["losses"], "scored": len(rows),
             "bucket_bytes": r0["bucket_bytes"], "tuner": tuner,
             "trace": trace, "job_s": a_s,
             "launches": [r0["launches"], r1["launches"]]}
        log(f"tune (33a): llama300m bf16 seq 1024 b8 a rank, AdamW, dp 2 on "
            f"the native engine, tuned and traced: {r0['tokens_per_s']:.1f} "
            f"tokens/s (step {r0['step_ms']:.1f} ms) against 31's untuned "
            f"engine row {untuned_tok_s:.1f} tokens/s; {len(rows)} "
            f"configurations scored; tuner now fusion "
            f"{tuner['fusion_threshold']} B, cycle "
            f"{tuner['cycle_time_ms']:.3f} ms, ring chunk "
            f"{tuner['ring_chunk_bytes']} B, bucket {tuner['bucket_bytes']} "
            f"B; best fusion {tuner['best_fusion_threshold']} B, cycle "
            f"{tuner['best_cycle_time_ms']:.3f} ms, chunk "
            f"{tuner['best_ring_chunk_bytes']} B, bucket "
            f"{tuner['best_bucket_bytes']} B; both ranks adopted bucket "
            f"{r0['bucket_bytes']} B; trace phases "
            f"{json.dumps(trace['phases'])}, {trace['gradients']} gradients "
            f"x {trace['seq_ids_per_gradient']} seq ids on both ranks; "
            f"rank 1 clock offset {trace['clock']['offset_seconds']:.6f} s "
            f"± {trace['clock']['uncertainty_seconds']:.6f} s; straggler "
            f"report {json.dumps(trace['report'])}; flash launches rank 0 "
            f"{json.dumps(r0['launches'])} rank 1 "
            f"{json.dumps(r1['launches'])}; job {a_s:.1f} s [{card}]")
        log(f"tune (33a) autotune log rows: {json.dumps(rows)}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return a


def run_tune_checks(card: str):
    """Phase 33 (b) the Python controller's tuned weights against its
    untuned ones, (c) the overlap probe on CUDA tensors (second lane:
    jobs only, the weights compared on the host)."""
    import tempfile

    import torch

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        # The two float32 jobs run at once (four processes on the card):
        # their results do not depend on timing, and it halves (b)'s wall
        # time.
        # Both under the runtime monitors, their artifacts in one
        # directory (one protocheck run for both): the traced job's clock
        # pings ride HEARTBEAT frames on the star.
        monitor_dir = os.path.join(out_dir, "monitor")
        jobs = {}
        for label, env, trace_on in (
                ("tuned", {"HOROVOD_ENGINE": "python",
                           "HOROVOD_AUTOTUNE": "1"}, True),
                ("plain", {"HOROVOD_ENGINE": "python"}, False)):
            sub = os.path.join(out_dir, label)
            os.makedirs(sub)
            env.update(monitor_env(monitor_dir, label))
            if label == "tuned":
                # 35 (b): the doctor's sweep, the window roller, the
                # exporter and the flight recorder on the tuned job.
                env.update(doctor_env(os.path.join(sub, "fr.{rank}.jsonl")))
            jobs[label] = (sub, start_job("parity", env, sub, trace_on))
        weights, b = {}, {}
        try:
            for label, (sub, job) in jobs.items():
                code, secs = finish_job(job)
                recs = job_records(job, code)
                weights[label] = torch.load(os.path.join(sub, "parity.pt"),
                                            map_location="cpu")
                b[label] = {"losses": recs[0]["losses"], "job_s": secs,
                            "doctor": recs[0].get("doctor")}
        finally:
            for _, (proc, *_) in jobs.values():
                if proc.poll() is None:
                    _stop_group(proc)
                _CHILDREN.discard(proc)
        b["monitors"] = mon = check_monitors(
            monitor_dir, {f"{label} rank {r}": f"{label}.json.rank{r}"
                          for label in jobs for r in range(2)},
            "tune (33b)")
        log(f"tune (33b) monitors: transitions "
            f"{json.dumps(mon['protocol'])}; lock graphs "
            f"{json.dumps(mon['locks'])}; protocheck "
            f"{mon['protocheck_s']:.1f} s: "
            f"{' / '.join(mon['protocheck_tail'])}")
        worst = max(float((weights["tuned"][n] - weights["plain"][n])
                          .abs().max()) for n in weights["plain"])
        if worst != 0 or sorted(weights["tuned"]) != sorted(weights["plain"]):
            raise AssertionError(f"(b): tuned weights differ from untuned "
                                 f"by {worst}")
        b["max_abs_weight_diff"] = worst
        log(f"tune (33b): llama300m f32 ({PARITY_LAYERS} layers) seq "
            f"{CONTROLLER_SEQ} b{CONTROLLER_BATCH_PARITY} a rank, 2 AdamW "
            f"steps on the Python controller; losses tuned+traced "
            f"{b['tuned']['losses']} vs plain {b['plain']['losses']}; max "
            f"abs weight diff {worst}")
        rep = b["tuned"]["doctor"]
        if rep is None or rep["counts"]["critical"] or any(
                f["rule"] == "persistent_straggler"
                for f in rep["findings"]):
            raise AssertionError(f"(35b): the tuned job's last /doctor "
                                 f"report: {json.dumps(rep)}")
        log(f"doctor (35b): the tuned+traced job above ran with the doctor "
            f"sweep, the window roller, the exporter and the recorder on, "
            f"weights still equal (diff {worst}); its last /doctor report: "
            f"ranks observed {rep['ranks_observed']}, counts "
            f"{json.dumps(rep['counts'])}, findings "
            f"{json.dumps(rep['findings'])}")

        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
        env["PYTHONPATH"] = here
        probe = run_child(
            [sys.executable, "-m", "horovod_tpu_torch.examples.overlap_probe",
             "--device", "cuda:0", "--steps", "3", "--timeout", "200"], 240,
            cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        if probe.returncode != 0:
            raise AssertionError(f"overlap probe exited {probe.returncode}: "
                                 f"{probe.stdout[-2000:]}"
                                 f"{probe.stderr[-2000:]}")
        c = json.loads(probe.stdout.strip().splitlines()[-1])
        if not c["bit_identical"] or c["device"] != "cuda:0":
            raise AssertionError(f"(c): {c}")
        log(f"tune (33c) overlap probe, CUDA tensors, {c['engine']}: "
            f"{c['tensors']} x {c['tensor_mib']} MiB, {c['buckets']} "
            f"buckets of {c['bucket_mib']} MiB, pipelined {c['pipeline']}; "
            f"bucketed == unbucketed bit for bit; step "
            f"{c['unbucketed_step_ms']:.1f} ms unbucketed, "
            f"{c['bucketed_step_ms']:.1f} ms bucketed; overlap measured "
            f"{c['overlap_efficiency']} vs predicted "
            f"{c['model_predicted_overlap_efficiency']}; stall split "
            f"{json.dumps(c.get('stall_split'))} [{card}]")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"b": b, "c": c}


def run_static_gates(card: str):
    """Phase 34: ``python -m horovod_tpu_torch.tools.check --format json``
    (hvdlint, the aux lint, protocheck with the native engine's frame
    coverage, the static lock graph and hvdabi over the port) must exit 0
    on the card host; its summary and seconds are logged."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = here
    t = time.perf_counter()
    proc = run_child(
        [sys.executable, "-m", "horovod_tpu_torch.tools.check", "--format",
         "json"], 300, cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    seconds = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"static gates exited {proc.returncode}: "
                             f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"static gates (34): {json.dumps(summary)} in {seconds:.1f} s "
        f"[{card}]")
    return {"summary": summary, "seconds": seconds}


# Phase 35: the cluster doctor. (a) is the JAX acceptance scenario
# (tests/test_doctor.py) at Llama-300M: rank 1's every wire_send from the
# 5th on is 50 ms late. The live rule compares each worker's tick
# lateness with the other workers', so it needs two of them: three ranks.
DOCTOR_RANKS = 3
DOCTOR_ITERS = 2                     # timed steps after one warm-up step
DOCTOR_BATCH = 8                     # per rank, bf16
DOCTOR_SEQ = 1024
DOCTOR_DELAY_S = 0.05
DOCTOR_PLAN = {"seed": 7, "faults": [
    {"site": "wire_send", "action": "delay", "at": 5, "times": 1000000,
     "seconds": DOCTOR_DELAY_S, "rank": 1}]}
# (c): rank 1 installs it after its second step; its next send kills it.
POSTMORTEM_PLAN = {"seed": 7, "faults": [
    {"site": "wire_send", "action": "kill", "at": 1, "rank": 1}]}


def doctor_env(recorder: str) -> dict:
    """The doctor's stack on a job: the exporter, the piggyback every 5
    cycles, a sweep every 20, 2 s telemetry windows, the recorder."""
    return {"HOROVOD_METRICS_PORT": str(free_port()),
            "HOROVOD_METRICS_PUSH_CYCLES": "5",
            "HOROVOD_DOCTOR_CYCLES": "20",
            "HOROVOD_METRICS_WINDOW_SECONDS": "2",
            "HOROVOD_FLIGHT_RECORDER": recorder}


def _straggler_hits(report: dict):
    return [f for f in report["findings"]
            if f["rule"] == "persistent_straggler" and f["rank"] == 1]


def doctor_live(rank: int, ctl) -> dict:
    """35 (a) on one rank: Llama-300M bf16 training through the training
    example's pieces under the delay plan, one warm-up and
    ``DOCTOR_ITERS`` timed steps, whose controller cycles and rank 0's
    wait for rank 1's late ticks (the delay's share of the step) are
    counted. Rank 0 polls its own ``GET /doctor`` from the start until
    ``persistent_straggler`` names rank 1 (the controller's cycle index,
    the seconds and the ``hvd_doctor_findings`` series of ``/metrics``
    then), keeps the periodic sweep's ``doctor:`` log lines, times one
    live ``doctor.report()`` (a sweep's work) and reads
    ``/metrics?window=recent``."""
    import logging

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import doctor, metrics
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.examples import llama_training as lx
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.utils import live_calibration

    def windows_ingested() -> int:
        live = live_calibration.get()
        return live.windows_ingested if live is not None else 0

    out, found, lines = {}, {}, []
    stop = threading.Event()
    t0 = time.perf_counter()
    if rank == 0:
        port = basics._state.metrics_exporter.port

        class Lines(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()  # "[0]: doctor: ..."
                if "doctor: " in msg:
                    lines.append(msg[msg.index("doctor: "):])

        logging.getLogger("horovod_tpu_torch").addHandler(Lines())

        def poll():
            while not stop.is_set():
                try:
                    hits = _straggler_hits(json.loads(_http(port,
                                                            "/doctor")))
                except OSError:
                    hits = []
                if hits:
                    found.update(finding=hits[0], cycles=ctl._cycle_index,
                                 seconds=time.perf_counter() - t0)
                    # The /doctor call just set the hvd_doctor_* series.
                    found["series"] = [
                        ln for ln in _http(port, "/metrics").splitlines()
                        if ln.startswith("hvd_doctor_findings{")]
                    return
                stop.wait(0.5)

        poller = threading.Thread(target=poll, name="doctor-poll",
                                  daemon=True)
        poller.start()

    def waited_on_rank1() -> float:
        """Rank 0's summed wait past the allowance for rank 1's ticks
        (``hvd_controller_tick_lateness_seconds{rank="1"}``)."""
        entry = metrics.snapshot().get(
            "hvd_controller_tick_lateness_seconds", {})
        return sum(v["sum"] for labels, v in entry.get("values", [])
                   if labels == ["1"])

    _reset_counts()
    model = lx.make_model(LLAMA_300M, device="cuda")
    # Every rank has built its model before the broadcast: its 147
    # parameters negotiate in one tick, so the rank that finished
    # building last would arrive last at all 147, outweighing the steps'
    # collectives in the offline attribution with a set-up skew.
    hvd.allreduce(torch.ones(1, device="cuda"), name="doctor.built")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = lx.make_optimizer("adamw", model)
    loss_fn = lx.make_loss_fn(0)
    ids = lx.batch_ids(LLAMA_300M, DOCTOR_BATCH, DOCTOR_SEQ, "cuda")
    float(lx.train_step(model, opt, ids, loss_fn))
    c0, w0, t = ctl._cycle_index, waited_on_rank1(), time.perf_counter()
    for _ in range(DOCTOR_ITERS):
        loss = lx.train_step(model, opt, ids, loss_fn)
    float(hvd.allreduce(loss, name="doctor.loss"))
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    out.update(step_ms=dt / DOCTOR_ITERS * 1e3,
               tokens_per_s=(DOCTOR_BATCH * DOCTOR_RANKS * DOCTOR_SEQ
                             * DOCTOR_ITERS / dt),
               cycles_per_step=(ctl._cycle_index - c0) / DOCTOR_ITERS,
               delay_share_ms=(waited_on_rank1() - w0) / DOCTOR_ITERS * 1e3,
               launches=_counts())
    _drop(model, opt)
    del model, opt
    if rank == 0:
        poller.join(timeout=60)
        stop.set()
        if not found:
            raise AssertionError("(35a): the live /doctor never named rank "
                                 "1 as a persistent straggler")
        # The periodic sweep and the roller run on their own clocks: wait
        # (the workers' controllers still ticking) for a sweep's line
        # naming rank 1 and a window ingested by the live calibration.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                any("rank 1 persistent_straggler" in ln for ln in lines)
                and windows_ingested() >= 1):
            time.sleep(0.25)
        t = time.perf_counter()
        report = doctor.report()
        out["sweep_s"] = time.perf_counter() - t
        windowed = _http(port, "/metrics?window=recent")
        out.update(
            found=found, report=report, doctor_lines=lines[-3:],
            doctor_line_count=len(lines),
            named_lines=sum("rank 1 persistent_straggler" in ln
                            for ln in lines),
            windowed="no completed telemetry window" not in windowed
            and "hvd_controller_tick_lateness_seconds" in windowed,
            windowed_bytes=len(windowed),
            windows_ingested=windows_ingested(),
            remote_ranks=sorted(metrics.remote_snapshots()))
    # Every rank waits here, its controller ticking, until rank 0 is done.
    hvd.allreduce(torch.ones(1, device="cuda"), name="doctor.done")
    return out


def doctor_postmortem(rank: int) -> None:
    """35 (c) on one rank: float32 Llama-300M at ``PARITY_LAYERS``, AdamW
    steps through the Python controller; after its second step rank 1
    installs ``POSTMORTEM_PLAN`` and dies at its next send, and rank 0's
    next step fails (its ``fail_all`` dumps the flight recorder)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import fault
    from horovod_tpu_torch.examples import llama_fsdp_training as fx
    from horovod_tpu_torch.examples import llama_training as lx
    from horovod_tpu_torch.models.llama import LLAMA_300M

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32,
                              num_layers=PARITY_LAYERS)
    ids = fx.batch_ids(cfg, CONTROLLER_BATCH_PARITY, CONTROLLER_SEQ, 2,
                       rank, "cuda")
    model = lx.make_model(cfg, device="cuda")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = lx.make_optimizer("adamw", model)
    loss_fn = lx.make_loss_fn(0)
    for step in range(8):
        float(lx.train_step(model, opt, ids, loss_fn))
        if step == 1 and rank == 1:
            fault.install_plan(fault.FaultPlan.from_json(
                json.dumps(POSTMORTEM_PLAN), rank=1))
    raise AssertionError("(35c): eight steps ran with rank 1 dead")


def doctor_worker(out_path: str, mode: str) -> int:
    """One rank of phase 35 (``horovodrun -np N ... chip_smoke.py
    --doctor-worker OUT MODE``), sharing ``cuda:0``: ``live`` is
    :func:`doctor_live`, ``postmortem`` :func:`doctor_postmortem`. Each
    rank of a live job writes ``OUT.rank<r>.json``."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    rank = _card_rank()
    if rank is None:
        return 2
    ctl = basics.controller()
    out = {"engine": type(ctl).__name__}
    if mode == "live":
        out.update(doctor_live(rank, ctl))
    else:
        doctor_postmortem(rank)
    hvd.shutdown()
    dist.destroy_process_group()
    with open(f"{out_path}.rank{rank}.json", "w") as f:
        json.dump(out, f)
    log(f"rank {rank}: doctor worker ({mode}) ok")
    return 0


def run_tools_doctor(path: str):
    """``python -m horovod_tpu_torch.tools.doctor PATH --format json``,
    which must exit 0; returns its report and seconds."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = here
    t = time.perf_counter()
    proc = run_child(
        [sys.executable, "-m", "horovod_tpu_torch.tools.doctor", path,
         "--format", "json"], 120, cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    seconds = time.perf_counter() - t
    report = json.loads(proc.stdout) if proc.returncode != 2 else None
    if proc.returncode != 0:
        raise AssertionError(f"tools.doctor {path} exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    return report, seconds


def last_arrivals_by_kind(trace_dir: str) -> dict:
    """The offline attribution's straggler cycles of each rank, split by
    the kind of collective (``broadcast``: the parameter broadcast,
    ``doctor``: the script's own, ``gradients``: the rest), from the
    job's merged trace."""
    from horovod_tpu_torch.trace import straggler, tracer

    with open(os.path.join(trace_dir, tracer.MERGED_TRACE_FILE)) as f:
        events = json.load(f)
    kinds = {}
    for ev in events:
        op = ev.get("args", {}).get("op")
        if ev.get("name") == "negotiate" and op:
            kind = op.split(".", 1)[0]
            if kind not in ("broadcast", "doctor"):
                kind = "gradients"
            kinds.setdefault(kind, []).append(ev)
    return {kind: {r: v["straggler_cycles"] for r, v in straggler.attribute(
        evs, feed=False)["per_rank"].items()}
        for kind, evs in sorted(kinds.items())}


def run_doctor_phase(card: str):
    """Phase 35 (a) and (c), whose jobs run at once (five processes on
    the card: (c)'s result does not depend on timing, and it keeps the
    phase short; (c)'s dump is read while (a) runs); (b) rides 33 (b)
    and (d) 16 and 18."""
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_doctor_")
    try:
        pm_dir = os.path.join(out_dir, "postmortem")
        live_dir = os.path.join(out_dir, "live")
        os.makedirs(pm_dir)
        os.makedirs(live_dir)
        postmortem = start_job(
            "postmortem", {"HOROVOD_ENGINE": "python",
                           "HOROVOD_CPU_OPS": "star",
                           "HOROVOD_FLIGHT_RECORDER":
                               os.path.join(pm_dir, "fr.{rank}.jsonl")},
            pm_dir, False, worker="--doctor-worker")
        # The response cache off: a cached step bypasses negotiation and
        # leaves no negotiate span, so with it on the offline attribution
        # would see the first step's gradients only.
        live = start_job(
            "live", {"HOROVOD_ENGINE": "python",
                     "HOROVOD_CACHE_CAPACITY": "0",
                     "HOROVOD_TRACE_DIR": os.path.join(live_dir, "trace"),
                     "HOROVOD_FAULT_PLAN": json.dumps(DOCTOR_PLAN),
                     **doctor_env(os.path.join(live_dir, "fr.{rank}.jsonl"))},
            live_dir, False, ranks=DOCTOR_RANKS, worker="--doctor-worker")
        c = doctor_postmortem_job(postmortem, pm_dir, card)
        return {"a": doctor_live_job(live, live_dir, card), "c": c}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def doctor_live_job(job, live_dir: str, card: str) -> dict:
    """35 (a): waits for ``job``, three ranks of :func:`doctor_live`
    under the delay plan, then runs ``tools.doctor`` over their trace
    directory, whose every ``persistent_straggler`` finding must name
    rank 1, the straggler report's worst rank."""
    from horovod_tpu_torch.ops import attention as A

    trace_dir = os.path.join(live_dir, "trace")
    code, a_s = finish_job(job)
    recs = job_records(job, code)
    r0 = recs[0]
    found = r0["found"]["finding"]
    if found["evidence"]["source"] != "tick_lateness" or \
            found["evidence"]["tick_lateness_p99_seconds"] < 0.03:
        raise AssertionError(f"(35a): live finding {json.dumps(found)}")
    if not r0["named_lines"]:
        raise AssertionError(f"(35a): no periodic doctor line names "
                             f"rank 1: {r0['doctor_lines']}")
    series = [ln for ln in r0["found"]["series"]
              if 'rule="persistent_straggler"' in ln]
    if not series or float(series[0].rsplit(" ", 1)[1]) < 1:
        raise AssertionError(f"(35a): /metrics doctor series "
                             f"{r0['found']['series']}")
    if not r0["windowed"] or r0["windows_ingested"] < 1 or \
            r0["remote_ranks"] != list(range(1, DOCTOR_RANKS)):
        raise AssertionError(
            f"(35a): windowed view {r0['windowed']}, windows ingested "
            f"{r0['windows_ingested']}, piggybacked ranks "
            f"{r0['remote_ranks']}")
    for r, rec in enumerate(recs):
        if rec["engine"] != "Controller" or \
                min(rec["launches"][n] for n in A.LAUNCHES) <= 0:
            raise AssertionError(f"(35a) rank {r}: engine "
                                 f"{rec['engine']}, flash launches "
                                 f"{rec['launches']}")
    offline, cli_s = run_tools_doctor(trace_dir)
    with open(os.path.join(trace_dir, "straggler_report.json")) as f:
        report = json.load(f)
    cycles = {r: v["straggler_cycles"]
              for r, v in report["per_rank"].items()}
    by_kind = last_arrivals_by_kind(trace_dir)
    hits = [f for f in offline["findings"]
            if f["rule"] == "persistent_straggler"]
    # As tests/test_torch_doctor_mp.py holds the CPU job: rank 1 and no
    # other rank.
    if not hits or any(f["rank"] != 1 for f in hits) or \
            report["worst_rank"] != 1:
        raise AssertionError(
            f"(35a): tools.doctor over the trace: {json.dumps(hits)}; "
            f"straggler cycles {cycles} of {report['collectives']}, by "
            f"kind {json.dumps(by_kind)}")
    share_ms = r0["delay_share_ms"]
    a = {"step_ms": r0["step_ms"], "tokens_per_s": r0["tokens_per_s"],
         "cycles_per_step": r0["cycles_per_step"],
         "delay_share_ms": share_ms,
         "first_finding": r0["found"], "sweep_s": r0["sweep_s"],
         "doctor_line_count": r0["doctor_line_count"],
         "doctor_lines_naming_rank1": r0["named_lines"],
         "windows_ingested": r0["windows_ingested"],
         "windowed_bytes": r0["windowed_bytes"],
         "offline": {"findings": offline["findings"],
                     "ranks_observed": offline["ranks_observed"],
                     "collectives": report["collectives"],
                     "straggler_cycles": cycles, "by_kind": by_kind,
                     "seconds": cli_s},
         "live_report_counts": r0["report"]["counts"],
         "job_s": a_s, "launches": [rec["launches"] for rec in recs]}
    log(f"doctor (35a): llama300m bf16 ({LAYERS} layers) seq {DOCTOR_SEQ} "
        f"b{DOCTOR_BATCH} a rank, AdamW, dp {DOCTOR_RANKS} on the Python "
        f"controller over the ring, rank 1 {DOCTOR_DELAY_S * 1e3:.0f} ms "
        f"late at every send: first live persistent_straggler (rank 1, "
        f"{found['severity']}, tick lateness p99 "
        f"{found['evidence']['tick_lateness_p99_seconds']:.4f} s over "
        f"{found['evidence']['cycles']} cycles) at controller cycle "
        f"{r0['found']['cycles']}, {r0['found']['seconds']:.1f} s after "
        f"rank 0's init; {DOCTOR_ITERS} timed steps after a warm-up: step "
        f"{r0['step_ms']:.1f} ms ({r0['tokens_per_s']:.1f} tokens/s) over "
        f"{r0['cycles_per_step']:.1f} cycles, the delay's share (rank 0's "
        f"wait for rank 1's late ticks) {share_ms:.1f} ms a step, "
        f"{r0['step_ms'] - share_ms:.1f} ms without it; one live sweep "
        f"(doctor.report) {r0['sweep_s'] * 1e3:.1f} ms, its counts "
        f"{json.dumps(r0['report']['counts'])}; "
        f"{r0['doctor_line_count']} periodic lines "
        f"({r0['named_lines']} naming rank 1), the last: "
        f"{r0['doctor_lines'][-1][:240]!r}; "
        f"{r0['windows_ingested']} windows ingested, windowed /metrics "
        f"{r0['windowed_bytes']} B; tools.doctor over the trace "
        f"{cli_s:.1f} s: {json.dumps(hits)}; last arrivals by rank "
        f"{json.dumps(cycles)} of {report['collectives']} collectives, by "
        f"kind {json.dumps(by_kind)}; flash launches "
        f"{json.dumps(a['launches'])}; job {a_s:.1f} s [{card}]")
    return a


def doctor_postmortem_job(job, pm_dir: str, card: str) -> dict:
    """35 (c): waits for ``job``, two ranks of :func:`doctor_postmortem`
    under the flight recorder, which must exit non-zero; rank 0's dump
    read back and by ``tools.doctor``."""
    code, _ = finish_job(job)
    if code == 0:
        raise AssertionError("(35c): the job exited 0; rank 1's death "
                             "must fail it")
    dump = os.path.join(pm_dir, "fr.0.jsonl")
    if not os.path.exists(dump):
        raise AssertionError(f"(35c): no rank-0 postmortem in "
                             f"{sorted(os.listdir(pm_dir))}")
    with open(dump) as f:
        events = [json.loads(line) for line in f]
    aborts = [e for e in events if e["kind"] == "abort"]
    if not aborts or aborts[0]["dead_rank"] != 1 or not any(
            e["kind"] == "fail_all" for e in events):
        raise AssertionError(f"(35c): postmortem {events}")
    pm_report, pm_cli_s = run_tools_doctor(pm_dir)
    if 0 not in pm_report["ranks_observed"]:
        raise AssertionError(f"(35c): tools.doctor {pm_report}")
    c = {"exit_code": code, "dump_bytes":
         os.path.getsize(dump), "events": len(events) - 1,
         "kinds": sorted({e["kind"] for e in events}),
         "abort": aborts[0], "tools_doctor": pm_report,
         "tools_doctor_s": pm_cli_s}
    log(f"doctor (35c): llama300m f32 ({PARITY_LAYERS} layers) dp 2, "
        f"rank 1 killed at its first send after step 2, run beside (a): "
        f"job exit {code} (expected non-zero); rank 0's "
        f"postmortem {c['dump_bytes']} B, {c['events']} events of "
        f"kinds {c['kinds']}, abort {json.dumps(aborts[0])}; "
        f"tools.doctor exit 0 in {pm_cli_s:.1f} s, ranks observed "
        f"{pm_report['ranks_observed']}, findings "
        f"{json.dumps(pm_report['findings'])} [{card}]")
    return c


def compare_planes(rounds: int) -> int:
    """``python3 chip_smoke.py --compare-planes N``: phase 31 (c) alone
    (one warm and three timed steps), on the Python controller over the
    ring and on the native engine in turns — python, native, native,
    python, N rounds — because the host's share of a two-rank step drifts
    by 10% and more between jobs of one call. Logs each job's tok/s and
    rank 0's mean split, then the medians, beside the card's name and
    power limit."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from horovod_tpu_torch.core import bindings
    from horovod_tpu_torch.ops import _build

    _build.build_all()
    bindings.build()
    card = card_line()
    planes = {"python": {"HOROVOD_ENGINE": "python"}, "native": {}}
    got = {plane: [] for plane in planes}
    for _ in range(rounds):
        for plane in ("python", "native", "native", "python"):
            results, _ = launch_eager_job("timed", planes[plane],
                                          timeline=False)
            c = results["c"]
            got[plane].append(c["tokens_per_s"])
            split = {k: statistics.mean(s[k] for s in c["steps"][1:])
                     for k, _ in RING_SPLIT[plane]}
            log(f"{plane}: {c['tokens_per_s']:.1f} tokens/s, step "
                f"{c['step_s'] * 1e3:.1f} ms, rank 0 mean split (s) "
                f"{json.dumps(split)} [{card}]")
    log("medians: " + ", ".join(
        f"{plane} {statistics.median(v):.1f} tokens/s of {len(v)} jobs"
        for plane, v in sorted(got.items())) + f" [{card}]")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import attention as flash_ops

    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    # The native core (g++) builds beside the kernels (nvcc); phases 31
    # and 33 load it.
    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu_torch.core import bindings

    with ThreadPoolExecutor(1) as pool:
        core = pool.submit(bindings.build)
        _build.build_all()
        core.result()
    log(f"kernel build ({len(_build.SOURCES)} sources in parallel, the "
        f"native core beside them): {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for kernel, regs, spill in ptxas_report(name):
            log(f"  ptxas {name}.cu {kernel}: {regs}; {spill}")

    # float32 parity runs in full float32: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    def phase(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"phase {label}: {time.perf_counter() - t:.1f} s")
        return out

    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=device)
    results = phase("2 decode kernels", check_kernels, device,
                    flush_buf.zero_)
    phase("2 decode chunk edges", check_chunk_edges, device)
    flash_results = phase("6 flash kernels", check_flash, device,
                          flush_buf.zero_)
    operand = phase("14 operand range", check_operand_range, device,
                    flush_buf.zero_)
    ring_flash = phase("24 ring kernels (dlse)", check_flash, device,
                       flush_buf.zero_, ring_flash_cases(), True)
    del flush_buf

    # The second lane: jobs of their own (two to four processes on the
    # card, most of their time on the host), beside phases 3-23 of this
    # one, after the kernels' timings above. Joined before phase 32's
    # replay, as is the third.
    lane = Lane([("32 elastic membership job (horovodrun --elastic)",
                  run_elastic_job),
                 ("30 controller (two ranks, horovodrun)",
                  run_controller_phase, card),
                 ("31 (e) two-level plane (four ranks, horovodrun)",
                  run_two_level_phase),
                 ("33 (b)-(c) tuned parity and overlap probe",
                  run_tune_checks, card),
                 ("37 (e) simulated cluster and its tools",
                  run_sim_tools, card)])
    # A third lane: 31 (d)'s job (its checks do not depend on timing),
    # then host-only work that reads no timing of the card: 38 (e)'s
    # probes and the static gates.
    int8_lane = Lane([("31 (d) int8 wire (horovodrun)", run_int8_phase,
                       card),
                      ("38 (e) host probes (wire, autotune, scaling)",
                       run_host_probes, card),
                      ("39 TF and Keras front ends", run_tf_front_ends,
                       card),
                      ("34 static gates (tools.check)", run_static_gates,
                       card)], "third lane")

    phase("7 collectives", run_collectives)

    cfg32 = dataclasses.replace(LLAMA_300M, dtype=torch.float32)
    model, gen_launches = phase("3 generate", run_generate, cfg32)
    paged_launches = phase("4 engine parity", run_engine_parity, model,
                           cfg32)
    fleet_parity, fleet_launches = phase("17 fleet parity",
                                         run_fleet_parity, model, cfg32)
    release_serving()
    del model
    torch.cuda.empty_cache()
    serving_numbers = phase("5 engine timing, graph and eager; 36 (b)",
                            run_engine_timing, card)
    release_serving()
    torch.cuda.empty_cache()
    graph_launches = phase("36 (c) decode graph against the eager step",
                           run_graph_checks, card)
    generation, example_launches = phase(
        "15 generation example", run_generation_example, card)
    loadgen_300m, loadgen_launches = phase(
        "16 loadgen llama-300m", run_loadgen, LOADGEN_300M,
        "llama_300m_serving_b8_loadgen", card)
    loadgen_eager = {"16": phase(
        "16 loadgen llama-300m, eager step", run_loadgen, LOADGEN_300M,
        "llama_300m_serving_b8_loadgen eager", card, True)}
    fleet_rows = {}
    # The chaos pass reruns the same trace in the same (warm) process.
    for label, extra in (("fleet", []),
                         ("fleet_chaos", ["--chaos-kill", "--no-warmup"])):
        fleet_rows[label] = phase(
            f"18 loadgen tiny {label}", run_loadgen,
            LOADGEN_FLEET_TINY + extra,
            f"llama_serving_fleet_prefix_loadgen {label}", card)
    loadgen_eager["18"] = phase(
        "18 loadgen tiny fleet, eager step", run_loadgen,
        LOADGEN_FLEET_TINY + ["--no-warmup"],
        "llama_serving_fleet_prefix_loadgen fleet eager", card, True)
    for row, graphed, eager in (
            ("16", loadgen_300m, loadgen_eager["16"][0]),
            ("18", fleet_rows["fleet"][0], loadgen_eager["18"][0])):
        log(f"loadgen {row} graph / eager step: " + ", ".join(
            f"{key} {graphed[key]} / {eager[key]}" for key in (
                "value", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                "tpot_p99_s")) + f" [{card}]")
    for label, (rec, _) in fleet_rows.items():
        base = rec["baseline_no_sharing"]
        log(f"fleet row {label}: TTFT p50 warm {rec['ttft_warm_p50_s']} s "
            f"vs cold {rec['ttft_cold_p50_s']} s; blocks_live_peak "
            f"{rec['blocks_live_peak']} vs {base['blocks_live_peak']} "
            f"without sharing; reroutes {rec['router']['reroutes']}")
    torch.cuda.empty_cache()

    parity = phase("8 training parity", run_training_parity)
    training = phase("9 training example", run_training_timed, card)
    torch.cuda.empty_cache()
    phase37 = {"a_parity": phase("37 (a) adafactor parity",
                                 run_adafactor_parity),
               "a": phase("37 (a) adafactor training example",
                          run_adafactor_timed, card, training),
               "b": phase("37 (b) HOROVOD_FLASH_XLA_BWD step",
                          run_flag_step),
               "c": phase("37 (c) generation --checkpoint",
                          run_checkpoint_generation, card),
               "d": phase("37 (d) word2vec", run_word2vec, card)}
    torch.cuda.empty_cache()

    moe_parity = phase("19 moe parity", run_moe_parity)
    moe_training = phase("20 moe training example", run_moe_training_timed,
                         card)
    moe_model, moe_generation, moe_gen_launches, moe_example_launches = \
        phase("21 moe generation", run_moe_generation, card)
    moe_paged_launches = phase("22 moe engine", run_engine_parity,
                               moe_model, moe_model.config, "moe-small")
    release_serving()
    del moe_model
    torch.cuda.empty_cache()
    vit = phase("23 vit example", run_vit_timed, card)

    zoo = {"resnet50_parity": phase("10 resnet parity", run_resnet_parity),
           "synthetic_benchmark": phase("11 synthetic benchmark",
                                        run_synthetic_benchmark, card),
           "bert_parity": phase("12 bert parity", run_bert_parity)}
    bert = phase("13 bert example", run_bert_timed, card)
    torch.cuda.empty_cache()
    probes = phase("38 (a)-(d) probe examples", run_probe_phase, card)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    second = {**lane.join(), **int8_lane.join()}
    gates = second["34 static gates (tools.check)"]
    log(f"second and third lanes joined after "
        f"{time.perf_counter() - t:.1f} s")
    controller = second["30 controller (two ranks, horovodrun)"]
    elastic = phase("32 elastic replay", run_elastic_phase,
                    second["32 elastic membership job (horovodrun --elastic)"],
                    card)
    parallel = phase("24-28 parallel modes and sharded state (two ranks)",
                     run_parallel_phases, card)
    resume = phase("29 checkpoint resume", run_checkpoint_resume, card)
    hvd.shutdown()
    ring = phase("31 native data plane (horovodrun)", run_ring_phase, card)
    ring["int8"] = second["31 (d) int8 wire (horovodrun)"]
    ring["hierarchical"] = second[
        "31 (e) two-level plane (four ranks, horovodrun)"]
    tune = {"a": phase("33 (a) tuning and tracing (horovodrun --trace, "
                       "autotune)", run_tune_phase, card,
                       ring["native"]["c"]["tokens_per_s"]),
            **second["33 (b)-(c) tuned parity and overlap probe"]}
    doctor = phase("35 cluster doctor (horovodrun -np 3 under a delay, "
                   "a postmortem)", run_doctor_phase, card)
    phase37["e"] = second["37 (e) simulated cluster and its tools"]
    probes["e"] = second["38 (e) host probes (wire, autotune, scaling)"]
    tf_front_ends = second["39 TF and Keras front ends"]

    # The two ranks' counts of each parallel path, summed.
    by_rank = parallel["counts_by_rank"]

    def both(phase_label, key, name):
        return sum(rank[phase_label][key][name] for rank in by_rank)

    flash_names = list(flash_ops.LAUNCHES)
    flash_paths = {"llama300m training (9)": training["flash_launches"],
                   "llama300m adafactor training (37 a)":
                       phase37["a"]["flash_launches"],
                   "bert-base training (13)": bert["flash_launches"],
                   "moe-small training (20)": moe_training["flash_launches"],
                   "vit-s16 --attention flash (23)":
                       vit["flash"]["flash_launches"],
                   "llama300m seq-parallel training (24)": {
                       n: both("24 sp timed", "", n) for n in flash_names},
                   "llama300m fsdp training (27)": {
                       n: both("27 fsdp", "timed", n) for n in flash_names},
                   "llama300m zero-1 training (28)": {
                       n: both("28 zero", "timed", n) for n in flash_names},
                   "llama300m training through the controller (30)": {
                       n: sum(r["c"]["launches"][n]
                              for r in controller["by_rank"])
                       for n in flash_names},
                   **{f"llama300m training, {plane} on the ring (31)": {
                       n: sum(r["c"]["launches"][n]
                              for r in ring[plane]["by_rank"])
                       for n in flash_names}
                      for plane in ("python", "native")},
                   "llama300m elastic training, both ranks and the joiner "
                   "(32)": {n: sum(p[n] for p in elastic["launches"].values())
                            for n in flash_names},
                   "llama300m tuned and traced training, both ranks (33)": {
                       n: sum(r[n] for r in tune["a"]["launches"])
                       for n in flash_names},
                   "llama300m training under the doctor, three ranks (35)": {
                       n: sum(r[n] for r in doctor["a"]["launches"])
                       for n in flash_names},
                   "flash_attention_benchmark (38 a)": probes["a_launches"],
                   "headpack_probe part F (38 b)": probes["b_launches"]}
    forward_only = {f"long context ring {layout} (24)": both(
        "24 sp timed", f"long_context_{layout}", "flash_forward")
        for layout in ("contiguous", "zigzag")}
    # Under the flag a step's backward runs no kernel: its forwards only.
    forward_only["HOROVOD_FLASH_XLA_BWD step (37 b)"] = \
        phase37["b"]["launches"]["flash_forward"]
    forward_only["seq-parallel parity, HOROVOD_FLASH_XLA_BWD step (24)"] = \
        both("24 sp parity", "flagged", "flash_forward")
    log(f"flash launches by main path: {json.dumps(flash_paths)}")
    decode_paths = {"generate (3)": gen_launches,
                    "generation example (15)": example_launches,
                    "generation example --checkpoint (37 c)":
                        phase37["c"]["launches"],
                    "moe-small generate (21)": moe_gen_launches,
                    "moe-small generation example (21)":
                        moe_example_launches,
                    "tp generate, both ranks (25)": both(
                        "25 tp", "generate", "decode_attention"),
                    "tp_decode_profile, both ranks (25)": both(
                        "25 tp", "profile", "decode_attention"),
                    "decode_floor_probe, unroll 1 and 4 (38 c)":
                        probes["c_launches"]}
    paged_paths = {"engine parity (4)": paged_launches,
                   "fleet parity (17)": fleet_launches,
                   "loadgen llama-300m (16)": loadgen_launches,
                   **{f"loadgen tiny {k} (18)": v[1]
                      for k, v in fleet_rows.items()},
                   "moe-small engine parity (22)": moe_paged_launches,
                   "decode graph against the eager step (36 c)":
                       graph_launches,
                   **{f"loadgen {k}, eager step": v[1]
                      for k, v in loadgen_eager.items()},
                   "tp engine, both ranks (25)": both(
                       "25 tp", "engine", "paged_decode_attention")}
    log(f"decode_attention launches by main path: "
        f"{json.dumps(decode_paths)}")
    log(f"paged_decode_attention launches by main path: "
        f"{json.dumps(paged_paths)}")
    log(f"flash_forward launches of the forward-only ring paths: "
        f"{json.dumps(forward_only)}")
    if min(list(decode_paths.values()) + list(paged_paths.values())
           + list(forward_only.values())) <= 0:
        raise AssertionError(f"a main path never ran its kernel: "
                             f"{decode_paths} {paged_paths} {forward_only}")
    launches = {"decode_attention": sum(decode_paths.values()),
                "paged_decode_attention": sum(paged_paths.values()),
                **{name: sum(path[name] for path in flash_paths.values())
                   for name in flash_names}}
    launches["flash_forward"] += sum(forward_only.values())
    # The key mask's bitmap: one a masked flash forward, on BERT's paths.
    mask_paths = {"bert-base training (13)": bert["mask_launches"],
                  "bert-base padded steps (13)":
                      bert["padded"]["launches"]["flash_mask_words"]}
    log(f"flash_mask_words launches by main path: {json.dumps(mask_paths)}")
    launches["flash_mask_words"] = sum(mask_paths.values())
    never = [f"{path}: {name}" for path, counts in flash_paths.items()
             for name, n in counts.items() if n <= 0]
    never += [f"{path}: flash_mask_words"
              for path, n in mask_paths.items() if n <= 0]
    if min(launches.values()) <= 0 or never:
        raise AssertionError(f"a kernel of the main paths never ran: "
                             f"{launches}; {never}")
    kernels = []
    for name in ("decode_attention", "paged_decode_attention"):
        row = results[(name, "llama300m", "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    row = flash_results[("slice", "bfloat16")]
    errs = row["max_abs_err"]
    flash_errs = {"flash_forward": errs["out"],
                  "flash_backward_dq": errs["dq"],
                  "flash_backward_dkdv": max(errs["dk"], errs["dv"])}
    for name in flash_ops.LAUNCHES:
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": flash_errs[name], "ms": row["ms"][name],
            "plain_ms": row["plain_ms"][name],
            "bound_ms": row["bound_ms"][name],
            "bound_by": row["bound_by"][name],
            "library_ms": (row["sdpa_fwd_ms"] if name == "flash_forward"
                           else None)})
    # The bitmap's kernel at BERT-base's shape (no one PyTorch call packs
    # bits).
    words = flash_results[("bert", "bfloat16")]["mask_words"]
    kernels.append({
        "name": "flash_mask_words", "route": "cuda",
        "source": SOURCES["flash_mask_words"],
        "replaces": REPLACES["flash_mask_words"],
        "launches": launches["flash_mask_words"],
        "max_abs_err": words["max_abs_err"], "ms": words["ms"],
        "plain_ms": words["plain_ms"], "bound_ms": words["bound_ms"],
        "bound_by": words["bound_by"], "library_ms": None})
    log(f"serving: {json.dumps(serving_numbers)}")
    log(f"operand range: {json.dumps(operand)}")
    log(f"fleet: {json.dumps({'parity': fleet_parity, 'generation': generation, 'loadgen_300m': loadgen_300m, 'fleet_tiny': {k: v[0] for k, v in fleet_rows.items()}, 'eager_step': {k: v[0] for k, v in loadgen_eager.items()}})}")
    log(f"training: {json.dumps({'parity': parity, **training})}")
    log(f"zoo: {json.dumps({**zoo, 'bert_training': bert})}")
    log(f"moe: {json.dumps({'parity': moe_parity, 'training': moe_training, 'generation': moe_generation})}")
    log(f"vit: {json.dumps(vit)}")
    log(f"parallel: {json.dumps(parallel)}")
    log(f"checkpoint resume: {json.dumps(resume)}")
    log(f"controller: {json.dumps(controller)}")
    log(f"native data plane: {json.dumps(ring)}")
    log(f"elastic: {json.dumps(elastic)}")
    log(f"tuning and tracing: {json.dumps(tune)}")
    log(f"static gates: {json.dumps(gates)}")
    log(f"cluster doctor: {json.dumps(doctor)}")
    log(f"phase 37: {json.dumps(phase37)}")
    log(f"phase 38: {json.dumps(probes)}")
    log(f"phase 39: {json.dumps(tf_front_ends)}")
    log(f"ring kernels: {json.dumps({f'{k[0]} {k[1]}': v for k, v in ring_flash.items()})}")
    log(f"wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_main() -> int:
    """:func:`main`; whatever way it ends, no job it started outlives
    it."""
    try:
        return main()
    finally:
        stop_children()


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--parallel-worker":
        sys.exit(parallel_worker(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4]))
    if len(sys.argv) == 3 and sys.argv[1] == "--compare-planes":
        sys.exit(compare_planes(int(sys.argv[2])))
    if len(sys.argv) == 4 and sys.argv[1] == "--controller-worker":
        sys.exit(controller_worker(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--tune-worker":
        sys.exit(tune_worker(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--doctor-worker":
        sys.exit(doctor_worker(sys.argv[2], sys.argv[3]))
    sys.exit(run_main())
