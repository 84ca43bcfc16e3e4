#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (znicz_tpu_torch) end to end on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, builds every Hopper kernel of the ported paths from
the sources here (the LRN forward in Triton, compiled at first launch; the
LRN backward, flash-attention, Kohonen and RBM kernels in CUDA C++, built
with nvcc up front, one process a source, in parallel), and fails (non-zero
exit, no result line) when any phase fails:

1. the card's ``nvidia-smi`` name and power limit, and the versions; the
   LRN backward's build: nvcc's seconds, ptxas' registers, spills and
   shared memory of each of its 32 instantiations (it fails on a spill);
2. each LRN kernel against its plain PyTorch version on the same CUDA
   tensors, at AlexNet's two norm shapes (batch 128), in f32 and bf16; the
   backward's second launch bitwise equal to its first, and a canary (its C
   entry with dx at the front of a NaN-filled larger buffer: nothing past
   dx written, dx bitwise the wrapper's);
3. the LRN kernels' times beside their memory bound, the plain versions'
   and the ``F.local_response_norm`` yardstick's (timed here only; the port
   never calls it), with CUDA events, in bf16 and f32;
   3b. the backward at views 1 and 2 elements past an allocation (its
   narrower instantiations) and at C 16,384 (n 5 and 7; whole rows in
   shared memory), in f32 and bf16, against the plain version, each with a
   canary;
4. the AlexNet slice: ``alexnet.build_workflow(device="cuda")`` at the
   published geometry (227x227x3, 1000 classes, batch 128, bf16) runs one
   epoch (4 train steps and the eval pass) with the launch counters set to 0
   just before and read just after, then timed train steps; and a 4-image
   f32 forward (TF32 off) on the card against the CPU from identical
   weights;
5. the flash-attention build (made before phase 2): nvcc's seconds, and ptxas' registers and
   spills with the dynamic shared memory of each kernel; then the tensor-core
   instructions (SASS ``HMMA``, and ``HGMMA`` for ``wgmma``) of each kernel,
   counted in ``cuobjdump -sass`` of the built library: it fails if one of
   the 24 kernels (the bf16 forward, dQ and dK/dV; the f32 ones in 3xTF32)
   has none;
6. each flash kernel (forward, dQ, dK/dV) against its plain version on the
   same CUDA tensors, with O(1) ``dout`` and ``dlse``: the LM slice's shape
   (B 16, T 2048, H 8, D 64, causal), D 32 and 128, a non-causal and a
   ragged (T 2000) case, phase 31's tensor-parallel shape on each rank
   (B 2, T 2048, 4 local heads, D 64, causal), and phase 32's: the ring's
   blocks (B 4, T 1024, causal and full), a pipeline stage's microbatch
   (B 1, T 2048, causal) and the same over 4 local heads, each in f32 and
   bf16; at
   the slice shape a second launch of the forward, dQ and dK/dV must be
   bitwise equal to the first, in both dtypes; the f32 forward's ``out`` and ``lse`` (at the slice
   shape, D 128 and without the mask) and dQ and dK/dV (at the slice shape)
   against a float64 plain version, within 10 times the f32 plain
   version's error;
   6b. ``flash_attention_lse`` at a head dim the kernels take zero-padded
   (96, on non-contiguous views), forward and gradients against autograd
   through the plain forward, in f32 and bf16; and the three wrappers at a
   B*H of 65600, launched as two batch slices, against their plain versions;
7. the flash kernels' times at the slice shape beside their bound (the f32
   kernels at the 3xTF32 rate, their f32-FMA bound beside it), the
   plain versions' and ``F.scaled_dot_product_attention``'s forward and
   autograd backward (timed here only; the port never calls it), in f32 and
   bf16;
8. the LM slice: ``transformer_lm.build_workflow(device="cuda",
   attention="flash")`` at the repo's mid LM's width and depth (vocab 8192,
   d_model 512, 12 layers, 8 heads, T 2048, batch 16) runs one epoch (4
   train steps, 1 eval step) with the flash counters set to 0 just before
   and read just after, then timed train steps with f32 and bf16 attention
   (tokens/sec), each with the flash counters read around them (12 of each
   kernel a train step: the bf16 steps run all three on the tensor cores),
   and a 512-token f32 forward on the card against the CPU from identical
   weights;
9. the Kohonen and RBM builds (made with the flash build): nvcc's seconds, ptxas' registers, spills and
   static shared memory of each kernel; the SASS ``HMMA`` count of each of
   the four Kohonen GEMM instantiations (``scores_kernel``,
   ``accum_kernel``) and the six RBM ones (``hidden_kernel``,
   ``visible_kernel``, ``stats_kernel``), each with 16- and 4-byte copies:
   it fails if one has none; both kernels' launches and grids at each check
   shape;
10. the Kohonen kernel against its plain version (num, den and the updated
    weights within 1e-5 of the largest magnitude, on the synthetic MNIST
    blobs): the model's shape (B 100, 8x8, F 784, masked tail), B 600 with
    500 valid (6x6, F 256), B 300 (6x6, F 64) and B 4096 (32x32, F 784); a
    repeat launch must be bitwise equal; one launch count a call; samples
    whose winner differs are counted, at most max(1, B // 1000) near-ties
    (the plain version then takes the kernel's winners); num and den
    against a float64 plain version along the kernel's winners within 10
    times the f32 plain version's error; a canary (every output and scratch
    buffer at the front of a NaN-filled larger one, with 16- and 4-byte
    copies) unchanged past them;
11. the RBM kernel against its plain version: the saturated regime exact;
    with injected uniforms and with the kernel's own draws against the
    plain version fed the generator twin's uniforms, at (B 100, 784x128,
    k 1), (B 1024, 784x1024, k 1) and (B 256, 784x1024, k 3) with a masked
    tail, and at (B 8, 784x14000, k 1) with injected uniforms: one launch
    count a call; every draw of the chain counted as a flip where the plain
    version, led along the kernel's own samples, would have drawn the other
    way, at most 1e-5 of the draws; within 1e-4 when none flipped; dW, dvb
    and dhb against a float64 plain version along the kernel's samples
    within 10 times the f32 plain version's error, never skipped; the same
    seed bitwise equal, another seed different; a canary (every output and
    scratch buffer at the front of a NaN-filled larger one, with 16- and
    4-byte copies) unchanged past them; the kernel's generator bitwise equal
    to its twin; Bernoulli frequencies at p 0.1, 0.5, 0.9 within 5 sigma;
12. both kernels' times at the model's shape and the large check shape
    (the RBM's k 3 case too) beside their bound (at the 3xTF32 rate, the
    f32-FMA bound beside it) and their plain version's (no PyTorch call
    computes either: library none);
13. the Kohonen model (``kohonen.build_workflow(device="cuda")``: 8x8 map,
    784 features, batch 100) and 14. the MNIST RBM (``mnist_rbm``: 784 x
    128, CD-1, batch 100), each on the synthetic MNIST stand-in at MNIST's
    split sizes (60000 / 10000): one epoch with the kernel's counter set to 0
    just before and read just after (one launch a train step, 600), timed
    train steps (images/sec), and one step on the card against the CPU from
    identical weights (the Kohonen kernel's own winners within max(1, B //
    1000) near-ties of the CPU's; the RBM with the same seed: the same
    chain);
15. the MNIST MLP (``mnist.build_workflow(device="cuda")``: 784 -> tanh 100
    -> softmax 10, batch 100, the synthetic 2000 / 500 with 15% held out,
    f32 without TF32; no hand kernel on its path) runs 3 epochs (17 train, 3
    valid and 5 test steps each), then the same seed on the CPU: per-epoch
    loss within 1e-4 relative and n_err within 1 a split;
    ``evaluate("test", confusion=True)`` on both from the card's weights
    (each matrix sums to n_samples with trace n_samples - n_err; the two
    equal, or every sample classed otherwise a near-tie, top-2 logits within
    1e-5); BASELINE's "MNIST MLP step latency", the median of 50
    synchronized train steps, beside the card's name and power limit;
16. CIFAR-10 (``cifar.build_workflow(device="cuda")``: conv 32 -> max-pool
    -> LRN -> conv 64 -> avg-pool -> FC 64 -> softmax 10, f32 without TF32,
    batch 100, the synthetic 2000 / 500) runs one epoch with the LRN
    counters set to 0 just before and read just after (20 forward and 20
    backward launches from the train steps, 5 forward from the test steps);
    a 4-image f32 forward on the card against the CPU from the same weights;
    20 timed train steps (images/sec); then both LRN kernels at the norm
    layer's ``[100, 15, 15, 32]`` as in phases 2-3, in f32 and bf16;
17. the image-file loaders, with no image library needed: a Kanji-shaped
    PNG tree (4 classes, 60 images in colour types 0, 2 and 6, every row
    filter) written by the script's own encoder under ``build/chip_smoke/``,
    each file decoded bitwise to its samples / 255, served by
    ``ImageDirectoryLoader`` (grey 24x24) and packed by ``pack_image_dir``
    equal to the expected; ``native/batch_assembler.cc`` built with g++
    (its seconds); ``crop_gather_u8`` on a ``[640, 256, 256, 3]`` u8 pool
    at batch 128, crop 227, with flips, bitwise equal to its numpy version,
    and its ms and GB/s a batch; the pool saved as packed ImageNet files
    (512 train, 128 valid, 1000 classes);
18. AlexNet from disk: ``alexnet.build_workflow(device="cuda")`` with that
    ``data_dir`` (the ImageNet loader, crop 227, batch 128, bf16, a
    1000-class head) runs one epoch with the LRN counters set to 0 just
    before and read just after (phase 4's counts), then 10 timed train
    steps split into the host's fill, the u8 batch's H2D copy and the step,
    as images/sec beside phase 4's synthetic rate, and a 4-image f32
    forward on the card against the CPU from the same weights;
19. ``mnist_ae`` at its published widths (batch 100, f32 without TF32): 3
    epochs on the card against the CPU from one seed (per-epoch loss within
    1e-4 relative), its step time (median of 20), the deconv and both its
    gradients at the model's shape on the card against the CPU (within
    1e-5 of the largest magnitude); one epoch each of ``video_ae``,
    ``kanji`` and ``yale_faces`` on their synthetic data and of ``kanji``
    on phase 17's tree, with images/sec;
20. the host loop around the step, on phase 17's packed files at phase
    18's geometry: ``run_epoch`` through the prefetch thread (depth 2, the
    default; the producer copies each batch into pinned memory, the
    consumer issues its copies on the step's stream), one epoch with the
    LRN counters set to 0 just before and read just after (phase 18's
    counts), every batch's int64 sum on the card equal to the loader's on
    the host, then windows of 10 epochs through the thread and through the
    serial loop in turns: images/sec over each whole window beside phase
    18's serial split, the per-step means of the step wall, dispatch,
    wait and producer stages, the pinned and pageable copy of one batch by
    CUDA events and the pipeline attribution; what the thread costs the
    SOM, the RBM, MNIST and CIFAR-10 (``run_epoch`` at depth 0 and 2 in
    turns) beside the bare hand-off of one item; a ``snapshot_dir`` run's
    'best' snapshot (MB, save and load ms) and a fresh workflow resumed
    from it evaluating as the saved one (cuDNN deterministic: equal n_err,
    loss within 1e-6); the registry's Prometheus text written to
    ``build/chip_smoke/metrics.prom``;
21. self-healing training: the anomaly watch's cost (``run_epoch`` with
    the watch on and off in turns: ms a step over whole windows, the
    per-step means of ``dispatch/train`` and the step wall, how many steps
    late the detector read its vectors, and one epoch each under
    ``torch.cuda.set_sync_debug_mode("warn")``, where the watch may add no
    synchronizing call) on AlexNet at phase 4's geometry and on the SOM,
    the RBM and MNIST at prefetch depth 0; then, with cuDNN deterministic,
    AlexNet runs of 3 epochs: a loader that returns NaN data for one train
    batch, once, under ``RecoveryPolicy(perturb=False, lr_backoff=1.0)``
    (``non_finite_loss`` within 3 steps, the epoch-start buffer restored
    bitwise, the rollback counter +1, the run bitwise equal to the
    unfaulted one, the LRN counters set to 0 just before and read just
    after; the rollback's and the clone's ms and the clone's MB);
    ``request_stop()`` mid-epoch with emergency snapshots (the snapshot's MB
    and seconds, a fresh workflow resumed from it bitwise equal to the
    uninterrupted run); deferred against sync epoch sync in turns
    (images/sec over whole runs, the same stop epoch, the same params);
    the SOM, the RBM and the LM (the mid LM's width at 2 layers, flash
    attention) each saved after one epoch and resumed, bitwise equal to
    its uninterrupted run;
22. the device-resident pool and the scan dispatch as CUDA graph replays,
    cuDNN deterministic: MNIST at ``bench.py``'s ``mnist_epoch`` shape
    (784 -> tanh 256 -> softmax 10, batch 128, 12,800 u8 images in the
    resident pool), the graph dispatch (``epoch_dispatch="scan"``) and the
    step dispatch from one seed for 3 epochs, the weights and histories
    bitwise equal, then images/sec over windows of whole epochs of at
    least ``SCAN_WINDOW_S`` seconds, 3 for each dispatch in turns, each
    ratio with its spread over the windows; a NaN fed
    into one drained watch row under ``RecoveryPolicy(perturb=False,
    lr_backoff=1.0)``: the graph and the step dispatch each roll back once
    and end bitwise equal to the unfaulted graph run; the SOM (8x8) and the
    RBM (784 x 128, CD-1) on the same pool with deferred sync, bitwise and
    in turns; every run's launches counted twice: through the wrappers'
    counters, set to 0 just before and read just after the run (the step
    dispatch's every launch; the graph dispatch's warm-up and capture
    calls), and, for the epochs after the first (the graph dispatch's
    replays only), as the kernel records of a ``torch.profiler`` (CUPTI)
    trace of those epochs, by kernel name, exact for both dispatches; AlexNet at full
    width (batch 128, bf16, 227^2, 1000 classes) from a resident FullBatch
    pool and from ``ImageNetLoader(device_resident=True)`` over packed
    256^2 files (1,024 train and 128 valid images), each bitwise against
    the step dispatch over 2 epochs with the LRN launches exact, the card's
    crops of an epoch equal to the host's native crops bitwise (and one
    batch's crop timed beside its bound), images/sec
    in turns beside phase 20's prefetch thread; for MNIST, the SOM, the RBM
    and AlexNet one train split of replays timed: the host's µs to issue a
    replay against the device's µs a step, the kernels' busy time
    (``torch.profiler``) and the idle share; the mid LM's width at 2
    layers through the graph with flash (its traced launches exact, the losses
    within 1e-4 of the step dispatch's: the embedding's backward adds with
    atomics);
23. the mixture of experts at the mid LM's width (``bench.py``'s LM_MOE:
    vocab 8192, d_model 512, 12 layers, 8 heads, 8 experts of d_ff 1024,
    top-k 2, T 2048, batch 16, flash attention in f32, lr 0.001), dense and
    capacity dispatch: one epoch (4 train steps, 1 eval step) with the flash
    counters set to 0 just before and read just after (12 of each kernel a
    train step), 2 warm-up and 3 timed train steps (tokens/sec beside phase
    8's dense-FFN mid LM), and a 512-token f32 forward at 2 layers on the
    card against the CPU from the same weights in both dispatches (within
    1e-4 of the largest logit);
24. the MoE LM at that width and 2 layers through the graph dispatch and
    the step dispatch, dense and capacity, as phase 22's LM: the flash
    launches of the replayed epoch read from its trace, exact; the losses
    within 1e-4 (the capacity combine adds with atomics: not bitwise);
25. KV-cache decoding at the mid LM (``bench.py``'s lm_decode: greedy,
    prompt 64, 256 new tokens, batch 16): ``generate`` (its decode step
    captured into a CUDA graph, replayed a position), the served program
    replayed again and the eager step loop, with generated tokens/sec for
    the replays and the eager loop and their tokens equal; every decode
    step's logits within 1e-4 of the largest of ``lm_apply``'s at the same
    position on the card, the tokens their argmax; then the MoE LM at 2
    layers, dense and capacity, graph against eager;
26. a ``generate_serve`` stream of ``bench.py``'s prompt lengths (16, 40,
    64, 120; 64 new tokens, batch 16 a request), twice over: exactly one
    program (a captured graph) a prompt bucket (16, 64, 128), the rest hits,
    each length's tokens equal to ``generate``'s; requests, hits, compiles,
    capture seconds (the program ledger) and tokens/sec;
27. the serving engines (``services/engine.py``) at the mid LM with
    ``bench.py``'s settings (max_seq 256, 16 slots, ``admit_every`` 8, EOS 0,
    greedy, weights from seed 95), each program a captured CUDA graph: the
    dense engine over 64 requests of prompts 16/40/64/120 and budget 64, the
    paged engine (block 32, the pool at the dense footprint) and its
    concurrency probe (32 slots, the same pool), the prefix cache on against
    off (a 160-token system prompt, 16/24/32-token tails, max_seq 384) and
    speculation (``spec_k`` 7 against 0, batch 8, ``bench.py``'s repeat-heavy
    stream): each warmed by one stream, then a fresh engine's first pass
    (its captures) and its second pass over the same prompts (timed: it must
    capture nothing and give the same tokens); each request's tokens against
    ``generate``'s on the card (equal, or first differing at a near-tie: the
    top-2 logits within 1e-5 of the largest magnitude); exactly the expected
    program keys, one graph each; tokens/sec, TTFT and latency percentiles,
    peak_active, prefix hits, TTFT on against off, the acceptance rate; the
    host µs to issue a chunk's replay against its device µs; then a 2-layer
    stream at the mid width on the card and on the CPU from the same weights
    (dense, paged and speculative engines; the MoE LM's dense and paged
    engines in both dispatches), equal tokens but for near-ties;
28. the serving front door (``services/frontdoor.py``) behind the HTTP
    server (``services/serve.py``) at ``bench.py``'s lm_serve_frontdoor
    settings (the mid LM from seed 95, a paged engine factory of 16 slots,
    block 32, ``admit_every`` 8, max_seq 256, EOS 0, greedy; ``max_pending``
    128, ``default_deadline_s`` 300): 4 HTTP clients POST 64 requests of
    prompts 16/40/64/120 and budget 64 after one warm request, each
    request's tokens against the engine alone on the same stream (equal, or
    first differing at a near-tie), the engine alone's programs and no new
    ledger entry; requests/sec, generated tokens/sec, TTFT p50/p99, queue
    age p99 and the engine thread's tick share beside the engine alone's and
    phase 27's; ``/healthz``, ``/metrics``, ``/debug/programs`` (the ledger,
    ``cuda:0``'s memory), ``/prefix_probe``, ``/slo``; the door's pusher into
    an in-process aggregator; on the card a cancel and a deadline mid-decode
    (the pool swept), an engine crash (slot residents typed ``error``, the
    rest golden on the rebuilt engine, its rebuild and re-capture seconds),
    ``/debug/profile`` during a stream (CUDA kernel events; a second
    capture 409; a chunk's replay issue time before and after), and
    ``close(drain=True)`` with work in flight (finished or typed ``shed``);
    then the dense engine and speculation (``spec_k`` 7 on phase 27's
    repeat-heavy stream, the same draft totals as the engine alone)
    through the door;
29. the serving cluster (``znicz_tpu_torch/cluster/``) at ``bench.py``'s
    lm_serve_router settings: two replicas (a front door over a paged engine
    of the mid LM behind the HTTP server each) and the prefix-affinity
    router in front of them, in this process; 3 families of a 160-token
    shared prefix with 16/24/32-token tails, 4 requests each, interleaved,
    budget 24, greedy, sequential, in three passes on fresh replicas (a warm
    affinity pass, then affinity and round-robin timed): the fleet's prefix
    hit rate, the client-clock TTFT, generated tokens/sec, retries, the
    replicas used and their programs; every request's tokens the engine
    alone's but for near-ties, each family on one replica under affinity,
    the affinity hit rate above round-robin's, no program beyond the engine
    alone's and none ledgered anew; then the failure paths (a refused
    connect, an engine crash mid-stream spliced golden, a dead replica
    ejected by the heartbeat and re-admitted, both replicas failing, a
    saturated fleet), each golden or typed with the pools swept after, and
    the port's doctor against the router's ``/metrics``;
30. data parallelism (``znicz_tpu_torch/parallel/``), cuDNN deterministic:
    30a. one NCCL rank (``multihost.initialize`` at a free localhost port,
    ``DataParallel(make_mesh())``, the group destroyed after): AlexNet at
    phase 4's geometry (10 train steps), the SOM and the RBM (configs[4]
    and configs[2], one epoch of 20 train steps through their kernels and
    psum rules) and the mid LM at full width (f32 flash, lr 0.001, 3 train
    steps), each against the same run without the policy from one seed:
    the params bitwise equal (the LM within 1e-6 of max |param|: its
    embedding's backward adds with atomics) and the same kernel launches;
    ms a step with and without the policy in turns (AlexNet median of 10,
    the LM of 3); MNIST at ``bench.py``'s ``mnist_epoch`` shape through
    the graph dispatch bitwise its step dispatch under the policy, a
    fresh run's first and second epoch traced: c10d's all-reduce called 6
    times in the first (2 in the eager warm-up step, 2 in the capture, 2
    at the epoch's end) and 2 in the second (its replays call none; a
    one-rank all-reduce in place launches no device work);
    30b. two ranks on the one card over gloo (this script started twice
    with ``--dp-rank``, each wait with its own timeout): the MNIST MLP (784
    -> 100 -> 10, global batch 100, 3 epochs) against one process on the
    card (loss within 1e-4 relative, n_err within 1), a snapshot from rank
    0 only; the SOM's weights within 1e-5 of one process's; the RBM's
    two-rank update against the one built here from the two shards' kernel
    statistics with seeds 2s and 2s + 1, summed (within 1e-5); a
    pool-sharded resident FullBatch pool with half the rows' bytes on each
    rank's card and an epoch trained; ``epoch_dispatch="scan"`` refused
    under gloo on the card;
31. tensor and expert parallelism (``parallel/tensor_parallel.py``), gloo
    ranks on the one card (this script started with ``--tp-rank``, each
    wait with its own timeout; cuDNN deterministic, TF32 off), each against
    one process on the card: two ranks as ``(data=1, model=2)``: AlexNet
    at full width (``tp=True``, so ``cnn_tp_rules``: conv1/3/5 and fc6/7
    column, conv2/4 row; batch cut to 32, 2 epochs; losses within 1e-3
    relative in bf16, each rank's LRN launches those of one process; the
    same run in f32: losses within 1e-4 and each leaf's change over the
    2 epochs within 10 times (+1e-5) the difference between one process's
    with cuDNN on and off, in norm, bf16's change read; the
    LRN pair against its plain version at that batch's norm1 and norm2
    shapes, f32 and bf16), the
    mid LM with ``tensor_parallel`` and f32 flash (batch cut to 2, one
    epoch of 3 steps; within 1e-4; each rank's flash kernels over its 4
    local heads), ``generate()`` on the gathered params against one
    process decoding the same params, and the MoE LM at 2 layers (4 of 8
    experts a rank) in both dispatches; ms a train step of a rank and of
    one process, and the collectives' wall share of a rank's step (each
    collective timed between two synchronisations); four ranks as ``(2,
    2)``: ``tests/test_multihost.py``'s TP conv net (losses within 1e-4,
    the coordinator's snapshot holding the whole ``(5, 5, 1, 8)`` kernel
    and loading into a run without TP), the SOM (params whole, psum over
    the data column; within 1e-5) and one RBM step through its psum rule
    (the two data rows' summed shards, within 1e-5);
32. sequence and pipeline parallelism (``parallel/ring_attention.py``,
    ``parallel/pipeline.py``), the mid LM at full width (f32 flash, TF32
    off, lr 0.001): 32a. one NCCL rank, batch 16 with
    ``sequence_parallel`` over ``make_mesh(1)`` (a ring of one) against
    the run without it, 3 train steps: the loss and every param within
    1e-6 (the same bits predicted: the merge's weights are 1 and 0 and the
    lse cotangent cancels), the same launches; then gloo ranks on the one
    card (this script started with ``--sp-pp-rank``, each wait with its
    own timeout), batch cut to 4, one epoch of 3 train steps, each against
    one process on the card (loss within 1e-4 relative, every rank's the
    same): 32b. two as ``make_mesh(2)`` with ``DataParallel`` and
    ``sequence_parallel`` (blocks of T 1024: rank 0 runs the diagonal
    block, rank 1 the diagonal and the past one, a layer a step); 32c. two
    as ``make_mesh(1, 1, 2)`` with ``pipeline_parallel`` (2 stages of 6
    layers, 4 microbatches of 1); 32d. four as ``make_mesh(1, 2, 2)`` with
    pipeline and tensor parallelism (flash over 4 local heads), the
    coordinator's snapshot holding the stage leaves whole and resumed on
    every rank; each rank's flash launches exactly as predicted and the
    (shape, causal) of every launch logged; ms a train step of a rank
    beside one process's, and the exchanges' wall share of it;
33. the launcher, ``python -m znicz_tpu_torch`` (``launcher.py``), on the
    card: 33a. ``launcher.run_args`` in this process on
    ``models/alexnet.py`` (full width, the synthetic stand-in) with
    ``--random-seed``, ``--stop-after 1``, ``--snapshot-dir`` and
    ``--export``, the LRN counters set to 0 just before and read just
    after (10 forward and 8 backward launches predicted from 4 train and 1
    eval step), its epoch's history and params bitwise those of the same
    workflow built directly (fresh streams, ``initialize(seed=)``, as the
    CLI does; cuDNN deterministic); the build, ``initialize``, the epoch,
    the best snapshot's save and the export timed apart;
    33b. the artifact's blobs bitwise the trained f32 masters, a second
    export timed and byte-equal, ``native/znicz_infer.cc`` built with g++
    into ``build/native/`` and run on 4 validation images against the
    port's f32 forward of the same params on the card (TF32 off; rtol 1e-4,
    atol 1e-6, tighter than ``tests/test_native.py``'s for conv stacks: the
    one-epoch output is near-uniform, p ~ 1e-3; the engine's seconds are
    host CPU time); 33c. ``--evaluate valid`` of 33a's best
    snapshot in a process of its own against ``Workflow.evaluate`` on the
    same params (rtol 1e-4); 33d. ``--supervise`` over the MNIST MLP of
    ``tests/test_torch_launcher.py`` with a crash entering epoch 2
    (``ZNICZ_FAULTS``), ``supervisor.json`` one restart, the result's
    history and params equal to an uninterrupted CLI run's, the restarted
    child's start, CUDA init, build and run on its own clocks; 33e. SIGTERM
    mid epoch 1: exit 75 with an emergency snapshot, then ``--resume auto``
    to the uninterrupted run's result (33d-e's processes run beside
    33a-c); 33f. ``MetricsCSVWriter``, ``StatusWriter``,
    ``MarkdownReporter`` and ``AccumulatingPlotter`` attached by a config
    module to the MNIST MLP on the card: the files each epoch, and the
    plotter's PNG with matplotlib or its logged failure without it while
    training goes on; each part's seconds;
34. the whole script's seconds, the ``kernels`` JSON line (each flash row
    with its bf16 times, bound, launches and error beside the f32 ones under
    ``"bf16"``; the f32 flash, Kohonen and RBM rows also with their f32-FMA
    bound and their float64 errors beside the plain version's; the LRN rows
    with the CIFAR path's launches and f32 times under ``"cifar"``, the
    disk path's launches under ``"alexnet_disk"``, the host loop's under
    ``"host_loop"`` and the poisoned run's of phase 21 under
    ``"self_healing"``; every row with the launches that phase 22's traces
    read from the graph dispatch's replayed epochs under ``"scan"``; each
    flash row with the MoE epochs' launches of phase 23 and the traced ones
    of phase 24 under ``"moe"``; every row with phase 30's one-NCCL-rank
    launches under ``"dp"``, the Kohonen and RBM rows with each gloo
    rank's; every row with phase 31's gloo ranks' launches under
    ``"tp"``; each flash row with phase 32's gloo ranks' launches and the
    ring of one's under ``"sp_pp"``), then the result line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ALEXNET_NORMS = {  # NHWC inputs of AlexNet's two norm layers at batch 128
    "norm1": (128, 55, 55, 96),
    "norm2": (128, 27, 27, 256),
}
LRN = dict(alpha=1e-4, beta=0.75, k=2.0, n=5)
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
# operations per element: window sum of squares (2n), s (2), s^-beta (3),
# the product (1); the backward adds the inner term (3), the adjoint window
# (n) and the two-term output (4)
FWD_OPS = 2 * LRN["n"] + 6
BWD_OPS = 3 * LRN["n"] + 12
REPLACES = {
    "lrn_fwd": "znicz_tpu/ops/pallas/lrn.py:123",
    "lrn_bwd": "znicz_tpu/ops/pallas/lrn.py:142",
}
LRN_ROUTE = {  # (route, source)
    "lrn_fwd": ("triton", "znicz_tpu_torch/ops/kernels/lrn.py"),
    "lrn_bwd": ("cuda", "znicz_tpu_torch/csrc/lrn.cu"),
}

# the repo's mid LM (bench.py's LM_MID: ~50M parameters), T 2048, batch 16
LM_MID = dict(vocab=8192, d_model=512, n_layers=12, n_heads=8)
LM_T, LM_B = 2048, 16
LM_N_TRAIN, LM_N_TEST = 64, 16  # 4 train steps and 1 eval step an epoch
FLASH_CASES = [  # (tag, B, T, H, D, causal)
    ("slice", LM_B, LM_T, 8, 64, True),
    ("d32", 4, 1024, 8, 32, True),
    ("d128", 2, 1024, 8, 128, True),
    ("full", 2, 1024, 8, 64, False),
    ("ragged", 2, 2000, 8, 64, True),
    # phase 31's on each of two tensor-parallel ranks: batch 2, 4 local heads
    ("tp", 2, LM_T, LM_MID["n_heads"] // 2, 64, True),
    # phase 32's: the two-rank ring's blocks (batch 4, T 1024: the diagonal
    # causal, the past block whole), a pipeline stage's microbatch, and the
    # same over a tensor-parallel rank's 4 local heads
    ("ring", 4, LM_T // 2, 8, 64, True),
    ("ring_full", 4, LM_T // 2, 8, 64, False),
    ("stage", 1, LM_T, 8, 64, True),
    ("stage_tp", 1, LM_T, LM_MID["n_heads"] // 2, 64, True),
]
# of the reference's largest magnitude: f32 sums run in another order; bf16
# rounds p and ds before their products at other places (running maxima)
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the 3xTF32 f32 flash kernels against float64: within this factor of the
# f32 plain version's error (one TF32 product would be ~1000 times it)
FLOAT64_FACTOR = 10
PEAK_FLOPS = {"float32": F32_FLOPS, "bfloat16": 989e12}  # H100 SXM, dense
TF32_FLOPS = 495e12  # H100 SXM, dense; 3xTF32 takes three products for one
# products of 2*D flops for each live (q, k) pair
FLASH_PRODUCTS = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}
FLASH_SOURCE = "znicz_tpu_torch/csrc/flash_attention.cu"
REPLACES.update({
    "flash_fwd": "znicz_tpu/ops/pallas/attention.py:212",
    "flash_dq": "znicz_tpu/ops/pallas/attention.py:265",
    "flash_dkv": "znicz_tpu/ops/pallas/attention.py:277",
})
FLASH = tuple(FLASH_PRODUCTS)
F64_OUTPUTS = {"flash_fwd": ("out", "lse"), "flash_dq": ("dq",), "flash_dkv": ("dk", "dv")}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, *, warmup: int = 3, iters: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean per-call time of ``iters`` calls,
    by CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def compare(name, got, ref, dtype_name, *, strict=True):
    """Max abs/rel error of ``got`` against ``ref``; fails past TOL when
    ``strict``."""
    rtol, atol = TOL[dtype_name]
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / r.abs().clamp_min(1e-30)).max())
    bad = int((diff > atol + rtol * r.abs()).sum())
    print(
        f"check {name} {dtype_name}: max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} (rtol {rtol}, atol {atol}) "
        f"{'ok' if bad == 0 else f'{bad} elements out of tolerance'}"
    )
    if strict and (bad or not math.isfinite(max_abs)):
        fail(f"{name} {dtype_name} disagrees with its plain version")
    return max_abs


def _lrn_inputs(torch, gen, shape, dtype):
    """Softplus-like positive activations, as after conv_relu, and an O(1)
    output gradient, so that |dx| (up to ~10) stands well above atol and a
    zero or misplaced dx fails the check."""
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).exp().log1p()
    g = torch.randn(shape, generator=gen, device="cuda") * 3
    return x.to(dtype), g.to(dtype)


def _lrn_canary(torch, lrn_kernel, label, x, g, want, args):
    """The backward's C entry with dx at the front of a NaN-filled larger
    buffer: fails if anything past dx changed or dx differs from ``want``
    (the wrapper's)."""
    numel = x.numel()
    buf = torch.full((numel + 4096,), math.nan, dtype=x.dtype, device="cuda")
    lrn_kernel._launch_bwd(x, g, buf[:numel].view(x.shape), *args)
    torch.cuda.synchronize()
    past = not bool(torch.isnan(buf[numel:]).all())
    same = torch.equal(buf[:numel].view(x.shape), want)
    print(f"check lrn_bwd {label} canary: dx at the front of a NaN-filled buffer: written "
          f"past it: {past}; values bitwise the wrapper's: {same}")
    if past or not same:
        fail(f"lrn_bwd {label}: the kernel wrote past dx or differs from the wrapper")


def phase_kernels(torch, lrn_kernel, shapes=ALEXNET_NORMS, seed=0):
    """Phase 2 and 3 (and 16's kernel part at CIFAR's shape): correctness at
    each of ``shapes`` in both dtypes (the backward also a bitwise repeat
    and a canary), then times."""
    args = (LRN["alpha"], LRN["beta"], LRN["k"], LRN["n"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    err = {"lrn_fwd": {}, "lrn_bwd": {}}  # {dtype name: max over the shapes}
    rows = {"lrn_fwd": {}, "lrn_bwd": {}}  # {dtype name: [a row a shape]}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for tag, shape in shapes.items():
            x, g = _lrn_inputs(torch, gen, shape, dtype)
            y = lrn_kernel.lrn_forward(x, *args)
            dx = lrn_kernel.lrn_backward(x, g, *args)
            torch.cuda.synchronize()
            e_f = compare(f"lrn_fwd {tag}", y, lrn_kernel.lrn_reference(x, *args), dname)
            e_b = compare(
                f"lrn_bwd {tag}", dx, lrn_kernel.lrn_bwd_reference(x, g, *args), dname
            )
            err["lrn_fwd"][dname] = max(err["lrn_fwd"].get(dname, 0.0), e_f)
            err["lrn_bwd"][dname] = max(err["lrn_bwd"].get(dname, 0.0), e_b)
            same = torch.equal(lrn_kernel.lrn_backward(x, g, *args), dx)
            print(f"check lrn_bwd {tag} {dname}: a second launch bitwise equal to the first: "
                  f"{same}")
            if not same:
                fail(f"lrn_bwd {tag} {dname}: a repeat launch differs")
            _lrn_canary(torch, lrn_kernel, f"{tag} {dname}", x, g, dx, args)
            nbytes = x.numel() * x.element_size()
            xc = x.permute(0, 3, 1, 2)  # NCHW view for the yardstick
            lib = lambda: torch.nn.functional.local_response_norm(  # noqa: E731
                xc, LRN["n"], alpha=LRN["alpha"] * LRN["n"], beta=LRN["beta"], k=LRN["k"]
            )
            compare(f"yardstick F.local_response_norm {tag}", lib().permute(0, 2, 3, 1),
                    lrn_kernel.lrn_reference(x, *args), dname, strict=False)
            xr = xc.detach().requires_grad_(True)
            y_lib = torch.nn.functional.local_response_norm(
                xr, LRN["n"], alpha=LRN["alpha"] * LRN["n"], beta=LRN["beta"], k=LRN["k"]
            )
            gc = g.permute(0, 3, 1, 2)
            t = {
                "fwd_ms": cuda_ms(lambda: lrn_kernel.lrn_forward(x, *args)),
                "fwd_plain_ms": cuda_ms(lambda: lrn_kernel.lrn_reference(x, *args)),
                "fwd_lib_ms": cuda_ms(lib),
                "bwd_ms": cuda_ms(lambda: lrn_kernel.lrn_backward(x, g, *args)),
                "bwd_plain_ms": cuda_ms(lambda: lrn_kernel.lrn_bwd_reference(x, g, *args)),
                "bwd_lib_ms": cuda_ms(
                    lambda: torch.autograd.grad(y_lib, xr, gc, retain_graph=True)
                ),
            }
            n_el = x.numel()
            # (bytes over the memory rate, operations over the f32 rate)
            limits = {
                "lrn_fwd": (2 * nbytes / HBM_BYTES_PER_S, FWD_OPS * n_el / F32_FLOPS),
                "lrn_bwd": (3 * nbytes / HBM_BYTES_PER_S, BWD_OPS * n_el / F32_FLOPS),
            }
            for kname, short in (("lrn_fwd", "fwd"), ("lrn_bwd", "bwd")):
                row = {
                    "shape": tag,
                    "ms": t[f"{short}_ms"],
                    "plain_ms": t[f"{short}_plain_ms"],
                    "library_ms": t[f"{short}_lib_ms"],
                    "bound_ms": max(limits[kname]) * 1e3,
                    "bound_by": "bytes" if limits[kname][0] >= limits[kname][1] else "operations",
                }
                rows[kname].setdefault(dname, []).append(row)
                print(
                    f"time {kname} {tag} {list(shape)} {dname}: kernel {row['ms']:.4f} ms, "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                    f"plain {row['plain_ms']:.4f} ms, "
                    f"F.local_response_norm {'fwd' if short == 'fwd' else 'autograd bwd'} "
                    f"{row['library_ms']:.4f} ms"
                )
            del xr, y_lib
    return err, rows


# the backward's other instantiations: contiguous views that start 1 and 2
# elements past an allocation (narrower vectors), and C 16,384 (whole rows in
# shared memory), each on 128 rows; the C 16,384 case also at n 7
LRN_BWD_EXTRA = [  # (tag, shape, view offset in elements, n)
    ("misaligned+1", ALEXNET_NORMS["norm1"], 1, LRN["n"]),
    ("misaligned+2", ALEXNET_NORMS["norm1"], 2, LRN["n"]),
    ("c16384", (128, 16384), 0, LRN["n"]),
    ("c16384_n7", (128, 16384), 0, 7),
]


def phase_lrn_bwd_extra(torch, lrn_kernel):
    """Phase 3b: the backward at the shapes and views the wrappers route to
    its other instantiations, against the plain version, with a canary;
    returns {tag: {dtype name: max abs error}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = {}
    for tag, shape, offset, n in LRN_BWD_EXTRA:
        args = (LRN["alpha"], LRN["beta"], LRN["k"], n)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x0, g0 = _lrn_inputs(torch, gen, shape, dtype)
            numel = x0.numel()
            x = torch.empty(numel + offset, dtype=dtype, device="cuda")[offset:].view(shape)
            g = torch.empty(numel + offset, dtype=dtype, device="cuda")[offset:].view(shape)
            x.copy_(x0)
            g.copy_(g0)
            geo = lrn_kernel.launch_geometry(numel // shape[-1], shape[-1], x.element_size(),
                                             lrn_kernel._alignment(x, g), n)
            launches = lrn_kernel.lrn_backward.launches
            dx = lrn_kernel.lrn_backward(x, g, *args)
            torch.cuda.synchronize()
            if lrn_kernel.lrn_backward.launches != launches + 1:
                fail(f"lrn_bwd {tag}: the wrapper did not launch the kernel")
            print(f"lrn_bwd {tag} {list(shape)} {dname} n {n}: "
                  f"{'halo' if geo.halo else 'rows'} kernel, {geo.vec}-element vectors, "
                  f"{geo.rows_per_block} rows a block of {geo.threads} threads")
            e = compare(f"lrn_bwd {tag}", dx, lrn_kernel.lrn_bwd_reference(x, g, *args), dname)
            out.setdefault(tag, {})[dname] = e
            _lrn_canary(torch, lrn_kernel, f"{tag} {dname}", x, g, dx, args)
    return out


def phase_slice(torch, lrn_kernel, alexnet, model_lib, prng):
    """Phase 4: the port's main path at AlexNet's published geometry."""
    prng.seed_all(1234)
    t0 = time.perf_counter()
    wf = alexnet.build_workflow(device="cuda")
    wf.initialize()
    torch.cuda.synchronize()
    print(f"slice: built AlexNet workflow in {time.perf_counter() - t0:.1f} s; "
          f"layer shapes {list(wf.model.layer_shapes)}")
    n_train = wf.loader.n_minibatches("train")
    n_eval = wf.loader.n_minibatches("valid")
    torch.backends.cudnn.benchmark = True

    # the main path: counts set to 0 just before, read just after
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {
        "lrn_fwd": lrn_kernel.lrn_forward.launches,
        "lrn_bwd": lrn_kernel.lrn_backward.launches,
    }
    summary = verdict["summary"]
    print(f"slice: epoch 1 (first, with cuDNN autotuning) {epoch_s:.2f} s: "
          + json.dumps(summary))
    for split, n in (("train", 512), ("valid", 128)):
        m = summary.get(split)
        if m is None or m["n_samples"] != n:
            fail(f"{split} split saw {m and m['n_samples']} samples, want {n}")
        if not all(math.isfinite(float(v)) for v in m.values()):
            fail(f"non-finite {split} metrics: {m}")
    want = {"lrn_fwd": 2 * (n_train + n_eval), "lrn_bwd": 2 * n_train}
    print(f"slice: launches {launches}, want {want} "
          f"({n_train} train steps, {n_eval} eval steps, 2 norm layers)")
    if launches != want:
        fail(f"LRN launch counts {launches} != {want}")

    # step times: train steps on one minibatch, synchronised each step
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x = torch.as_tensor(mb.data, device="cuda")
    y = torch.as_tensor(mb.labels, device="cuda")
    mask = torch.as_tensor(mb.mask, device="cuda")
    step_s = []
    for _ in range(12):
        t0 = time.perf_counter()
        acc = wf.train_step(x, y, mask)
        float(acc[0])  # the step's metrics on the host: a full sync
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s[2:])
    batch = x.shape[0]
    print(f"slice: train step (batch {batch}, bf16) median {med * 1e3:.2f} ms over "
          f"{len(step_s) - 2} steps after 2 warm-up; {batch / med:.1f} images/sec; "
          f"all steps ms {[round(s * 1e3, 2) for s in step_s]}")
    t0 = time.perf_counter()
    verdict2 = wf.run_epoch()
    torch.cuda.synchronize()
    print(f"slice: epoch 2 {time.perf_counter() - t0:.2f} s "
          f"({n_train} train + {n_eval} eval steps, host loop included): "
          + json.dumps(verdict2["summary"]))

    # card vs CPU: 4-image f32 forward from identical weights, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    m32 = model_lib.build(
        alexnet.DEFAULTS["layers"], wf.loader.sample_shape, device="cpu"
    )
    host = model_lib.params_to_numpy(wf.state.params)
    xb = torch.as_tensor(mb.data[:4]).float() * (1.0 / 255.0) - 0.5
    with torch.no_grad():
        out_gpu = m32.apply(model_lib.params_from_jax(host, "cuda"), xb.cuda()).cpu()
        out_cpu = m32.apply(model_lib.params_from_jax(host, "cpu"), xb)
    rel = float((out_gpu - out_cpu).abs().max() / out_cpu.abs().max())
    print(f"slice: 4-image f32 forward, card vs CPU: max |diff| / max |logit| = "
          f"{rel:.3e} (limit 1e-4); logits shape {list(out_gpu.shape)}")
    if not rel < 1e-4 or out_gpu.shape != (4, 1000):
        fail("card and CPU forwards disagree")
    return launches, {"step_ms": med * 1e3, "images_per_s": batch / med}


# a flash kernel's mangled name: (fwd|dq|dkv)_mma_kernel<D> (bf16) and
# (fwd|dq|dkv)_tf32_kernel<D> (f32, 3xTF32), all on the tensor cores
_FLASH_KERNEL = re.compile(r"(fwd|dq|dkv)_(mma|tf32)_kernelILi(\d+)E")
_PTXAS_ENTRY = re.compile(r"Compiling entry function '\S*?" + _FLASH_KERNEL.pattern)


def build_all(cuda_build):
    """Every CUDA C++ source of the port built from the sources here, one
    nvcc each, all started together; returns {name: Built}."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        built = dict(zip(CUDA_SOURCES, pool.map(cuda_build.build, CUDA_SOURCES)))
    print(f"build: {len(built)} CUDA sources in parallel, {time.perf_counter() - t0:.1f} s wall")
    return built


def _flash_key(m):
    """(kernel, dtype, D) of a _FLASH_KERNEL match."""
    return m.group(1), "bf16" if m.group(2) == "mma" else "f32", int(m.group(3))


def _sass_mma_counts(cuda_build, lib_path):
    """{(kernel, dtype, D): (HMMA, HGMMA)} of each flash kernel: the
    tensor-core instructions in ``cuobjdump -sass`` of the built library."""
    from pathlib import Path

    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = _FLASH_KERNEL.search(line)
            cur = _flash_key(m) if m else None
            if cur is not None:
                counts[cur] = [0, 0]
        elif cur is not None:
            op = re.search(r"\b(HMMA|HGMMA)\.", line)
            if op:
                counts[cur][op.group(1) == "HGMMA"] += 1
    return {key: tuple(c) for key, c in counts.items()}


def phase_flash_build(built, fa, cuda_build, torch):
    """Phase 5: the flash-attention library's build and its tensor-core
    instructions."""
    print(f"build: {built.path.name}: nvcc {built.seconds:.1f} s"
          + ("" if built.seconds else " (the library was there already)"))
    rows, cur = [], None
    for line in built.log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            kernel, dtype, d = _flash_key(m)
            cur = {"kernel": kernel, "dtype": dtype, "d": d, "regs": None, "spill": None}
            rows.append(cur)
        elif cur is not None:
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if regs:
                cur["regs"] = int(regs.group(1))
            if spill:
                cur["spill"] = (int(spill.group(1)), int(spill.group(2)))
    if len(rows) != 24:
        fail(f"ptxas reported {len(rows)} flash kernels, want 24 (3 kernels x 2 dtypes x 4 D)")
    sass = _sass_mma_counts(cuda_build, built.path)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for r in sorted(rows, key=lambda r: (r["kernel"], r["dtype"], r["d"])):
        key = (r["kernel"], r["dtype"], r["d"])
        hmma, hgmma = sass.get(key, (0, 0))
        print(f"ptxas flash_{r['kernel']} {r['dtype']} D={r['d']}: {r['regs']} registers, "
              f"spill stores/loads {r['spill']} bytes, "
              f"{fa.smem_bytes(r['kernel'], r['d'], dtypes[r['dtype']])} bytes dynamic shared "
              f"memory a block; SASS tensor-core instructions: {hmma} HMMA, {hgmma} HGMMA")
        # all on the tensor cores (the f32 ones in 3xTF32)
        if hmma + hgmma == 0:
            fail(f"flash_{r['kernel']} {r['dtype']} D={r['d']} has no tensor-core instructions")


def _flash_inputs(torch, b, t, h, d, dtype, seed):
    """q, k, v, dout (O(1), so a zero or misplaced gradient fails) and dlse."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v, dout = (
        torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype) for _ in range(4)
    )
    dlse = torch.randn((b, t, h), generator=gen, device="cuda")
    return q, k, v, dout, dlse


def _near(name, got, ref, tol):
    """Max abs error of ``got`` against ``ref``; fails past ``tol`` times the
    reference's largest magnitude."""
    scale = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    ok = math.isfinite(err) and err <= tol * max(scale, 1e-6)
    print(f"check {name}: max_abs_err={err:.3e} of max |ref| {scale:.3e} "
          f"(limit {tol} of it) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def _flash_bwd_float64(torch, q, k, v, dout, lse, delta, causal, scale):
    """dq, dk, dv in float64 from the same inputs: the answer that the f32
    kernels and the f32 plain versions both approximate."""
    q, k, v, dout, lse, delta = (x.double() for x in (q, k, v, dout, lse, delta))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - lse.permute(0, 2, 1)[..., None])
    del s
    if causal:
        p = p.tril()
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dout, v) - delta.permute(0, 2, 1)[..., None])
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k),
            scale * torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, dout))


def _flash_fwd_float64(torch, q, k, v, causal, scale):
    """out and lse in float64 from the same inputs: the answer that the f32
    forward kernel and the f32 plain version both approximate."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    if causal:
        t = q.shape[1]
        s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool, device=s.device).tril(),
                          -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    s = torch.exp(s - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", s, v.double()), lse.permute(0, 2, 1)


def _float64_check(torch, label, names, got, plain, exact):
    """Each f32 result's max error against float64, the kernel's within
    FLOAT64_FACTOR of the plain version's; returns {name: (kernel's, plain
    version's max error)}."""
    out = {}
    for name, g, p, e in zip(names, got, plain, exact):
        ek = float((g.double() - e).abs().max())
        ep = float((p.double() - e).abs().max())
        ok = math.isfinite(ek) and ek <= FLOAT64_FACTOR * ep
        print(f"check {label} {name} against float64: kernel (3xTF32) max_abs_err={ek:.3e}, "
              f"f32 plain version {ep:.3e}, ratio {ek / max(ep, 1e-30):.2f} (limit "
              f"{FLOAT64_FACTOR}) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{label} {name}: the f32 kernel is not f32-accurate against float64")
        out[name] = (ek, ep)
    return out


def phase_flash_checks(torch, fa):
    """Phase 6: each flash kernel against its plain version; at the slice
    shape every kernel launched twice; the f32 forward (slice, D 128, no
    mask) and the f32 dQ and dK/dV (slice) against float64.  Returns the
    slice shape's max errors in f32 and bf16, and the f32 kernels' float64
    errors there."""
    err, bf16_err, f64_err = {}, {}, {}
    for seed, (tag, b, t, h, d, causal) in enumerate(FLASH_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v, dout, dlse = _flash_inputs(torch, b, t, h, d, dtype, seed)
            kw = dict(causal=causal, scale=1.0 / math.sqrt(d))
            label = f"{tag} [{b},{t},{h},{d}] {'causal' if causal else 'full'} {dname}"
            out, lse = fa.flash_fwd(q, k, v, **kw)
            out_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
            # both backward kernels from the same residuals and delta as
            # their plain versions
            delta = ((dout.float() * out_r.float()).sum(-1) - dlse).contiguous()
            dq = fa.flash_dq(q, k, v, dout, lse_r, delta, **kw)
            dk, dv = fa.flash_dkv(q, k, v, dout, lse_r, delta, **kw)
            torch.cuda.synchronize()
            tol = FLASH_TOL[dname]
            e = {"flash_fwd": _near(f"flash_fwd out {label}", out, out_r, tol)}
            _near(f"flash_fwd lse {label}", lse, lse_r, FLASH_TOL["float32"])
            del out_r
            dq_r = fa.flash_dq_reference(q, k, v, dout, lse_r, delta, **kw)
            e["flash_dq"] = _near(f"flash_dq {label}", dq, dq_r, tol)
            dk_r, dv_r = fa.flash_dkv_reference(q, k, v, dout, lse_r, delta, **kw)
            e["flash_dkv"] = max(_near(f"flash_dkv dk {label}", dk, dk_r, tol),
                                 _near(f"flash_dkv dv {label}", dv, dv_r, tol))
            if dtype is torch.float32 and tag in ("slice", "d128", "full"):
                out_r, _ = fa.flash_fwd_reference(q, k, v, **kw)
                exact = _flash_fwd_float64(torch, q, k, v, causal, kw["scale"])
                f64 = _float64_check(torch, f"flash_fwd {label}", ("out", "lse"), (out, lse),
                                     (out_r, lse_r), exact)
                del out_r, exact
                if tag == "slice":
                    f64_err.update(f64)
            if tag == "slice":
                if dtype is torch.float32:  # the counted epoch's
                    err = e
                    exact = _flash_bwd_float64(torch, q, k, v, dout, lse_r, delta, causal,
                                               kw["scale"])
                    f64_err.update(_float64_check(torch, f"{label}", ("dq", "dk", "dv"),
                                                  (dq, dk, dv), (dq_r, dk_r, dv_r), exact))
                    del exact
                else:
                    bf16_err = e
                # one owner per output tile, no atomics: the same bits again
                out2, lse2 = fa.flash_fwd(q, k, v, **kw)
                dq2 = fa.flash_dq(q, k, v, dout, lse_r, delta, **kw)
                dk2, dv2 = fa.flash_dkv(q, k, v, dout, lse_r, delta, **kw)
                torch.cuda.synchronize()
                same = {"flash_fwd": torch.equal(out, out2) and torch.equal(lse, lse2),
                        "flash_dq": torch.equal(dq, dq2),
                        "flash_dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2)}
                print(f"check {label}: a second launch bitwise equal to the first: {same}")
                if not all(same.values()):
                    fail(f"{dname} launches at {label} are not bitwise repeatable")
                del out2, lse2, dq2, dk2, dv2
            del q, k, v, dout, dlse, out, lse, lse_r, delta, dq, dk, dv, dq_r, dk_r, dv_r
            torch.cuda.empty_cache()
    return err, bf16_err, f64_err


def phase_flash_inputs(torch, fa):
    """Phase 6b: what JAX's kernel takes and the kernels' grid does not hold
    as it is.  A head dim between the kernels' (96: zero-padded to 128 in
    the autograd layer) and non-contiguous views through
    ``flash_attention_lse``, forward and gradients against autograd through
    the plain forward on the same tensors, each kernel launched once; and a
    B*H above the grid's 65535, launched a batch slice at a time."""
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        b, t, h, d = 2, 1024, 8, 96
        q, k, v, dout, dlse = _flash_inputs(torch, b, t, h, d, dtype, 7)
        label = f"padded head dim [{b},{t},{h},{d}] causal {dname}"

        def grads(fn):
            xs = [x.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v)]  # non-contiguous views
            out, lse = fn(*xs)
            g = torch.autograd.grad((out, lse), xs, (dout, dlse))
            return (out.detach(), lse.detach(), *g)

        before = {name: getattr(fa, name).launches for name in FLASH}
        got = grads(lambda *xs: fa.flash_attention_lse(*xs, causal=True))
        torch.cuda.synchronize()
        launched = {name: getattr(fa, name).launches - before[name] for name in FLASH}
        want = grads(lambda *xs: fa.flash_fwd_reference(*xs, causal=True, scale=d ** -0.5))
        print(f"check {label}: launches {launched}")
        if launched != dict.fromkeys(FLASH, 1):
            fail(f"{label}: launches {launched}, want one of each kernel")
        for name, g, r in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            if g.shape != r.shape:
                fail(f"{label}: {name} shape {tuple(g.shape)} != {tuple(r.shape)}")
            _near(f"{label} {name}", g, r,
                  FLASH_TOL["float32"] if name == "lse" else FLASH_TOL[dname])
        del q, k, v, dout, dlse, got, want
    b, t, h, d = 4100, 64, 16, 16  # B*H = 65600
    q, k, v, dout, dlse = _flash_inputs(torch, b, t, h, d, torch.float32, 8)
    kw = dict(causal=True, scale=0.25)
    label = f"B*H {b * h} [{b},{t},{h},{d}] causal float32"
    before = {name: getattr(fa, name).launches for name in FLASH}
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = ((dout * out).sum(-1) - dlse).contiguous()
    dq = fa.flash_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = fa.flash_dkv(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    launched = {name: getattr(fa, name).launches - before[name] for name in FLASH}
    print(f"check {label}: launches {launched} (a batch slice each)")
    if launched != dict.fromkeys(FLASH, 2):
        fail(f"{label}: launches {launched}, want two of each kernel")
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    _near(f"flash_fwd out {label}", out, out_r, FLASH_TOL["float32"])
    _near(f"flash_fwd lse {label}", lse, lse_r, FLASH_TOL["float32"])
    del out_r, lse_r
    _near(f"flash_dq {label}", dq, fa.flash_dq_reference(q, k, v, dout, lse, delta, **kw),
          FLASH_TOL["float32"])
    for name, g, r in zip(("dk", "dv"), (dk, dv),
                          fa.flash_dkv_reference(q, k, v, dout, lse, delta, **kw)):
        _near(f"flash_dkv {name} {label}", g, r, FLASH_TOL["float32"])
    del q, k, v, dout, dlse, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()


def _flash_rate(name, dname):
    """The card's peak rate for the products a kernel takes: 3xTF32 (three
    TF32 products for one) for the f32 kernels, bf16 for the bf16 ones."""
    return TF32_FLOPS / 3 if dname == "float32" else PEAK_FLOPS[dname]


def _flash_bounds(b, t, h, d, causal, esize, dname, rate=_flash_rate):
    """Per kernel: (bound ms, "bytes" or "operations") for these inputs:
    the live (q, k) pairs they need, each input read once, each output
    written once; the operations at ``rate(kernel, dtype)``."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor, stat = b * t * h * d * esize, b * t * h * 4
    nbytes = {
        "flash_fwd": 4 * tensor + stat,  # q, k, v in; out, lse out
        "flash_dq": 5 * tensor + 2 * stat,  # q, k, v, dout, lse, delta in; dq out
        "flash_dkv": 6 * tensor + 2 * stat,  # and dk, dv out
    }
    out = {}
    for name, n_products in FLASH_PRODUCTS.items():
        t_ops = n_products * 2 * d * pairs / rate(name, dname)
        t_bytes = nbytes[name] / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_flash_times(torch, fa):
    """Phase 7: times at the LM slice's shape, f32 and bf16."""
    _, b, t, h, d, causal = FLASH_CASES[0]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q, k, v, dout, dlse = _flash_inputs(torch, b, t, h, d, dtype, 100)
        kw = dict(causal=causal, scale=1.0 / math.sqrt(d))
        out, lse = fa.flash_fwd(q, k, v, **kw)
        delta = ((dout.float() * out.float()).sum(-1) - dlse).contiguous()
        bwd = (q, k, v, dout, lse, delta)
        heavy = dict(warmup=1, iters=3, repeats=3)
        ms = {
            "flash_fwd": (cuda_ms(lambda: fa.flash_fwd(q, k, v, **kw), iters=5, repeats=3),
                          cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, **kw), **heavy)),
            "flash_dq": (cuda_ms(lambda: fa.flash_dq(*bwd, **kw), iters=5, repeats=3),
                         cuda_ms(lambda: fa.flash_dq_reference(*bwd, **kw), **heavy)),
            "flash_dkv": (cuda_ms(lambda: fa.flash_dkv(*bwd, **kw), iters=5, repeats=3),
                          cuda_ms(lambda: fa.flash_dkv_reference(*bwd, **kw), **heavy)),
        }
        # the yardstick: one PyTorch call, on [B, H, T, D] views
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), iters=5, repeats=3)
        xr = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
        o_lib = sdpa(*xr, is_causal=causal)
        g_lib = dout.transpose(1, 2)
        lib_bwd = cuda_ms(
            lambda: torch.autograd.grad(o_lib, xr, g_lib, retain_graph=True), iters=5, repeats=3
        )
        bounds = _flash_bounds(b, t, h, d, causal, q.element_size(), dname)
        # the f32 kernels' bound on f32 FMAs too, beside their 3xTF32 one
        fma = _flash_bounds(b, t, h, d, causal, q.element_size(), dname,
                            rate=lambda name, dname: PEAK_FLOPS[dname])
        for name in FLASH:
            kernel_ms, plain_ms = ms[name]
            bound_ms, bound_by = bounds[name]
            lib = lib_fwd if name == "flash_fwd" else lib_bwd
            rows[(name, dname)] = {
                "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib,
            }
            extra = ""
            if dname == "float32":
                rows[(name, dname)]["f32_fma_bound_ms"] = fma[name][0]
                extra = f" (3xTF32; {fma[name][0]:.4f} ms on f32 FMAs)"
            print(f"time {name} [{b},{t},{h},{d}] causal {dname}: kernel {kernel_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}){extra}, plain {plain_ms:.4f} ms, "
                  f"F.scaled_dot_product_attention "
                  f"{'fwd' if name == 'flash_fwd' else 'autograd bwd (dq, dk, dv together)'} "
                  f"{lib:.4f} ms")
        del q, k, v, dout, dlse, out, lse, delta, bwd, qt, kt, vt, xr, o_lib, g_lib
        torch.cuda.empty_cache()
    return rows


def _timed_steps(torch, fa, wf, label, steps=12, layers=LM_MID["n_layers"]):
    """Median of ``steps - 2`` synchronised train steps after 2 warm-up, on
    the first train minibatch, with the flash counters set to 0 just before
    and read just after (one launch of each kernel a layer and step);
    returns (step ms, tokens/sec, launches)."""
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x = torch.as_tensor(mb.data, device="cuda")
    y = torch.zeros((x.shape[0],), dtype=torch.int32, device="cuda")
    mask = torch.as_tensor(mb.mask, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    for name in FLASH:
        getattr(fa, name).launches = 0
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        acc = wf.train_step(x, y, mask)
        float(acc[0])  # the step's metrics on the host: a full sync
        step_s.append(time.perf_counter() - t0)
    launches = {name: getattr(fa, name).launches for name in FLASH}
    med = statistics.median(step_s[2:])
    tokens = x.shape[0] * x.shape[1]
    print(f"lm: train step ({label}, batch {x.shape[0]} x T {x.shape[1]}) median "
          f"{med * 1e3:.2f} ms over {len(step_s) - 2} steps after 2 warm-up; "
          f"{tokens / med:.1f} tokens/sec; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"all steps ms {[round(v * 1e3, 2) for v in step_s]}")
    want = layers * len(step_s)
    print(f"lm: launches over the {len(step_s)} {label} steps {launches}, want {want} of each")
    if launches != dict.fromkeys(FLASH, want):
        fail(f"flash launch counts over the {label} steps {launches} != {want} of each")
    return med * 1e3, tokens / med, launches


def phase_lm(torch, fa, transformer_lm, transformer, model_lib, troot, prng):
    """Phase 8: the LM slice at the mid LM's width and depth."""
    troot.transformer_lm.update({
        **LM_MID,
        "loader": {"seq_len": LM_T, "n_train": LM_N_TRAIN, "n_test": LM_N_TEST,
                   "minibatch_size": LM_B},
    })
    prng.seed_all(1234)
    t0 = time.perf_counter()
    wf = transformer_lm.build_workflow(device="cuda", attention="flash")
    wf.initialize()
    torch.cuda.synchronize()
    n_params = sum(w.numel() for layer in wf.state.params for w in layer.values())
    print(f"lm: built the workflow (bigram data on the host, {n_params} parameters on the "
          f"card) in {time.perf_counter() - t0:.1f} s")
    n_train = wf.loader.n_minibatches("train")
    n_eval = wf.loader.n_minibatches("test")
    # the initial weights, for the card-vs-CPU check below: SGD at the
    # LM's default lr 0.1 diverges at this depth within a few steps (so does
    # the JAX package's), which the timed steps do not mind
    host = model_lib.params_to_numpy(wf.state.params)

    # the main path: counts set to 0 just before, read just after
    for name in FLASH:
        getattr(fa, name).launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {name: getattr(fa, name).launches for name in FLASH}
    summary = verdict["summary"]
    print(f"lm: epoch 1 {epoch_s:.2f} s: " + json.dumps(summary))
    for split, n in (("train", LM_N_TRAIN), ("test", LM_N_TEST)):
        m = summary.get(split)
        if m is None or m["n_samples"] != n:
            fail(f"{split} split saw {m and m['n_samples']} samples, want {n}")
        if not all(math.isfinite(float(v)) for v in m.values()):
            fail(f"non-finite {split} metrics: {m}")
    layers = LM_MID["n_layers"]
    want = {"flash_fwd": layers * (n_train + n_eval), "flash_dq": layers * n_train,
            "flash_dkv": layers * n_train}
    print(f"lm: launches {launches}, want {want} "
          f"({n_train} train steps, {n_eval} eval steps, {layers} layers)")
    if launches != want:
        fail(f"flash launch counts {launches} != {want}")

    steps = {"f32": _timed_steps(torch, fa, wf, "f32 attention")}

    # card vs CPU: one 512-token sequence, f32, TF32 off, identical weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    tokens = torch.as_tensor(wf.loader.data["test"][:1, :512]).long()
    kw = dict(n_heads=LM_MID["n_heads"], attention_fn=fa.flash_attention)
    with torch.no_grad():
        lg_card = transformer.lm_apply(
            model_lib.params_from_jax(host, "cuda"), tokens.cuda(), **kw).cpu()
        lg_cpu = transformer.lm_apply(model_lib.params_from_jax(host, "cpu"), tokens, **kw)
    if not bool(torch.isfinite(lg_cpu).all()):
        fail("non-finite CPU logits")
    rel = float((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max())
    print(f"lm: 512-token f32 forward, card (kernels) vs CPU (plain): max |diff| / "
          f"max |logit| = {rel:.3e} (limit 1e-4); logits shape {list(lg_card.shape)}")
    if not rel < 1e-4 or tuple(lg_card.shape) != (1, 512, LM_MID["vocab"]):
        fail("card and CPU LM forwards disagree")
    loader = wf.loader
    del wf, host, lg_card
    torch.cuda.empty_cache()

    wf16 = transformer.TransformerLMWorkflow(
        loader, **LM_MID, attention="flash", attention_dtype="bf16", device="cuda"
    )
    wf16.initialize()
    steps["bf16"] = _timed_steps(torch, fa, wf16, "bf16 attention")
    del wf16
    torch.cuda.empty_cache()
    return launches, steps, loader


# -- the unsupervised slice: Kohonen SOM and RBM -------------------------------

CUDA_SOURCES = ("lrn", "flash_attention", "kohonen", "rbm")
UNSUP_SOURCE = {"kohonen_accumulate": "znicz_tpu_torch/csrc/kohonen.cu",
                "rbm_cd": "znicz_tpu_torch/csrc/rbm.cu"}
REPLACES.update({
    "kohonen_accumulate": "znicz_tpu/ops/pallas/kohonen.py:93",
    "rbm_cd": "znicz_tpu/ops/pallas/rbm.py:161",
})
# of the reference's largest magnitude: f32 sums run in another order
KOHONEN_TOL, RBM_TOL = 1e-5, 1e-4
KOHONEN_CASES = [  # (tag, B, map side, F, valid rows)
    ("model", 100, 8, 784, 93),
    ("multi_tile", 600, 6, 256, 500),
    ("ragged", 300, 6, 64, 300),
    ("large", 4096, 32, 784, 4096),
]
RBM_CASES = [  # (tag, B, V, H, cd_k, valid rows)
    ("model", 100, 784, 128, 1, 93),
    ("large", 1024, 784, 1024, 1, 1000),
    ("k3", 256, 784, 1024, 3, 250),
]
MNIST_SPLITS = {"train": 60000, "test": 10000}  # MNIST's own split sizes


RBM_GEMMS = {f"{k}_kernel<{copy}>" for k in ("hidden", "visible", "stats") for copy in (4, 16)}
KOHONEN_GEMMS = {f"{k}_kernel<{copy}>" for k in ("scores", "accum") for copy in (4, 16)}


def _kernel_name(mangled):
    """A csrc kernel's name from its mangled one: ``hidden_kernel<16>``,
    ``uniforms_kernel``; None for anything else."""
    name = re.search(r"\d+([a-z]+_kernel)(ILi(\d+)EE)?", mangled)
    if name is None:
        return None
    return name.group(1) + (f"<{name.group(3)}>" if name.group(3) else "")


def _ptxas_rows(log, name=_kernel_name):
    """(kernel name, registers, (spill stores, loads), static smem bytes) of
    each entry nvcc's ptxas reported."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = [name(m.group(1)), None, None, 0]
            rows.append(cur)
        elif cur is not None:
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            smem = re.search(r"(\d+) bytes smem", line)
            if regs:
                cur[1] = int(regs.group(1))
            if spill:
                cur[2] = (int(spill.group(1)), int(spill.group(2)))
            if smem:
                cur[3] = int(smem.group(1))
    return rows


# csrc/lrn.cu's instantiations: halo_kernel<BF16, VEC, beta kind> (the main
# path) and rows_kernel<BF16, VEC>
_LRN_KERNEL = re.compile(r"(halo|rows)_kernelILb([01])ELi(\d+)E(?:Li(\d)E)?")
LRN_BETAS = ("0.75", "0.5", "0.25", "1", "any")  # the source's BetaKind, in order
LRN_KERNELS = ({f"halo_kernel<{t}, {v}, beta {b}>"
                for t, vs in (("f32", (2, 4)), ("bf16", (2, 4, 8))) for v in vs for b in LRN_BETAS}
               | {f"rows_kernel<{t}, {v}>" for t, vs in (("f32", (1, 2, 4)), ("bf16", (1, 2, 4, 8)))
                  for v in vs})


def _lrn_kernel_name(mangled):
    m = _LRN_KERNEL.search(mangled)
    return m and (f"{m.group(1)}_kernel<{'bf16' if m.group(2) == '1' else 'f32'}, {m.group(3)}"
                  + (f", beta {LRN_BETAS[int(m.group(4))]}>" if m.group(4) else ">"))


def phase_lrn_build(b):
    """Phase 1 (the build): the LRN backward's nvcc seconds and each
    instantiation's registers, spills and shared memory; fails on a spill.
    Returns {instantiation: [registers, spill store bytes]}."""
    print(f"build: {b.path.name}: nvcc {b.seconds:.1f} s"
          + ("" if b.seconds else " (the library was there already)"))
    rows = _ptxas_rows(b.log, _lrn_kernel_name)
    if {r[0] for r in rows} != LRN_KERNELS:
        fail(f"ptxas reported {sorted(map(str, (r[0] for r in rows)))} for lrn.cu, "
             f"want {sorted(LRN_KERNELS)}")
    out = {}
    for kname, regs, spill, smem in sorted(rows):
        print(f"ptxas lrn {kname}: {regs} registers, spill stores/loads {spill} bytes, "
              f"{smem} bytes static shared memory a block (dynamic: "
              f"{'32 bytes a thread' if kname.startswith('halo') else '8 bytes a row channel'})")
        if spill is None or spill != (0, 0):
            fail(f"lrn {kname} spills registers: {spill}")
        out[kname] = [regs, spill[0]]
    return out


def _sass_hmma(cuda_build, lib_path):
    """{kernel name: SASS HMMA count} of each kernel of a built library."""
    from pathlib import Path

    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = _kernel_name(line.split("Function :")[1])
            counts.setdefault(cur, 0)
        elif cur is not None and re.search(r"\bHMMA\.", line):
            counts[cur] += 1
    return counts


def phase_unsup_build(built, khk, rbk, cuda_build):
    """Phase 9: the Kohonen and RBM libraries' builds; every Kohonen and RBM
    GEMM instantiation on the tensor cores (SASS HMMA)."""
    want = {"kohonen": KOHONEN_GEMMS | {"winners_kernel"},
            "rbm": RBM_GEMMS | {"uniforms_kernel"}}
    for name in ("kohonen", "rbm"):
        b = built[name]
        print(f"build: {b.path.name}: nvcc {b.seconds:.1f} s"
              + ("" if b.seconds else " (the library was there already)"))
        rows = _ptxas_rows(b.log)
        if {r[0] for r in rows} != want[name]:
            fail(f"ptxas reported {sorted(map(str, (r[0] for r in rows)))} for {name}.cu, "
                 f"want {sorted(want[name])}")
        for kname, regs, spill, smem in sorted(rows):
            print(f"ptxas {name} {kname}: {regs} registers, spill stores/loads {spill} bytes, "
                  f"{smem} bytes static shared memory a block")
    for name, gemms in (("kohonen", KOHONEN_GEMMS), ("rbm", RBM_GEMMS)):
        hmma = _sass_hmma(cuda_build, built[name].path)
        for kname in sorted(gemms):
            print(f"sass {name} {kname}: {hmma.get(kname, 0)} HMMA")
            if not hmma.get(kname):
                fail(f"{name} {kname} has no tensor-core instructions")
    for tag, b, side, f, _ in KOHONEN_CASES:
        m, t = side * side, lambda n: -(-n // khk.TILE)  # noqa: E731
        print(f"kohonen launches at {tag} (B {b}, {side}x{side}, F {f}): 3 a call: scores grid "
              f"{t(m)} x {t(b)} x {khk.split_count(b, m, f)} (F split), winners "
              f"{-(-b // 8)} + table blocks of 256 threads, accum {t(f + 1)} x {t(m)} blocks of "
              f"128 threads; {'16' if f % 4 == 0 and m % 4 == 0 else '4'}-byte copies")
    for tag, b, v, h, cd_k, _ in RBM_CASES:
        t = lambda n: -(-n // rbk.TILE)  # noqa: E731
        print(f"rbm launches at {tag} (B {b}, {v} x {h}, k {cd_k}): {2 * cd_k + 2} a step: "
              f"hidden grid {t(h)} x {t(b)}, visible {t(v)} x {t(b)}, stats {t(h)} x {t(v)} "
              f"blocks of 128 threads; {'16' if v % 4 == 0 and h % 4 == 0 else '4'}-byte copies")


def _mnist_rows(datasets, n, normalization):
    """n rows of the synthetic MNIST stand-in (its well-separated blobs),
    normalized as the models normalize them, as float32 [n, 784]."""
    loader = datasets.mnist(n_train=n, n_test=0, normalization=normalization)
    return loader.data["train"]


def _rel_err(name, got, ref, tol, *, strict=True):
    """Max abs error, checked against ``tol`` of max |ref| when ``strict``."""
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = math.isfinite(err) and err <= tol * max(scale, 1e-12)
    print(f"check {name}: max_abs_err={err:.3e} of max |ref| {scale:.3e} "
          f"(limit {tol} of it) {'ok' if ok else 'FAILED' if strict else 'not held: units flipped'}")
    if strict and not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def _kohonen_canary(torch, khk, label, w, x, mask, d2m, tss):
    """The C entry with every output and scratch buffer taken from the front
    of a NaN-filled larger one: fails if anything past them changed or the
    results differ from the wrapper's own."""
    want = khk.accumulate(w, x, mask, d2m, tss)
    carved, own = {}, khk._buffers

    def canary_buffers(b, m, f, device):
        ptr = {}
        for name, shape in khk.buffer_shapes(b, m, f).items():
            n = math.prod(shape)
            carved[name] = (torch.full((n + 4096,), math.nan, device=device), n)
            ptr[name] = carved[name][0].data_ptr()
        return (carved["num"][0][:m * f].view(m, f), carved["den"][0][:m].view(m, 1), ptr)

    khk._buffers = canary_buffers
    try:
        got = khk.accumulate(w, x, mask, d2m, tss)
        torch.cuda.synchronize()
    finally:
        khk._buffers = own
    past = [name for name, (full, n) in carved.items() if not bool(torch.isnan(full[n:]).all())]
    same = all(torch.equal(g, w_) for g, w_ in zip(got, want))
    print(f"check {label} canary: {len(carved)} buffers each at the front of a NaN-filled "
          f"one: written past {past or 'none'}; results bitwise the wrapper's: {same}")
    if past or not same:
        fail(f"{label}: the kernel wrote past its buffers or read what it did not write")


def phase_kohonen_checks(torch, khk, kh, datasets, prng):
    """Phase 10: the Kohonen kernel against its plain version and against
    float64 along its own winners.  Returns the model shape's max error
    against the plain version and its float64 errors by output."""
    prng.seed_all(11)
    xs = torch.as_tensor(_mnist_rows(datasets, 4096, "mean_disp"), device="cuda")
    err, f64 = 0.0, {}
    for tag, b, side, f, n_valid in KOHONEN_CASES:
        m = side * side
        x = xs[:b, :f].contiguous()
        w = kh.init_params(side, side, f, device="cuda")["weights"]
        # a map that has started to learn: units near some samples
        w = (w + xs[torch.arange(m, device="cuda") * 7 % 4096, :f]).contiguous()
        mask = (torch.arange(b, device="cuda") < n_valid).float()
        d2m = khk.pairwise_d2(kh.grid_coords(side, side, device="cuda"))
        tss, lr = khk.sigma_tensor(2.5, "cuda"), 0.3
        win = torch.empty((b,), dtype=torch.int32, device="cuda")
        before = khk.accumulate.launches
        num, den = khk.accumulate(w, x, mask, d2m, tss, winners_out=win)
        num2, den2 = khk.accumulate(w, x, mask, d2m, tss)
        torch.cuda.synchronize()
        if khk.accumulate.launches - before != 2:
            fail(f"kohonen {tag}: {khk.accumulate.launches - before} launch counts for two calls")
        same = torch.equal(num, num2) and torch.equal(den, den2)
        differ = int((kh.winners({"weights": w}, x) != win).sum())
        label = f"kohonen {tag} (B {b}, {side}x{side}, F {f}, {b - n_valid} masked)"
        print(f"check {label}: repeat launch bitwise equal: {same}; samples whose winner "
              f"differs from the plain version's: {differ} (limit {max(1, b // 1000)})"
              + (" (plain version run with the kernel's winners)" if differ else ""))
        if not same:
            fail(f"{label}: two launches on the same inputs differ")
        if differ > max(1, b // 1000):
            fail(f"{label}: {differ} winners differ, more than near-ties explain")
        ref_num, ref_den = khk.accumulate_reference(w, x, mask, d2m, tss,
                                                    win=win if differ else None)
        e = max(_rel_err(f"{label} num", num, ref_num, KOHONEN_TOL),
                _rel_err(f"{label} den", den, ref_den, KOHONEN_TOL))
        _rel_err(f"{label} updated weights", khk._apply_update(w, num, den, lr),
                 khk._apply_update(w, ref_num, ref_den, lr), KOHONEN_TOL)
        # float64 along the kernel's winners, beside the f32 plain version there
        plain = khk.accumulate_reference(w, x, mask, d2m, tss, win=win)
        exact = khk.accumulate_reference(w.double(), x.double(), mask.double(), d2m.double(),
                                         tss, win=win)
        e64 = _float64_check(torch, label, ("num", "den"), (num, den), plain, exact)
        if tag == "model":
            err, f64 = e, e64
    # the canary, with 16-byte copies (the model's shape) and 4-byte ones
    for b, side, f in ((100, 8, 784), (70, 5, 50)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(b)
        x = torch.rand((b, f), generator=gen, device="cuda")
        w = torch.rand((side * side, f), generator=gen, device="cuda")
        mask = (torch.arange(b, device="cuda") < b - 3).float()
        d2m = khk.pairwise_d2(kh.grid_coords(side, side, device="cuda"))
        _kohonen_canary(torch, khk, f"kohonen (B {b}, {side}x{side}, F {f})", w, x, mask, d2m,
                        khk.sigma_tensor(1.3, "cuda"))
    return err, f64


def _rbm_inputs(torch, xs, b, v, h, n_valid, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = {
        "weights": torch.randn((v, h), generator=gen, device="cuda") * (1.0 / math.sqrt(v)),
        "vbias": torch.randn((v,), generator=gen, device="cuda") * 0.1,
        "hbias": torch.randn((h,), generator=gen, device="cuda") * 0.1,
    }
    v0 = xs[:b, :v].contiguous()
    mask = (torch.arange(b, device="cuda") < n_valid).float()
    return params, v0, mask


def _rbm_against_plain(torch, rbk, label, params, v0, mask, seed, cd_k, uniforms, uh, uv):
    """One kernel call against the plain version: every draw of the chain a
    flip where the plain version, led along the kernel's samples, would have
    drawn the other way; dW, dvb, dhb and stats within RBM_TOL where none
    flipped; dW, dvb and dhb against float64 along the kernel's samples,
    within FLOAT64_FACTOR of the f32 plain version's error, never skipped.
    Returns (the statistics, max error against the plain version where no
    draw flipped, else 0, and the float64 errors by output)."""
    chain, led = {}, {}
    before = rbk.statistics.launches
    got = rbk.statistics(params, v0, mask, rbk.seed_tensor(seed, "cuda"), cd_k=cd_k,
                         uniforms=uniforms, chain=chain)
    torch.cuda.synchronize()
    if rbk.statistics.launches - before != 1:
        fail(f"{label}: {rbk.statistics.launches - before} launch counts for one call")
    samples = (chain["hidden_samples"], chain["visible_samples"])
    plain = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k, chain=led,
                                     samples=samples)
    flips = rbk.count_flips(chain, led, uh, uv)
    draws = samples[0].numel() + samples[1].numel()
    print(f"check {label}: {flips} of {draws} draws flipped (every draw of the chain; "
          f"limit {1e-5 * draws:.1f})")
    if flips > 1e-5 * draws:
        fail(f"{label}: {flips} flips")
    err = 0.0
    if flips == 0:  # then the kernel's chain is the plain version's own
        ref = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k)
        err = max(_rel_err(f"{label}, {name}", g, r, RBM_TOL)
                  for name, g, r in zip(("dW", "dvb", "dhb", "stats"), got, ref))
    p64 = {k: t.double() for k, t in params.items()}
    exact = rbk.statistics_reference(p64, v0.double(), mask.double(), None, None, cd_k=cd_k,
                                     samples=samples)
    f64 = _float64_check(torch, label, ("dW", "dvb", "dhb"), got[:3], plain[:3], exact[:3])
    return got, err, f64


def _rbm_canary(torch, rbk, label, params, v0, mask, seed, cd_k):
    """The C entry with every output and scratch buffer taken from the front
    of a NaN-filled larger one: fails if anything past them changed or the
    results differ from the wrapper's own."""
    want = rbk.statistics(params, v0, mask, rbk.seed_tensor(seed, "cuda"), cd_k=cd_k)
    carved, own = {}, rbk._buffers

    def canary_buffers(b, v, h, k, device):
        out = {}
        for name, shape in rbk.buffer_shapes(b, v, h, k).items():
            n = math.prod(shape)
            carved[name] = (torch.full((n + 4096,), math.nan, device=device), n)
            out[name] = carved[name][0][:n].view(shape)
        return out

    rbk._buffers = canary_buffers
    try:
        got = rbk.statistics(params, v0, mask, rbk.seed_tensor(seed, "cuda"), cd_k=cd_k)
        torch.cuda.synchronize()
    finally:
        rbk._buffers = own
    past = [name for name, (full, n) in carved.items() if not bool(torch.isnan(full[n:]).all())]
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"check {label} canary: {len(carved)} buffers each at the front of a NaN-filled "
          f"one: written past {past or 'none'}; results bitwise the wrapper's: {same}")
    if past or not same:
        fail(f"{label}: the kernel wrote past its buffers or read what it did not write")


def phase_rbm_checks(torch, rbk, datasets, prng):
    """Phase 11: the RBM kernel against its plain version."""
    prng.seed_all(12)
    xs = torch.as_tensor((_mnist_rows(datasets, 1024, "linear") + 1.0) / 2.0, device="cuda")
    err, f64 = 0.0, {}
    # the saturated regime: sampling cannot depend on the draws
    v, h = 128, 64
    params = {"weights": torch.zeros((v, h), device="cuda"),
              "vbias": torch.full((v,), -20.0, device="cuda"),
              "hbias": torch.full((h,), 20.0, device="cuda")}
    v0 = (xs[:32, :v] > 0.5).float().contiguous()
    mask = (torch.arange(32, device="cuda") < 30).float()
    for cd_k in (1, 2):
        got = rbk.statistics(params, v0, mask, rbk.seed_tensor(5, "cuda"), cd_k=cd_k)
        uh, uv = rbk.chain_uniforms(5, 32, v, h, cd_k, "cuda")
        ref = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k)
        exact = all(torch.equal(g, r) for g, r in zip(got, ref))
        print(f"check rbm saturated (biases +-20, B 32, {v} x {h}, k {cd_k}): exact {exact}")
        if not exact:
            fail("rbm saturated regime is not exact")
    for seed, (tag, b, v, h, cd_k, n_valid) in enumerate(RBM_CASES):
        params, v0, mask = _rbm_inputs(torch, xs, b, v, h, n_valid, seed)
        uh, uv = rbk.chain_uniforms(seed, b, v, h, cd_k, "cuda")
        label = f"rbm {tag} (B {b}, {v} x {h}, k {cd_k}, {b - n_valid} masked)"
        for how, uniforms in (("injected uniforms", (uh, uv)), ("in-kernel draws", None)):
            got, e, e64 = _rbm_against_plain(torch, rbk, f"{label}, {how}", params, v0, mask,
                                             seed, cd_k, uniforms, uh, uv)
            if tag == "model":
                err, f64 = max(err, e), e64
        again = rbk.statistics(params, v0, mask, rbk.seed_tensor(seed, "cuda"), cd_k=cd_k)
        other = rbk.statistics(params, v0, mask, rbk.seed_tensor(seed + 1000, "cuda"),
                               cd_k=cd_k)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        changed = not torch.equal(got[0], other[0])
        print(f"check {label}: same seed bitwise equal {same}; another seed changes dW {changed}")
        if not (same and changed):
            fail(f"{label}: the seed does not key the chain")
    # a wide hidden layer (C4: beyond one block's shared memory in the old design)
    b, v, h = 8, 784, 14_000
    params, v0, mask = _rbm_inputs(torch, xs, b, v, h, 7, 40)
    uh, uv = rbk.chain_uniforms(40, b, v, h, 1, "cuda")
    _rbm_against_plain(torch, rbk, f"rbm wide (B {b}, {v} x {h}, k 1, 1 masked), injected "
                       "uniforms", params, v0, mask, 40, 1, (uh, uv), uh, uv)
    # the canary, with 16-byte copies (the model's shape) and 4-byte ones
    for b, v, h, cd_k in ((100, 784, 128, 1), (70, 50, 33, 3)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(b)
        params, v0, mask = _rbm_inputs(torch, torch.rand((b, v), generator=gen, device="cuda"),
                                       b, v, h, b - 3, 41)
        _rbm_canary(torch, rbk, f"rbm (B {b}, {v} x {h}, k {cd_k})", params, v0, mask, 21, cd_k)
    for stream, shape in ((rbk.HIDDEN, (2, 1024, 1024)), (rbk.VISIBLE, (1, 1024, 784))):
        same = torch.equal(rbk.uniforms_cuda(77, stream, shape), rbk.philox_uniforms(77, stream, shape, "cuda"))
        print(f"check rbm generator stream {stream} {list(shape)}: kernel draws bitwise equal "
              f"to the PyTorch twin: {same}")
        if not same:
            fail("the kernel's generator and its twin differ")
    b = 1 << 20
    for p in (0.1, 0.5, 0.9):
        # one visible and one hidden unit: vp is 1 where the hidden unit was
        # drawn and 2e-9 where not, so -dvb / B is the draws' frequency
        params = {"weights": torch.full((1, 1), 40.0, device="cuda"),
                  "vbias": torch.full((1,), -20.0, device="cuda"),
                  "hbias": torch.full((1,), math.log(p / (1 - p)), device="cuda")}
        chain = {}
        _, dvb, _, _ = rbk.statistics(params, torch.zeros((b, 1), device="cuda"),
                                      torch.ones((b,), device="cuda"), rbk.seed_tensor(99, "cuda"),
                                      cd_k=1, chain=chain)
        p_exact = float(chain["h0p"][0, 0])
        freq = -float(dvb[0]) / b
        sd = math.sqrt(p_exact * (1 - p_exact) / b)
        print(f"check rbm Bernoulli frequency at p {p_exact:.7f} over {b} draws: {freq:.7f} "
              f"({(freq - p_exact) / sd:+.2f} sigma, limit 5)")
        if abs(freq - p_exact) > 5 * sd:
            fail("rbm Bernoulli frequency off")
    return err, f64


def _unsup_bound(flops, nbytes, rate=F32_FLOPS):
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_unsup_times(torch, khk, kh, rbk):
    """Phase 12: each kernel's time at the model's shape and at the large
    check shape, beside its bound and its plain version's."""
    rows = {}
    for tag, b, side, f, _ in (KOHONEN_CASES[0], KOHONEN_CASES[3]):
        m = side * side
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        x = torch.randn((b, f), generator=gen, device="cuda")
        w = torch.randn((m, f), generator=gen, device="cuda") * 0.1
        mask = torch.ones((b,), device="cuda")
        d2m = khk.pairwise_d2(kh.grid_coords(side, side, device="cuda"))
        # 2 sigma^2 on the card, as the workflow's step hands it to the kernel
        tss = khk.sigma_tensor(2.0, "cuda")
        ms = cuda_ms(lambda: khk.accumulate(w, x, mask, d2m, tss))
        plain = cuda_ms(lambda: khk.accumulate_reference(w, x, mask, d2m, tss))
        # x, w, mask and d2m read once; num and den written once; the two
        # products at the 3xTF32 rate (three TF32 products for one), and on
        # f32 FMAs beside it
        nbytes = 4 * (b * f + m * f + b + m * m + m * f + m)
        bound, by = _unsup_bound(4 * b * m * f, nbytes, TF32_FLOPS / 3)
        fma_bound, _ = _unsup_bound(4 * b * m * f, nbytes)
        rows[("kohonen_accumulate", tag)] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                                 bound_by=by, library_ms=None,
                                                 f32_fma_bound_ms=fma_bound)
        print(f"time kohonen_accumulate {tag} (B {b}, {side}x{side}, F {f}): kernel {ms:.4f} ms "
              f"(3 launches), bound {bound:.4f} ms ({by}; 3xTF32; {fma_bound:.4f} ms on f32 "
              f"FMAs), plain {plain:.4f} ms, library: none (no single PyTorch call computes "
              f"it)")
    for tag, b, v, h, cd_k, _ in RBM_CASES:
        params, v0, mask = _rbm_inputs(torch, torch.rand((b, v), device="cuda"), b, v, h, b, 3)
        uh, uv = rbk.chain_uniforms(3, b, v, h, cd_k, "cuda")
        seed = rbk.seed_tensor(3, "cuda")  # on the card, as the workflow's step hands it
        ms = cuda_ms(lambda: rbk.statistics(params, v0, mask, seed, cd_k=cd_k))
        plain = cuda_ms(lambda: rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k))
        # v0, mask, W and the biases read once; dW, dvb, dhb, stats written once;
        # the products at the 3xTF32 rate (three TF32 products for one), and on
        # f32 FMAs beside it
        nbytes = 4 * (b * v + b + 2 * v * h + 2 * (v + h) + 2)
        flops = (2 * cd_k + 3) * 2 * b * v * h
        bound, by = _unsup_bound(flops, nbytes, TF32_FLOPS / 3)
        fma_bound, _ = _unsup_bound(flops, nbytes)
        rows[("rbm_cd", tag)] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                                     library_ms=None, f32_fma_bound_ms=fma_bound)
        print(f"time rbm_cd {tag} (B {b}, {v} x {h}, k {cd_k}): kernel {ms:.4f} ms "
              f"({2 * cd_k + 2} launches), bound {bound:.4f} ms ({by}; 3xTF32; {fma_bound:.4f} "
              f"ms on f32 FMAs), plain {plain:.4f} ms (uniforms given), library: none (no "
              f"single PyTorch call computes it)")
    return rows


def _unsup_epoch(torch, wf, counter, label):
    """One epoch of ``wf`` with ``counter`` (the kernel wrapper) set to 0 just
    before and read just after; checks the samples and the finite loss."""
    n_train = wf.loader.n_minibatches("train")
    counter.launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = counter.launches
    summary = verdict["summary"]
    print(f"{label}: epoch 1 {epoch_s:.2f} s: " + json.dumps(summary))
    for split, n in MNIST_SPLITS.items():
        m = summary.get(split)
        if m is None or m["n_samples"] != n:
            fail(f"{label}: {split} split saw {m and m['n_samples']} samples, want {n}")
        if not math.isfinite(m["loss"]):
            fail(f"{label}: non-finite {split} loss {m['loss']}")
    print(f"{label}: launches {launches}, want {n_train} (one a train step; eval steps "
          f"launch nothing)")
    if launches != n_train:
        fail(f"{label}: {launches} kernel launches in the epoch, want {n_train}")
    return launches


def _unsup_steps(torch, wf, label):
    """Median of 10 synchronised train steps after 2 warm-up, images/sec."""
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x = torch.as_tensor(mb.data, device="cuda")
    y = torch.zeros((x.shape[0],), dtype=torch.int32, device="cuda")
    mask = torch.as_tensor(mb.mask, device="cuda")
    step_s = []
    for _ in range(12):
        t0 = time.perf_counter()
        acc = wf.train_step(x, y, mask)
        float(acc[0])  # the step's metrics on the host: a full sync
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s[2:])
    print(f"{label}: train step (batch {x.shape[0]}) median {med * 1e3:.3f} ms over "
          f"{len(step_s) - 2} steps after 2 warm-up; {x.shape[0] / med:.1f} images/sec; "
          f"all steps ms {[round(v * 1e3, 3) for v in step_s]}")
    return med * 1e3, x.shape[0] / med, mb


def phase_kohonen_model(torch, kohonen, khk, kh, troot, prng):
    """Phase 13: the Kohonen SOM model at its published widths."""
    troot.kohonen.update({"loader": {"n_train": MNIST_SPLITS["train"],
                                     "n_test": MNIST_SPLITS["test"]}})
    prng.seed_all(1234)
    t0 = time.perf_counter()
    wf = kohonen.build_workflow(device="cuda")
    wf.initialize()
    torch.cuda.synchronize()
    print(f"kohonen: built the workflow (8x8 map, 784 features, batch 100, synthetic MNIST "
          f"stand-in {MNIST_SPLITS}) in {time.perf_counter() - t0:.1f} s")
    launches = _unsup_epoch(torch, wf, khk.accumulate, "kohonen")
    step_ms, ips, mb = _unsup_steps(torch, wf, "kohonen")
    # card vs CPU: one step from identical weights
    w = wf.state.params["weights"]
    x = torch.as_tensor(mb.data)
    mask = torch.as_tensor(mb.mask)
    lr, sigma = kh.decay_schedule(wf.state.step, wf._total_steps, lr0=wf.lr0, lr1=wf.lr1,
                                  sigma1=wf.sigma1, sx=wf.sx, sy=wf.sy)
    coords = kh.grid_coords(wf.sx, wf.sy, device="cpu")
    card = khk.train_step({"weights": w}, x.cuda(), coords.cuda(), mask=mask.cuda(),
                          learning_rate=lr, tss=khk.sigma_tensor(sigma, "cuda"))
    cpu = khk.train_step({"weights": w.cpu()}, x, coords, mask=mask, learning_rate=lr,
                         tss=khk.sigma_tensor(sigma, "cpu"))
    # the kernel's own winners on the same data against the CPU plain version's
    win = torch.empty((x.shape[0],), dtype=torch.int32, device="cuda")
    khk.accumulate(w, x.cuda(), mask.cuda(), khk.pairwise_d2(coords.cuda()),
                   khk.sigma_tensor(sigma, "cuda"), winners_out=win)
    differ = int((win.cpu() != kh.winners({"weights": w.cpu()}, x)).sum())
    limit = max(1, x.shape[0] // 1000)
    print(f"kohonen: one train step card vs CPU from identical weights (lr {lr}, sigma "
          f"{sigma}): the kernel's winners that differ from the CPU's {differ} (limit {limit})")
    if differ > limit:
        fail("kohonen: card and CPU pick other winners on the model's data")
    _rel_err("kohonen card vs CPU updated weights", card["weights"].cpu(), cpu["weights"],
             KOHONEN_TOL)
    return launches, step_ms, ips


def phase_rbm_model(torch, mnist_rbm, rbk, troot, prng):
    """Phase 14: the MNIST RBM at its published widths."""
    troot.mnist_rbm.update({"loader": {"n_train": MNIST_SPLITS["train"],
                                       "n_test": MNIST_SPLITS["test"]}})
    prng.seed_all(1234)
    t0 = time.perf_counter()
    wf = mnist_rbm.build_workflow(device="cuda")
    wf.initialize()
    torch.cuda.synchronize()
    print(f"rbm: built the workflow (784 x 128, CD-1, batch 100, synthetic MNIST stand-in "
          f"{MNIST_SPLITS}) in {time.perf_counter() - t0:.1f} s")
    launches = _unsup_epoch(torch, wf, rbk.statistics, "rbm")
    step_ms, ips, mb = _unsup_steps(torch, wf, "rbm")
    # card vs CPU: one CD-1 step from identical weights and the same seed,
    # which is the same chain through the generator's twin
    params = wf.state.params
    cpu_params = {k: t.cpu() for k, t in params.items()}
    v0, mask = torch.as_tensor(mb.data), torch.as_tensor(mb.mask)
    seed, b, v, h = wf.state.step, v0.shape[0], v0.shape[1], wf.n_hidden
    chain, led = {}, {}
    stats_card = rbk.statistics(params, v0.cuda(), mask.cuda(), rbk.seed_tensor(seed, "cuda"),
                                cd_k=1, chain=chain)
    uh, uv = rbk.chain_uniforms(seed, b, v, h, 1)
    card_chain = {k: t.cpu() for k, t in chain.items()}
    samples = (card_chain["hidden_samples"], card_chain["visible_samples"])
    # the CPU step led along the card's draws: every draw a flip where the
    # CPU would have drawn the other way
    stats_cpu = rbk.statistics_reference(cpu_params, v0, mask, uh, uv, cd_k=1, chain=led,
                                         samples=samples)
    flips = rbk.count_flips(card_chain, led, uh, uv)
    draws = samples[0].numel() + samples[1].numel()
    print(f"rbm: one CD-1 step card vs CPU from identical weights, seed {seed}: {flips} of "
          f"{draws} draws flipped")
    if flips > 1e-5 * draws:
        fail("rbm: card and CPU chains diverge")
    if flips == 0:
        new_card, err_card = rbk._apply_update(params, *stats_card, wf.learning_rate)
        new_cpu, err_cpu = rbk._apply_update(cpu_params, *stats_cpu, wf.learning_rate)
        for k in new_cpu:
            _rel_err(f"rbm card vs CPU updated {k}", new_card[k].cpu(), new_cpu[k], RBM_TOL)
        _rel_err("rbm card vs CPU reconstruction error", err_card.cpu(), err_cpu, RBM_TOL)
    return launches, step_ms, ips


MNIST_STEPS = {"train": 17, "valid": 3, "test": 5}  # batch 100 over 1700 / 300 / 500
MNIST_EPOCHS = 3
CIFAR_NORM = {"cifar": (100, 15, 15, 32)}  # the norm layer's input, batch 100
NEAR_TIE = 1e-5  # top-2 logits this close may be ordered either way


def _f32_exact(torch):
    """f32 products and convolutions without TF32, as the CPU computes them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _epochs(wf, n):
    return [wf.run_epoch()["summary"] for _ in range(n)]


def _step_seconds(torch, wf, n, warmup):
    """Seconds of ``n`` train steps on the first train minibatch (its
    labels, or the batch itself for an autoencoder), each synchronized,
    after ``warmup`` more."""
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x, mask = (torch.as_tensor(a, device="cuda") for a in (mb.data, mb.mask))
    y = x if wf.target == "input" else torch.as_tensor(mb.labels, device="cuda")
    step_s = []
    for _ in range(warmup + n):
        t0 = time.perf_counter()
        wf.train_step(x, y, mask)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return step_s[warmup:]


def _copy_params(dst, src):
    import torch

    with torch.no_grad():
        for ld, ls in zip(dst.state.params, src.state.params):
            for k in ld:
                ld[k].copy_(ls[k].to(ld[k].device))


def _confusion_against_cpu(torch, label, wf, wf_cpu, split):
    """``evaluate(split, confusion=True)`` on the card and on the CPU from the
    card's weights: each matrix sums to n_samples with trace n_samples -
    n_err, and the two are equal or differ only by near-ties (samples whose
    top-2 logits are within NEAR_TIE)."""
    _copy_params(wf_cpu, wf)
    card, cpu = wf.evaluate(split, confusion=True), wf_cpu.evaluate(split, confusion=True)
    for side, r in (("card", card), ("cpu", cpu)):
        c = r["confusion"]
        if c.dtype.name != "int32" or c.sum() != r["n_samples"] or (
                c.trace() != r["n_samples"] - r["n_err"]):
            fail(f"{label}: the {side} confusion {c.dtype} sums to {c.sum()} with trace "
                 f"{c.trace()}, want {r['n_samples']} and {r['n_samples'] - r['n_err']}")
    differ = int((card["confusion"] != cpu["confusion"]).sum())
    ties = []
    if differ:  # name every sample whose class differs; each must be a near-tie
        with torch.no_grad():
            for mb in wf.loader.batches(split, shuffle=False):
                x = torch.as_tensor(mb.data)
                lc = wf.model.apply(wf.state.params, x.cuda()).cpu()
                lh = wf_cpu.model.apply(wf_cpu.state.params, x)
                for i in torch.nonzero((lc.argmax(1) != lh.argmax(1)) & (
                        torch.as_tensor(mb.mask) > 0)).flatten().tolist():
                    top = lh[i].topk(2).values
                    ties.append((int(mb.indices[i]), float(top[0] - top[1])))
    print(f"{label}: evaluate({split!r}, confusion=True) card {json.dumps(card['confusion'].tolist())}"
          f", n_err {card['n_err']:.0f} of {card['n_samples']:.0f}, loss {card['loss']:.6f}; CPU "
          f"n_err {cpu['n_err']:.0f}, loss {cpu['loss']:.6f}; {differ} cells differ; samples "
          f"classed otherwise (index, top-2 gap) {ties}")
    if any(gap > NEAR_TIE for _, gap in ties) or (differ and not ties):
        fail(f"{label}: the card's confusion differs from the CPU's beyond near-ties")
    return card


def _epochs_against_cpu(label, card, cpu, rtol=1e-4):
    """Per-epoch loss within ``rtol`` relative and n_err within 1 a split."""
    for e, (ec, eh) in enumerate(zip(card, cpu)):
        for split in eh:
            c, h = ec[split], eh[split]
            rel = abs(c["loss"] - h["loss"]) / abs(h["loss"])
            print(f"{label}: epoch {e} {split}: card loss {c['loss']:.7f} n_err {c['n_err']:.0f}; "
                  f"CPU loss {h['loss']:.7f} n_err {h['n_err']:.0f} (loss rel diff {rel:.2e}, "
                  f"limit {rtol}; n_err within 1)")
            if not rel <= rtol or abs(c["n_err"] - h["n_err"]) > 1:
                fail(f"{label}: epoch {e} {split} differs between the card and the CPU")


def phase_mnist(torch, mnist, prng, smi):
    """Phase 15: the MNIST MLP at its published widths (784 -> tanh 100 ->
    softmax 10, batch 100, synthetic 2000 / 500 with 15% held out)."""
    _f32_exact(torch)
    prng.seed_all(1234)
    wf = mnist.build_workflow(device="cuda")
    wf.initialize()
    steps = {s: wf.loader.n_minibatches(s) for s in MNIST_STEPS}
    print(f"mnist: layer shapes {list(wf.model.layer_shapes)}; steps an epoch {steps}")
    if steps != MNIST_STEPS:
        fail(f"mnist: {steps} steps an epoch, want {MNIST_STEPS}")
    t0 = time.perf_counter()
    card = _epochs(wf, MNIST_EPOCHS)
    torch.cuda.synchronize()
    print(f"mnist: {MNIST_EPOCHS} epochs on the card in {time.perf_counter() - t0:.2f} s "
          "(no hand kernel on this path: cuBLAS products)")
    prng.seed_all(1234)
    wf_cpu = mnist.build_workflow(device="cpu")
    wf_cpu.initialize()
    _epochs_against_cpu("mnist", card, _epochs(wf_cpu, MNIST_EPOCHS))
    _confusion_against_cpu(torch, "mnist", wf, wf_cpu, "test")
    step_s = _step_seconds(torch, wf, 50, 5)
    med = statistics.median(step_s)
    print(f"mnist: MNIST MLP step latency (batch 100, f32): median {med * 1e3:.4f} ms over 50 "
          f"synchronized train steps after 5 warm-up, on {smi}; min "
          f"{min(step_s) * 1e3:.4f}, max {max(step_s) * 1e3:.4f} ms")
    return med * 1e3


def phase_cifar(torch, cifar, lrn_kernel, model_lib, prng, smi):
    """Phase 16: the CIFAR-10 model at its published geometry (f32, batch
    100, synthetic 2000 / 500): one epoch with the LRN counters set to 0
    just before and read just after, a card-vs-CPU forward, timed train
    steps."""
    _f32_exact(torch)
    prng.seed_all(1234)
    wf = cifar.build_workflow(device="cuda")
    wf.initialize()
    torch.backends.cudnn.benchmark = True
    n_train, n_test = wf.loader.n_minibatches("train"), wf.loader.n_minibatches("test")
    print(f"cifar: layer shapes {list(wf.model.layer_shapes)}; {n_train} train and {n_test} "
          "test steps an epoch")
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {"lrn_fwd": lrn_kernel.lrn_forward.launches,
                "lrn_bwd": lrn_kernel.lrn_backward.launches}
    summary = verdict["summary"]
    print(f"cifar: epoch 1 (first, with cuDNN autotuning) {epoch_s:.2f} s: {json.dumps(summary)}")
    for split, n in (("train", 2000), ("test", 500)):
        m = summary.get(split)
        if m is None or m["n_samples"] != n or not all(
                math.isfinite(float(v)) for v in m.values()):
            fail(f"cifar: {split} saw {m}, want {n} samples and finite metrics")
    want = {"lrn_fwd": n_train + n_test, "lrn_bwd": n_train}
    print(f"cifar: launches {launches}, want {want} ({n_train} train steps: one forward and one "
          f"backward each; {n_test} test steps: one forward each)")
    if (n_train, n_test) != (20, 5) or launches != want:
        fail(f"cifar: LRN launch counts {launches} != {want}")

    # card vs CPU: 4-image f32 forward from identical weights
    torch.backends.cudnn.benchmark = False
    m32 = model_lib.build(cifar.DEFAULTS["layers"], wf.loader.sample_shape, device="cpu")
    host = model_lib.params_to_numpy(wf.state.params)
    mb = next(iter(wf.loader.batches("test", shuffle=False)))
    xb = torch.as_tensor(mb.data[:4])
    with torch.no_grad():
        out_gpu = m32.apply(model_lib.params_from_jax(host, "cuda"), xb.cuda()).cpu()
        out_cpu = m32.apply(model_lib.params_from_jax(host, "cpu"), xb)
    rel = float((out_gpu - out_cpu).abs().max() / out_cpu.abs().max())
    print(f"cifar: 4-image f32 forward, card vs CPU: max |diff| / max |logit| = {rel:.3e} "
          f"(limit 1e-4); logits shape {list(out_gpu.shape)}")
    if not rel < 1e-4 or out_gpu.shape != (4, 10):
        fail("cifar: card and CPU forwards disagree")

    torch.backends.cudnn.benchmark = True
    step_s = _step_seconds(torch, wf, 20, 2)
    med = statistics.median(step_s)
    print(f"cifar: train step (batch 100, f32, TF32 off) median {med * 1e3:.4f} ms over 20 "
          f"synchronized steps after 2 warm-up; {100 / med:.1f} images/sec on {smi}; all "
          f"steps ms {[round(v * 1e3, 3) for v in step_s]}")
    geo = lrn_kernel.launch_geometry(100 * 15 * 15, 32, 4, 16, LRN["n"])
    print(f"cifar: lrn_bwd at {list(CIFAR_NORM['cifar'])} f32: "
          f"{'halo' if geo.halo else 'rows'} kernel, {geo.vec}-element vectors, "
          f"{geo.rows_per_block} rows a block of {geo.threads} threads, {geo.grid} blocks")
    err, rows = phase_kernels(torch, lrn_kernel, CIFAR_NORM, seed=2)
    return launches, err, rows, {"step_ms": med * 1e3, "images_per_s": 100 / med}


# -- the image-file loaders, AlexNet from disk, the autoencoders -------------
WORK_DIR = "build/chip_smoke"  # under the checkout (gitignored), made anew each run
PNG_FILTERS = ("None", "Sub", "Up", "Average", "Paeth")
TREE_SPLITS = {"train": 12, "test": 3}  # images a class
TREE_CLASSES = ("ka", "ki", "ku", "ke")
TREE_SIZES = ((24, 24), (28, 20), (20, 30))  # (H, W): nearest resizes to 24x24 too
CROP_POOL = (640, 256, 256, 3)  # phase 18's 512 train + 128 valid images
CROP, CROP_BATCH = 227, 128
DISK_SPLITS = {"train": 512, "valid": 128}
AE_EPOCHS = 3


def _png_bytes(samples, ctype, filters):
    """An 8-bit, non-interlaced PNG of ``samples`` ``[H, W, S]`` (colour
    type 0, 2 or 6), row ``r`` filtered by ``filters[r % len(filters)]``:
    the script's own encoder (``zlib``), so that no image library is
    needed to write the tree."""
    import struct
    import zlib

    h, w, s = samples.shape
    rows = samples.reshape(h, w * s).tolist()
    raw, prev = bytearray(), [0] * (w * s)
    for r, cur in enumerate(rows):
        kind = filters[r % len(filters)]
        raw.append(kind)
        for i, x in enumerate(cur):
            a = cur[i - s] if i >= s else 0
            b = prev[i]
            c = prev[i - s] if i >= s else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            raw.append((x - (0, a, b, (a + b) >> 1, paeth)[kind]) & 0xFF)
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _nearest(img, h, w):
    """Nearest-neighbour resize, written out here: the check's own."""
    import numpy as np

    ih, iw = img.shape[:2]
    return img[(np.arange(h) * ih / h).astype(np.int64)][:, (np.arange(w) * iw / w).astype(np.int64)]


def _write_png_tree(root):
    """A Kanji-shaped tree (``<split>/<class>/*.png``, 4 classes) in colour
    types 0, 2 and 6 and every row filter, each image alone and all five in
    turn; returns {path: the expected float32 image [H, W, C]}."""
    import numpy as np

    rng = np.random.default_rng(17)
    expected, k = {}, 0
    for split, n in TREE_SPLITS.items():
        for ci, cls in enumerate(TREE_CLASSES):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                h, w = TREE_SIZES[k % len(TREE_SIZES)]
                ctype = (0, 2, 6)[k % 3]
                s = {0: 1, 2: 3, 6: 4}[ctype]
                samples = np.clip(40 + 50 * ci + rng.normal(0, 30, (h, w, s)), 0, 255).astype(
                    np.uint8)
                filters = [k % 5] if k % 6 else [0, 1, 2, 3, 4]
                path = d / f"{i:03d}.png"
                path.write_bytes(_png_bytes(samples, ctype, filters))
                expected[str(path)] = np.divide(samples[..., :3], 255, dtype=np.float32)
                k += 1
    return expected


def phase_loaders(torch, image_lib, imagenet_lib, native_lib, smi):
    """Phase 17: the loaders on this machine (no image library needed): a
    PNG tree written by the script's encoder, decoded bitwise, served by
    ``ImageDirectoryLoader`` and packed by ``pack_image_dir``; the native
    crop gather built with g++, held bitwise against its numpy version at
    AlexNet's batch and timed; the packed ImageNet-shaped files of phase
    18.  Returns the tree's path, the packed dir's path and the crop's
    numbers."""
    import importlib.util
    import shutil
    from pathlib import Path

    import numpy as np

    work = Path(__file__).resolve().parent / WORK_DIR
    shutil.rmtree(work, ignore_errors=True)
    libs = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "matplotlib")}
    print(f"loaders: image libraries importable here: {libs} (the port decodes PNG and BMP "
          "itself)")
    t0 = time.perf_counter()
    expected = _write_png_tree(work / "tree")
    tree = str(work / "tree")
    bad = [p for p, want in expected.items()
           if not np.array_equal(image_lib._read_image(p), want)]
    print(f"loaders: wrote {len(expected)} PNGs (colour types 0, 2, 6; filters "
          f"{', '.join(PNG_FILTERS)}) in {time.perf_counter() - t0:.2f} s; decoded bitwise "
          f"equal to the encoded samples / 255: {len(expected) - len(bad)} of {len(expected)}")
    if bad:
        fail(f"loaders: {len(bad)} PNGs decode to other values, e.g. {bad[0]}")
    dl = image_lib.ImageDirectoryLoader(tree, target_shape=(24, 24, 1), grayscale=True,
                                        minibatch_size=10)
    n_rows = 0
    for split in ("train", "test"):
        for mb in dl.batches(split, shuffle=False):
            for row, idx in enumerate(mb.indices[mb.mask > 0]):
                path, label = dl.index[split][int(idx)]
                want = _nearest(expected[path], 24, 24).mean(axis=-1, keepdims=True)
                if not np.array_equal(mb.data[row], want) or mb.labels[row] != label:
                    fail(f"loaders: ImageDirectoryLoader row {row} of {split} ({path}) differs")
                n_rows += 1
    if dl.classes != sorted(TREE_CLASSES) or n_rows != len(expected):
        fail(f"loaders: ImageDirectoryLoader classes {dl.classes}, {n_rows} rows")
    counts = imagenet_lib.pack_image_dir(tree, str(work / "packed_tree"), size=32)
    packed = np.load(work / "packed_tree" / "train_images.npy")
    labels = np.load(work / "packed_tree" / "train_labels.npy")
    want = np.stack([imagenet_lib._to_u8_rgb(expected[p], 32) for p, _ in dl.index["train"]])
    print(f"loaders: ImageDirectoryLoader served {n_rows} grey 24x24 rows equal to the "
          f"expected; pack_image_dir {counts}, train images {list(packed.shape)} equal to the "
          f"expected: {np.array_equal(packed, want)}")
    if not np.array_equal(packed, want) or labels.tolist() != [
            lab for _, lab in dl.index["train"]]:
        fail("loaders: pack_image_dir wrote other images or labels")

    t0 = time.perf_counter()
    built = native_lib.build()
    print(f"loaders: native/batch_assembler.cc built by g++ in {built.seconds:.2f} s "
          f"({time.perf_counter() - t0:.2f} s with the load) -> {built.path.name}")
    native_lib.load()
    rng = np.random.default_rng(23)
    pool = rng.integers(0, 256, CROP_POOL, dtype=np.uint8)
    n, h, w, _ = pool.shape
    args = (rng.integers(0, n, CROP_BATCH), rng.integers(0, h - CROP + 1, CROP_BATCH),
            rng.integers(0, w - CROP + 1, CROP_BATCH), rng.integers(0, 2, CROP_BATCH), CROP, CROP)
    got = native_lib.crop_gather_u8(pool, *args)
    same = np.array_equal(got, native_lib.crop_gather_u8_reference(pool, *args))
    print(f"loaders: crop_gather_u8 on a {list(CROP_POOL)} u8 pool, batch {CROP_BATCH}, crop "
          f"{CROP}, {int(args[3].sum())} flips: native bitwise equal to the numpy version: {same}")
    if not same:
        fail("loaders: the native crop differs from its numpy version")
    ms = []
    for _ in range(23):
        t0 = time.perf_counter()
        native_lib.crop_gather_u8(pool, *args)
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    native_lib.crop_gather_u8_reference(pool, *args)
    plain_ms = (time.perf_counter() - t0) * 1e3
    med = statistics.median(ms[3:])
    nbytes = got.nbytes
    print(f"loaders: crop_gather_u8 {med:.3f} ms a batch (median of 20 after 3 warm-up; "
          f"{nbytes / 1e6:.2f} MB out, the same read), {nbytes / med / 1e6:.2f} GB/s written; "
          f"numpy version {plain_ms:.3f} ms; {smi}")

    out = work / "imagenet"  # phase 18's data: pack_image_dir's layout at 256
    out.mkdir()
    n_train = DISK_SPLITS["train"]
    labels = rng.integers(0, 1000, n).astype(np.int32)
    for split, sl in (("train", slice(0, n_train)), ("valid", slice(n_train, n))):
        np.save(out / f"{split}_images.npy", pool[sl])
        np.save(out / f"{split}_labels.npy", labels[sl])
    (out / "classes.json").write_text(json.dumps([f"n{i:08d}" for i in range(1000)]))
    mean = pool[:n_train].reshape(-1, 3).mean(axis=0) / 255.0
    (out / "mean_rgb.json").write_text(json.dumps(mean.tolist()))
    return tree, str(out), {"crop_ms": med, "crop_gb_per_s": nbytes / med / 1e6,
                            "crop_plain_ms": plain_ms, "gxx_s": built.seconds}


def phase_alexnet_disk(torch, lrn_kernel, alexnet, imagenet_lib, model_lib, prng, troot,
                       data_dir, synthetic, smi):
    """Phase 18: AlexNet at its published geometry (227 crops, batch 128,
    1000 classes, bf16) from phase 17's packed files: one epoch with the
    LRN counters set to 0 just before and read just after, timed steps
    split into the host's fill, the u8 batch's H2D copy and the step, and a
    4-image f32 forward on the card against the CPU."""
    saved = troot.to_dict()
    try:
        troot.alexnet.loader.update({"data_dir": data_dir})
        prng.seed_all(1234)
        t0 = time.perf_counter()
        wf = alexnet.build_workflow(device="cuda")
    finally:
        troot.clear()
        troot.update(saved)
    wf.initialize()
    loader = wf.loader
    print(f"alexnet disk: built in {time.perf_counter() - t0:.1f} s on {type(loader).__name__} "
          f"({loader.data_dir}): {loader.class_lengths}, {loader.n_classes()} classes, crops "
          f"{loader.sample_shape}, head {wf.model.output_shape}, {wf.model.compute_dtype}")
    if not isinstance(loader, imagenet_lib.ImageNetLoader) or wf.model.output_shape != (1000,) \
            or loader.sample_shape != (CROP, CROP, 3) or loader.class_lengths != DISK_SPLITS:
        fail("alexnet disk: not the ImageNet loader at the published geometry")
    n_train, n_eval = loader.n_minibatches("train"), loader.n_minibatches("valid")
    torch.backends.cudnn.benchmark = True
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {"lrn_fwd": lrn_kernel.lrn_forward.launches,
                "lrn_bwd": lrn_kernel.lrn_backward.launches}
    summary = verdict["summary"]
    print(f"alexnet disk: epoch 1 {epoch_s:.2f} s: {json.dumps(summary)}")
    for split, n in DISK_SPLITS.items():
        m = summary.get(split)
        if m is None or m["n_samples"] != n or not all(math.isfinite(float(v))
                                                        for v in m.values()):
            fail(f"alexnet disk: {split} saw {m}, want {n} samples and finite metrics")
    want = {"lrn_fwd": 2 * (n_train + n_eval), "lrn_bwd": 2 * n_train}
    print(f"alexnet disk: launches {launches}, want {want} (as phase 4: {n_train} train steps, "
          f"{n_eval} eval steps, 2 norm layers)")
    if launches != want:
        fail(f"alexnet disk: LRN launch counts {launches} != {want}")

    def train_batches():
        while True:
            yield from loader.batches("train")

    batches = train_batches()
    parts = {"fill": [], "h2d": [], "step": [], "total": []}
    for i in range(12):
        t0 = time.perf_counter()
        mb = next(batches)  # the shuffle draw, the crop draws, the native crop
        t1 = time.perf_counter()
        x = torch.as_tensor(mb.data).to("cuda")
        y = torch.as_tensor(mb.labels).to("cuda")
        mask = torch.as_tensor(mb.mask).to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        acc = wf.train_step(x, y, mask)
        float(acc[0])
        t3 = time.perf_counter()
        if i >= 2:
            for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t3 - t0)):
                parts[k].append(v * 1e3)
    med = {k: statistics.median(v) for k, v in parts.items()}
    rate = CROP_BATCH / med["total"] * 1e3
    print(f"alexnet disk: train step from disk (batch {CROP_BATCH}, bf16) median "
          f"{med['total']:.2f} ms over 10 steps after 2 warm-up: host fill (crop) "
          f"{med['fill']:.2f} ms, H2D of the u8 batch {med['h2d']:.2f} ms "
          f"({x.numel() / 1e6:.1f} MB), step {med['step']:.2f} ms; {rate:.1f} images/sec, "
          f"beside phase 4's synthetic {synthetic['images_per_s']:.1f} images/sec "
          f"({synthetic['step_ms']:.2f} ms a step); {smi}; all totals ms "
          f"{[round(v, 2) for v in parts['total']]}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    m32 = model_lib.build(alexnet.DEFAULTS["layers"], loader.sample_shape, device="cpu")
    host = model_lib.params_to_numpy(wf.state.params)
    mb = next(iter(loader.batches("valid")))
    xb = loader.device_preproc()(torch.as_tensor(mb.data[:4]))
    with torch.no_grad():
        out_gpu = m32.apply(model_lib.params_from_jax(host, "cuda"), xb.cuda()).cpu()
        out_cpu = m32.apply(model_lib.params_from_jax(host, "cpu"), xb)
    rel = float((out_gpu - out_cpu).abs().max() / out_cpu.abs().max())
    print(f"alexnet disk: 4-image f32 forward of the valid crops, card vs CPU: max |diff| / "
          f"max |logit| = {rel:.3e} (limit 1e-4); logits shape {list(out_gpu.shape)}")
    if not rel < 1e-4 or out_gpu.shape != (4, 1000):
        fail("alexnet disk: card and CPU forwards disagree")
    return launches, {**med, "images_per_s": rate}


def phase_autoencoders(torch, models, deconv, troot, prng, tree, smi):
    """Phase 19: mnist_ae at its published widths (batch 100, f32 without
    TF32) 3 epochs on the card against the CPU from one seed, its step
    time, the deconv at its shape card against CPU; one epoch each of
    video_ae, kanji and yale_faces (synthetic) and kanji from phase 17's
    tree on the card."""
    _f32_exact(torch)
    torch.backends.cudnn.benchmark = False
    mnist_ae = models["mnist_ae"]
    prng.seed_all(1234)
    wf = mnist_ae.build_workflow(device="cuda")
    wf.initialize()
    print(f"mnist_ae: layer shapes {list(wf.model.layer_shapes)}; "
          f"{wf.loader.n_minibatches('train')} train and {wf.loader.n_minibatches('test')} test "
          "steps an epoch")
    if wf.model.layer_shapes != ((7, 7, 12), (28, 28, 1)):
        fail(f"mnist_ae: layer shapes {wf.model.layer_shapes}")
    t0 = time.perf_counter()
    card = _epochs(wf, AE_EPOCHS)
    torch.cuda.synchronize()
    print(f"mnist_ae: {AE_EPOCHS} epochs on the card in {time.perf_counter() - t0:.2f} s "
          "(conv and deconv: cuDNN; no hand kernel on this path)")
    prng.seed_all(1234)
    wf_cpu = mnist_ae.build_workflow(device="cpu")
    wf_cpu.initialize()
    _epochs_against_cpu("mnist_ae", card, _epochs(wf_cpu, AE_EPOCHS))
    step_s = _step_seconds(torch, wf, 20, 5)
    med = statistics.median(step_s) * 1e3
    print(f"mnist_ae: train step (batch 100, f32, TF32 off) median {med:.4f} ms over 20 "
          f"synchronized steps after 5 warm-up, on {smi}; min {min(step_s) * 1e3:.4f}, max "
          f"{max(step_s) * 1e3:.4f} ms")

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((100, 7, 7, 12), generator=gen)
    w = torch.randn((10, 10, 1, 12), generator=gen) * 0.05
    g = torch.randn((100, 28, 28, 1), generator=gen)
    res = {}
    for dev in ("cpu", "cuda"):
        xd, wd = x.to(dev).requires_grad_(True), w.to(dev).requires_grad_(True)
        y = deconv.apply({"weights": wd}, xd, sliding=(3, 3))
        dx, dw = torch.autograd.grad((y * g.to(dev)).sum(), (xd, wd))
        res[dev] = [t.detach().cpu() for t in (y, dx, dw)]
    errs = {name: float((c - h).abs().max() / h.abs().max())
            for name, c, h in zip(("y", "dx", "dw"), res["cuda"], res["cpu"])}
    print(f"mnist_ae: deconv at [100, 7, 7, 12] -> [100, 28, 28, 1] (10x10, stride 3), card vs "
          f"CPU, max |diff| / max |ref|: {errs} (limit 1e-5)")
    if not all(v < 1e-5 for v in errs.values()):
        fail("mnist_ae: the deconv or its gradients differ between the card and the CPU")

    rates = {}
    runs = [(name, None) for name in ("video_ae", "kanji", "yale_faces")] + [("kanji", tree)]
    for name, data_dir in runs:
        saved = troot.to_dict()
        try:
            if data_dir:
                getattr(troot, name).loader.update({"data_dir": data_dir})
            prng.seed_all(1234)
            wf = models[name].build_workflow(device="cuda")
        finally:
            troot.clear()
            troot.update(saved)
        wf.initialize()
        t0 = time.perf_counter()
        summary = wf.run_epoch()["summary"]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = sum(m["n_samples"] for m in summary.values())
        label = f"{name}{' (PNG tree)' if data_dir else ''}"
        if n != sum(wf.loader.class_lengths.values()) or not all(
                math.isfinite(float(v)) for m in summary.values() for v in m.values()):
            fail(f"{label}: epoch saw {n} samples or non-finite metrics: {summary}")
        if data_dir and wf.model.output_shape != (len(TREE_CLASSES),):
            fail(f"{label}: head {wf.model.output_shape}, want {len(TREE_CLASSES)} classes")
        rates[label] = n / secs
        print(f"{label}: one epoch on the card (first, synthetic data unless said) "
              f"{secs:.3f} s, {n:.0f} images (train and eval), {n / secs:.1f} images/sec: "
              + json.dumps(summary))
    return {"mnist_ae_step_ms": med, "rates": rates}



# -- the host loop around the step: prefetch, pinned copies, snapshots --------
HOST_LOOP_CHECKED = 2  # epochs whose every batch is summed on both sides
HOST_LOOP_EPOCHS = 10  # epochs a timed window: 40 train and 10 eval steps
# the thread on the small models: epochs a window, at depth 0 and 2 in turns
THREAD_COST_EPOCHS = {"kohonen": 1, "mnist_rbm": 1, "mnist": 8, "cifar": 4}


def _window(torch, wf, epochs):
    """``epochs`` epochs of ``wf.run_epoch()`` after the attribution window
    is reset: the window's seconds, the mean (ms, the series' sum over its
    count in the window) of the host loop's histograms, and the
    attribution.  Series the loop did not observe (the serial loop has no
    fetch, enqueue or wait) are None."""
    from znicz_tpu_torch import observability as obs
    from znicz_tpu_torch.observability import pipeline

    pipeline.reset_window()
    t0 = time.perf_counter()
    for _ in range(epochs):
        wf.run_epoch()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fams = obs.get_registry().metrics()

    def mean_ms(name, *labels):
        child = fams[name].children().get(labels) if name in fams else None
        return child.sum / child.count * 1e3 if child is not None and child.count else None

    stages = (pipeline.STAGE_FETCH, pipeline.STAGE_H2D, pipeline.STAGE_ENQUEUE)
    return {
        "seconds": secs,
        "step_wall_ms": mean_ms(pipeline.STEP_WALL_METRIC),
        "dispatch_train_ms": mean_ms(pipeline.PHASE_METRIC, "dispatch/train"),
        "wait_ms": mean_ms(pipeline.WAIT_METRIC),
        **{f"{st}_ms": mean_ms(pipeline.STAGE_METRIC, st) for st in stages},
        "attribution": pipeline.PipelineAttribution.from_registry().attribution(),
    }


def _ms(v):
    return "-" if v is None else f"{v:.3f}"


def _pinned_copy_ms(torch, shape, reps=20):
    """Median ms (CUDA events) of one ``non_blocking`` copy of a u8 array
    of ``shape`` from pinned memory to the card, and of the same copy from
    pageable memory, in turns."""
    import numpy as np

    host = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    src = {"pinned": torch.from_numpy(host).pin_memory(), "pageable": torch.from_numpy(host)}
    times = {k: [] for k in src}
    for _ in range(reps + 2):
        for k, t in src.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = t.to("cuda", non_blocking=True)
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
            if not torch.equal(out[0].cpu(), t[0]):
                fail(f"host loop: the {k} copy changed the batch")
    return {k: statistics.median(v[2:]) for k, v in times.items()}


def phase_host_loop(torch, lrn_kernel, alexnet, prng, troot, data_dir, serial, smi):
    """Phase 20: AlexNet from phase 17's packed files through the
    workflow's own host loop: the prefetch thread (depth 2).  One epoch
    with the LRN counters set to 0 just before and read just after; two
    epochs whose every batch's int64 sum on the card is held against the
    loader's on the host; timed windows of the thread and of the serial
    loop (``prefetch_batches=0``) in turns, read through the registry's
    series; one batch's copy from pinned and from pageable memory; the
    attribution; a snapshot and an exact resume; the Prometheus text."""
    import tempfile

    import numpy as np

    from znicz_tpu_torch import observability as obs
    from znicz_tpu_torch.workflow import snapshotter as snap_lib

    def build(**kw):
        saved = troot.to_dict()
        try:
            troot.alexnet.loader.update({"data_dir": data_dir})
            prng.seed_all(1234)
            return alexnet.build_workflow(device="cuda", **kw)
        finally:
            troot.clear()
            troot.update(saved)

    torch.backends.cudnn.benchmark = True
    wf = build()
    if wf.prefetch_batches != 2:
        fail(f"host loop: prefetch_batches {wf.prefetch_batches}, want the default 2")
    wf.initialize()
    loader = wf.loader
    n_train, n_eval = loader.n_minibatches("train"), loader.n_minibatches("valid")
    # every batch of the checked epochs: its sum on the host as the loader
    # made it (the producer thread), and on the card as the step received it
    host_sums, card_sums = [], []
    fill, train_step, eval_step = loader.fill, wf.train_step, wf.eval_step

    def fill_spy(indices, split):
        mb = fill(indices, split)
        host_sums.append(int(mb.data.sum(dtype=np.int64)))
        return mb

    def train_spy(x, y, mask, *args):
        card_sums.append(x.sum(dtype=torch.int64))
        return train_step(x, y, mask, *args)

    def eval_spy(x, y, mask, *args):
        card_sums.append(x.sum(dtype=torch.int64))
        return eval_step(x, y, mask, *args)

    loader.fill, wf.train_step, wf.eval_step = fill_spy, train_spy, eval_spy
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {"lrn_fwd": lrn_kernel.lrn_forward.launches,
                "lrn_bwd": lrn_kernel.lrn_backward.launches}
    want = {"lrn_fwd": 2 * (n_train + n_eval), "lrn_bwd": 2 * n_train}
    summary = verdict["summary"]
    print(f"host loop: epoch 1 through the prefetch thread {epoch_s:.2f} s: {json.dumps(summary)}")
    print(f"host loop: launches {launches}, want {want} (phase 18's counts)")
    if launches != want:
        fail(f"host loop: LRN launch counts {launches} != {want}")
    for split, n in DISK_SPLITS.items():
        m = summary.get(split)
        if m is None or m["n_samples"] != n or not all(math.isfinite(float(v))
                                                        for v in m.values()):
            fail(f"host loop: {split} saw {m}, want {n} samples and finite metrics")
    for _ in range(HOST_LOOP_CHECKED - 1):
        wf.run_epoch()
    loader.fill, wf.train_step, wf.eval_step = fill, train_step, eval_step
    got = [int(v) for v in card_sums]
    bad = [i for i, (a, b) in enumerate(zip(got, host_sums)) if a != b]
    n_items = HOST_LOOP_CHECKED * (n_train + n_eval)
    print(f"host loop: {len(got)} batches of {HOST_LOOP_CHECKED} epochs checked on the card "
          f"against the loader's int64 sums ({len(host_sums)} filled): {len(bad)} differ")
    if len(got) != n_items or len(host_sums) != n_items or bad:
        fail(f"host loop: batches changed on their way to the step (first at {bad[:3]})")

    # the timed windows: the thread, the serial loop, the serial loop, the thread
    ser = build(prefetch_batches=0)
    ser.initialize()
    ser.run_epoch()
    rounds = {"thread": [], "serial": []}
    for kind in ("thread", "serial", "serial", "thread"):
        rounds[kind].append(_window(torch, wf if kind == "thread" else ser, HOST_LOOP_EPOCHS))
    win, ser_win = rounds["thread"][-1], rounds["serial"][-1]
    att = win["attribution"]
    epoch_images = HOST_LOOP_EPOCHS * sum(DISK_SPLITS.values())
    rates = {k: [epoch_images / w["seconds"] for w in ws] for k, ws in rounds.items()}
    copy = _pinned_copy_ms(torch, (CROP_BATCH, CROP, CROP, 3))
    batch_bytes = CROP_BATCH * CROP * CROP * 3
    res = {
        "images_per_s": rates["thread"],
        "serial_images_per_s": rates["serial"],
        **{k: win[k] for k in ("step_wall_ms", "dispatch_train_ms", "wait_ms", "fetch_ms",
                               "h2d_ms", "enqueue_ms")},
        "serial_step_wall_ms": ser_win["step_wall_ms"],
        "serial_dispatch_train_ms": ser_win["dispatch_train_ms"],
        "serial_h2d_ms": ser_win["h2d_ms"],
        "pinned_copy_ms": copy["pinned"],
        "pinned_copy_gb_per_s": batch_bytes / copy["pinned"] / 1e6,
        "pageable_copy_ms": copy["pageable"],
        "verdict": att["verdict"],
        "fractions": att["fractions"],
        "serial_verdict": ser_win["attribution"]["verdict"],
    }
    print(f"host loop: {HOST_LOOP_EPOCHS} epochs a window ({epoch_images} images, train and "
          f"eval, the epoch ends and the final sync included), run_epoch through the prefetch "
          f"thread (batch {CROP_BATCH}, bf16, depth 2, pinned copies) "
          f"{', '.join(f'{r:.1f}' for r in rates['thread'])} images/sec in its two windows, "
          f"beside the serial run_epoch (prefetch_batches=0) "
          f"{', '.join(f'{r:.1f}' for r in rates['serial'])} and phase 18's split "
          f"{serial['total']:.2f} ms a step (fill {serial['fill']:.2f} + pageable H2D "
          f"{serial['h2d']:.2f} + synchronized step {serial['step']:.2f}; "
          f"{serial['images_per_s']:.1f} images/sec) in this run; {smi}")
    print(f"host loop: per-step means of the last thread window (ms, the registry's sum over "
          f"count): step wall {_ms(win['step_wall_ms'])}, dispatch/train "
          f"{_ms(win['dispatch_train_ms'])}, consumer wait {_ms(win['wait_ms'])}; producer "
          f"stages fetch {_ms(win['fetch_ms'])}, h2d (the copy into pinned memory) "
          f"{_ms(win['h2d_ms'])}, enqueue {_ms(win['enqueue_ms'])}; serial: step wall "
          f"{_ms(ser_win['step_wall_ms'])}, dispatch/train {_ms(ser_win['dispatch_train_ms'])}, "
          f"h2d (pageable, synchronous) {_ms(ser_win['h2d_ms'])}; one batch's copy to the card "
          f"(CUDA events) from pinned memory {copy['pinned']:.3f} ms "
          f"({res['pinned_copy_gb_per_s']:.2f} GB/s), from pageable {copy['pageable']:.3f} ms; "
          f"{smi}")
    print(f"host loop: attribution {att['verdict']} ({att['confidence']}), fractions "
          f"{json.dumps(att['fractions'])} (serial: {res['serial_verdict']}, "
          f"{json.dumps(ser_win['attribution']['fractions'])})")

    # snapshot and exact resume
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        saver = build(snapshot_dir=tmp)
        saver.initialize()
        save_s = []
        save = saver.snapshotter.save

        def timed_save(*args, **kw):
            t = time.perf_counter()
            try:
                return save(*args, **kw)
            finally:
                save_s.append(time.perf_counter() - t)

        saver.snapshotter.save = timed_save
        saver.run_epoch()
        path = saver.snapshotter.best_path
        if len(save_s) != 1 or not snap_lib.is_valid_snapshot(path):
            fail(f"host loop: the epoch wrote {len(save_s)} snapshots, want one valid 'best'")
        mb = os.path.getsize(path) / 1e6
        t = time.perf_counter()
        snap_lib.load_snapshot(path)
        load_s = time.perf_counter() - t
        want_eval = saver.evaluate("valid")
        resumed = build()
        t = time.perf_counter()
        resumed.initialize(snapshot=path)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
        got_eval = resumed.evaluate("valid")
    torch.backends.cudnn.deterministic = False
    rel = abs(got_eval["loss"] - want_eval["loss"]) / max(abs(want_eval["loss"]), 1e-30)
    res.update(snapshot_mb=mb, save_ms=save_s[0] * 1e3, load_ms=load_s * 1e3,
               resume_ms=resume_s * 1e3, resume_loss_rel=rel)
    print(f"host loop: snapshot 'best' of epoch 1 {mb:.1f} MB (gzip) saved in "
          f"{res['save_ms']:.0f} ms; load_snapshot {res['load_ms']:.0f} ms, initialize(snapshot=) "
          f"on the card {res['resume_ms']:.0f} ms; evaluate('valid') saved {json.dumps(want_eval)} "
          f"vs resumed {json.dumps(got_eval)}: loss rel diff {rel:.3e} (limit 1e-6); {smi}")
    if got_eval["n_err"] != want_eval["n_err"] or not rel <= 1e-6:
        fail("host loop: the resumed workflow does not evaluate as the saved one")

    prom = obs.prometheus_text()
    out = os.path.join(WORK_DIR, "metrics.prom")
    with open(out, "w") as f:
        f.write(prom)
    families = sorted(obs.get_registry().metrics())
    print(f"host loop: {out} {len(prom.encode())} bytes, {len(families)} families: "
          + ", ".join(families))
    return launches, res


def _bare_loop_seconds(torch, wf, epochs, depth):
    """``epochs`` epochs of the loader's batches through ``prefetch`` (no
    transform: the producer only fills, in numpy) or in series (depth 0),
    the consumer copying each batch from pageable memory and calling the
    workflow's public steps, one fetch a split an epoch: the thread's own
    cost, without the workflow's staging and telemetry.  Seconds."""
    from znicz_tpu_torch.loader.prefetch import prefetch

    labels = wf.loss_function == "softmax"
    t0 = time.perf_counter()
    for _ in range(epochs):
        accs = {}
        batches = wf.loader.epoch()
        for split, mb in (prefetch(batches, depth) if depth else batches):
            x = torch.as_tensor(mb.data, device=wf.device)
            y = torch.as_tensor(mb.labels, device=wf.device) if labels else x
            mask = torch.as_tensor(mb.mask, device=wf.device)
            step = wf.train_step if split == "train" else wf.eval_step
            accs[split] = step(x, y, mask, acc=accs.get(split))
        for acc in accs.values():
            acc.cpu()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_thread_cost(torch, models, troot, prng, smi):
    """Phase 20, continued: what the prefetch thread (the default) costs
    the host-bound models at their phases' sizes (the SOM and the RBM on
    MNIST's 60,000 / 10,000, MNIST and CIFAR-10): ``run_epoch`` of two
    workflows from one seed, ``prefetch_batches`` 0 and 2, one warm-up
    epoch each, then windows of ``THREAD_COST_EPOCHS`` epochs at depth 0,
    2, 2, 0, and the same for the bare loop (``_bare_loop_seconds``); ms a
    step and the per-step means of each window's series; beside them the
    bare hand-off of one item through ``prefetch`` with no work on either
    side."""
    from znicz_tpu_torch.loader.prefetch import prefetch

    for name in ("kohonen", "mnist_rbm"):
        getattr(troot, name).update({"loader": {"n_train": MNIST_SPLITS["train"],
                                                "n_test": MNIST_SPLITS["test"]}})
    n = 20000
    t0 = time.perf_counter()
    for _ in prefetch(iter(range(n)), 2):
        pass
    out = {"handoff_us": (time.perf_counter() - t0) / n * 1e6}
    print(f"thread cost: the bare hand-off of one item through prefetch (depth 2, no work) "
          f"{out['handoff_us']:.2f} us, mean of {n}")
    for name, epochs in THREAD_COST_EPOCHS.items():
        wfs = {}
        for depth in (0, 2):
            prng.seed_all(1234)
            wfs[depth] = models[name].build_workflow(device="cuda", prefetch_batches=depth)
            wfs[depth].initialize()
            wfs[depth].run_epoch()
        wins, bare = {0: [], 2: []}, {0: [], 2: []}
        for depth in (0, 2, 2, 0):
            wins[depth].append(_window(torch, wfs[depth], epochs))
        for depth in (0, 2, 2, 0):
            bare[depth].append(_bare_loop_seconds(torch, wfs[0], epochs, depth))
        loader = wfs[0].loader
        steps = epochs * sum(loader.n_minibatches(s) for s in loader.class_lengths)
        per_step = {d: [w["seconds"] / steps * 1e3 for w in ws] for d, ws in wins.items()}
        bare_step = {d: [v / steps * 1e3 for v in vs] for d, vs in bare.items()}
        means = {d: {k: statistics.mean(w[k] for w in ws) if ws[0][k] is not None else None
                     for k in ("step_wall_ms", "dispatch_train_ms", "wait_ms", "fetch_ms",
                               "h2d_ms")}
                 for d, ws in wins.items()}
        out[name] = {"steps": steps, "ms_a_step": per_step, "bare_ms_a_step": bare_step,
                     "means": means}
        print(f"thread cost: {name} ({steps} steps a window, train and eval) run_epoch ms a "
              f"step at depth 0 {[round(v, 4) for v in per_step[0]]}, at depth 2 "
              f"{[round(v, 4) for v in per_step[2]]}; the bare loop at depth 0 "
              f"{[round(v, 4) for v in bare_step[0]]}, at depth 2 "
              f"{[round(v, 4) for v in bare_step[2]]}; run_epoch's per-step means (ms) at "
              "depth 0 / 2: "
              + "; ".join(f"{k[:-3]} {_ms(means[0][k])} / {_ms(means[2][k])}"
                          for k in means[0])
              + f"; {smi}")
    return out


# -- self-healing training (phase 21) -------------------------------------------

HEAL_EPOCHS = 3  # the golden AlexNet runs: 12 train and 3 eval steps
HEAL_POISON = 5  # the train batch (in fill order) filled with NaN once: epoch 1's second
HEAL_STOP = 6  # the train step whose lr asks for the stop: mid epoch 1
# epochs a window of the watch's cost: AlexNet 150 steps (~2 s), the others 200-700
WATCH_EPOCHS = {"alexnet": 30, "kohonen": 1, "mnist_rbm": 1, "mnist": 8}
# the watch on / off a window, two a side (the script's time limit)
WATCH_TURNS = (True, False, False, True)
TRANSPORT_CALLS = 2000  # calls of each watch transport, in turns
# deferred against sync: a stop driven by fail_iterations after ~20 epochs (~100 steps)
DEFERRED_DECISION = {"max_epochs": 40, "fail_iterations": 20}
DEFERRED_RUNS = ("sync", "deferred", "deferred", "sync")  # two a side (the time limit)
RESUME_EPOCHS = 3  # SOM, RBM and LM: uninterrupted against 1 + snapshot + 2 resumed
LM_RESUME = dict(LM_MID, n_layers=2)  # the mid LM's width at a smaller depth
LM_RESUME_N = 48  # 3 train steps an epoch at batch 16, T 2048


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _differ(torch, a, b):
    """(tensors of ``a`` not bitwise equal to ``b``'s, the largest |diff|)."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        fail(f"states of {len(la)} and {len(lb)} tensors compared")
    bad = [(x, y) for x, y in zip(la, lb) if not torch.equal(x, y)]
    worst = max((float((x.float() - y.float()).abs().max()) for x, y in bad), default=0.0)
    return len(bad), worst


def _sync_warnings(torch, wf):
    """One ``run_epoch`` under ``torch.cuda.set_sync_debug_mode("warn")``:
    the synchronizing calls it made (count, distinct first lines)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            wf.run_epoch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the mode's one-time "prototype feature" notice is not a call
    msgs = [str(w.message).splitlines()[0][:100] for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
    return len(msgs), sorted(set(msgs))


def _spread(on, off):
    """The difference of two lists' means with its spread, the least and
    the largest difference of one element of each."""
    return (statistics.mean(on) - statistics.mean(off), min(on) - max(off), max(on) - min(off))


def _watch_parts(torch, wf, epochs):
    """One window of ``epochs`` epochs of ``wf`` (the watch on) with each
    part of the watch timed on the host: the norms (``tensor_norms`` or the
    unsupervised ``update_norms``, patched in their modules), the watch
    vector's stack, pinned copy and event (``_watch_vector``), the lagged
    read (``_feed_watch`` less the detector) and the detector
    (``observe_step``); µs a train step, the window's ms a step, the reads,
    the reads whose event had not completed, and the mean lag in train
    steps."""
    from znicz_tpu_torch.workflow import unsupervised as unsup_mod
    from znicz_tpu_torch.workflow import workflow as wf_mod

    secs = {"norms": 0.0, "vector": 0.0, "feed": 0.0, "detector": 0.0}
    counts = {"reads": 0, "waits": 0, "lag": 0}

    def timed(fn, key):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                secs[key] += time.perf_counter() - t
        return call

    feed = wf._feed_watch

    def counted_feed(step, watch, step_seconds=None):
        event = watch[1]
        counts["reads"] += 1
        counts["waits"] += int(event is not None and not event.query())
        counts["lag"] += wf.state.step - 1 - int(step)
        return feed(step, watch, step_seconds)

    patched = [(wf_mod, "tensor_norms"), (unsup_mod, "update_norms")]
    saved = [getattr(m, n) for m, n in patched]
    for m, n in patched:
        setattr(m, n, timed(getattr(m, n), "norms"))
    wf._watch_vector = timed(wf._watch_vector, "vector")
    wf._feed_watch = timed(counted_feed, "feed")
    wf.anomaly.observe_step = timed(wf.anomaly.observe_step, "detector")
    try:
        loader = wf.loader
        steps = epochs * sum(loader.n_minibatches(s) for s in loader.class_lengths)
        win = _window(torch, wf, epochs)
    finally:
        for (m, n), fn in zip(patched, saved):
            setattr(m, n, fn)
        for name in ("_watch_vector", "_feed_watch"):
            del wf.__dict__[name]
        del wf.anomaly.__dict__["observe_step"]
    n = max(counts["reads"], 1)
    us = {k: v / n * 1e6 for k, v in secs.items()}
    us["read"] = us.pop("feed") - us["detector"]
    return {"us_a_train_step": us, "ms_a_step": win["seconds"] / steps * 1e3,
            "reads": counts["reads"], "waits": counts["waits"],
            "lag_steps_mean": counts["lag"] / n}


def _watch_transport(torch, smi):
    """The watch vector's way to the host, host µs a call over
    ``TRANSPORT_CALLS`` calls each, in turns: the stack of a loss and 16
    norms (AlexNet's tensors), the shipped copy into a fresh pinned tensor
    with a fresh event (``_fetch_async``), and a copy into a reused ring of
    pinned rows with reused events."""
    from znicz_tpu_torch.workflow.workflow import WATCH_LAG, _fetch_async

    loss = torch.rand((), device="cuda")
    norms = list(torch.rand(16, device="cuda").unbind())
    vec = torch.stack([loss, *norms])
    ring = torch.empty((WATCH_LAG + 2, vec.numel()), dtype=torch.float32, pin_memory=True)
    events = [torch.cuda.Event() for _ in range(len(ring))]

    def stack(i):
        torch.stack([loss, *norms])

    def fresh(i):
        _fetch_async([vec])

    def reused(i):
        j = i % len(ring)
        ring[j].copy_(vec, non_blocking=True)
        events[j].record()

    us = {f.__name__: [] for f in (stack, fresh, reused)}
    for f in (stack, fresh, reused, reused, fresh, stack):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(TRANSPORT_CALLS):
            f(i)
        us[f.__name__].append((time.perf_counter() - t) / TRANSPORT_CALLS * 1e6)
        torch.cuda.synchronize()
    print(f"self-healing: the watch vector's transport, host µs a call ({TRANSPORT_CALLS} "
          f"calls a run, two runs each): stack of 17 {[round(v, 2) for v in us['stack']]}; "
          f"copy into a fresh pinned tensor + fresh event {[round(v, 2) for v in us['fresh']]}; "
          f"copy into a reused pinned ring + reused event {[round(v, 2) for v in us['reused']]}; "
          f"{smi}")
    return us


def _watch_cost(torch, make, epochs, label, smi):
    """``run_epoch`` of two workflows from one seed, the anomaly watch on
    (the default) and off, one warm-up epoch each, then windows of
    ``epochs`` epochs on and off in ``WATCH_TURNS``: ms a step over each whole
    window, the difference of the means with its spread, and the per-step
    means of ``dispatch/train`` and the step wall; then one window with the
    watch's parts timed (:func:`_watch_parts`), and one epoch of each under
    the sync debug mode, where the watch may add no synchronizing call."""
    wfs = {}
    for on in (True, False):
        wfs[on] = make()
        if not on:
            wfs[on].anomaly = None  # what anomaly=False builds
        wfs[on].initialize()
        wfs[on].run_epoch()
    wins = {True: [], False: []}
    for on in WATCH_TURNS:
        wins[on].append(_window(torch, wfs[on], epochs))
    loader = wfs[True].loader
    steps = epochs * sum(loader.n_minibatches(s) for s in loader.class_lengths)
    per_step = {on: [w["seconds"] / steps * 1e3 for w in ws] for on, ws in wins.items()}
    means = {on: {k: statistics.mean(w[k] for w in ws) for k in ("step_wall_ms",
                                                                   "dispatch_train_ms")}
             for on, ws in wins.items()}
    diff = _spread(per_step[True], per_step[False])
    parts = _watch_parts(torch, wfs[True], epochs)
    syncs = {on: _sync_warnings(torch, wfs[on]) for on in (True, False)}
    out = {"steps": steps, "ms_a_step": {"on": per_step[True], "off": per_step[False]},
           "diff_ms": diff, "means_on": means[True], "means_off": means[False],
           "parts": parts, "sync_calls_an_epoch": {"on": syncs[True][0], "off": syncs[False][0]}}
    us = parts["us_a_train_step"]
    print(f"self-healing: watch cost, {label} ({steps} steps a window, train and eval): "
          f"run_epoch ms a step with the watch {[round(v, 4) for v in per_step[True]]}, "
          f"without {[round(v, 4) for v in per_step[False]]}: on - off {diff[0]:+.4f} ms "
          f"(spread {diff[1]:+.4f} .. {diff[2]:+.4f}); per-step means (ms) on / off: "
          f"dispatch/train {_ms(means[True]['dispatch_train_ms'])} / "
          f"{_ms(means[False]['dispatch_train_ms'])}, step wall "
          f"{_ms(means[True]['step_wall_ms'])} / {_ms(means[False]['step_wall_ms'])}; "
          f"the watch's parts, host µs a train step (a timed window of "
          f"{parts['ms_a_step']:.4f} ms a step): norms {us['norms']:.1f}, stack + pinned copy "
          f"+ event {us['vector']:.1f}, lagged read {us['read']:.1f}, detector "
          f"{us['detector']:.1f}; the detector read {parts['reads']} vectors "
          f"{parts['lag_steps_mean']:.3f} train steps late on average ({parts['waits']} "
          f"found their copy incomplete); synchronizing calls in one epoch under the sync "
          f"debug mode: {syncs[True][0]} with the watch, {syncs[False][0]} without "
          f"({syncs[True][1]}); {smi}")
    if syncs[True][0] > syncs[False][0]:
        fail(f"self-healing: the watch synchronizes the host with the card ({label}: "
             f"{syncs[True][1]})")
    return out


def _poisoned_rollback(torch, lrn_kernel, build, ref, cfg, smi):
    """AlexNet with a loader whose ``fill`` returns NaN data for one train
    batch, once, under ``RecoveryPolicy(perturb=False, lr_backoff=1.0)``:
    the detector raises ``non_finite_loss`` within 3 steps, the rollback
    restores the epoch-start buffer bitwise and the run ends bitwise equal
    to ``ref``, the unfaulted run of the same seed.  The LRN counters are
    set to 0 just before the run and read just after."""
    import numpy as np

    from znicz_tpu_torch import observability as obs
    from znicz_tpu_torch.observability import pipeline
    from znicz_tpu_torch.workflow.recovery import RecoveryPolicy

    pol = RecoveryPolicy(perturb=False, lr_backoff=1.0)
    wf = build(recovery=pol, **cfg)
    fill, train_step, eval_step = wf.loader.fill, wf.train_step, wf.eval_step
    seen = {"fills": 0, "poisoned": False, "train": 0, "eval": 0}

    def poisoned(idx, split):
        mb = fill(idx, split)
        if split == "train":
            if seen["fills"] == HEAL_POISON and not seen["poisoned"]:
                seen["poisoned"] = True
                mb = mb._replace(data=np.full(mb.data.shape, np.nan, np.float32))
            seen["fills"] += 1
        return mb

    def train_spy(*args, **kw):
        seen["train"] += 1
        return train_step(*args, **kw)

    def eval_spy(*args, **kw):
        seen["eval"] += 1
        return eval_step(*args, **kw)

    retain, rollback = wf._retain_epoch_start, wf._execute_rollback
    clone_ms, rb = [], {}

    def timed_retain():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = retain()
        torch.cuda.synchronize()
        clone_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_rollback(reason):
        buf = wf._epoch_start[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        rollback(reason)
        torch.cuda.synchronize()
        rb["ms"] = (time.perf_counter() - t) * 1e3
        rb["differ"] = _differ(torch, list(buf[:2]), [wf.state.params, wf.state.velocity])
        rb["steps"] = (wf.state.step, int(buf[2]))
        rb["mb"] = sum(t.numel() * t.element_size() for t in _leaves(list(buf[:2]))) / 1e6

    wf.loader.fill, wf.train_step, wf.eval_step = poisoned, train_spy, eval_spy
    wf._retain_epoch_start, wf._execute_rollback = timed_retain, timed_rollback
    fam = obs.get_registry().metrics().get(pipeline.ROLLBACKS_METRIC)
    before = fam.children().get(("non_finite_loss",)) if fam is not None else None
    before = before.value if before is not None else 0.0
    wf.initialize()
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    t0 = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"lrn_fwd": lrn_kernel.lrn_forward.launches,
                "lrn_bwd": lrn_kernel.lrn_backward.launches}
    after = obs.get_registry().metrics()[pipeline.ROLLBACKS_METRIC].children()[
        ("non_finite_loss",)].value
    ev = pol.events[0] if pol.events else {}
    lag = ev.get("step", -1) - HEAL_POISON
    differ = _differ(torch, wf.state.params, ref.state.params)
    same_history = wf.decision.history == ref.decision.history
    want = {"lrn_fwd": 2 * (seen["train"] + seen["eval"]), "lrn_bwd": 2 * seen["train"]}
    res = {"rollback_ms": rb.get("ms"), "clone_ms": clone_ms, "clone_mb": rb.get("mb"),
           "detected_steps_after": lag, "events": [{k: v for k, v in e.items() if k != "unix"}
                                                   for e in pol.events],
           "counter_delta": after - before, "final_differ": differ, "run_s": run_s,
           "launches": launches, "steps": {k: seen[k] for k in ("train", "eval")}}
    print(f"self-healing: poisoned batch (train batch {HEAL_POISON}, NaN data once): "
          f"{json.dumps(res['events'])}; the detector raised {lag} steps after the poisoned "
          f"step; znicz_train_rollbacks_total{{reason=\"non_finite_loss\"}} +{after - before:g}; "
          f"rollback {rb.get('ms', float('nan')):.2f} ms; epoch-start clones "
          f"{[round(v, 3) for v in clone_ms]} ms of {rb.get('mb', float('nan')):.1f} MB "
          f"(params and momentum); restored against the buffer {rb.get('differ')} "
          f"(tensors that differ, max |diff|); the run ({seen['train']} train and "
          f"{seen['eval']} eval steps, {run_s:.2f} s) against the unfaulted one: {differ}, "
          f"history {'equal' if same_history else 'differs'}; LRN launches {launches}, "
          f"want {want}; {smi}")
    if not seen["poisoned"] or pol.rollbacks_used != 1 or ev.get("reason") != "non_finite_loss":
        fail(f"self-healing: the poisoned batch was not rolled back once: {pol.events}")
    if ev.get("source") != "epoch-start buffer" or not 0 < lag <= 3:
        fail(f"self-healing: rollback from {ev.get('source')}, {lag} steps after the poison")
    if rb["differ"] != (0, 0.0) or rb["steps"][0] != rb["steps"][1]:
        fail(f"self-healing: the rollback did not restore the buffer bitwise: {rb}")
    if after - before != 1:
        fail(f"self-healing: the rollback counter moved by {after - before}")
    if differ != (0, 0.0) or not same_history:
        fail(f"self-healing: the recovered run differs from the unfaulted one: {differ}")
    if launches != want:
        fail(f"self-healing: LRN launches {launches} != {want}")
    return res


def _graceful_stop(torch, build, ref, cfg, smi):
    """``request_stop()`` mid-epoch with emergency snapshots on: the
    ``TrainingPreempted`` path writes one snapshot (its MB and seconds), and
    a fresh workflow resumed from it ends bitwise equal to ``ref``."""
    import tempfile
    from pathlib import Path

    from znicz_tpu_torch.workflow.recovery import TrainingPreempted

    work = Path(__file__).resolve().parent / WORK_DIR
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        # save_best off: the emergency snapshot is the run's only one
        wf = build(snapshot_dir=tmp, snapshot_config={"save_best": False}, **cfg)
        wf.enable_emergency_snapshots()
        policy, save, save_s = wf.lr_policy, wf.snapshotter.save, []

        def stop_at(base, step):
            if step == HEAL_STOP:
                wf.request_stop()
            return policy(base, step) if policy else base

        def timed_save(*args, **kw):
            t = time.perf_counter()
            try:
                return save(*args, **kw)
            finally:
                save_s.append(time.perf_counter() - t)

        wf.lr_policy, wf.snapshotter.save = stop_at, timed_save
        wf.initialize()
        path = None
        try:
            wf.run()
        except TrainingPreempted as exc:
            path = exc.snapshot_path
        stopped_at = wf.state.step
        if path is None or not os.path.exists(path) or len(save_s) != 1:
            fail(f"self-healing: the stop wrote {len(save_s)} snapshots ({path}), want one")
        mb = os.path.getsize(path) / 1e6
        del wf
        resumed = build(**cfg)
        t = time.perf_counter()
        resumed.initialize(snapshot=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    epoch = resumed.decision.epoch
    resumed.run()
    torch.cuda.synchronize()
    differ = _differ(torch, resumed.state.params, ref.state.params)
    same_history = resumed.decision.history == ref.decision.history
    res = {"snapshot_mb": mb, "save_s": save_s[0], "resume_s": load_s, "stopped_at_step":
           stopped_at, "resumed_epoch": epoch, "final_differ": differ}
    print(f"self-healing: request_stop() at train step {HEAL_STOP} (mid epoch 1): stopped "
          f"before step {stopped_at}; emergency snapshot {mb:.1f} MB (gzip) written in "
          f"{save_s[0]:.2f} s; a fresh workflow resumed from it in {load_s:.2f} s at epoch "
          f"{epoch} and ran to the end: against the uninterrupted run {differ}, history "
          f"{'equal' if same_history else 'differs'}; {smi}")
    if stopped_at != HEAL_STOP + 1 or epoch != 1:
        fail(f"self-healing: stopped before step {stopped_at}, resumed at epoch {epoch}")
    if differ != (0, 0.0) or not same_history:
        fail(f"self-healing: the resumed run differs from the uninterrupted one: {differ}")
    return res


def _deferred_against_sync(torch, build, smi):
    """``run()`` in sync and deferred mode in turns (``DEFERRED_RUNS``),
    each a fresh workflow from one seed under ``DEFERRED_DECISION``:
    images/sec over each whole run (train and eval, the epoch ends
    included), the difference of the modes' means with its spread, and the
    epoch each stopped at, which must be the same; the first deferred run's
    params and history bitwise the first sync run's."""
    runs, finals = {"sync": [], "deferred": []}, {}
    for mode in DEFERRED_RUNS:
        wf = build(epoch_sync=mode, decision_config=DEFERRED_DECISION)
        wf.initialize()
        images = sum(wf.loader.class_lengths.values())
        torch.cuda.synchronize()
        t = time.perf_counter()
        dec = wf.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        runs[mode].append({"seconds": secs, "epochs": dec.epoch,
                           "images_per_s": dec.epoch * images / secs})
        finals.setdefault(mode, (wf.state.params, dec.history))
        del wf
    stops = {r["epochs"] for rs in runs.values() for r in rs}
    differ = _differ(torch, finals["sync"][0], finals["deferred"][0])
    rate = {m: [r["images_per_s"] for r in rs] for m, rs in runs.items()}
    diff = _spread(rate["deferred"], rate["sync"])
    pct = [100 * d / statistics.mean(rate["sync"]) for d in diff]
    print(f"self-healing: deferred against sync, run() under {DEFERRED_DECISION}: images/sec "
          f"sync {[round(v, 1) for v in rate['sync']]}, deferred "
          f"{[round(v, 1) for v in rate['deferred']]}: deferred - sync {diff[0]:+.1f} "
          f"({pct[0]:+.2f}%, spread {pct[1]:+.2f}% .. {pct[2]:+.2f}%); seconds a run "
          f"{[round(r['seconds'], 3) for r in runs['sync']]} / "
          f"{[round(r['seconds'], 3) for r in runs['deferred']]}; stopped after "
          f"{[r['epochs'] for r in runs['sync']]} / {[r['epochs'] for r in runs['deferred']]} "
          f"epochs; deferred params against sync {differ}; {smi}")
    if len(stops) != 1 or differ != (0, 0.0) or finals["sync"][1] != finals["deferred"][1]:
        fail(f"self-healing: deferred and sync runs disagree: stops {stops}, params {differ}")
    return {"runs": runs, "diff_pct": pct}


def _resume_golden(torch, label, make, smi):
    """``RESUME_EPOCHS`` uninterrupted epochs against one epoch, its
    snapshot (uncompressed), a fresh workflow resumed from it and the rest:
    the params and the history bitwise equal."""
    import tempfile
    from pathlib import Path

    from znicz_tpu_torch.workflow.snapshotter import Snapshotter

    ref = make(None)
    ref.initialize()
    for _ in range(RESUME_EPOCHS):
        ref.run_epoch()
    work = Path(__file__).resolve().parent / WORK_DIR
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        snap = Snapshotter(tmp, label, interval=1, compress=False, save_best=False)
        saver = make(snap)
        saver.initialize()
        saver.run_epoch()
        path = snap._path("epoch0")
        mb = os.path.getsize(path) / 1e6
        resumed = make(None)
        t = time.perf_counter()
        resumed.initialize(snapshot=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    for _ in range(RESUME_EPOCHS - 1):
        resumed.run_epoch()
    torch.cuda.synchronize()
    differ = _differ(torch, resumed.state.params, ref.state.params)
    same = resumed.decision.history == ref.decision.history
    print(f"self-healing: {label} resume: snapshot of epoch 0 {mb:.1f} MB, resumed in "
          f"{load_s:.2f} s at step {saver.state.step}, {RESUME_EPOCHS - 1} more epochs against "
          f"{RESUME_EPOCHS} uninterrupted: {differ} (tensors that differ, max |diff|), history "
          f"{'equal' if same else 'differs'}; {smi}")
    if differ != (0, 0.0) or not same or resumed.state.step != ref.state.step:
        fail(f"self-healing: the resumed {label} differs from its uninterrupted run: {differ}")
    return {"snapshot_mb": mb, "resume_s": load_s}


def phase_self_healing(torch, lrn_kernel, alexnet, models, prng, smi):
    """Phase 21: self-healing training.  The anomaly watch's cost on AlexNet
    (the synthetic stand-in at the published geometry, as phase 4) and on
    the SOM, the RBM and MNIST at depth 0; then, with cuDNN deterministic, a
    real poisoned batch rolled back, a graceful stop resumed, deferred
    against sync, and snapshots of the SOM, the RBM and the LM resumed."""
    import numpy as np

    from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu_torch.nn.optimizer import HyperParams
    from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow

    def build(**kw):
        prng.seed_all(1234)
        return alexnet.build_workflow(device="cuda", **kw)

    def model(name, **kw):
        def make():
            prng.seed_all(1234)
            return models[name].build_workflow(device="cuda", **kw)
        return make

    out = {"watch": {}}
    torch.backends.cudnn.benchmark = True
    out["watch"]["alexnet"] = _watch_cost(torch, build, WATCH_EPOCHS["alexnet"], "alexnet", smi)
    out["watch"]["transport_us"] = _watch_transport(torch, smi)
    for name in ("kohonen", "mnist_rbm", "mnist"):
        out["watch"][name] = _watch_cost(torch, model(name, prefetch_batches=0),
                                         WATCH_EPOCHS[name], name, smi)
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cfg = {"decision_config": {"max_epochs": HEAL_EPOCHS}}
        ref = build(**cfg)
        ref.initialize()
        ref.run()
        torch.cuda.synchronize()
        out["rollback"] = _poisoned_rollback(torch, lrn_kernel, build, ref, cfg, smi)
        out["stop"] = _graceful_stop(torch, build, ref, cfg, smi)
        del ref
        out["deferred"] = _deferred_against_sync(torch, build, smi)

        def unsup(name):
            def make(snap):
                prng.seed_all(1234)
                return models[name].build_workflow(
                    device="cuda", snapshotter=snap,
                    decision_config={"max_epochs": RESUME_EPOCHS})
            return make

        tokens = np.random.default_rng(5).integers(
            0, LM_RESUME["vocab"], (LM_RESUME_N, LM_T)).astype(np.int32)

        def lm(snap):
            prng.seed_all(1234)
            loader = FullBatchLoader({"train": tokens, "test": tokens[:LM_B]},
                                     minibatch_size=LM_B)
            # lr 0.01: the default 0.1 diverges at this width (as in JAX)
            return TransformerLMWorkflow(
                loader, **LM_RESUME, attention="flash", max_epochs=RESUME_EPOCHS,
                hyper=HyperParams(learning_rate=0.01, gradient_moment=0.9),
                snapshotter=snap, device="cuda")

        out["resume"] = {name: _resume_golden(torch, name, make, smi) for name, make in (
            ("kohonen", unsup("kohonen")), ("mnist_rbm", unsup("mnist_rbm")), ("lm", lm))}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    return out["rollback"]["launches"], out


SCAN_IMAGES = 12800  # bench.py's mnist_epoch: 100 train steps of 128
SCAN_BATCH = 128
SCAN_EPOCHS = 3  # the runs held bitwise: graph against step dispatch
SCAN_WINDOW_S = 1.0  # a timed window: whole epochs, at least this long
SCAN_TURNS = ("graph", "step", "step", "graph", "graph", "step")  # timed windows, in turns
SCAN_POOL = {"train": 1024, "valid": 128}  # AlexNet's pools: 8 train and 1 eval step
SCAN_POISON = 150  # the watch row the rollback runs poison: epoch 1's 51st train step
SCAN_LM_N = {"train": 48, "test": 16}  # 3 train steps and 1 eval step at batch 16
# each counted wrapper's one kernel a call, as the trace names it (a
# Kohonen call also launches scores_kernel and winners_kernel, an RBM call
# hidden_kernel and visible_kernel)
TRACE_NAMES = {"lrn_fwd": "lrn_fwd_kernel", "lrn_bwd": "halo_kernel|rows_kernel",
               "kohonen_accumulate": "accum_kernel", "rbm_cd": "stats_kernel",
               "flash_fwd": "fwd_mma_kernel|fwd_tf32_kernel",
               "flash_dq": "dq_mma_kernel|dq_tf32_kernel",
               "flash_dkv": "dkv_mma_kernel|dkv_tf32_kernel"}


def _mnist_u8(n, seed):
    import numpy as np

    gen = np.random.default_rng(seed)
    return (gen.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8),
            gen.integers(0, 10, n).astype(np.int32))


def _traced_launches(torch, prof, names):
    """Each of ``names``' kernel records in the trace of ``prof``: what the
    card launched, whether through a wrapper or from a graph's replay."""
    pats = {n: re.compile(r"(?:^|\s|::)(?:%s)\b" % TRACE_NAMES[n]) for n in names}
    got = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n, pat in pats.items():
                if pat.search(e.key):
                    got[n] += e.count
    return got


def _traced_epochs(torch, wf, epochs, names):
    """``epochs`` epochs of ``wf``: the first untraced (the graph
    dispatch's warm-up and captures), the rest under ``torch.profiler``
    with ``names``' kernel records counted (:func:`_traced_launches`; no
    trace when ``names`` is empty).  Returns the epochs' results, the
    first epoch's seconds and the traced counts."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    out = [wf.run_epoch()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if not names:
        out += [wf.run_epoch() for _ in range(epochs - 1)]
        return out, first_s, {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out += [wf.run_epoch() for _ in range(epochs - 1)]
        torch.cuda.synchronize()
    return out, first_s, _traced_launches(torch, prof, names)


def _scan_runs(torch, prng, make, label, counters=(), epochs=SCAN_EPOCHS, deferred=False):
    """The graph dispatch (``epoch_dispatch="scan"`` on the card) and the
    step dispatch of ``make(dispatch)``, ``epochs`` epochs each from the
    same seed (the initial weights drawn after ``prng.seed_all``), the
    histories and the final state bitwise equal.  ``counters`` (``(name,
    wrapper, launches an epoch)``) are set to 0 just before each run and
    read just after: the step dispatch's must be exact; the graph
    dispatch's hold its warm-up and capture calls only, so the launches of
    the epochs after the first are read from their trace
    (:func:`_traced_epochs`) and must be exact in both dispatches.
    Returns ``{dispatch: workflow}`` and the graph dispatch's traced
    launches."""
    names = [name for name, _, _ in counters]
    wfs, first_s, traced = {}, {}, {}
    for dispatch in ("scan", "step"):
        prng.seed_all(3)
        wf = make(dispatch)
        wf.initialize(seed=3)
        if wf._use_epoch_scan() != (dispatch == "scan"):
            fail(f"{label}: epoch_dispatch={dispatch!r} took the other dispatch")
        for _, fn, _ in counters:
            fn.launches = 0
        _, first_s[dispatch], traced[dispatch] = _traced_epochs(torch, wf, epochs, names)
        if deferred:
            wf.sync_epoch()
        torch.cuda.synchronize()
        wrapped = {name: fn.launches for name, fn, _ in counters}
        want = {name: n * (epochs - 1) for name, _, n in counters}
        print(f"{label}: {dispatch} dispatch, {epochs} epochs: wrapper counts {wrapped}; "
              f"traced launches of epochs 2-{epochs} {traced[dispatch]}, want {want}")
        if traced[dispatch] != want:
            fail(f"{label}: {dispatch} dispatch's trace shows {traced[dispatch]} launches "
                 f"in epochs 2-{epochs}, want {want}")
        if dispatch == "step" and wrapped != {name: n * epochs for name, _, n in counters}:
            fail(f"{label}: the step dispatch's wrappers counted {wrapped} launches")
        if dispatch == "scan" and any(v == 0 for v in wrapped.values()):
            fail(f"{label}: the graph dispatch's capture went through no wrapper: {wrapped}")
        wfs[dispatch] = wf
    graph, step = wfs["scan"], wfs["step"]
    if not any(r.graph is not None for r in graph._splits.values()):
        fail(f"{label}: the scan dispatch captured no CUDA graph")
    n_bad, worst = _differ(torch, graph.state.params, step.state.params)
    same_hist = graph.decision.history == step.decision.history
    print(f"{label}: graph against step dispatch after {epochs} epochs: {n_bad} tensors differ "
          f"(largest |diff| {worst:.3e}), histories {'equal' if same_hist else 'DIFFER'}; "
          f"{len(graph._splits)} captured split steps; first epoch (with the capture) "
          f"{first_s['scan']:.2f} s, step dispatch {first_s['step']:.2f} s")
    if n_bad or not same_hist:
        fail(f"{label}: the graph dispatch is not bitwise the step dispatch")
    return wfs, traced["scan"]


def _scan_turns(torch, wfs, images, label, smi):
    """Images/sec of the two dispatches over windows of whole epochs, each
    at least ``SCAN_WINDOW_S`` long, in turns (``SCAN_TURNS``), after one
    epoch each as warm-up: the ratio of the means, and its spread from
    the slowest graph window over the fastest step window to the fastest
    over the slowest."""
    for wf in wfs.values():
        wf.run_epoch()
        wf.sync_epoch()
    rates = {"graph": [], "step": []}
    for turn in SCAN_TURNS:
        wf = wfs["scan" if turn == "graph" else "step"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < SCAN_WINDOW_S:
            wf.run_epoch()
            n += 1
        wf.sync_epoch()
        torch.cuda.synchronize()
        rates[turn].append(images * n / (time.perf_counter() - t0))
    g, s = rates["graph"], rates["step"]
    ratio = statistics.mean(g) / statistics.mean(s)
    spread = (min(g) / max(s), max(g) / min(s))
    print(f"{label}: images/sec over windows of at least {SCAN_WINDOW_S} s in turns: graph "
          f"{', '.join(f'{r:.0f}' for r in g)}, step {', '.join(f'{r:.0f}' for r in s)} "
          f"(graph/step {ratio:.2f}x, {spread[0]:.2f}-{spread[1]:.2f}x over the windows); {smi}")
    return {"graph": g, "step": s, "speedup": ratio, "speedup_spread": list(spread)}


def _replay_profile(torch, wf, label, smi):
    """The captured train step of ``wf`` replayed over one split (``n``
    replays, no Python between them but the loop): the host µs to issue a
    replay, the device's µs a step between CUDA events around the split,
    then the kernels' device time a step under ``torch.profiler`` (CUPTI)
    and the device's idle share; "not measured" when the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    run = next(r for (s, _), r in wf._splits.items() if s == "train")
    n = int(run.rows["x"].shape[0])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    wf._run_split("train", run, n)
    host_us = (time.perf_counter() - t0) / n * 1e6
    end.record()
    end.synchronize()
    wall_us = start.elapsed_time(end) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wf._run_split("train", run, n)
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0) / n
    out = {"host_us_a_replay": host_us, "device_us_a_step": wall_us,
           "busy_us_a_step": busy_us or None,
           "idle_share": 1.0 - busy_us / wall_us if busy_us else None}
    idle = "not measured" if not busy_us else f"{out['idle_share']:.1%}"
    print(f"{label}: {n} replays of the captured train step: {host_us:.1f} µs of host time "
          f"to issue one, {wall_us:.1f} µs of device time a step (CUDA events), kernels busy "
          f"{busy_us:.1f} µs a step (profiler), idle {idle}; {smi}")
    return out


def _alexnet_resident(alexnet, loader, dispatch, n_classes, compute_dtype=None, **kw):
    import copy

    from znicz_tpu_torch.workflow.standard import StandardWorkflow

    layers = copy.deepcopy(alexnet.DEFAULTS["layers"])
    layers[-1]["->"]["output_sample_shape"] = n_classes
    return StandardWorkflow(
        loader, layers, decision_config={"max_epochs": 10000},
        lr_policy=alexnet.DEFAULTS["lr_policy"],
        compute_dtype=compute_dtype or alexnet.DEFAULTS["compute_dtype"],
        epoch_dispatch=dispatch, device="cuda", name=f"AlexNetResident-{dispatch}", **kw)


def _pool_crops_against_host(torch, imagenet_lib, native_lib, wf, label, smi):
    """One epoch of the resident ImageNet loader's payloads: the crops cut on
    the card from the workflow's pool against ``crop_gather_u8`` on the host
    from the packed files, bitwise; then the crop of one train batch timed
    on the card (CUDA events) beside its bound (each crop's bytes read once
    from the pool and written once)."""
    import numpy as np

    ld = wf.loader
    pool = wf._ctx["pool"]
    n, flips, train = 0, 0, None
    for split, mb in ld.epoch():
        p = mb.data
        rows = p[:, 0].astype(np.int64) - ld._pool_offsets[split]
        host = native_lib.crop_gather_u8(ld.images[split], rows, p[:, 1], p[:, 2], p[:, 3],
                                         ld.crop_size, ld.crop_size)
        card = imagenet_lib.crop_from_pool(pool, torch.as_tensor(p, device="cuda"),
                                           ld.crop_size).cpu().numpy()
        if not np.array_equal(card, host):
            fail(f"{label}: the card's crops of a {split} batch differ from the host's")
        n += len(p)
        flips += int(p[:, 3].sum())
        if split == "train":
            train = p
    print(f"{label}: {n} crops cut on the card from the resident pool equal the host's "
          f"native crops bitwise ({flips} flipped)")
    payload = torch.as_tensor(train, device="cuda")
    ms = cuda_ms(lambda: imagenet_lib.crop_from_pool(pool, payload, ld.crop_size))
    nbytes = 2 * len(train) * ld.crop_size * ld.crop_size * pool.shape[-1]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{label}: crop_from_pool of a batch of {len(train)} ({ld.crop_size}^2, u8) on the card "
          f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), bound {bound:.4f} ms (bytes); {smi}")
    return {"crop_ms": ms, "crop_bound_ms": bound}


def _scan_lm(torch, prng, label, **moe):
    """The mid LM's width at 2 layers (``moe``: its MoE keywords) from a
    resident pool, through the graph dispatch and the step dispatch, 2
    epochs each from one seed: the flash launches of epoch 2 read from its
    trace (exact in both; the step dispatch's wrappers count both epochs),
    every loss finite, and the per-epoch losses within 1e-4 relative of
    each other (the embedding's backward, and the capacity dispatch's
    combine, add with atomics: the dispatches agree to a float32 sum's
    order, not bitwise).  Returns ``{dispatch: (workflow, history)}`` and
    the graph dispatch's traced launches."""
    import numpy as np

    from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu_torch.nn.optimizer import HyperParams
    from znicz_tpu_torch.ops.kernels import attention as fa
    from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow

    tokens = np.random.default_rng(7).integers(0, LM_RESUME["vocab"],
                                              (sum(SCAN_LM_N.values()), LM_T))
    split_tok = {"train": tokens[:SCAN_LM_N["train"]], "test": tokens[SCAN_LM_N["train"]:]}
    n_tr, n_ev = SCAN_LM_N["train"] // LM_B, SCAN_LM_N["test"] // LM_B
    depth = LM_RESUME["n_layers"]
    lm_counters = [("flash_fwd", fa.flash_fwd, depth * (n_tr + n_ev)),
                   ("flash_dq", fa.flash_dq, depth * n_tr),
                   ("flash_dkv", fa.flash_dkv, depth * n_tr)]
    lm_wfs, scan_traced = {}, {}
    for dispatch in ("scan", "step"):
        ld = FullBatchLoader(split_tok, minibatch_size=LM_B, device_resident=True)
        prng.seed_all(3)
        wf = TransformerLMWorkflow(ld, **dict(LM_RESUME, **moe), attention="flash",
                                   max_epochs=10000,
                                   hyper=HyperParams(learning_rate=0.001, gradient_moment=0.9),
                                   epoch_dispatch=dispatch, device="cuda")
        wf.initialize(seed=3)
        for _, fn, _ in lm_counters:
            fn.launches = 0
        out, _, traced = _traced_epochs(torch, wf, 2, [name for name, _, _ in lm_counters])
        hist = [r["summary"] for r in out]
        torch.cuda.synchronize()
        wrapped = {name: fn.launches for name, fn, _ in lm_counters}
        want = {name: n for name, _, n in lm_counters}
        print(f"{label}: {dispatch} dispatch, 2 epochs: wrapper counts {wrapped}; traced "
              f"launches of epoch 2 {traced}, want {want}; " + json.dumps(hist))
        if (traced != want or (dispatch == "step" and wrapped != {n: 2 * v for n, v in want.items()})
                or not all(math.isfinite(m["loss"]) for e in hist for m in e.values())):
            fail(f"{label}: {dispatch} dispatch launched {traced} in epoch 2 (want {want}; "
                 f"wrapper counts {wrapped}) or lost finiteness")
        if dispatch == "scan":
            if not any(r.graph is not None for r in wf._splits.values()):
                fail(f"{label}: the scan dispatch captured no CUDA graph")
            scan_traced = traced
        lm_wfs[dispatch] = (wf, hist)
    rel = max(abs(a[s]["loss"] - b[s]["loss"]) / abs(b[s]["loss"])
              for a, b in zip(lm_wfs["scan"][1], lm_wfs["step"][1]) for s in a)
    print(f"{label}: graph against step dispatch, per-epoch loss rel diff {rel:.2e} (limit 1e-4)")
    if not rel <= 1e-4:
        fail(f"{label}: the graph dispatch's losses differ from the step dispatch's")
    return lm_wfs, scan_traced


def phase_scan(torch, models, libs, prng, thread_rate, smi):
    """Phase 22: the device-resident pool and the scan dispatch as CUDA
    graph replays (see the module docstring)."""
    import numpy as np

    from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu_torch.ops.kernels import kohonen as khk, lrn as lrn_kernel
    from znicz_tpu_torch.ops.kernels import rbm as rbk
    from znicz_tpu_torch.utils import faults
    from znicz_tpu_torch.workflow.recovery import RecoveryPolicy
    from znicz_tpu_torch.workflow.standard import StandardWorkflow
    from znicz_tpu_torch.workflow.unsupervised import KohonenWorkflow, RBMWorkflow

    alexnet, imagenet_lib, native_lib = models["alexnet"], libs["imagenet"], libs["native"]
    res = {}
    launches = dict.fromkeys(TRACE_NAMES, 0)  # the graph dispatch's, from its traces
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    _f32_exact(torch)
    imgs, labels = _mnist_u8(SCAN_IMAGES, 1)
    n_steps = SCAN_IMAGES // SCAN_BATCH

    # MNIST at bench.py's mnist_epoch shape
    def mnist(dispatch, **kw):
        ld = FullBatchLoader({"train": imgs}, {"train": labels}, minibatch_size=SCAN_BATCH,
                             normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5},
                             device_resident=True)
        return StandardWorkflow(
            ld, [{"type": "all2all_tanh", "->": {"output_sample_shape": 256}},
                 {"type": "softmax", "->": {"output_sample_shape": 10}}],
            decision_config={"max_epochs": 10000},
            default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
            epoch_dispatch=dispatch, device="cuda", name=f"MnistResident-{dispatch}", **kw)

    wfs, _ = _scan_runs(torch, prng, mnist, "scan mnist")
    res["mnist"] = _scan_turns(torch, wfs, SCAN_IMAGES, "scan mnist", smi)
    res["mnist"]["replay"] = _replay_profile(torch, wfs["scan"], "scan mnist", smi)
    del wfs

    # the rollback under the graph dispatch: a NaN in one drained watch row
    pol_kw = dict(max_rollbacks=2, perturb=False, lr_backoff=1.0)
    runs = {}
    for key, dispatch, fault in (("golden", "scan", False), ("graph", "scan", True),
                                 ("step", "step", True)):
        pol = RecoveryPolicy(**pol_kw)
        prng.seed_all(3)
        wf = mnist(dispatch, recovery=pol)
        wf.initialize(seed=3)
        if fault:
            faults.inject("train.step_nan", flag=True, times=1, after=SCAN_POISON)
        try:
            while wf.decision.epoch < SCAN_EPOCHS:
                wf.run_epoch()
        finally:
            faults.clear()
        torch.cuda.synchronize()
        runs[key] = (wf, pol)
    (g, gp), (s, sp), (ref, _) = runs["graph"], runs["step"], runs["golden"]
    diffs = {k: _differ(torch, w.state.params, ref.state.params)
             for k, w in (("graph", g), ("step", s))}
    events = {k: [(e["kind"], e["reason"], e["step"]) for e in p.events]
              for k, p in (("graph", gp), ("step", sp))}
    print(f"scan rollback: NaN in the watch row of step {SCAN_POISON}: graph events "
          f"{events['graph']}, step events {events['step']}; against the unfaulted graph run "
          f"after {SCAN_EPOCHS} epochs (tensors differing, largest |diff|): {diffs}")
    if (gp.rollbacks_used != 1 or sp.rollbacks_used != 1 or any(n for n, _ in diffs.values())
            or g.decision.history != ref.decision.history
            or s.decision.history != ref.decision.history):
        fail("scan rollback: the graph dispatch's rollback is not bitwise the step dispatch's")
    res["rollback"] = {"events_graph": events["graph"], "events_step": events["step"]}
    del runs, g, s, ref

    # the SOM and the RBM, resident and deferred
    def som(dispatch):
        ld = FullBatchLoader({"train": imgs}, minibatch_size=SCAN_BATCH, normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5},
                             device_resident=True)
        return KohonenWorkflow(ld, sx=8, sy=8, total_epochs=10000, epoch_sync="deferred",
                               epoch_dispatch=dispatch, device="cuda")

    def rbm(dispatch):
        ld = FullBatchLoader({"train": imgs}, minibatch_size=SCAN_BATCH, normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": 0.0},
                             device_resident=True)
        return RBMWorkflow(ld, n_hidden=128, learning_rate=0.1, cd_k=1, max_epochs=10000,
                           epoch_sync="deferred", epoch_dispatch=dispatch, device="cuda")

    for name, make, kname, fn in (("kohonen", som, "kohonen_accumulate", khk.accumulate),
                                  ("mnist_rbm", rbm, "rbm_cd", rbk.statistics)):
        wfs, traced = _scan_runs(torch, prng, make, f"scan {name}", [(kname, fn, n_steps)],
                                 deferred=True)
        launches[kname] += traced[kname]
        res[name] = _scan_turns(torch, wfs, SCAN_IMAGES, f"scan {name}", smi)
        res[name]["replay"] = _replay_profile(torch, wfs["scan"], f"scan {name}", smi)
        del wfs

    # AlexNet at full width from a resident FullBatch pool and from the
    # packed ImageNet files' resident pool
    lrn_counters = [("lrn_fwd", lrn_kernel.lrn_forward, 2 * (8 + 1)),
                    ("lrn_bwd", lrn_kernel.lrn_backward, 2 * 8)]
    gen = np.random.default_rng(0)
    data = {s: gen.integers(0, 256, (n, 227, 227, 3), dtype=np.uint8)
            for s, n in SCAN_POOL.items()}
    lab = {s: gen.integers(0, 1000, n).astype(np.int32) for s, n in SCAN_POOL.items()}

    def alex_fb(dispatch):
        ld = FullBatchLoader(data, lab, minibatch_size=128, normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5},
                             device_resident=True)
        return _alexnet_resident(alexnet, ld, dispatch, 1000)

    wfs, traced = _scan_runs(torch, prng, alex_fb, "scan alexnet", lrn_counters, epochs=2)
    for name in traced:
        launches[name] += traced[name]
    res["alexnet"] = _scan_turns(torch, wfs, SCAN_POOL["train"], "scan alexnet", smi)
    res["alexnet"]["replay"] = _replay_profile(torch, wfs["scan"], "scan alexnet", smi)
    del wfs, data
    pack = os.path.join(WORK_DIR, "imagenet_resident")
    os.makedirs(pack, exist_ok=True)
    for s, n in SCAN_POOL.items():
        np.save(os.path.join(pack, f"{s}_images.npy"),
                gen.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8))
        np.save(os.path.join(pack, f"{s}_labels.npy"), gen.integers(0, 1000, n).astype(np.int32))
    with open(os.path.join(pack, "mean_rgb.json"), "w") as f:
        json.dump([0.485, 0.456, 0.406], f)

    def alex_im(dispatch):
        ld = imagenet_lib.ImageNetLoader(pack, crop_size=227, minibatch_size=128,
                                         device_resident=True)
        return _alexnet_resident(alexnet, ld, dispatch, 1000)

    wfs, traced = _scan_runs(torch, prng, alex_im, "scan imagenet", lrn_counters, epochs=2)
    for name in traced:
        launches[name] += traced[name]
    crop = _pool_crops_against_host(torch, imagenet_lib, native_lib, wfs["scan"],
                                    "scan imagenet", smi)
    res["imagenet"] = _scan_turns(torch, wfs, SCAN_POOL["train"], "scan imagenet", smi)
    res["imagenet"]["crop"] = crop
    print(f"scan imagenet: graph {statistics.mean(res['imagenet']['graph']):.1f} images/sec "
          f"from the resident packed pool, beside phase 20's prefetch thread "
          f"{', '.join(f'{r:.1f}' for r in thread_rate)} images/sec from the same geometry's "
          f"packed files; {smi}")
    del wfs
    torch.cuda.empty_cache()

    # the mid LM's width at 2 layers through the graph with flash
    lm_wfs, traced = _scan_lm(torch, prng, "scan lm")
    for name in traced:
        launches[name] += traced[name]
    res["lm"] = _scan_turns(torch, {k: w for k, (w, _) in lm_wfs.items()}, SCAN_LM_N["train"],
                            "scan lm", smi)
    del lm_wfs
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return launches, res


# -- the mixture of experts and KV-cache decoding ------------------------------

LM_MOE = dict(LM_MID, d_ff=1024)  # bench.py's LM_MOE: 8 experts of d_ff 1024, top-k 2
MOE = dict(moe_experts=8, moe_top_k=2)
MOE_DISPATCHES = ("dense", "capacity")
MOE_STEPS = 5  # 2 warm-up and 3 timed train steps
MOE_CHECK_T = 512  # the card-vs-CPU forward: one sequence, 2 layers
DECODE_PROMPT, DECODE_NEW = 64, 256  # bench.py's lm_decode: the mid LM, greedy, batch 16
SERVE_LENS = (16, 40, 64, 120)  # bench.py's LM_SERVE_LENS: buckets 16 / 64 / 64 / 128
SERVE_NEW = 64  # bench.py's LM_SERVE_NEW
SERVE_ROUNDS = 2  # passes over SERVE_LENS


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def phase_moe(torch, fa, transformer, model_lib, prng, loader, dense_rate, smi):
    """Phase 23: the MoE LM at the mid width, dense and capacity dispatch:
    one epoch with the flash counters set to 0 just before and read just
    after, timed train steps, then one 512-token forward at 2 layers on the
    card against the CPU from the same weights.  Returns the epochs'
    launches and the numbers."""
    from znicz_tpu_torch.nn.optimizer import HyperParams

    layers = LM_MOE["n_layers"]
    n_train, n_eval = loader.n_minibatches("train"), loader.n_minibatches("test")
    want = {"flash_fwd": layers * (n_train + n_eval), "flash_dq": layers * n_train,
            "flash_dkv": layers * n_train}
    launches, res = {}, {}
    for dispatch in MOE_DISPATCHES:
        label = f"moe {dispatch}"
        prng.seed_all(1234)
        t0 = time.perf_counter()
        # lr 0.001: the default 0.1 diverges at this depth (phase 8)
        wf = transformer.TransformerLMWorkflow(
            loader, **LM_MOE, **MOE, moe_dispatch=dispatch, attention="flash",
            hyper=HyperParams(learning_rate=0.001, gradient_moment=0.9), device="cuda")
        wf.initialize()
        torch.cuda.synchronize()
        n_params = sum(w.numel() for layer in wf.state.params for w in layer.values())
        print(f"{label}: built ({n_params} parameters on the card) in "
              f"{time.perf_counter() - t0:.1f} s")
        # the main path: counts set to 0 just before, read just after
        for name in FLASH:
            getattr(fa, name).launches = 0
        t0 = time.perf_counter()
        summary = wf.run_epoch()["summary"]
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        got = {name: getattr(fa, name).launches for name in FLASH}
        print(f"{label}: epoch 1 {epoch_s:.2f} s: {json.dumps(summary)}; launches {got}, "
              f"want {want}")
        if got != want:
            fail(f"{label}: flash launch counts {got} != {want}")
        for split, n in (("train", n_train), ("test", n_eval)):
            m = summary.get(split)
            if m is None or m["n_samples"] != n * LM_B or not all(
                    math.isfinite(float(v)) for v in m.values()):
                fail(f"{label}: {split} metrics {m}")
        step_ms, rate, _ = _timed_steps(torch, fa, wf, f"MoE {dispatch} dispatch",
                                        steps=MOE_STEPS)
        launches[dispatch] = got
        res[dispatch] = {"epoch_s": epoch_s, "step_ms": step_ms, "tokens_per_s": rate,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del wf
        torch.cuda.empty_cache()
    print(f"moe: train tokens/sec at the mid width (E 8, top-k 2, d_ff 1024, f32 attention): "
          f"dense {res['dense']['tokens_per_s']:.1f}, capacity "
          f"{res['capacity']['tokens_per_s']:.1f}, beside phase 8's dense-FFN mid LM "
          f"{dense_rate:.1f}; {smi}")

    # card vs CPU: one 512-token sequence at 2 layers, f32, TF32 off
    _f32_exact(torch)
    prng.seed_all(99)
    host = model_lib.params_to_numpy(transformer.init_lm_params(
        LM_MOE["vocab"], LM_MOE["d_model"], 2, LM_MOE["n_heads"], MOE_CHECK_T,
        d_ff=LM_MOE["d_ff"], moe_experts=MOE["moe_experts"], device="cpu"))
    tokens = torch.as_tensor(loader.data["test"][:1, :MOE_CHECK_T]).long()
    for dispatch in MOE_DISPATCHES:
        kw = dict(n_heads=LM_MOE["n_heads"], attention_fn=fa.flash_attention,
                  moe_top_k=MOE["moe_top_k"], moe_dispatch=dispatch)
        with torch.no_grad():
            lg_card = transformer.lm_apply(
                model_lib.params_from_jax(host, "cuda"), tokens.cuda(), **kw).cpu()
            lg_cpu = transformer.lm_apply(model_lib.params_from_jax(host, "cpu"), tokens, **kw)
        rel = _rel(lg_card, lg_cpu)
        print(f"moe {dispatch}: {MOE_CHECK_T}-token f32 forward at 2 layers, card (kernels) vs "
              f"CPU (plain): max |diff| / max |logit| = {rel:.3e} (limit 1e-4)")
        if not (rel < 1e-4 and bool(torch.isfinite(lg_cpu).all())):
            fail(f"moe {dispatch}: card and CPU forwards disagree")
        res[dispatch]["card_vs_cpu_rel"] = rel
    return launches, res


def phase_moe_graph(torch, prng):
    """Phase 24: the MoE LM at the mid width and 2 layers through the graph
    dispatch and the step dispatch (:func:`_scan_lm`), dense and capacity.
    Returns the graph dispatch's traced launches."""
    torch.backends.cudnn.deterministic = True
    launches = {}
    for dispatch in MOE_DISPATCHES:
        wfs, launches[dispatch] = _scan_lm(torch, prng, f"moe graph {dispatch}",
                                           d_ff=LM_MOE["d_ff"], moe_dispatch=dispatch, **MOE)
        del wfs
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return launches


def _decode_eager(G, params, prompt, n_new, **moe):
    """The eager step loop (no graph) of ``generate``'s greedy program."""
    return G._generate_impl(
        params, prompt, None, n_new, 0.0, 1.0, None, n_heads=LM_MID["n_heads"],
        max_new_tokens=n_new, greedy=True, top_k=0, nucleus=False, eos_id=None,
        moe_top_k=moe.get("moe_top_k", 1), moe_dispatch=moe.get("moe_dispatch", "dense"),
        graph=False)


def _wall(torch, fn, reps):
    """The fastest of ``reps`` synchronised calls of ``fn``: (seconds, its
    result)."""
    best, out = math.inf, None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def phase_decode(torch, transformer, prng, loader, smi):
    """Phase 25: greedy KV-cache decoding at the mid LM's width and depth
    (prompt 64, 256 new tokens, batch 16): ``generate`` (its decode step
    captured into a CUDA graph and replayed a position), the served program
    replayed again, and the eager step loop, their tokens equal; every
    decode step's logits against ``lm_apply``'s at the same position; then
    the MoE LM at 2 layers, dense and capacity.  Returns the numbers and
    the mid LM's params (for phase 26)."""
    from znicz_tpu_torch.workflow import generate as G

    _f32_exact(torch)
    heads, b = LM_MID["n_heads"], LM_B
    t_max = DECODE_PROMPT + DECODE_NEW
    prng.seed_all(97)
    params = transformer.init_lm_params(LM_MID["vocab"], LM_MID["d_model"], LM_MID["n_layers"],
                                        heads, t_max, device="cuda")
    prompt = torch.as_tensor(loader.data["train"][:b, :DECODE_PROMPT], device="cuda").long()
    kw = dict(n_heads=heads, max_new_tokens=DECODE_NEW)
    new = b * DECODE_NEW
    first_s, out = _wall(torch, lambda: G.generate(params, prompt, **kw), 1)
    G.reset_serve_cache()
    capture_s, served = _wall(torch, lambda: G.generate_serve(params, prompt, **kw), 1)
    graph_s, served = _wall(torch, lambda: G.generate_serve(params, prompt, **kw), 3)
    eager_s, eager = _wall(torch, lambda: _decode_eager(G, params, prompt, DECODE_NEW), 2)
    res = {"generate_first_s": first_s, "serve_first_s": capture_s,
           "graph_tokens_per_s": new / graph_s, "eager_tokens_per_s": new / eager_s}
    print(f"decode: mid LM, greedy, prompt {DECODE_PROMPT}, {DECODE_NEW} new tokens, batch {b}: "
          f"replayed graph {res['graph_tokens_per_s']:.1f} generated tokens/sec "
          f"({graph_s * 1e3:.1f} ms a request, {graph_s / DECODE_NEW * 1e6:.1f} µs a step), "
          f"eager step loop {res['eager_tokens_per_s']:.1f} ({eager_s * 1e3:.1f} ms); "
          f"generate() with its capture {first_s:.2f} s, the served program's first request "
          f"{capture_s:.2f} s; {smi}")
    if not (torch.equal(out, served) and torch.equal(out, eager)):
        fail("decode: the graph, served and eager tokens differ")
    # every decode step's logits against lm_apply's at the same position
    toks = out.long()
    with torch.no_grad():
        caches = G.init_kv_cache(params, b, t_max, n_heads=heads)
        caches, lg = G.prefill(params, toks[:, :DECODE_PROMPT], caches, n_heads=heads)
        steps = [lg]
        for p in range(DECODE_PROMPT, t_max - 1):
            caches, lg = G.decode_step(params, caches, toks[:, p], p, n_heads=heads)
            steps.append(lg)
        dec = torch.stack(steps, 1)
        full = transformer.lm_apply(params, toks[:, :-1], n_heads=heads)[:, DECODE_PROMPT - 1:]
    rel = _rel(dec, full)
    same = bool(torch.equal(dec.argmax(-1), toks[:, DECODE_PROMPT:]))
    print(f"decode: {DECODE_NEW} teacher-forced decode steps against lm_apply on the card: "
          f"max |diff| / max |logit| = {rel:.3e} (limit 1e-4); the tokens are the steps' "
          f"argmax: {same}")
    if not (rel < 1e-4 and same):
        fail("decode: the decode steps' logits disagree with lm_apply's")
    res["logits_rel"] = rel
    del caches, dec, full, steps
    # the MoE LM at 2 layers, dense and capacity
    for dispatch in MOE_DISPATCHES:
        prng.seed_all(98)
        mp = transformer.init_lm_params(LM_MOE["vocab"], LM_MOE["d_model"], 2, heads, t_max,
                                        d_ff=LM_MOE["d_ff"], moe_experts=MOE["moe_experts"],
                                        device="cuda")
        moe = dict(moe_top_k=MOE["moe_top_k"], moe_dispatch=dispatch)
        g_first, g_out = _wall(torch, lambda: G.generate(mp, prompt, **kw, **moe), 1)
        G.generate_serve(mp, prompt, **kw, **moe)
        g_s, s_out = _wall(torch, lambda: G.generate_serve(mp, prompt, **kw, **moe), 2)
        e_s, e_out = _wall(torch, lambda: _decode_eager(G, mp, prompt, DECODE_NEW, **moe), 1)
        print(f"decode moe {dispatch} (2 layers): replayed graph {new / g_s:.1f} generated "
              f"tokens/sec, eager step loop {new / e_s:.1f}; generate() with its capture "
              f"{g_first:.2f} s; {smi}")
        if not (torch.equal(g_out, e_out) and torch.equal(g_out, s_out)):
            fail(f"decode moe {dispatch}: the graph, served and eager tokens differ")
        res[f"moe_{dispatch}"] = {"graph_tokens_per_s": new / g_s,
                                  "eager_tokens_per_s": new / e_s}
        del mp
    G.reset_serve_cache()
    torch.cuda.empty_cache()
    return res, params


def phase_serve(torch, params, smi):
    """Phase 26: a ``generate_serve`` request stream at the mid LM
    (``bench.py``'s prompt lengths and budget, batch 16 a request): one
    program a prompt bucket, the rest hits, each request's tokens equal to
    ``generate``'s."""
    import numpy as np

    from znicz_tpu_torch.observability import device as ledger
    from znicz_tpu_torch.workflow import generate as G

    heads = LM_MID["n_heads"]
    G.reset_serve_cache()
    n_ledger = ledger.program_count("serve_cache")
    reqs = np.random.default_rng(12)
    walls, checked = [], {}
    for j in range(SERVE_ROUNDS * len(SERVE_LENS)):
        length = SERVE_LENS[j % len(SERVE_LENS)]
        prompt = torch.as_tensor(reqs.integers(1, LM_MID["vocab"], (LM_B, length)),
                                 device="cuda")
        wall, out = _wall(torch, lambda: G.generate_serve(params, prompt, n_heads=heads,
                                                          max_new_tokens=SERVE_NEW), 1)
        walls.append(wall)
        if length not in checked:
            ref = G.generate(params, prompt, n_heads=heads, max_new_tokens=SERVE_NEW)
            checked[length] = bool(torch.equal(out, ref))
    st = G.serve_cache_stats()
    made = ledger.programs("serve_cache")[n_ledger:]
    n_req = len(walls)
    tokens = LM_B * SERVE_NEW
    res = {"requests": st["requests"], "hits": st["hits"], "compiles": st["compiles"],
           "programs": st["programs"], "capture_s": [e["compile_s"] for e in made],
           "tokens_per_s": n_req * tokens / sum(walls),
           "hit_tokens_per_s": (n_req - len(SERVE_LENS)) * tokens / sum(walls[len(SERVE_LENS):]),
           "keys": st["keys"]}
    print(f"serve: {n_req} requests of prompt lengths {SERVE_LENS} (batch {LM_B}, "
          f"{SERVE_NEW} new tokens): {st['programs']} programs ({st['keys']}), "
          f"{st['compiles']} compiles, {st['hits']} hits; capture seconds "
          f"{[round(v, 3) for v in res['capture_s']]}; {res['tokens_per_s']:.1f} generated "
          f"tokens/sec over the stream, {res['hit_tokens_per_s']:.1f} over its second pass; "
          f"tokens equal generate()'s: {checked}; {smi}")
    if (st["programs"], st["compiles"], len(made)) != (3, 3, 3) or st["hits"] != n_req - 3:
        fail(f"serve: want one program a prompt bucket (3), the rest hits; got {st}")
    if not all(checked.values()):
        fail(f"serve: generate_serve's tokens differ from generate()'s: {checked}")
    G.reset_serve_cache()
    torch.cuda.empty_cache()
    return res


# -- the serving engine --------------------------------------------------------

ENGINE = dict(n_heads=LM_MID["n_heads"], eos_id=0, admit_every=8, max_seq=256)  # bench.py
ENGINE_B = 16  # bench.py's LM_MID_B: the engine's slots
ENGINE_T = 384  # the prefix stream's t_max and position table (bench.py)
SERVE_BLOCK = 32  # bench.py's LM_SERVE_PAGED_BLOCK
PREFIX_SYS = 160  # bench.py's LM_PREFIX_SYS: 5 full blocks of 32
SPEC_STREAM = (  # bench.py's LM_SPEC_STREAM: (motif, prompt length)
    ((2765, 2796, 6653, 2317), 120), ((3347, 4349, 4741), 120), ((4069, 5480, 3836), 120),
    ((123, 1175, 3860), 16), ((1359, 63), 40), ((1805, 2090, 1511, 2733), 16),
    ((4069, 5480, 3836), 64), ((2765, 2796, 6653, 2317), 64),
)
SPEC_B, SPEC_K = 8, 7  # bench.py's LM_SPEC_B and LM_SPEC_K
ENGINE_CHECK_LENS, ENGINE_CHECK_NEW, ENGINE_CHECK_B = (16, 40, 64, 120, 21, 33), 16, 4
REPLAY_REPS = 30


def _pct(values, q):
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def _served(eng, prompts, budget):
    """Submit ``prompts`` and drain the engine: (request ids, wall seconds)."""
    t0 = time.perf_counter()
    ids = [eng.submit(p, budget) for p in prompts]
    eng.run()
    return ids, time.perf_counter() - t0


def _stream_numbers(eng, ids, wall):
    comps = [eng.completions[i] for i in ids]
    ttft = [c.ttft_s * 1e3 for c in comps]
    lat = [c.latency_s * 1e3 for c in comps]
    return {"requests": len(comps), "tokens": sum(c.n_new for c in comps), "wall_s": wall,
            "tokens_per_s": sum(c.n_new for c in comps) / wall,
            "ttft_ms": {"mean": statistics.fmean(ttft), "p50": _pct(ttft, 0.5),
                        "p99": _pct(ttft, 0.99)},
            "latency_ms": {"p50": _pct(lat, 0.5), "p99": _pct(lat, 0.99)}}


def _trim(row, n_prompt, eos):
    new = row[n_prompt:]
    hit = [j for j, t in enumerate(new) if t == eos]
    return list(row[:n_prompt]) + list(new[: hit[0] + 1] if hit else new)


def _tie_gap(torch, transformer, params, tokens, j, **moe):
    """The top-2 gap of the logits that predict token ``j`` after
    ``tokens[:j]``, over the largest logit's magnitude."""
    with torch.no_grad():
        lg = transformer.lm_apply(params, torch.as_tensor([list(tokens[:j])]).to(
            params[0]["embed"].device), n_heads=LM_MID["n_heads"], **moe)[0, -1].double()
    top = lg.topk(2).values
    return float((top[0] - top[1]) / lg.abs().max())


def _first_diff(a, b):
    n = min(len(a), len(b))
    return next((j for j in range(n) if a[j] != b[j]), n)


def _held_to(torch, transformer, params, label, got, want, **moe):
    """Token lists ``got`` against ``want``, each pair equal or first
    differing at a near-tie (of ``params``' logits there); returns the
    count equal and the near-ties as (index, position, gap)."""
    equal, ties = 0, []
    for i, (g, w) in enumerate(zip(got, want)):
        if list(g) == list(w):
            equal += 1
            continue
        j = _first_diff(list(g), list(w))
        ties.append((i, j, _tie_gap(torch, transformer, params, g, j, **moe)))
    if any(gap > NEAR_TIE for _, _, gap in ties):
        fail(f"{label}: tokens differ beyond near-ties (index, position, top-2 gap / max "
             f"|logit|): {ties}")
    return equal, ties


def _against_generate(torch, G, transformer, params, label, eng, ids, prompts, budget):
    """Each request's tokens against ``generate``'s on the card, the
    prompts grouped by length, trimmed at EOS."""
    import numpy as np

    groups = {}
    for rid, p in zip(ids, prompts):
        groups.setdefault(len(p), []).append((rid, p))
    got, want = [], []
    for members in groups.values():
        batch = torch.as_tensor(np.stack([p for _, p in members]), device="cuda")
        ref = G.generate(params, batch, n_heads=LM_MID["n_heads"], max_new_tokens=budget,
                         eos_id=0).cpu().tolist()
        for (rid, p), row in zip(members, ref):
            got.append(eng.completions[rid].tokens.tolist())
            want.append(_trim(row, len(p), 0))
    equal, ties = _held_to(torch, transformer, params, label, got, want)
    print(f"{label}: {equal} of {len(got)} requests' tokens equal generate()'s on the card "
          f"(prompts grouped by length, trimmed at EOS); near-ties {ties}")
    return equal


def _programs_check(label, eng, allowed, must):
    progs = set(eng.compile_stats()["programs"])
    if not must <= progs or not progs <= allowed:
        fail(f"{label}: programs {sorted(progs)}; want every one of {sorted(must)} within "
             f"{sorted(allowed)}")
    st = eng.compile_stats()
    graphs = sum(v for k, v in st.items() if k.endswith("_graph_entries"))
    if graphs != len(progs) or set(eng.capture_s) != progs:
        fail(f"{label}: {graphs} graphs and {len(eng.capture_s)} captures for {len(progs)} "
             f"programs: {st}")
    return sorted(str(k) for k in progs)


def _replay_costs(torch, eng, key):
    """Host µs to issue one replay of ``key``'s graph, its device µs (CUDA
    events) and the µs of a whole program call (inputs staged, replay, the
    one host read), medians of REPLAY_REPS on the idle engine (a replay
    recomputes the last chunk in place)."""
    prog = eng._progs[key]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host, dev, call = [], [], []
    inp = prog.io["inp"].cpu().numpy()
    for _ in range(REPLAY_REPS):
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        prog.graph.replay()
        host.append((time.perf_counter() - t0) * 1e6)
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) * 1e3)
        t0 = time.perf_counter()
        eng._call(key, None, inp)
        prog.read()
        call.append((time.perf_counter() - t0) * 1e6)
    return {"host_us": statistics.median(host), "device_us": statistics.median(dev),
            "call_us": statistics.median(call)}


def _print_replay(label, res, smi):
    r = res["chunk_replay"]
    print(f"{label}: a chunk's graph (8 steps) issued in {r['host_us']:.1f} µs of host time "
          f"against {r['device_us']:.1f} µs of device time; a whole program call (inputs "
          f"staged, replay, the one host read) {r['call_us']:.1f} µs; capture seconds of the "
          f"timed engine {res['capture_s']:.3f}; {smi}")


def _timed_twice(torch, G, transformer, params, label, make, prompts, budget, smi, check=True,
                 between=None):
    """bench.py's protocol (one stream warms a first engine, a fresh one is
    timed) and the fresh engine's second pass over the same prompts (after
    ``between(engine)``): the first pass captures this engine's graphs, the
    second captures nothing and gives the same tokens."""
    _served(make(), prompts[: len(SERVE_LENS)], budget)
    eng = make()
    ids, wall = _served(eng, prompts, budget)
    first = _stream_numbers(eng, ids, wall)
    captured = dict(eng.capture_s)
    if between is not None:
        between(eng)
    ids2, wall2 = _served(eng, prompts, budget)
    second = _stream_numbers(eng, ids2, wall2)
    if eng.capture_s != captured or any(
            p.graph is None for p in eng._progs.values()):
        fail(f"{label}: the second stream captured graphs: {sorted(eng.capture_s)}")
    if any(eng.completions[a].tokens.tolist() != eng.completions[b].tokens.tolist()
           for a, b in zip(ids, ids2)):
        fail(f"{label}: the second stream's tokens differ from the first's")
    if check:
        first["equal_generate"] = _against_generate(torch, G, transformer, params, label, eng,
                                                    ids, prompts, budget)
    capture_s = sum(captured.values())
    st = eng.stats()
    occ = st["tick_occupancy"]
    res = {"fresh": first, "warm": second, "capture_s": capture_s,
           "peak_active": st["peak_active"], "n_programs": st["n_programs"],
           "tick_occupancy": occ}
    print(f"{label}: {len(prompts)} requests, {second['tokens']} tokens: warm "
          f"{second['tokens_per_s']:.1f} generated tokens/sec (TTFT mean "
          f"{second['ttft_ms']['mean']:.1f} ms, p50 {second['ttft_ms']['p50']:.1f}, p99 "
          f"{second['ttft_ms']['p99']:.1f}; latency p50 {second['latency_ms']['p50']:.1f} ms, "
          f"p99 {second['latency_ms']['p99']:.1f}); the fresh engine's first pass "
          f"{first['tokens_per_s']:.1f} with its {len(captured)} captures "
          f"({capture_s:.2f} s); peak_active {st['peak_active']}"
          + (f", preemptions {st['preemptions']}" if "preemptions" in st else "")
          + f"; the engine's {occ['ticks']} ticks: {occ['frac']} of their wall by phase; {smi}")
    return eng, res


def _engine_card_vs_cpu(torch, TE, transformer, model_lib, prng, smi):
    """A 2-layer stream at the mid width on the card and on the CPU from the
    same weights: the dense engine, the paged engine and speculation on the
    dense-FFN LM, the dense and paged engines on the MoE LM in both
    dispatches; equal tokens but for near-ties (of the CPU's logits)."""
    import numpy as np

    _f32_exact(torch)
    gen = np.random.default_rng(16)
    prompts = [gen.integers(1, LM_MID["vocab"], (n,)).astype(np.int32)
               for n in ENGINE_CHECK_LENS]
    prompts += [np.tile(np.asarray(m, np.int32), n // len(m) + 1)[:n] for m, n in SPEC_STREAM[:3]]
    cases = [("dense", {}, {}), ("paged", {}, {}), ("spec", {}, {})]
    cases += [(kind, dict(d_ff=LM_MOE["d_ff"], moe_experts=MOE["moe_experts"]),
               dict(moe_top_k=MOE["moe_top_k"], moe_dispatch=d))
              for d in MOE_DISPATCHES for kind in ("dense", "paged")]
    out = {}
    for kind, arch, moe in cases:
        label = f"engine card vs CPU {kind}{' moe ' + moe['moe_dispatch'] if moe else ''}"
        prng.seed_all(96)
        host = model_lib.params_to_numpy(transformer.init_lm_params(
            LM_MID["vocab"], LM_MID["d_model"], 2, LM_MID["n_heads"], 256, device="cpu",
            **arch))
        toks = {}
        for dev in ("cuda", "cpu"):
            params = model_lib.params_from_jax(host, dev)
            kw = dict(ENGINE, batch_size=ENGINE_CHECK_B, **moe)
            if kind == "dense":
                eng = TE.DecodeEngine(params, **kw)
            else:
                eng = TE.PagedDecodeEngine(params, block_size=SERVE_BLOCK, prefix_cache=False,
                                           spec_k=SPEC_K if kind == "spec" else 0, **kw)
            ids, _ = _served(eng, prompts, ENGINE_CHECK_NEW)
            toks[dev] = [eng.completions[i].tokens.tolist() for i in ids]
        equal, ties = _held_to(torch, transformer, model_lib.params_from_jax(host, "cpu"), label,
                               toks["cuda"], toks["cpu"], **moe)
        print(f"{label}: {equal} of {len(prompts)} requests' tokens equal (2 layers, f32, TF32 "
              f"off); near-ties {ties}")
        out[label] = {"equal": equal, "requests": len(prompts), "near_ties": len(ties)}
    print(f"engine card vs CPU: {smi}")
    return out


def phase_engine(torch, transformer, model_lib, prng, smi):
    """Phase 27: the serving engines at the mid LM (``bench.py``'s
    lm_serve, lm_serve_paged, lm_serve_prefix and lm_serve_spec: vocab
    8192, d_model 512, 12 layers, 8 heads, max_seq 256, 16 slots,
    admit_every 8, EOS 0, greedy, random weights from a seed), their
    programs replayed CUDA graphs."""
    import numpy as np

    from znicz_tpu_torch.services import engine as TE
    from znicz_tpu_torch.workflow import generate as G

    _f32_exact(torch)

    def lm(max_seq):
        """bench.py's weights: seed 95 at its position table."""
        prng.seed_all(95)
        return transformer.init_lm_params(LM_MID["vocab"], LM_MID["d_model"],
                                          LM_MID["n_layers"], LM_MID["n_heads"], max_seq,
                                          device="cuda")

    params = lm(ENGINE["max_seq"])
    greedy = (True, 0, False)
    reqs = np.random.default_rng(12)
    res = {}

    # dense: bench.py's lm_serve
    prompts = [reqs.integers(1, LM_MID["vocab"], (SERVE_LENS[j % len(SERVE_LENS)],)).astype(
        np.int32) for j in range(4 * ENGINE_B)]
    eng, res["dense"] = _timed_twice(
        torch, G, transformer, params, "engine dense",
        lambda: TE.DecodeEngine(params, batch_size=ENGINE_B, **ENGINE), prompts, SERVE_NEW, smi)
    want = {("admit", b, greedy) for b in (16, 64, 128)} | {("chunk", 8, ENGINE_B, greedy)}
    res["dense"]["programs"] = _programs_check("engine dense", eng, want, want)
    res["dense"]["chunk_replay"] = _replay_costs(torch, eng, ("chunk", 8, ENGINE_B, greedy))
    _print_replay("engine dense", res["dense"], smi)
    del eng

    # paged: bench.py's lm_serve_paged (the pool at the dense footprint)
    n_blocks = ENGINE_B * (256 // SERVE_BLOCK) + 1
    paged = dict(ENGINE, block_size=SERVE_BLOCK, n_blocks=n_blocks, prefix_cache=False)
    prompts = [reqs.integers(1, LM_MID["vocab"], (SERVE_LENS[j % len(SERVE_LENS)],)).astype(
        np.int32) for j in range(4 * ENGINE_B)]
    eng, res["paged"] = _timed_twice(
        torch, G, transformer, params, "engine paged",
        lambda: TE.PagedDecodeEngine(params, batch_size=ENGINE_B, **paged), prompts, SERVE_NEW,
        smi)
    windows = {("paged_chunk", 8, ENGINE_B, w, greedy) for w in (1, 2, 4, 8)}
    res["paged"]["programs"] = _programs_check(
        "engine paged", eng, windows | {("prefill", SERVE_BLOCK, greedy)},
        {("prefill", SERVE_BLOCK, greedy)})
    widest = max(k for k in eng._progs if k[0] == "paged_chunk")
    res["paged"]["chunk_replay"] = {"window": widest[3], **_replay_costs(torch, eng, widest)}
    _print_replay(f"engine paged (window {widest[3]})", res["paged"], smi)
    res["paged"]["preemptions"] = eng.stats()["preemptions"]
    del eng
    # the concurrency probe: 2x the slots over the same pool, 16+16 requests
    probe = TE.PagedDecodeEngine(params, batch_size=2 * ENGINE_B, **paged)
    _served(probe, [reqs.integers(1, LM_MID["vocab"], (16,)).astype(np.int32)
                    for _ in range(4 * ENGINE_B)], 16)
    st = probe.stats()
    res["paged"]["probe"] = {"peak_active": st["peak_active"], "preemptions": st["preemptions"]}
    print(f"engine paged: concurrency probe (32 slots, the same {n_blocks - 1}-block pool, "
          f"16+16-token requests): peak_active {st['peak_active']} (the dense layout holds "
          f"{ENGINE_B} rows in this memory), preemptions {st['preemptions']}; {smi}")
    if st["peak_active"] <= ENGINE_B:
        fail(f"engine paged: the probe decoded at most {st['peak_active']} rows at once")
    del probe

    # prefix: bench.py's lm_serve_prefix, the cache on against off
    sys_prompt = np.random.default_rng(14).integers(1, LM_MID["vocab"], (PREFIX_SYS,)).astype(
        np.int32)
    tails = np.random.default_rng(15)
    prompts = [np.concatenate([sys_prompt, tails.integers(1, LM_MID["vocab"], (
        16 + 8 * (j % 3),)).astype(np.int32)]) for j in range(4 * ENGINE_B)]
    prefix, prefix_params = {}, lm(ENGINE_T)
    for on in (True, False):
        label = f"engine prefix {'on' if on else 'off'}"

        def seed(e):
            """Only the system prompt cached, as bench.py times it."""
            e.flush_prefix_cache()
            _served(e, [sys_prompt], 1)

        def make(on=on):
            e = TE.PagedDecodeEngine(prefix_params, batch_size=ENGINE_B, **dict(
                ENGINE, max_seq=ENGINE_T), block_size=SERVE_BLOCK,
                n_blocks=ENGINE_B * (ENGINE_T // SERVE_BLOCK) + 1, prefix_cache=on)
            seed(e)
            return e

        eng, prefix[on] = _timed_twice(torch, G, transformer, prefix_params, label, make,
                                       prompts, SERVE_NEW, smi, check=on, between=seed)
        pc = eng.stats()["prefix_cache"]
        prefix[on]["prefix_cache"] = pc
        windows = {("paged_chunk", 8, ENGINE_B, w, greedy) for w in (1, 2, 4, 8, 12)}
        prefix[on]["programs"] = _programs_check(
            label, eng, windows | {("prefill", SERVE_BLOCK, greedy), ("cow", SERVE_BLOCK)},
            {("prefill", SERVE_BLOCK, greedy)})
        del eng
    del prefix_params
    ratio = prefix[True]["warm"]["ttft_ms"]["mean"] / prefix[False]["warm"]["ttft_ms"]["mean"]
    res["prefix"] = {"on": prefix[True], "off": prefix[False], "ttft_on_vs_off": ratio}
    print(f"engine prefix: {PREFIX_SYS}-token system prompt + 16/24/32-token tails: prefix hits "
          f"{prefix[True]['prefix_cache']['hits']}, cached tokens "
          f"{prefix[True]['prefix_cache']['cached_tokens']}; TTFT warm cache against off "
          f"{ratio:.3f}; tokens/sec {prefix[True]['warm']['tokens_per_s']:.1f} against "
          f"{prefix[False]['warm']['tokens_per_s']:.1f}; {smi}")
    if prefix[True]["prefix_cache"]["hits"] < 5 * 4 * ENGINE_B:
        fail(f"engine prefix: {prefix[True]['prefix_cache']['hits']} block hits, want at least "
             f"{5 * 4 * ENGINE_B}")

    # spec: bench.py's lm_serve_spec, spec_k 7 against 0
    prompts = [np.tile(np.asarray(m, np.int32), n // len(m) + 1)[:n]
               for m, n in (SPEC_STREAM[j % len(SPEC_STREAM)] for j in range(2 * SPEC_B))]
    spec = {}
    toks = {}
    for k in (SPEC_K, 0):
        label = f"engine spec k={k}"
        spec_kw = dict(ENGINE, block_size=SERVE_BLOCK, n_blocks=SPEC_B * (256 // SERVE_BLOCK) + 1,
                       prefix_cache=False, spec_k=k)
        first = {}
        eng, spec[k] = _timed_twice(
            torch, G, transformer, params, label,
            lambda: TE.PagedDecodeEngine(params, batch_size=SPEC_B, **spec_kw), prompts,
            SERVE_NEW, smi, check=k == SPEC_K, between=lambda e: first.update(e.spec_stats()))
        # the second (timed) pass's tallies
        spec[k]["spec"] = {n: v - first[n] for n, v in eng.spec_stats().items()
                           if n in ("drafted", "accepted", "rejected", "verify_steps")}
        spec[k]["spec"]["acceptance_rate"] = (spec[k]["spec"]["accepted"]
                                              / max(spec[k]["spec"]["drafted"], 1))
        toks[k] = [c.tokens.tolist() for c in sorted(eng.completions.values(),
                                                     key=lambda c: c.id)]
        windows = {("paged_chunk", 8, SPEC_B, w, greedy) for w in (1, 2, 4, 8)}
        verify = {("spec_verify", wd, SPEC_B, w, greedy) for wd in (2, 4, 8) for w in (1, 2, 4, 8)}
        spec[k]["programs"] = _programs_check(
            label, eng, windows | verify | {("prefill", SERVE_BLOCK, greedy)},
            {("prefill", SERVE_BLOCK, greedy)})
        del eng
    sp = spec[SPEC_K]["spec"]
    res["spec"] = {"on": spec[SPEC_K], "off": spec[0],
                   "speedup": spec[SPEC_K]["warm"]["tokens_per_s"] / spec[0]["warm"]["tokens_per_s"]}
    print(f"engine spec: spec_k {SPEC_K} against 0 (batch {SPEC_B}, bench.py's repeat-heavy "
          f"stream): {spec[SPEC_K]['warm']['tokens_per_s']:.1f} against "
          f"{spec[0]['warm']['tokens_per_s']:.1f} generated tokens/sec (x{res['spec']['speedup']:.3f});"
          f" acceptance {sp['acceptance_rate']:.4f} ({sp['accepted']}/{sp['drafted']} drafts, "
          f"{sp['verify_steps']} verifies, the timed pass); {smi}")
    equal, ties = _held_to(torch, transformer, params, "engine spec against spec off",
                           toks[SPEC_K], toks[0])
    if sp["verify_steps"] == 0 or sp["accepted"] == 0:
        fail(f"engine spec: no draft was accepted: {sp}")
    res["spec"]["equal_to_spec_off"] = equal
    del params
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = _engine_card_vs_cpu(torch, TE, transformer, model_lib, prng, smi)
    return res


# -- the serving front door (phase 28) -----------------------------------------

DOOR_CLIENTS = 4  # bench.py's lm_serve_frontdoor: 4 HTTP clients
DOOR_PENDING = 128  # bench.py: max_pending 2x the 64 requests
DOOR_DEADLINE_S = 300.0  # bench.py's default_deadline_s
DOOR_CRASH_N = 24  # requests in flight when the engine crashes: 16 slots and 8 more
DOOR_DRAIN_N, DOOR_DRAIN_GRACE_S = 48, 0.5  # requests in flight at close(drain=True)
DOOR_DENSE_N = 16  # the dense backend's short stream
DOOR_PROFILE_S = 1.0


def _http(port, method, path, body=None, timeout=300):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _http_generate(port, prompt, budget):
    """bench.py's client: POST /generate and read the NDJSON stream; the
    first token's time on the client's clock."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/generate", body=json.dumps(
            {"prompt": [int(t) for t in prompt], "max_new_tokens": budget}))
        resp = conn.getresponse()
        if resp.status != 200:
            return {"status": resp.status, "body": resp.read().decode()}
        out = {"status": 200, "tokens": [], "ttft_s": None, "done": None}
        while True:
            line = resp.readline()
            if not line:
                break
            rec = json.loads(line)
            if "token" in rec:
                if out["ttft_s"] is None:
                    out["ttft_s"] = time.perf_counter() - t0
                out["tokens"].append(rec["token"])
            elif rec.get("done"):
                out["done"] = rec
        out["latency_s"] = time.perf_counter() - t0
        return out
    finally:
        conn.close()


def _http_stream(port, prompts, budget, during=None, clients=DOOR_CLIENTS):
    """``clients`` threads POST ``prompts`` in turn; ``during()`` runs on
    this thread while they do.  Returns the results in prompt order, the
    stream's wall seconds and what ``during`` returned."""
    import threading

    todo, results, lock = list(enumerate(prompts)), {}, threading.Lock()

    def client():
        while True:
            with lock:
                if not todo:
                    return
                i, p = todo.pop(0)
            r = _http_generate(port, p, budget)
            with lock:
                results[i] = r

    threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    extra = during() if during is not None else None
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or len(results) != len(prompts):
        fail(f"frontdoor: {len(results)} of {len(prompts)} HTTP requests answered")
    return [results[i] for i in range(len(prompts))], wall, extra


def _door_numbers(results, wall):
    """bench.py's lm_serve_frontdoor numbers of one HTTP stream."""
    ok = [r for r in results if r.get("status") == 200 and r["done"] is not None
          and r["done"]["finish_reason"] in ("eos", "budget")]
    ttft = [r["ttft_s"] * 1e3 for r in ok if r["ttft_s"] is not None]
    qage = [r["done"]["timings"]["queue_s"] * 1e3 for r in ok]
    tokens = sum(len(r.get("tokens", ())) for r in results)
    return {"requests": len(results), "completed": len(ok), "wall_s": wall,
            "requests_per_s": len(ok) / wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "ttft_ms": {"p50": _pct(ttft, 0.5), "p99": _pct(ttft, 0.99)},
            "queue_age_ms": {"p99": _pct(qage, 0.99)}}


def _timed_ticks(door):
    """Wrap the door's engine-thread tick with a host clock; returns the
    tally it adds to."""
    spent = {"s": 0.0, "n": 0}
    tick = door._tick

    def timed():
        t0 = time.perf_counter()
        try:
            tick()
        finally:
            spent["s"] += time.perf_counter() - t0
            spent["n"] += 1

    door._tick = timed
    return spent


def _busy_share(events, seconds):
    """The share of a capture window in which the card ran a kernel: the
    union of the trace's kernel intervals over the window."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events if e.get("cat") == "kernel")
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / (seconds * 1e6)


def _pool_swept(door):
    st = door.engine.stats()
    return st["pool_blocks_free"] == st["pool_blocks"]


def _until_idle(door, label, timeout=120.0):
    deadline = time.monotonic() + timeout
    while door.has_work():
        if time.monotonic() > deadline:
            fail(f"{label}: the door still has work after {timeout} s")
        time.sleep(0.005)


def _through_door(door, prompts, budget):
    handles = [door.submit(p, budget) for p in prompts]
    return [h.result(timeout=300.0) for h in handles]


def phase_frontdoor(torch, transformer, prng, smi, engine_res):
    """Phase 28: the serving front door (``services/frontdoor.py``) behind
    the HTTP server (``services/serve.py``) at ``bench.py``'s
    lm_serve_frontdoor settings: the mid LM (weights from seed 95), a paged
    engine factory (16 slots, block 32, ``admit_every`` 8, max_seq 256, EOS
    0, greedy), 4 HTTP clients over 64 requests of prompts 16/40/64/120 and
    budget 64; the failure paths on the card; ``/debug/profile``; the fleet
    telemetry; the dense backend and speculation through the door."""
    import threading

    import numpy as np

    from znicz_tpu_torch.observability import device as ledger
    from znicz_tpu_torch.observability.aggregate import (
        MetricsAggregator,
        build_aggregator_server,
    )
    from znicz_tpu_torch.services import engine as TE
    from znicz_tpu_torch.services import frontdoor as TF
    from znicz_tpu_torch.services import serve as TS
    from znicz_tpu_torch.utils import faults

    _f32_exact(torch)
    prng.seed_all(95)
    params = transformer.init_lm_params(LM_MID["vocab"], LM_MID["d_model"], LM_MID["n_layers"],
                                        LM_MID["n_heads"], ENGINE["max_seq"], device="cuda")
    reqs = np.random.default_rng(12)
    prompts = [reqs.integers(1, LM_MID["vocab"], (SERVE_LENS[j % len(SERVE_LENS)],)).astype(
        np.int32) for j in range(4 * ENGINE_B)]
    res = {}

    def make_paged():
        return TE.PagedDecodeEngine(params, batch_size=ENGINE_B, block_size=SERVE_BLOCK, **ENGINE)

    # the engine alone on the same stream, as the door will run it: a fresh
    # engine, one warm request (prompt 0), then the 64 requests at once
    alone = make_paged()
    _served(alone, prompts[:1], SERVE_NEW)
    ids, wall = _served(alone, prompts, SERVE_NEW)
    res["engine_alone"] = _stream_numbers(alone, ids, wall)
    golden = [alone.completions[i].tokens.tolist() for i in ids]
    alone_programs = set(alone.compile_stats()["programs"])
    # a chunk's replay issue time here and around the door's profile
    # capture below, on this engine (a replay rewrites its last chunk's
    # blocks, so never on the door's, whose prefix cache serves on)
    key = max(k for k in alone._progs if k[0] == "paged_chunk")
    replay = {"first": _replay_costs(torch, alone, key)}

    # the door behind the server, pushing to an in-process aggregator
    agg = MetricsAggregator()
    agg_srv = build_aggregator_server(agg, port=0)
    threading.Thread(target=agg_srv.serve_forever, daemon=True).start()
    restarts = []  # seconds of each watchdog rebuild (the factory's call)

    def factory():
        t0 = time.perf_counter()
        eng = make_paged()
        restarts.append(time.perf_counter() - t0)
        return eng

    n_ledger = ledger.program_count("engine")
    door = TF.ServingFrontDoor(
        factory, max_pending=DOOR_PENDING, default_deadline_s=DOOR_DEADLINE_S,
        aggregator_url=f"http://127.0.0.1:{agg_srv.server_address[1]}", push_interval_s=60.0)
    restarts.clear()  # the constructor's first build is no restart
    site = os.path.join(WORK_DIR, "frontdoor")
    os.makedirs(site, exist_ok=True)
    # http.server logs a line a request on stderr: keep this run's stderr
    # for failures
    TS.StatusRequestHandler.log_message = lambda *args: None
    srv = TS.build_server(directory=site, port=0, frontdoor=door)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    ticks = _timed_ticks(door)
    try:
        # one request warms the programs through HTTP, then the timed stream
        warm = _http_generate(port, prompts[0], SERVE_NEW)
        if warm.get("status") != 200:
            fail(f"frontdoor: the warm request answered {warm}")
        ticks.update(s=0.0, n=0)
        occ0 = door.engine.tick_occupancy()

        def healthz():
            time.sleep(0.05)
            return _http(port, "GET", "/healthz")

        results, wall, (h_status, h_body) = _http_stream(port, prompts, SERVE_NEW, healthz)
        num = _door_numbers(results, wall)
        num["tick_share"] = ticks["s"] / wall
        num["ticks"] = ticks["n"]
        occ = door.engine.tick_occupancy()
        num["tick_occupancy"] = occ
        res["http"] = num
        if h_status != 200 or json.loads(h_body)["state"] != "running":
            fail(f"frontdoor: /healthz answered {h_status} {h_body!r} while running")
        bad = [r for r in results if r.get("status") != 200 or r["done"] is None]
        if bad or num["completed"] != len(prompts):
            fail(f"frontdoor: {len(bad)} requests failed, {num['completed']} of {len(prompts)} "
                 f"finished eos/budget: {bad[:2]}")
        got = [list(p) + r["tokens"] for p, r in zip(prompts, results)]
        equal, ties = _held_to(torch, transformer, params, "frontdoor http", got, golden)
        num["equal_engine_alone"], num["near_ties"] = equal, len(ties)
        progs = set(door.engine.compile_stats()["programs"])
        st = door.engine.compile_stats()
        graphs = sum(v for k, v in st.items() if k.endswith("_graph_entries"))
        if progs != alone_programs or graphs != len(progs):
            fail(f"frontdoor: programs {sorted(progs)} ({graphs} graphs); the engine alone's "
                 f"{sorted(alone_programs)}")
        num["programs"] = sorted(str(k) for k in progs)
        door_stats = door.stats()
        print(f"frontdoor http: {num['requests']} requests over {DOOR_CLIENTS} HTTP clients: "
              f"{num['requests_per_s']:.2f} requests/sec, {num['tokens_per_s']:.1f} generated "
              f"tokens/sec, TTFT p50 {num['ttft_ms']['p50']:.1f} ms, p99 "
              f"{num['ttft_ms']['p99']:.1f} (client clock), queue age p99 "
              f"{num['queue_age_ms']['p99']:.1f} ms; beside the engine alone on the same stream "
              f"{res['engine_alone']['tokens_per_s']:.1f} tokens/sec (TTFT p50 "
              f"{res['engine_alone']['ttft_ms']['p50']:.1f}, p99 "
              f"{res['engine_alone']['ttft_ms']['p99']:.1f}) and phase 27's paged engine "
              f"{engine_res['paged']['warm']['tokens_per_s']:.1f}; shed "
              f"{sum(door_stats['rejected'].values())}, deadline "
              f"{door_stats['deadline_exceeded']}, cancelled {door_stats['cancelled']}, restarts "
              f"{door_stats['watchdog_restarts']}; {equal} of {len(got)} requests' tokens equal "
              f"the engine alone's (near-ties {ties}); programs {len(progs)} (the engine "
              f"alone's, one graph each); the engine thread's ticks took {num['tick_share']:.3f} "
              f"of the stream's wall ({ticks['n']} ticks; the engine's own phases "
              f"{occ['frac']}, {occ['ticks'] - occ0['ticks']} working ticks); {smi}")

        # the endpoints
        status, body = _http(port, "GET", "/metrics")
        text = body.decode()
        if status != 200 or "znicz_serve_frontdoor_ttft_seconds_bucket" not in text or (
                "znicz_serve_frontdoor_pending" not in text):
            fail(f"frontdoor: /metrics answered {status} without the front door's series")
        status, body = _http(port, "GET", "/debug/programs")
        body, snap = json.loads(body), ledger.ledger_snapshot()
        mem = {d["device"]: d["stats"] for d in body["device_memory"]}
        if status != 200 or [p["key"] for p in body["programs"]] != [
                p["key"] for p in snap["programs"]] or body["count"] != snap["count"]:
            fail(f"frontdoor: /debug/programs differs from the ledger ({status})")
        if not mem.get("cuda:0") or not all(mem["cuda:0"][k] > 0 for k in (
                "bytes_in_use", "peak_bytes_in_use", "bytes_limit")):
            fail(f"frontdoor: /debug/programs has no cuda:0 memory: {body['device_memory']}")
        if ledger.program_count("engine") != n_ledger:
            fail(f"frontdoor: the door ledgered {ledger.program_count('engine') - n_ledger} new "
                 f"programs")
        status, body = _http(port, "POST", "/prefix_probe", {"prompt": prompts[5].tolist()})
        if status != 200 or json.loads(body) != door.engine.prefix_probe(prompts[5]):
            fail(f"frontdoor: /prefix_probe answered {status} {body[:200]!r}")
        status, body = _http(port, "GET", "/slo")
        slo = json.loads(body)
        if status != 200 or "ttft" not in slo["targets"]:
            fail(f"frontdoor: /slo answered {status} {body[:200]!r}")
        res["endpoints"] = {"device_memory": mem["cuda:0"], "programs": snap["count"],
                            "slo_breached": slo["breached"]}
        print(f"frontdoor endpoints: /healthz 200 while running; /metrics carries the "
              f"znicz_serve_frontdoor_* series; /debug/programs is the ledger ({snap['count']} "
              f"programs, none new) with cuda:0 in use {mem['cuda:0']['bytes_in_use']}, peak "
              f"{mem['cuda:0']['peak_bytes_in_use']}, limit {mem['cuda:0']['bytes_limit']} "
              f"bytes; /prefix_probe equals the engine's; /slo answers (breached "
              f"{slo['breached']})")

        # the same stream with as many clients as the engine has slots
        results16, wall16, _ = _http_stream(port, prompts, SERVE_NEW, clients=ENGINE_B)
        res["http_16_clients"] = _door_numbers(results16, wall16)
        n16 = res["http_16_clients"]
        print(f"frontdoor http, {ENGINE_B} clients: {n16['requests_per_s']:.2f} requests/sec, "
              f"{n16['tokens_per_s']:.1f} generated tokens/sec, TTFT p50 "
              f"{n16['ttft_ms']['p50']:.1f} ms, p99 {n16['ttft_ms']['p99']:.1f}, queue age p99 "
              f"{n16['queue_age_ms']['p99']:.1f} ms (the engine alone: "
              f"{res['engine_alone']['tokens_per_s']:.1f}); {smi}")
        if n16["completed"] != len(prompts):
            fail(f"frontdoor http, {ENGINE_B} clients: {n16['completed']} finished")

        # the fleet telemetry: the door's pusher into the aggregator
        if not door._pusher.push_now():
            fail("frontdoor: the metrics push to the aggregator failed")
        agg_port = agg_srv.server_address[1]
        status, body = _http(agg_port, "GET", f"/metrics?instance={door.instance}")
        fleet = body.decode()
        status_i, inst = _http(agg_port, "GET", "/instances")
        names = [i["instance"] for i in json.loads(inst)["instances"]]
        if status != 200 or "znicz_serve_frontdoor_latency_seconds_count" not in fleet or (
                names != [door.instance]):
            fail(f"frontdoor: the aggregator's /metrics?instance= answered {status} ({names})")
        print(f"frontdoor fleet: the door's MetricsPusher into an in-process MetricsAggregator: "
              f"/instances {names}, the fleet /metrics under instance {door.instance} carries "
              f"the door's series ({len(fleet.splitlines())} lines)")

        # a cancel mid-decode, blocks reclaimed
        faults.inject("frontdoor.slow_tick", delay=0.02)
        h = door.submit(prompts[3], SERVE_NEW)
        next(h.tokens(timeout=300.0))
        h.cancel()
        comp = h.result(timeout=300.0)
        faults.clear("frontdoor.slow_tick")
        _until_idle(door, "frontdoor cancel")
        if comp.finish_reason != "cancelled" or not 1 <= comp.n_new < SERVE_NEW or not (
                _pool_swept(door)):
            fail(f"frontdoor cancel: {comp.finish_reason}, {comp.n_new} tokens, pool swept "
                 f"{_pool_swept(door)}")
        res["cancel"] = {"n_new": comp.n_new}
        # a deadline expired mid-flight
        faults.inject("frontdoor.slow_tick", delay=0.05)
        comp = door.submit(prompts[2], SERVE_NEW, deadline_s=0.25).result(timeout=300.0)
        faults.clear("frontdoor.slow_tick")
        _until_idle(door, "frontdoor deadline")
        if comp.finish_reason != "deadline_exceeded" or not 1 <= comp.n_new < SERVE_NEW or not (
                _pool_swept(door)):
            fail(f"frontdoor deadline: {comp.finish_reason}, {comp.n_new} tokens, pool swept "
                 f"{_pool_swept(door)}")
        res["deadline"] = {"n_new": comp.n_new}
        print(f"frontdoor cancel and deadline: a cancel mid-decode after "
              f"{res['cancel']['n_new']} tokens and a 0.25 s deadline expired after "
              f"{res['deadline']['n_new']} (slow ticks injected), each typed, the pool swept "
              f"after each (free == pool)")

        # an engine crash mid-stream: slot residents fail typed, the rest
        # finish golden on the rebuilt engine, which captures its own graphs
        dead_engine = door.engine
        first_ticks = dead_engine.tick_occupancy()["ticks"]
        del dead_engine
        handles = [door.submit(prompts[i], SERVE_NEW) for i in range(DOOR_CRASH_N)]
        next(handles[0].tokens(timeout=300.0))
        faults.inject("engine.decode_step", exc=RuntimeError("injected engine crash"), times=1)
        comps = [hd.result(timeout=300.0) for hd in handles]
        faults.clear("engine.decode_step")
        errors = [c for c in comps if c.finish_reason == "error"]
        served = [(i, c) for i, c in enumerate(comps) if c.finish_reason != "error"]
        if not errors or not served or any("injected engine crash" not in c.error for c in errors):
            fail(f"frontdoor crash: {len(errors)} typed errors, {len(served)} served: "
                 f"{[c.finish_reason for c in comps]}")
        equal_c, ties_c = _held_to(torch, transformer, params, "frontdoor crash",
                                   [c.tokens.tolist() for _, c in served],
                                   [golden[i] for i, _ in served])
        st = door.engine.compile_stats()
        graphs = sum(v for k, v in st.items() if k.endswith("_graph_entries"))
        recapture = sum(door.engine.capture_s.values())
        _until_idle(door, "frontdoor crash")
        if (door.stats()["watchdog_restarts"] != 1 or len(restarts) != 1 or graphs < 1
                or graphs != len(st["programs"]) or not _pool_swept(door)):
            fail(f"frontdoor crash: restarts {door.stats()['watchdog_restarts']}, rebuilds "
                 f"{restarts}, graphs {graphs} for {len(st['programs'])} programs")
        if ledger.program_count("engine") != n_ledger:
            fail("frontdoor crash: the restart ledgered new programs")
        res["crash"] = {"errors": len(errors), "served": len(served), "equal": equal_c,
                        "rebuild_s": restarts[0], "recapture_s": recapture,
                        "graphs": graphs, "dead_engine_ticks": first_ticks}
        print(f"frontdoor crash: engine.decode_step armed once mid-stream over {DOOR_CRASH_N} "
              f"requests: {len(errors)} slot residents typed error, {len(served)} re-admitted "
              f"or finished ({equal_c} equal the engine alone's, near-ties {ties_c}); "
              f"znicz_serve_watchdog_restarts_total +1; the rebuild {restarts[0]:.3f} s and the "
              f"new engine's {graphs} captures {recapture:.3f} s; no program ledgered anew; "
              f"{smi}")

        # /debug/profile under traffic (a process's first capture starts
        # CUPTI for seconds before its window opens, so the clients keep
        # posting until it answers); a second capture meanwhile is
        # refused; a chunk's replay issue time before and after
        replay["before_capture"] = _replay_costs(torch, alone, key)
        prof, answered = {}, threading.Event()

        def traffic():
            while not answered.is_set():
                _http_generate(port, prompts[1], SERVE_NEW)

        clients = [threading.Thread(target=traffic, daemon=True) for _ in range(DOOR_CLIENTS)]
        for c in clients:
            c.start()
        t = threading.Thread(target=lambda: prof.update(
            first=_http(port, "POST", f"/debug/profile?seconds={DOOR_PROFILE_S}")))
        t0 = time.perf_counter()
        t.start()
        time.sleep(0.3)
        prof["second"] = _http(port, "POST", "/debug/profile?seconds=1")
        t.join(timeout=300)
        capture_s = time.perf_counter() - t0
        answered.set()
        for c in clients:
            c.join(timeout=300)
        _until_idle(door, "frontdoor profile")
        replay["after_capture"] = _replay_costs(torch, alone, key)
        del alone
        status, body = prof["first"]
        out = json.loads(body)
        with open(os.path.join(out["log_dir"], "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        busy = _busy_share(events, out["seconds"])
        if status != 200 or kernels == 0 or prof["second"][0] != 409:
            fail(f"frontdoor profile: {status}, {kernels} kernel events, the second capture "
                 f"answered {prof['second'][0]}")
        res["profile"] = {"kernel_events": kernels, "events": len(events), "busy_share": busy,
                          "capture_wall_s": capture_s, "replay": replay}
        print(f"frontdoor profile: POST /debug/profile?seconds={DOOR_PROFILE_S} during a stream "
              f"answered 200 with {kernels} CUDA kernel events of {len(events)} (the card ran a "
              f"kernel in {busy:.3f} of the window); a second capture "
              f"meanwhile 409; the capture answered after {capture_s:.3f} s; a paged chunk's "
              f"replay (window {key[3]}) issued in host µs "
              + ", ".join(f"{k.replace('_', ' ')} {v['host_us']:.1f}" for k, v in replay.items())
              + " (device µs "
              + ", ".join(f"{v['device_us']:.1f}" for v in replay.values())
              + f"); {smi}")

        # close(drain=True) with work in flight
        handles = [door.submit(prompts[i % len(prompts)], SERVE_NEW)
                   for i in range(DOOR_DRAIN_N)]
        next(handles[0].tokens(timeout=300.0))
        t0 = time.perf_counter()
        door.close(drain=True, grace_s=DOOR_DRAIN_GRACE_S)
        close_s = time.perf_counter() - t0
        comps = [hd.result(timeout=60.0) for hd in handles]
        reasons = [c.finish_reason for c in comps]
        finished = [(i, c) for i, c in enumerate(comps) if c.finish_reason in ("eos", "budget")]
        if any(r not in ("eos", "budget", "shed") for r in reasons):
            fail(f"frontdoor drain: reasons {reasons}")
        _held_to(torch, transformer, params, "frontdoor drain",
                 [c.tokens.tolist() for _, c in finished],
                 [golden[i % len(prompts)] for i, _ in finished])
        status, _ = _http(port, "GET", "/healthz")
        if status != 503:
            fail(f"frontdoor drain: /healthz answered {status} after close")
        res["drain"] = {"finished": len(finished), "shed": reasons.count("shed"),
                        "close_s": close_s}
        print(f"frontdoor drain: close(drain=True, grace {DOOR_DRAIN_GRACE_S} s) with "
              f"{DOOR_DRAIN_N} requests in flight returned in {close_s:.3f} s: "
              f"{len(finished)} finished (their tokens the engine alone's), "
              f"{reasons.count('shed')} typed shed; /healthz 503 after")
    finally:
        faults.clear()
        TS.shutdown_gracefully(srv, door, grace_s=1.0)
        srv.server_close()
        agg_srv.shutdown()
        agg_srv.server_close()
    del door
    torch.cuda.empty_cache()

    # the dense backend through the door
    def make_dense():
        return TE.DecodeEngine(params, batch_size=ENGINE_B, **ENGINE)

    short = prompts[:DOOR_DENSE_N]
    alone = make_dense()
    ids, _ = _served(alone, short, SERVE_NEW)
    want = [alone.completions[i].tokens.tolist() for i in ids]
    del alone
    with TF.ServingFrontDoor(make_dense, max_pending=DOOR_PENDING) as door:
        t0 = time.perf_counter()
        comps = _through_door(door, short, SERVE_NEW)
        wall = time.perf_counter() - t0
    equal, ties = _held_to(torch, transformer, params, "frontdoor dense",
                           [c.tokens.tolist() for c in comps], want)
    res["dense"] = {"equal": equal, "tokens_per_s": sum(c.n_new for c in comps) / wall}
    print(f"frontdoor dense: {DOOR_DENSE_N} requests through the door over the dense engine "
          f"(its first pass, captures included: {res['dense']['tokens_per_s']:.1f} generated "
          f"tokens/sec): {equal} equal the engine alone's (near-ties {ties})")
    torch.cuda.empty_cache()

    # speculation through the door on phase 27's repeat-heavy stream
    spec_prompts = [np.tile(np.asarray(m, np.int32), n // len(m) + 1)[:n]
                    for m, n in (SPEC_STREAM[j % len(SPEC_STREAM)] for j in range(2 * SPEC_B))]

    def make_spec():
        return TE.PagedDecodeEngine(params, batch_size=SPEC_B, block_size=SERVE_BLOCK,
                                    n_blocks=SPEC_B * (256 // SERVE_BLOCK) + 1,
                                    prefix_cache=False, spec_k=SPEC_K, **ENGINE)

    alone = make_spec()
    ids, _ = _served(alone, spec_prompts, SERVE_NEW)
    want = [alone.completions[i].tokens.tolist() for i in ids]
    alone_spec = alone.spec_stats()
    del alone
    # every request queued before the first tick, as in the engine alone
    with TF.ServingFrontDoor(make_spec, max_pending=DOOR_PENDING, engine_queue_limit=0) as door:
        handles = [door.submit(p, SERVE_NEW) for p in spec_prompts]
        door.engine_queue_limit = len(spec_prompts)
        door._wake.set()
        comps = [hd.result(timeout=300.0) for hd in handles]
    drafted = sum(c.timings["spec_drafted"] for c in comps)
    accepted = sum(c.timings["spec_accepted"] for c in comps)
    equal, ties = _held_to(torch, transformer, params, "frontdoor spec",
                           [c.tokens.tolist() for c in comps], want)
    res["spec"] = {"drafted": drafted, "accepted": accepted,
                   "acceptance_rate": accepted / max(drafted, 1), "equal": equal,
                   "engine_alone": {k: alone_spec[k] for k in ("drafted", "accepted")}}
    print(f"frontdoor spec: spec_k {SPEC_K} on phase 27's repeat-heavy stream through the door: "
          f"the completions' timings carry {accepted}/{drafted} drafts accepted "
          f"({res['spec']['acceptance_rate']:.4f}); the engine alone {alone_spec['accepted']}/"
          f"{alone_spec['drafted']}; {equal} of {len(comps)} requests' tokens equal (near-ties "
          f"{ties})")
    if (drafted, accepted) != (alone_spec["drafted"], alone_spec["accepted"]):
        fail(f"frontdoor spec: the door's drafts {accepted}/{drafted}, the engine alone's "
             f"{alone_spec['accepted']}/{alone_spec['drafted']}")
    del params
    torch.cuda.empty_cache()
    return res


# -- the serving cluster (phase 29) ---------------------------------------------

ROUTER_FAMILIES, ROUTER_PER_FAMILY = 3, 4  # bench.py's lm_serve_router
ROUTER_BUDGET = 24  # bench.py's lm_serve_router budget
ROUTER_PASSES = ("warm", "prefix_affinity", "round_robin")  # the warm pass is affinity too


def _router_prompts():
    """bench.py's lm_serve_router stream: 3 families of a 160-token shared
    prefix, tails of 16/24/32 tokens, 4 requests a family, interleaved."""
    import numpy as np

    gen = np.random.default_rng(14)
    families = [gen.integers(1, LM_MID["vocab"], (PREFIX_SYS,)).astype(np.int32)
                for _ in range(ROUTER_FAMILIES)]
    return [np.concatenate([families[f], gen.integers(1, LM_MID["vocab"], (16 + 8 * f,)).astype(
        np.int32)]) for _ in range(ROUTER_PER_FAMILY) for f in range(ROUTER_FAMILIES)]


class _Cluster:
    """Two replicas (a front door over its own paged engine behind the HTTP
    server each) and the router in front of them, in this process, as
    bench.py's ``run_policy`` builds them; :meth:`close` stops every server,
    engine thread and the heartbeat.

    Before the router exists each fresh replica serves one request of its
    own, ``warm``, straight to its server: a replica's programs are CUDA
    graphs of its own engine, captured at their first call, where the JAX
    package's compiled programs are shared by the process, so bench.py's
    warm pass warms JAX's fresh replicas and not these.  Built after it,
    the router's heartbeat cannot catch a replica inside that request (a
    probe's load reading stays until the next one, 2 s later)."""

    def __init__(self, make, policy, warm):
        import threading

        from znicz_tpu_torch.cluster import ServingRouter, build_router_server
        from znicz_tpu_torch.services import frontdoor as TF, serve as TS

        self._threading, self._TS = threading, TS
        self.site = os.path.join(WORK_DIR, "cluster")
        os.makedirs(self.site, exist_ok=True)
        self.doors, self.srvs, self.router, self.rsrv = [], [], None, None
        try:
            for _ in range(2):
                self.doors.append(TF.ServingFrontDoor(
                    make, max_pending=2 * ROUTER_FAMILIES * ROUTER_PER_FAMILY))
                self.srvs.append(self._serve(self.doors[-1]))
            for srv, door in zip(self.srvs, self.doors):
                r = _http_generate(srv.server_address[1], warm, ROUTER_BUDGET)
                if r.get("status") != 200 or r["done"] is None:
                    fail(f"cluster: a replica's own warm request answered {r}")
                _until_idle(door, "cluster warm-up")
            self.router = ServingRouter(block_size=SERVE_BLOCK, policy=policy)
            for i, srv in enumerate(self.srvs):
                self.router.register(f"replica-{i}", f"http://127.0.0.1:{srv.server_address[1]}")
            self.rsrv = build_router_server(self.router, port=0)
            threading.Thread(target=self.rsrv.serve_forever, daemon=True).start()
        except BaseException:
            self.close()
            raise
        self.port = self.rsrv.server_address[1]

    def _serve(self, door, port=0):
        srv = self._TS.build_server(directory=self.site, port=port, frontdoor=door)
        self._threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    def kill(self, i):
        self.srvs[i].shutdown()
        self.srvs[i].server_close()
        self.srvs[i] = None

    def revive(self, i, port):
        """A new server for replica ``i``'s door (the same engine) on ``port``."""
        self.srvs[i] = self._serve(self.doors[i], port)

    def settle(self, label, timeout=120.0):
        """Wait until neither door has work nor is between a crashed engine
        and its rebuilt one, then check both pools swept."""
        deadline = time.monotonic() + timeout
        for door in self.doors:
            while door.engine is None:
                if time.monotonic() > deadline:
                    fail(f"{label}: a door has no engine after {timeout} s")
                time.sleep(0.005)
            _until_idle(door, label)
        if not all(_pool_swept(d) for d in self.doors):
            fail(f"{label}: a pool is not swept: "
                 f"{[d.engine.stats()['pool_blocks_free'] for d in self.doors]} free")

    def close(self):
        for srv in self.srvs + [self.rsrv]:
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        for door in self.doors:
            door.close(grace_s=10.0)
        if self.router is not None:
            self.router.close()


def _cluster_pass(torch, transformer, params, cluster, prompts, golden, label):
    """The stream through the router, one request after another: the
    numbers of bench.py's run_policy, each request's tokens held to the
    engine alone's, and the placement; the replicas' own warm requests are
    taken off their prefix-cache tallies."""
    base = [door.engine.stats()["prefix_cache"] for door in cluster.doors]
    t0 = time.perf_counter()
    results = [_http_generate(cluster.port, p, ROUTER_BUDGET) for p in prompts]
    wall = time.perf_counter() - t0
    bad = [r for r in results if r.get("status") != 200 or r["done"] is None
           or r["done"]["finish_reason"] not in ("eos", "budget")]
    if bad:
        fail(f"cluster {label}: {len(bad)} of {len(results)} requests failed: {bad[:2]}")
    equal, ties = _held_to(torch, transformer, params, f"cluster {label}",
                           [list(p) + r["tokens"] for p, r in zip(prompts, results)], golden)
    hits = sum(d.engine.stats()["prefix_cache"]["hits"] - b["hits"]
               for d, b in zip(cluster.doors, base))
    misses = sum(d.engine.stats()["prefix_cache"]["misses"] - b["misses"]
                 for d, b in zip(cluster.doors, base))
    placed = [r["done"]["router"]["replica"] for r in results]
    ttft = [r["ttft_s"] * 1e3 for r in results]
    # a request whose prompt blocks its replica had cached (1 prefill chunk
    # of 32 tokens) against one that prefilled them all (6)
    warm = [r["done"]["timings"]["cached_tokens"] > 0 for r in results]
    split = {k: statistics.fmean([t for t, w in zip(ttft, warm) if w == (k == "warm")])
             for k in ("cold", "warm") if (k == "warm") in warm}
    programs = [set(d.engine.compile_stats()["programs"]) for d in cluster.doors]
    graphs = [sum(v for k, v in d.engine.compile_stats().items() if k.endswith("_graph_entries"))
              for d in cluster.doors]
    return {"completed": len(results) - len(bad), "wall_s": wall,
            "tokens": sum(len(r["tokens"]) for r in results),
            "tokens_per_s": sum(len(r["tokens"]) for r in results) / wall,
            "hits": hits, "misses": misses, "hit_rate": hits / max(hits + misses, 1),
            "ttft_ms": {"mean": statistics.fmean(ttft), "each": ttft, **split,
                        "n_warm": sum(warm)},
            "retries": sum(r["done"]["router"]["retries"] for r in results),
            "placed": placed, "replicas_used": len(set(placed)),
            "affinity_blocks": [r["done"]["router"]["affinity_blocks"] for r in results],
            "equal": equal, "near_ties": ties, "programs": programs,
            "programs_per_replica": [len(p) for p in programs], "graphs": graphs}


def phase_cluster(torch, transformer, prng, smi, context):
    """Phase 29: the serving cluster (``znicz_tpu_torch/cluster/``) at
    ``bench.py``'s lm_serve_router settings: the mid LM (weights from seed
    95, a position table of 384), two replicas of a paged engine (16 slots,
    block 32, ``admit_every`` 8, EOS 0, greedy) behind front doors and HTTP
    servers, the router in front, bound to port 0; the stream of
    :func:`_router_prompts` at budget 24, sequential, in three passes on
    fresh replicas; then the failure paths on the card and the doctor.
    ``context`` says what ran before in this process (a ``torch.profiler``
    session leaves CUPTI subscribed, which slows every graph replay's
    issue)."""
    import contextlib
    import io

    import numpy as np

    from znicz_tpu_torch import observability as tobs
    from znicz_tpu_torch.observability import device as ledger
    from znicz_tpu_torch.observability import doctor
    from znicz_tpu_torch.services import engine as TE
    from znicz_tpu_torch.services import serve as TS
    from znicz_tpu_torch.utils import faults

    _f32_exact(torch)
    # the router's /metrics is this process's registry: start it from zero,
    # as a router process of its own would
    tobs.get_registry().reset()
    TS.StatusRequestHandler.log_message = lambda *args: None
    prng.seed_all(95)
    params = transformer.init_lm_params(LM_MID["vocab"], LM_MID["d_model"], LM_MID["n_layers"],
                                        LM_MID["n_heads"], ENGINE_T, device="cuda")
    prompts = _router_prompts()
    fam = [j % ROUTER_FAMILIES for j in range(len(prompts))]
    # each fresh replica's own warm request: the stream's lengths, no block of it
    warm = np.random.default_rng(15).integers(1, LM_MID["vocab"], (PREFIX_SYS + 16,)).astype(
        np.int32)

    def make():
        return TE.PagedDecodeEngine(params, batch_size=ENGINE_B, block_size=SERVE_BLOCK,
                                    **{**ENGINE, "max_seq": ENGINE_T})

    # the goldens: the engine alone, one request after another, as a
    # replica serves them
    alone = make()
    golden = []
    for p in prompts:
        (rid,), _ = _served(alone, [p], ROUTER_BUDGET)
        golden.append(alone.completions[rid].tokens.tolist())
    alone_programs = set(alone.compile_stats()["programs"])
    del alone
    n_ledger = ledger.program_count("engine")
    res = {"context": context}

    def owned(label, cluster):
        for door in cluster.doors:
            st = door.engine.compile_stats()
            progs = set(st["programs"])
            graphs = sum(v for k, v in st.items() if k.endswith("_graph_entries"))
            if not progs <= alone_programs or graphs != len(progs):
                fail(f"cluster {label}: programs {sorted(progs)} ({graphs} graphs) beyond the "
                     f"engine alone's {sorted(alone_programs)}")
        if ledger.program_count("engine") != n_ledger:
            fail(f"cluster {label}: {ledger.program_count('engine') - n_ledger} programs "
                 f"ledgered anew")

    for name in ROUTER_PASSES:
        cluster = _Cluster(make, "prefix_affinity" if name == "warm" else name, warm)
        try:
            num = _cluster_pass(torch, transformer, params, cluster, prompts, golden, name)
            owned(name, cluster)
            if name == "prefix_affinity":
                failures = _cluster_failures(torch, transformer, params, cluster, prompts,
                                             golden, faults, owned, smi)
                status, text = _http(cluster.port, "GET", "/metrics")
                url = f"http://127.0.0.1:{cluster.port}/metrics"
                rcs, outs = [], []
                for argv in ([url], [url, "--json"]):
                    out = io.StringIO()
                    with contextlib.redirect_stdout(out):
                        rcs.append(doctor.main(argv))
                    outs.append(out.getvalue())
        finally:
            cluster.close()
        if name != "warm" and num["retries"]:
            fail(f"cluster {name}: {num['retries']} retries in a clean pass")
        res[name] = {k: v for k, v in num.items() if k != "programs"}
    aff, rr = res["prefix_affinity"], res["round_robin"]
    for f in range(ROUTER_FAMILIES):
        where = {aff["placed"][j] for j in range(len(prompts)) if fam[j] == f}
        if len(where) != 1:
            fail(f"cluster prefix_affinity: family {f} landed on {sorted(where)}")
    if not aff["hit_rate"] > rr["hit_rate"]:
        fail(f"cluster: affinity hit rate {aff['hit_rate']:.4f} not above round-robin's "
             f"{rr['hit_rate']:.4f}")
    ratio = aff["ttft_ms"]["mean"] / rr["ttft_ms"]["mean"]
    res["ttft_vs_roundrobin"] = ratio
    for name in ROUTER_PASSES:
        n = res[name]
        print(f"cluster {name} ({context}): {n['completed']}/{len(prompts)} requests over 2 "
              f"replicas, one after another: prefix hit rate {n['hit_rate']:.4f} ({n['hits']} "
              f"of {n['hits'] + n['misses']} blocks), mean TTFT {n['ttft_ms']['mean']:.2f} ms "
              f"(client clock; each "
              f"{[round(v, 1) for v in n['ttft_ms']['each']]}; cold "
              f"{n['ttft_ms'].get('cold', float('nan')):.2f}, warm "
              f"{n['ttft_ms'].get('warm', float('nan')):.2f} over {n['ttft_ms']['n_warm']} warm), "
              f"{n['tokens_per_s']:.1f} "
              f"generated tokens/sec ({n['tokens']} in {n['wall_s']:.3f} s), retries "
              f"{n['retries']}, replicas used {n['replicas_used']} ({n['placed']}), affinity "
              f"blocks {n['affinity_blocks']}, programs per replica "
              f"{n['programs_per_replica']} (graphs {n['graphs']}; the engine alone's "
              f"{len(alone_programs)}, none ledgered anew); {n['equal']} of {len(prompts)} "
              f"equal the engine alone's (near-ties {n['near_ties']}); {smi}")
    print(f"cluster ({context}): affinity hit rate {aff['hit_rate']:.4f} vs round-robin "
          f"{rr['hit_rate']:.4f}; mean TTFT affinity {aff['ttft_ms']['mean']:.2f} ms vs "
          f"round-robin {rr['ttft_ms']['mean']:.2f} ms: ratio {ratio:.4f}; {smi}")
    res["failures"] = failures
    report = json.loads(outs[1]) if rcs[1] == 0 else None
    if status != 200 or "znicz_router_requests_total" not in text.decode() or rcs != [0, 0] or (
            report is None or report["verdict"] != "no-data"):
        fail(f"cluster doctor: /metrics {status}, the doctor answered {rcs}: {outs}")
    res["doctor"] = {"rc": rcs, "verdict": report["verdict"]}
    print(f"cluster doctor: python -m znicz_tpu_torch.observability.doctor {url} answered "
          f"{rcs[0]} ({outs[0].splitlines()[0]}), with --json {rcs[1]} and a JSON object "
          f"(verdict {report['verdict']}, anomalies active {report['anomalies']['active']})")
    del params
    torch.cuda.empty_cache()
    return res


def _cluster_failures(torch, transformer, params, cluster, prompts, golden, faults, owned, smi):
    """The failure paths through the router on the card, each ending golden
    or typed, the pools swept after it."""
    import gc
    import http.client

    from znicz_tpu_torch.services.engine import prefix_block_keys
    from znicz_tpu_torch.services.errors import RejectedError

    out = {}
    router, reg = cluster.router, cluster.router.registry

    def served(label, j, *, retries, replica=None):
        t0 = time.perf_counter()
        r = _http_generate(cluster.port, prompts[j], ROUTER_BUDGET)
        r["wall_s"] = time.perf_counter() - t0
        if r.get("status") != 200 or r["done"] is None or (
                r["done"]["finish_reason"] not in ("eos", "budget")):
            fail(f"cluster {label}: {r}")
        if r["done"]["router"]["retries"] != retries or (
                replica is not None and r["done"]["router"]["replica"] != replica):
            fail(f"cluster {label}: router {r['done']['router']}, want {retries} retries"
                 + (f" on {replica}" if replica else ""))
        equal, ties = _held_to(torch, transformer, params, f"cluster {label}",
                               [list(prompts[j]) + r["tokens"]], [golden[j]])
        r["spliced_differs"] = 1 - equal
        r["near_ties"] = ties
        cluster.settle(f"cluster {label}")
        return r

    # a refused connect: the next-best replica serves
    faults.inject("router.connect", times=1)
    r = served("connect", 0, retries=1)
    out["connect"] = {"wall_s": r["wall_s"], "ttft_s": r["ttft_s"]}

    # a replica's engine crashes after its first decode chunk streamed: its
    # typed error is re-routed, the other replica recomputes the delivered
    # prefix, which the router skips unread
    base = served("crash baseline", 1, retries=0)
    collect, collects = gc.collect, []

    def timed_collect(*args):
        # the restart's full collection holds the interpreter lock: with
        # both replicas and the router in this process it stalls them all
        t0 = time.perf_counter()
        try:
            return collect(*args)
        finally:
            collects.append((time.perf_counter() - t0) * 1e3)

    faults.inject("engine.decode_step", exc=RuntimeError("injected replica crash"), after=1,
                  times=1)
    gc.collect = timed_collect
    try:
        r = served("crash", 1, retries=1)
    finally:
        gc.collect = collect
        faults.clear("engine.decode_step")
    restarts = sorted(d.stats()["watchdog_restarts"] for d in cluster.doors)
    if restarts != [0, 1]:
        fail(f"cluster crash: watchdog restarts {restarts}")
    owned("crash", cluster)
    out["crash"] = {"wall_s": r["wall_s"], "baseline_wall_s": base["wall_s"],
                    "spliced_differs": r["spliced_differs"], "near_ties": r["near_ties"],
                    "replica": r["done"]["router"]["replica"],
                    "restarts": restarts, "gc_collect_ms": collects}

    # one replica's server shut down: the heartbeat ejects it, its family
    # routes to the other, a new server on the same engine is re-admitted
    j = 2
    home = router.rank(prefix_block_keys(prompts[j], SERVE_BLOCK))[0][0].instance
    i = int(home.split("-")[1])
    port = int(reg.get(home).port)
    cluster.kill(i)
    states = [reg.probe_all()[home] for _ in range(reg.dead_after)]
    if states[-1] != "dead" or router.affinity.stats()["keys_per_replica"].get(home):
        fail(f"cluster eject: {home} went {states}; affinity {router.affinity.stats()}")
    other = f"replica-{1 - i}"
    r = served("ejected", j, retries=0, replica=other)
    cluster.revive(i, port)
    back = reg.probe_all()[home]
    if back != "healthy" or reg.get(home).readmissions != 1:
        fail(f"cluster readmit: {home} {back}, readmissions {reg.get(home).readmissions}")
    out["eject"] = {"replica": home, "states": states, "served_by": other, "readmitted": back,
                    "wall_s": r["wall_s"]}
    served("readmitted", j + ROUTER_FAMILIES, retries=0)

    # both replicas failing mid-stream: a typed error done record, no hang
    faults.inject("router.stream")
    t0 = time.perf_counter()
    r = _http_generate(cluster.port, prompts[3], ROUTER_BUDGET)
    dead_s = time.perf_counter() - t0
    faults.clear("router.stream")
    if r.get("status") != 200 or r["done"] is None or r["done"]["finish_reason"] != "error":
        fail(f"cluster both failing: {r}")
    cluster.settle("cluster both failing")
    out["both_failing"] = {"finish_reason": "error", "wall_s": dead_s,
                           "error": r["done"]["error"][:120]}

    # a saturated fleet: every replica sheds, the router answers 503
    for door in cluster.doors:
        door.max_pending = 1
    faults.inject("frontdoor.slow_tick", delay=0.5)
    parked = []  # (stream index, handle): the stream's prompts keep to its programs
    try:
        time.sleep(0.1)  # both engine threads inside a sleeping tick
        for door in cluster.doors:
            for k in range(3):
                try:
                    parked.append((k, door.submit(prompts[k], ROUTER_BUDGET)))
                except RejectedError:
                    break
                if len(door._pending) >= door.max_pending:
                    break
        conn = http.client.HTTPConnection("127.0.0.1", cluster.port, timeout=300)
        try:
            conn.request("POST", "/generate", body=json.dumps(
                {"prompt": prompts[4].tolist(), "max_new_tokens": ROUTER_BUDGET}))
            resp = conn.getresponse()
            status, retry_after, body = resp.status, resp.getheader("Retry-After"), resp.read()
        finally:
            conn.close()
    finally:
        faults.clear("frontdoor.slow_tick")
    comps = [(k, h.result(timeout=300.0)) for k, h in parked]
    body = json.loads(body)
    if status != 503 or body.get("reason") != "fleet_saturated" or retry_after is None or any(
            c.finish_reason not in ("eos", "budget") for _, c in comps):
        fail(f"cluster saturated: {status} {body} Retry-After {retry_after}; parked "
             f"{[c.finish_reason for _, c in comps]}")
    _held_to(torch, transformer, params, "cluster parked", [c.tokens.tolist() for _, c in comps],
             [golden[k] for k, _ in comps])
    for door in cluster.doors:
        door.max_pending = 2 * ROUTER_FAMILIES * ROUTER_PER_FAMILY
    cluster.settle("cluster saturated")
    owned("failure paths", cluster)
    out["saturated"] = {"status": status, "reason": body["reason"], "retry_after": retry_after,
                        "parked": len(parked)}
    print(f"cluster failure paths: router.connect armed once: served golden after 1 retry "
          f"({out['connect']['wall_s'] * 1e3:.1f} ms); engine.decode_step armed after one "
          f"chunk on the serving replica: re-routed to {out['crash']['replica']}, the delivered "
          f"prefix skipped, the client's stream "
          f"{'the golden' if not out['crash']['spliced_differs'] else 'off the golden'} "
          f"(near-ties {out['crash']['near_ties']}) in {out['crash']['wall_s'] * 1e3:.1f} ms "
          f"against {out['crash']['baseline_wall_s'] * 1e3:.1f} ms uninterrupted, watchdog "
          f"restarts {restarts} (the restart's gc.collect "
          f"{[round(v, 1) for v in collects]} ms, the interpreter lock held); {home}'s server shut down: the heartbeat saw {states}, its "
          f"family served golden by {other}, a new server on the same engine re-admitted "
          f"({back}); both replicas failing: a typed error done record in {dead_s:.3f} s; a "
          f"saturated fleet: {status} fleet_saturated with Retry-After {retry_after}, "
          f"{len(parked)} parked requests finished golden; the pools swept after each; {smi}")
    return out


# -- phase 30: data parallelism -------------------------------------------------

DP_STEPS = 10  # AlexNet train steps with and without the policy, held bitwise
DP_LM_STEPS = 3  # the mid LM's train steps, held within DP_LM_TOL
DP_LM_TOL = 1e-6  # of max |param|: the embedding's backward adds with atomics
DP_TIMED = 10  # timed steps a turn (after 2 warm-up), AlexNet
DP_TURNS = ("plain", "dp", "dp", "plain", "plain", "dp")  # timed turns, in this order
DP_UNSUP = {"train": 2000, "test": 500}  # the SOM's and RBM's data: 20 train steps at 100
DP_SCAN_EPOCHS = 3
DP_WAIT_S = 420  # a gloo worker's wait
DP_GLOO_TOL = {"mnist_loss": 1e-4, "som": 1e-5, "rbm": 1e-5}
DP_RBM = dict(b=100, valid=90, v=784, h=128, seed=5)  # configs[2]'s step, a masked tail
DP_POOL = (2560, 128)  # the pool-sharded run: rows, global batch (20 train steps)
# device copies as the trace names them: a CUDA graph's memcpy nodes run
# as memcpy32_post kernels, eager ones as DtoD memcpys
DEVICE_COPY = re.compile(r"^(?:memcpy32_post|Memcpy DtoD)")


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _dp_steps(torch, wf, n, counters=()):
    """``n`` synchronised train steps on the first train minibatch, each
    wrapper of ``counters`` set to 0 just before and read just after;
    returns (step seconds, launches)."""
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x = torch.as_tensor(mb.data, device="cuda")
    y = torch.as_tensor(wf._batch_target(mb), device="cuda")
    mask = torch.as_tensor(mb.mask, device="cuda")
    for _, fn in counters:
        fn.launches = 0
    step_s = []
    for _ in range(n):
        t0 = time.perf_counter()
        wf.train_step(x, y, mask)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return step_s, {name: fn.launches for name, fn in counters}


def _dp_pair(torch, label, make, counters, steps, tol=0.0):
    """The same workflow from one seed without and with the policy
    (``make(parallel)``), ``steps`` train steps each (``None``: one epoch);
    the params bitwise equal (``tol`` 0) or within ``tol`` of max |param|.
    Returns the workflows and the policy run's launches."""
    from znicz_tpu_torch.core import prng

    wfs, launches = {}, {}
    for key in ("plain", "dp"):
        prng.seed_all(1234)
        wf = make(key == "dp")
        wf.initialize(seed=1234)
        if steps is None:
            for _, fn in counters:
                fn.launches = 0
            wf.run_epoch()
            torch.cuda.synchronize()
            launches[key] = {name: fn.launches for name, fn in counters}
        else:
            launches[key] = _dp_steps(torch, wf, steps, counters)[1]
        wfs[key] = wf
    n_bad, worst = _differ(torch, wfs["plain"].state.params, wfs["dp"].state.params)
    scale = max(float(t.detach().abs().max()) for t in _leaves(wfs["plain"].state.params))
    hist = wfs["plain"].decision.history == wfs["dp"].decision.history
    print(f"dp {label}: with the policy (one NCCL rank) against without, "
          f"{'one epoch' if steps is None else f'{steps} train steps'}: {n_bad} tensors differ, "
          f"largest |diff| {worst:.3e} of max |param| {scale:.3e} (limit {tol} of it), "
          f"histories {'equal' if hist else 'DIFFER'}; launches {launches}")
    if worst > tol * scale or not hist or (tol == 0.0 and n_bad):
        fail(f"dp {label}: the one-rank policy's run is not the run without it")
    if launches["dp"] != launches["plain"]:
        fail(f"dp {label}: the policy's run launched {launches['dp']}, the plain "
             f"{launches['plain']}")
    return wfs, launches["dp"]


def _dp_turns(torch, wfs, n, label, smi, unit):
    """ms a train step with and without the policy: medians of ``n``
    synchronised steps after 2 warm-up, in turns (``DP_TURNS``)."""
    per = {"plain": [], "dp": []}
    for key in DP_TURNS:
        per[key].append(statistics.median(_dp_steps(torch, wfs[key], n + 2)[0][2:]) * 1e3)
    res = {k: statistics.median(v) for k, v in per.items()}
    res["dp_over_plain"] = res["dp"] / res["plain"]
    res["turns_ms"] = per
    print(f"dp {label}: ms a train step ({unit}), median of {n} after 2 warm-up, turns "
          f"{list(DP_TURNS)}: without the policy {per['plain']}, with it (one NCCL rank) "
          f"{per['dp']}; ratio {res['dp_over_plain']:.4f}; {smi}")
    return res


def phase_dp_nccl(torch, fa, lrn_kernel, khk, rbk, models, transformer, lm_loader, troot, smi):
    """Phase 30a: the production backend as a world of one NCCL rank."""
    import torch.distributed as dist

    from znicz_tpu_torch.parallel import DataParallel, make_mesh, multihost
    from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu_torch.workflow.standard import StandardWorkflow

    res, launches = {}, {}
    info = multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            fail(f"dp: multihost.initialize made a {dist.get_backend()} group on the card")
        dp = DataParallel(make_mesh())
        print(f"dp: one NCCL rank {info}; mesh {dp.mesh}; host collectives "
              f"{dp.host_collectives}")
        if dp.host_collectives or dp.group is None:
            fail("dp: the NCCL group stages through the host or is missing")
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True

        def policy(on):
            return {"parallel": dp} if on else {}

        # AlexNet at phase 4's geometry (batch 128, bf16, both LRN kernels)
        alexnet = models["alexnet"]
        lrn = (("lrn_fwd", lrn_kernel.lrn_forward), ("lrn_bwd", lrn_kernel.lrn_backward))
        wfs, got = _dp_pair(torch, "alexnet",
                            lambda on: alexnet.build_workflow(device="cuda", **policy(on)),
                            lrn, DP_STEPS)
        launches.update(got)
        if got != {"lrn_fwd": 2 * DP_STEPS, "lrn_bwd": 2 * DP_STEPS}:
            fail(f"dp alexnet: LRN launches {got} over {DP_STEPS} steps")
        res["alexnet"] = _dp_turns(torch, wfs, DP_TIMED, "alexnet", smi, "batch 128, bf16")
        del wfs
        torch.cuda.empty_cache()

        # the SOM (configs[4]) and the RBM (configs[2]) through their kernels
        for name, key, fn in (("kohonen", "kohonen_accumulate", khk.accumulate),
                              ("mnist_rbm", "rbm_cd", rbk.statistics)):
            getattr(troot, name).update({"loader": {"n_train": DP_UNSUP["train"],
                                                    "n_test": DP_UNSUP["test"]}})
            mod = models[name]
            _, got = _dp_pair(torch, name,
                              lambda on, mod=mod: mod.build_workflow(device="cuda", **policy(on)),
                              ((key, fn),), None)
            launches.update(got)
            if got[key] != DP_UNSUP["train"] // 100:
                fail(f"dp {name}: {got[key]} kernel launches in the epoch")

        # the mid LM at full width, f32 flash (3xTF32), lr 0.001
        from znicz_tpu_torch.nn import optimizer

        hyper = optimizer.HyperParams(learning_rate=0.001, gradient_moment=0.9)
        flash = tuple((n, getattr(fa, n)) for n in FLASH)
        wfs, got = _dp_pair(
            torch, "mid lm",
            lambda on: transformer.TransformerLMWorkflow(
                lm_loader, **LM_MID, attention="flash", hyper=hyper, device="cuda",
                **policy(on)),
            flash, DP_LM_STEPS, tol=DP_LM_TOL)
        launches.update(got)
        if got != dict.fromkeys(FLASH, LM_MID["n_layers"] * DP_LM_STEPS):
            fail(f"dp mid lm: flash launches {got}")
        res["lm"] = _dp_turns(torch, wfs, DP_LM_STEPS, "mid lm", smi, "batch 16 x T 2048, f32")
        del wfs
        torch.cuda.empty_cache()

        # the graph dispatch: MNIST at bench.py's mnist_epoch shape, its
        # captured step holding the NCCL all-reduces
        _f32_exact(torch)
        imgs, labels = _mnist_u8(SCAN_IMAGES, 1)
        n_steps = SCAN_IMAGES // SCAN_BATCH

        def mnist(dispatch):
            ld = FullBatchLoader({"train": imgs}, {"train": labels}, minibatch_size=SCAN_BATCH,
                                 normalization="range",
                                 normalization_kwargs={"scale": 255.0, "shift": -0.5},
                                 device_resident=True)
            return StandardWorkflow(
                ld, [{"type": "all2all_tanh", "->": {"output_sample_shape": 256}},
                     {"type": "softmax", "->": {"output_sample_shape": 10}}],
                decision_config={"max_epochs": 10000},
                default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
                epoch_dispatch=dispatch, device="cuda", parallel=dp,
                name=f"MnistDP-{dispatch}")

        from znicz_tpu_torch.core import prng

        wfs, _ = _scan_runs(torch, prng, mnist, "dp mnist", epochs=DP_SCAN_EPOCHS)
        from torch.profiler import ProfilerActivity, profile

        # a one-rank all-reduce in place launches no device work (NCCL
        # returns at once), so the collectives show on the host: the
        # capture calls c10d's all-reduce (the count, the gradients) and a
        # replay calls nothing; the device copies a replay makes beside the
        # same graph's without the policy are the flatten's
        prng.seed_all(3)
        fresh, plain = mnist("scan"), mnist("scan")
        plain.parallel = None
        for wf in (fresh, plain):
            wf.initialize(seed=3)
        plain.run_epoch()  # its capture
        calls, copies = {}, {}
        for key, wf in (("capture", fresh), ("replays", fresh), ("plain", plain)):
            # no device tracing across the capture itself
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if key != "capture" else [])
            with profile(activities=acts) as prof:
                wf.run_epoch()
                torch.cuda.synchronize()
            calls[key] = copies[key] = 0
            for e in prof.key_averages():
                if e.key == "c10d::allreduce_":
                    calls[key] += e.count
                elif (e.device_type == torch.autograd.DeviceType.CUDA
                      and DEVICE_COPY.search(e.key)):
                    copies[key] += e.count
        print(f"dp mnist: c10d all-reduce calls on the host: {calls['capture']} in the first "
              f"epoch (2 eager warm-up, 2 captured, 2 at the epoch's end), {calls['replays']} "
              f"in a replayed one of {n_steps} replays (the epoch's end); device copies "
              f"(graph memcpy nodes, DtoD memcpys) a replayed epoch {copies['replays']} "
              f"against {copies['plain']} without the policy")
        if calls["capture"] != 6 or calls["replays"] != 2:
            fail(f"dp mnist: c10d all-reduce calls {calls}: the capture must hold the "
                 "step's two, a replay must call none")
        res["scan"] = {"c10d_calls": calls, "device_copies": copies}
        del wfs
    finally:
        dist.destroy_process_group()
    torch.backends.cudnn.deterministic = False
    return launches, res


def _dp_gloo_work(torch, out_dir, rank, parallel):
    """Phase 30b's runs on one rank (``parallel`` a two-rank gloo policy) or
    in one process (None), on the card; returns their results and writes
    the SOM's weights and the RBM's update to ``out_dir``."""
    import numpy as np

    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root as troot
    from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu_torch.models import kohonen, mnist
    from znicz_tpu_torch.ops.kernels import kohonen as khk, rbm as rbk
    from znicz_tpu_torch.parallel import make_mesh
    from znicz_tpu_torch.workflow.standard import StandardWorkflow

    _f32_exact(torch)
    torch.backends.cudnn.deterministic = True
    kw = {} if parallel is None else {"parallel": parallel}
    tag = "one" if parallel is None else f"rank{rank}"
    res = {}
    prng.seed_all(1234)
    wf = mnist.build_workflow(device="cuda", decision_config={"max_epochs": 3},
                              snapshot_dir=os.path.join(out_dir, f"snap_{tag}"), **kw)
    wf.initialize(seed=1234)
    res["mnist"] = [{s: {k: m[k] for k in ("loss", "n_err")} for s, m in e.items()
                     if isinstance(m, dict) and "loss" in m} for e in wf.run().history]
    res["mnist_scan_auto"] = wf._use_epoch_scan()
    troot.kohonen.update({"loader": {"n_train": DP_UNSUP["train"], "n_test": DP_UNSUP["test"]}})
    prng.seed_all(1234)
    wf = kohonen.build_workflow(device="cuda", **kw)
    wf.initialize(seed=1234)
    khk.accumulate.launches = 0
    wf.run_epoch()
    res["kohonen_launches"] = khk.accumulate.launches
    np.save(os.path.join(out_dir, f"som_{tag}.npy"), wf.state.params["weights"].cpu().numpy())
    if parallel is not None:
        case = np.load(os.path.join(out_dir, "rbm_case.npz"))
        rows = slice(rank * DP_RBM["b"] // 2, (rank + 1) * DP_RBM["b"] // 2)
        params = {k: torch.as_tensor(case[k], device="cuda") for k in ("weights", "vbias",
                                                                       "hbias")}
        rbk.statistics.launches = 0
        new, err = rbk.cd_step(params, torch.as_tensor(case["v0"][rows], device="cuda"),
                               rbk.seed_tensor(DP_RBM["seed"], "cuda"), learning_rate=0.1,
                               mask=torch.as_tensor(case["mask"][rows], device="cuda"),
                               mesh=make_mesh())
        res["rbm_launches"] = rbk.statistics.launches
        np.savez(os.path.join(out_dir, f"rbm_{tag}.npz"), err=err.cpu().numpy(),
                 **{k: v.cpu().numpy() for k, v in new.items()})
        # the pool-sharded resident pool: this rank's device holds half the rows
        imgs, labels = _mnist_u8(DP_POOL[0], 2)
        ld = FullBatchLoader({"train": imgs}, {"train": labels}, minibatch_size=DP_POOL[1],
                             normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5},
                             device_resident=True, pool_sharded=True)
        layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 256}},
                  {"type": "softmax", "->": {"output_sample_shape": 10}}]
        wf = StandardWorkflow(ld, layers, device="cuda", parallel=parallel)
        wf.initialize(seed=1)
        pool = wf._ctx["pool"]
        res["pool"] = {"device": str(pool.device), "bytes": pool.numel() * pool.element_size(),
                       "bytes_all": int(imgs.nbytes),
                       "equal_shard": bool(torch.equal(pool.cpu(), torch.from_numpy(
                           imgs[rank * DP_POOL[0] // 2:(rank + 1) * DP_POOL[0] // 2]))),
                       "scan": wf._use_epoch_scan(),
                       "loss": wf.run_epoch()["summary"]["train"]["loss"]}
        try:
            wf = StandardWorkflow(ld, layers, device="cuda", parallel=parallel,
                                  epoch_dispatch="scan")
            wf.initialize(seed=1)
            wf.run_epoch()
            res["scan_refused"] = None
        except ValueError as exc:
            res["scan_refused"] = str(exc)
    return res


def dp_worker(rank, addr, out_dir):
    """A phase 30b rank: a gloo group of two ranks on this process's card."""
    import datetime

    import torch
    import torch.distributed as dist

    from znicz_tpu_torch.parallel import DataParallel, make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=DP_WAIT_S))
    try:
        dp = DataParallel(make_mesh())
        res = {"host_collectives": dp.host_collectives, "device": str(dp.device),
               **_dp_gloo_work(torch, out_dir, rank, dp)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def phase_dp_gloo(torch, smi):
    """Phase 30b: two ranks on the one card over gloo, against one process
    on the card."""
    import numpy as np

    from znicz_tpu_torch.ops.kernels import rbm as rbk

    out_dir = os.path.join(WORK_DIR, "dp")
    os.makedirs(out_dir, exist_ok=True)
    gen = np.random.default_rng(DP_RBM["seed"])
    b, v, h = DP_RBM["b"], DP_RBM["v"], DP_RBM["h"]
    case = {"v0": (gen.random((b, v)) > 0.5).astype(np.float32),
            "mask": (np.arange(b) < DP_RBM["valid"]).astype(np.float32),
            "weights": gen.normal(0.0, 0.01, (v, h)).astype(np.float32),
            "vbias": np.zeros(v, np.float32), "hbias": np.zeros(h, np.float32)}
    np.savez(os.path.join(out_dir, "rbm_case.npz"), **case)
    t0 = time.perf_counter()
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
                               addr, out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=DP_WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks_s = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:])
            fail(f"dp gloo: rank {r} exited with {p.returncode}")
    ranks = []
    for r in (0, 1):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    one = _dp_gloo_work(torch, out_dir, 0, None)
    print(f"dp gloo: two ranks on the card over gloo in {ranks_s:.1f} s "
          f"(their start included); {smi}")
    if not all(r["host_collectives"] for r in ranks) or ranks[0]["mnist"] != ranks[1]["mnist"]:
        fail("dp gloo: the ranks are not one gloo job with one history")
    worst_loss, worst_err = 0.0, 0
    for e, (got, want) in enumerate(zip(ranks[0]["mnist"], one["mnist"])):
        for s in want:
            worst_loss = max(worst_loss, abs(got[s]["loss"] - want[s]["loss"]) / want[s]["loss"])
            worst_err = max(worst_err, abs(got[s]["n_err"] - want[s]["n_err"]))
    print(f"dp gloo mnist: 3 epochs, two ranks against one process: largest relative loss "
          f"difference {worst_loss:.3e} (limit {DP_GLOO_TOL['mnist_loss']}), largest n_err "
          f"difference {worst_err} (limit 1); the step dispatch taken: "
          f"{not ranks[0]['mnist_scan_auto']}")
    if (len(ranks[0]["mnist"]) != len(one["mnist"]) or worst_loss > DP_GLOO_TOL["mnist_loss"]
            or worst_err > 1):
        fail("dp gloo: the two-rank MNIST run is not the one-process run")
    snaps = [os.listdir(os.path.join(out_dir, f"snap_rank{r}")) for r in (0, 1)]
    print(f"dp gloo mnist: snapshots by rank {snaps}")
    if not snaps[0] or snaps[1]:
        fail("dp gloo: a snapshot written by a rank other than the coordinator, or none")
    som = [np.load(os.path.join(out_dir, f"som_{t}.npy")) for t in ("rank0", "rank1", "one")]
    if not np.array_equal(som[0], som[1]):
        fail("dp gloo som: the ranks' maps differ")
    _rel_err("dp gloo som: two ranks against one process, weights", torch.from_numpy(som[0]),
             torch.from_numpy(som[2]), DP_GLOO_TOL["som"])
    # the RBM: the ranks' update against one built here from the two shards'
    # kernel statistics with seeds 2s and 2s + 1, summed
    params = {k: torch.as_tensor(case[k], device="cuda") for k in ("weights", "vbias", "hbias")}
    parts = [rbk.statistics(params, torch.as_tensor(case["v0"][r * b // 2:(r + 1) * b // 2],
                                                    device="cuda"),
                            torch.as_tensor(case["mask"][r * b // 2:(r + 1) * b // 2],
                                            device="cuda"),
                            rbk.seed_tensor(2 * DP_RBM["seed"] + r, "cuda"), cd_k=1)
             for r in (0, 1)]
    want, want_err = rbk._apply_update(params, *[x + y for x, y in zip(*parts)], 0.1)
    got = [np.load(os.path.join(out_dir, f"rbm_rank{r}.npz")) for r in (0, 1)]
    for k in want:
        if not np.array_equal(got[0][k], got[1][k]):
            fail(f"dp gloo rbm: the ranks' {k} differ")
        _rel_err(f"dp gloo rbm: two ranks against the summed shards, {k}",
                 torch.from_numpy(got[0][k]), want[k].cpu(), DP_GLOO_TOL["rbm"])
    _rel_err("dp gloo rbm: reconstruction error", torch.from_numpy(got[0]["err"]),
             want_err.cpu(), DP_GLOO_TOL["rbm"])
    pools = [r["pool"] for r in ranks]
    print(f"dp gloo pool: {pools}; scan refused under gloo: {ranks[0]['scan_refused']!r}")
    for p in pools:
        if (p["bytes"] * 2 != p["bytes_all"] or not p["equal_shard"] or p["scan"]
                or not p["device"].startswith("cuda") or not math.isfinite(p["loss"])):
            fail("dp gloo pool: a rank's pool is not its half on the card, or its epoch failed")
    if not ranks[0]["scan_refused"] or "gloo" not in ranks[0]["scan_refused"]:
        fail("dp gloo: epoch_dispatch='scan' under gloo on the card was not refused")
    launches = {"kohonen_accumulate": [r["kohonen_launches"] for r in ranks],
                "rbm_cd": [r["rbm_launches"] for r in ranks]}
    print(f"dp gloo: kernel launches by rank {launches}")
    if launches != {"kohonen_accumulate": [DP_UNSUP["train"] // 100] * 2, "rbm_cd": [1, 1]}:
        fail(f"dp gloo: kernel launches {launches}")
    return launches, {"seconds": ranks_s, "mnist_loss_rel": worst_loss, "pool": pools}


# -- phase 31: tensor and expert parallelism ------------------------------------

TP_WAIT_S = 600  # a gloo rank's wait
# cuts of phase 31 (gloo stages every collective through the host; widths
# are never cut): AlexNet's batch 128 -> 32 (2 epochs of 2 train steps); the
# mid LM's batch 16 -> 2 (1 epoch of 3 train steps); the MoE LM's depth 12 -> 2
TP_ALEXNET = dict(n=64, batch=32, epochs=2)
TP_LM = dict(n=6, batch=2)
TP_MOE_LAYERS = 2
TP_TIMED = 3  # timed train steps a run (after 1 warm-up), and as many with the collectives timed
# relative limits against one process.  AlexNet's epoch-mean losses in
# bf16 within 1e-3 (~30x the 3.4e-5 measured), in f32 within 1e-4; in f32
# each leaf's change over the run, ||d_tp - d_one|| / ||d_one||, within
# TP_CHANGE_FACTOR times the same for one process with cuDNN off, plus
# 1e-5 (f32 sums in other orders grow from ~1e-7 at the head to ~3e-3 at
# conv1 through the pooling windows' near-ties; a partial sum missed or
# doubled moves it by O(1); bf16's is read, not held); the LMs and the
# conv net within 1e-4, the SOM's and the RBM's params 1e-5
TP_TOL = {"alexnet": 1e-3, "alexnet_f32": 1e-4, "alexnet_change": 1e-5, "lm": 1e-4,
          "moe": 1e-4, "conv": 1e-4, "som": 1e-5, "rbm": 1e-5}
TP_CHANGE_FACTOR = 10
TP_PROMPT = (2, 16, 8)  # generate(): rows, prompt length, new tokens
# tests/test_multihost.py's two-host TP conv net, on a (data=2, model=2) mesh
TP_CONV = [
    {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 5, "ky": 5}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "conv_relu", "->": {"n_kernels": 16, "kx": 5, "ky": 5}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]


def _collective_seconds(torch):
    """Wrap ``torch.distributed``'s ``all_reduce``, ``all_gather``,
    ``all_gather_into_tensor`` and ``all_to_all_single`` (the ring's and the
    pipeline's exchanges) so that each call is timed between two
    synchronisations; returns ``(acc,
    restore)``, ``acc["s"]`` the seconds summed, ``acc["n"]`` the calls."""
    import torch.distributed as dist

    acc = {"s": 0.0, "n": 0}
    orig = {name: getattr(dist, name) for name in ("all_reduce", "all_gather",
                                                    "all_gather_into_tensor",
                                                    "all_to_all_single")}

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc["s"] += time.perf_counter() - t0
            acc["n"] += 1
            return out
        return call

    for name, fn in orig.items():
        setattr(dist, name, timed(fn))

    def restore():
        for name, fn in orig.items():
            setattr(dist, name, fn)

    return acc, restore


def _tp_timed(torch, wf, parallel, n=TP_TIMED):
    """ms a train step: the median of ``n`` synchronised steps after a
    warm-up; under a policy, as many again with every collective timed
    (its wall share of those steps)."""
    step_s, _ = _dp_steps(torch, wf, n + 1)
    out = {"step_ms": statistics.median(step_s[1:]) * 1e3}
    if parallel is not None:
        acc, restore = _collective_seconds(torch)
        try:
            timed_s, _ = _dp_steps(torch, wf, n)
        finally:
            restore()
        out["collective_share"] = acc["s"] / sum(timed_s)
        out["collectives_a_step"] = acc["n"] / n
    return out


def _tp_runs(torch, out_dir, parallel):
    """Phase 31's (data=1, model=2) runs on one rank (``parallel`` its
    policy) or in one process (None), on the card: AlexNet (cnn_tp_rules),
    the mid LM (flash, then generate()) and the MoE LM in both dispatches.
    Returns each run's losses, launches and times; the rank at model
    position 0 writes the LM's gathered params for the generate check."""
    import numpy as np

    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu_torch.models import alexnet
    from znicz_tpu_torch.nn import optimizer
    from znicz_tpu_torch.ops.kernels import attention as fa, lrn as lrn_kernel
    from znicz_tpu_torch.parallel import DataParallel
    from znicz_tpu_torch.workflow import transformer

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    _f32_exact(torch)
    kw = {} if parallel is None else {"parallel": parallel}
    res = {}
    # AlexNet at full width (1000 classes), both norms' LRN kernels; its
    # policy has tp=True, so the workflow picks cnn_tp_rules on its own.  In
    # bf16 (its main path: launches, times) and in f32, whose changes of
    # each leaf are held to one process's; one process also runs f32 with
    # cuDNN off (im2col products: another summation order), the floor the
    # change's difference is held to
    gen = np.random.default_rng(31)
    imgs = gen.integers(0, 256, (TP_ALEXNET["n"], 227, 227, 3), dtype=np.uint8)
    labels = gen.integers(0, 1000, TP_ALEXNET["n"]).astype(np.int32)
    lrn = (("lrn_fwd", lrn_kernel.lrn_forward), ("lrn_bwd", lrn_kernel.lrn_backward))
    runs = ["bfloat16", "float32"] + (["floor"] if parallel is None else [])
    for run in runs:
        dtype = "float32" if run == "floor" else run
        torch.backends.cudnn.enabled = run != "floor"
        prng.seed_all(1234)
        ld = FullBatchLoader({"train": imgs}, {"train": labels},
                             minibatch_size=TP_ALEXNET["batch"], normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5},
                             device_convert=True)
        wf = _alexnet_resident(alexnet, ld, "step", 1000, compute_dtype=dtype, **(
            {} if parallel is None else {"parallel": DataParallel(parallel.mesh, tp=True)}))
        wf.initialize(seed=1234)
        start = [{k: v.detach().clone() for k, v in layer.items()} for layer in wf.state.params]
        for _, fn in lrn:
            fn.launches = 0
        losses = [wf.run_epoch()["summary"]["train"]["loss"]
                  for _ in range(TP_ALEXNET["epochs"])]
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in lrn}
        # each leaf's change over the epochs, whole (every rank takes part)
        change = [{k: v.detach() - start[i][k] for k, v in layer.items()}
                  for i, layer in enumerate(wf.state.params)]
        if parallel is not None:
            change = wf.parallel.gather_state(change)
        if parallel is None or parallel.model_index == 0:
            who = "floor" if run == "floor" else "one" if parallel is None else "tp"
            np.savez(os.path.join(out_dir, f"alexnet_change_{dtype}_{who}.npz"),
                     **{f"{i}.{k}": v.float().cpu().numpy() for i, layer in enumerate(change)
                        for k, v in layer.items()})
        del start, change
        key = {"bfloat16": "alexnet", "float32": "alexnet_f32", "floor": "alexnet_floor"}[run]
        res[key] = {"loss": losses, "launches": launches,
                    "sharded": sorted(wf.parallel.sharded) if parallel is not None else []}
        if dtype == "bfloat16":
            res[key].update(_tp_timed(torch, wf, parallel))
        del wf
        torch.cuda.empty_cache()
    torch.backends.cudnn.enabled = True
    # the mid LM at full width, f32 flash (3xTF32), lr 0.001
    hyper = optimizer.HyperParams(learning_rate=0.001, gradient_moment=0.9)
    tokens = np.random.default_rng(32).integers(0, LM_MID["vocab"], (TP_LM["n"], 2048))
    flash = tuple((n, getattr(fa, n)) for n in FLASH)

    def lm(label, cfg, **extra):
        prng.seed_all(1234)
        ld = FullBatchLoader({"train": tokens.astype(np.int32)}, minibatch_size=TP_LM["batch"])
        wf = transformer.TransformerLMWorkflow(
            ld, **cfg, attention="flash", hyper=hyper, device="cuda",
            tensor_parallel=parallel is not None, **kw, **extra)
        wf.initialize(seed=1234)
        for _, fn in flash:
            fn.launches = 0
        loss = wf.run_epoch()["summary"]["train"]["loss"]
        torch.cuda.synchronize()
        res[label] = {"loss": [loss], "launches": {n: fn.launches for n, fn in flash},
                      "flash_shape": list(fa.flash_fwd.last_shape or ()),
                      "wq": list(wf.state.params[1]["wq"].shape), **_tp_timed(torch, wf, parallel)}
        return wf

    wf = lm("lm", LM_MID)
    prompt = tokens[:TP_PROMPT[0], :TP_PROMPT[1]].astype(np.int32)
    res["lm"]["generate"] = wf.generate(prompt, max_new_tokens=TP_PROMPT[2]).cpu().tolist()
    if parallel is not None:
        whole = wf.parallel.gather_state(wf.state.params)  # every rank takes part
        if parallel.model_index == 0:
            np.savez(os.path.join(out_dir, "lm_params.npz"),
                     **{f"{i}.{k}": v.detach().cpu().numpy() for i, layer in enumerate(whole)
                        for k, v in layer.items()})
    res["lm_wf"] = wf if parallel is None else None
    del wf
    torch.cuda.empty_cache()
    for dispatch in MOE_DISPATCHES:
        lm(f"moe_{dispatch}", dict(LM_MOE, n_layers=TP_MOE_LAYERS), **MOE, moe_dispatch=dispatch)
    torch.cuda.empty_cache()
    return res


def _tp_mesh_work(torch, out_dir, rank):
    """Phase 31's (data=2, model=2) runs on one of four ranks: the TP conv
    net with the coordinator's snapshots, the SOM's epoch (params whole,
    psum over the data column) and one RBM CD step through the psum rule."""
    import numpy as np

    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root as troot
    from znicz_tpu_torch.loader import datasets
    from znicz_tpu_torch.models import kohonen
    from znicz_tpu_torch.ops.kernels import kohonen as khk, rbm as rbk
    from znicz_tpu_torch.parallel import DataParallel, make_mesh
    from znicz_tpu_torch.workflow.snapshotter import Snapshotter
    from znicz_tpu_torch.workflow.standard import StandardWorkflow

    _f32_exact(torch)
    torch.backends.cudnn.deterministic = True
    mesh = make_mesh(2, 2)
    res = {}
    prng.seed_all(55)
    wf = StandardWorkflow(datasets.mnist(n_train=128, n_test=0, minibatch_size=32, flat=False),
                          TP_CONV, decision_config={"max_epochs": 3},
                          default_hyper={"learning_rate": 0.05, "gradient_moment": 0.9},
                          device="cuda", parallel=DataParallel(mesh, tp=True))
    wf.snapshotter = Snapshotter(os.path.join(out_dir, "tp_snaps"), interval=1)
    wf.initialize(seed=55)
    res["conv_w0"] = list(wf.state.params[0]["weights"].shape)
    res["conv"] = [e["train"]["loss"] for e in wf.run().history]
    res["index"] = [wf.parallel.index, wf.parallel.model_index]
    troot.kohonen.update({"loader": {"n_train": DP_UNSUP["train"], "n_test": DP_UNSUP["test"]}})
    prng.seed_all(1234)
    wf = kohonen.build_workflow(device="cuda", parallel=DataParallel(mesh, tp=True))
    wf.initialize(seed=1234)
    khk.accumulate.launches = 0
    wf.run_epoch()
    res["kohonen_launches"] = khk.accumulate.launches
    res["som_sharded"] = sorted(wf.parallel.sharded)
    np.save(os.path.join(out_dir, f"tp_som_rank{rank}.npy"), wf.state.params["weights"].cpu().numpy())
    case = np.load(os.path.join(out_dir, "rbm_case.npz"))
    d = res["index"][0]
    rows = slice(d * DP_RBM["b"] // 2, (d + 1) * DP_RBM["b"] // 2)
    params = {k: torch.as_tensor(case[k], device="cuda") for k in ("weights", "vbias", "hbias")}
    rbk.statistics.launches = 0
    new, err = rbk.cd_step(params, torch.as_tensor(case["v0"][rows], device="cuda"),
                           rbk.seed_tensor(DP_RBM["seed"], "cuda"), learning_rate=0.1,
                           mask=torch.as_tensor(case["mask"][rows], device="cuda"), mesh=mesh)
    res["rbm_launches"] = rbk.statistics.launches
    np.savez(os.path.join(out_dir, f"tp_rbm_rank{rank}.npz"), err=err.cpu().numpy(),
             **{k: v.cpu().numpy() for k, v in new.items()})
    return res


def tp_worker(rank, world, addr, out_dir):
    """A phase 31 rank: a gloo group of ``world`` ranks on this process's
    card, the (1, 2) runs for two ranks, the (2, 2) runs for four."""
    import datetime

    import torch
    import torch.distributed as dist

    from znicz_tpu_torch.parallel import DataParallel, make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TP_WAIT_S))
    try:
        if world == 2:
            dp = DataParallel(make_mesh(1, 2))
            res = {"host_collectives": dp.host_collectives, **_tp_runs(torch, out_dir, dp)}
            res.pop("lm_wf")
        else:
            res = _tp_mesh_work(torch, out_dir, rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"tp{world}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _tp_ranks(world, out_dir):
    """Start ``world`` phase 31 ranks (this script with ``--tp-rank``) and
    wait for them; any rank's failure fails the phase.  Returns their
    results and the seconds they took."""
    t0 = time.perf_counter()
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
                               str(world), addr, out_dir], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=TP_WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:])
            fail(f"tp: rank {r} of {world} exited with {p.returncode}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"tp{world}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, time.perf_counter() - t0


def _rel_list(got, want):
    return max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))


def _tp_lrn_checks(torch):
    """The LRN pair against its plain version at the shapes AlexNet's two
    norms have at phase 31's batch (conv1's gathered output and conv2's
    summed one: whole channels), f32 and bf16."""
    from znicz_tpu_torch.ops.kernels import lrn as lrn_kernel

    args = (LRN["alpha"], LRN["beta"], LRN["k"], LRN["n"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    for tag, shape in ALEXNET_NORMS.items():
        shape = (TP_ALEXNET["batch"],) + shape[1:]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x, g = _lrn_inputs(torch, gen, shape, dtype)
            y = lrn_kernel.lrn_forward(x, *args)
            dx = lrn_kernel.lrn_backward(x, g, *args)
            torch.cuda.synchronize()
            compare(f"tp lrn_fwd {tag} {list(shape)}", y, lrn_kernel.lrn_reference(x, *args), dname)
            compare(f"tp lrn_bwd {tag} {list(shape)}", dx,
                    lrn_kernel.lrn_bwd_reference(x, g, *args), dname)


def phase_tp(torch, smi):
    """Phase 31: tensor and expert parallelism, two gloo ranks as (data=1,
    model=2) and four as (2, 2) on the one card, against one process on the
    card."""
    import numpy as np

    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.ops.kernels import rbm as rbk
    from znicz_tpu_torch.workflow.snapshotter import load_snapshot
    from znicz_tpu_torch.workflow.standard import StandardWorkflow

    out_dir = os.path.join(WORK_DIR, "tp")
    os.makedirs(out_dir, exist_ok=True)
    _tp_lrn_checks(torch)
    print(f"tp: cuts: AlexNet batch 128 -> {TP_ALEXNET['batch']} ({TP_ALEXNET['n']} images, "
          f"{TP_ALEXNET['epochs']} epochs); mid LM batch 16 -> {TP_LM['batch']} "
          f"({TP_LM['n']} sequences of 2048, one epoch); MoE LM depth 12 -> {TP_MOE_LAYERS}; "
          f"widths uncut")
    ranks, ranks_s = _tp_ranks(2, out_dir)
    one = _tp_runs(torch, out_dir, None)
    print(f"tp: two ranks (data=1, model=2) over gloo on the card in {ranks_s:.1f} s "
          f"(their start included); {smi}")
    if not all(r["host_collectives"] for r in ranks):
        fail("tp: the ranks are not one gloo job")
    res, launches = {"seconds": ranks_s}, {}
    for key in ("alexnet", "alexnet_f32", "lm", "moe_dense", "moe_capacity"):
        got = [r[key] for r in ranks]
        if got[0]["loss"] != got[1]["loss"]:
            fail(f"tp {key}: the ranks' losses differ: {got[0]['loss']} {got[1]['loss']}")
        tol = TP_TOL[key if key.startswith("alexnet") else key.split("_")[0]]
        rel = _rel_list(got[0]["loss"], one[key]["loss"])
        per = [g["launches"] for g in got]
        timed = "step_ms" in one[key]
        print(f"tp {key}: losses two ranks {got[0]['loss']} against one process "
              f"{one[key]['loss']}: largest relative difference {rel:.3e} (limit {tol}); "
              f"launches by rank {per}, one process {one[key]['launches']}" + (
                  f"; ms a train step one process {one[key]['step_ms']:.2f}, a rank "
                  f"{[g['step_ms'] for g in got]} (collectives "
                  f"{[round(g['collectives_a_step']) for g in got]} a step, their wall share "
                  f"{[round(g['collective_share'], 4) for g in got]})" if timed else "")
              + f"; {smi}")
        if rel > tol or not all(math.isfinite(x) for x in got[0]["loss"]):
            fail(f"tp {key}: two TP ranks are not one process")
        if any(p != one[key]["launches"] for p in per) or not all(all(p.values()) for p in per):
            fail(f"tp {key}: a rank's kernel launches {per} differ from one process's "
                 f"{one[key]['launches']} or are zero")
        res[key] = {"loss_rel": rel}
        if timed:
            res[key].update({"one_step_ms": one[key]["step_ms"],
                             "rank_step_ms": [g["step_ms"] for g in got],
                             "collective_share": [g["collective_share"] for g in got],
                             "collectives_a_step": [g["collectives_a_step"] for g in got]})
        if key != "alexnet_f32":  # the main path's launches (AlexNet's in bf16)
            for name, n in got[0]["launches"].items():
                launches.setdefault(name, {})[key] = [p[name] for p in per]
    print(f"tp alexnet: sharded leaves {ranks[0]['alexnet']['sharded']}")
    # conv1, conv3, conv5, fc6, fc7 column (weights and bias), conv2, conv4 row
    want_sharded = ["[0]['bias']", "[0]['weights']", "[10]['bias']", "[10]['weights']",
                    "[12]['bias']", "[12]['weights']", "[3]['weights']", "[6]['bias']",
                    "[6]['weights']", "[7]['weights']", "[8]['bias']", "[8]['weights']"]
    if ranks[0]["alexnet"]["sharded"] != want_sharded:
        fail("tp alexnet: cnn_tp_rules did not place conv1/3/5, fc6/7 column and conv2/4 row")
    # each leaf's change over the epochs, the ranks' gathered against one
    # process's, ||d_tp - d_one|| / ||d_one||; in f32 held to the floor, one
    # process's change with cuDNN off against with it; read in bf16
    def change_rel(a_name, b_name):
        a = np.load(os.path.join(out_dir, f"alexnet_change_{a_name}.npz"))
        b = np.load(os.path.join(out_dir, f"alexnet_change_{b_name}.npz"))
        out = {}
        for leaf in b.files:
            want, got = b[leaf].astype(np.float64), a[leaf].astype(np.float64)
            if got.shape != want.shape:
                fail(f"tp alexnet: leaf {leaf} {a_name} {got.shape}, {b_name} {want.shape}")
            out[leaf] = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        return out

    def fmt(rel):
        return {k: float(f"{v:.3e}") for k, v in rel.items()}

    tp32, floor32 = change_rel("float32_tp", "float32_one"), change_rel("float32_floor",
                                                                      "float32_one")
    tp16 = change_rel("bfloat16_tp", "bfloat16_one")
    limit = {k: TP_CHANGE_FACTOR * floor32[k] + TP_TOL["alexnet_change"] for k in floor32}
    print(f"tp alexnet_f32: each leaf's change over {TP_ALEXNET['epochs']} epochs, two ranks "
          f"against one process: {fmt(tp32)}; one process with cuDNN off against on (the "
          f"floor): {fmt(floor32)}; limit {TP_CHANGE_FACTOR} x the floor + "
          f"{TP_TOL['alexnet_change']}; largest ratio to the floor "
          f"{max(tp32[k] / max(floor32[k], 1e-30) for k in tp32):.3f}")
    print(f"tp alexnet: bf16 each leaf's change, two ranks against one process (read, not "
          f"held): {fmt(tp16)}")
    if (not all(math.isfinite(v) for v in [*tp32.values(), *floor32.values(), *tp16.values()])
            or any(tp32[k] > limit[k] for k in tp32)):
        fail("tp alexnet_f32: a leaf's change under TP is not one process's")
    res["alexnet_f32"]["change_rel"] = tp32
    res["alexnet_f32"]["change_floor"] = floor32
    res["alexnet"]["change_rel"] = tp16
    for key in ("lm", "moe_dense", "moe_capacity"):
        shapes = [r[key]["flash_shape"] for r in ranks]
        print(f"tp {key}: flash's last shape by rank {shapes} (one process "
              f"{one[key]['flash_shape']}), wq {ranks[0][key]['wq']}")
        if (any(s != [TP_LM["batch"], LM_T, LM_MID["n_heads"] // 2, 64] for s in shapes)
                or one[key]["flash_shape"][2:3] != [LM_MID["n_heads"]]):
            fail(f"tp {key}: the ranks' flash kernels did not run over the local heads at "
                 "phase 6's tp shape")
    # generate(): the ranks' tokens, against one process decoding the
    # gathered params the rank wrote
    wf = one.pop("lm_wf")
    saved = np.load(os.path.join(out_dir, "lm_params.npz"))
    with torch.no_grad():
        for i, layer in enumerate(wf.state.params):
            for k, v in layer.items():
                v.copy_(torch.from_numpy(saved[f"{i}.{k}"]))
    prompt = np.asarray(ranks[0]["lm"]["generate"], np.int32)[:, :TP_PROMPT[1]]
    want = wf.generate(prompt, max_new_tokens=TP_PROMPT[2]).cpu().tolist()
    differ = sum(a != b for ra, rb in zip(want, one["lm"]["generate"]) for a, b in zip(ra, rb))
    print(f"tp lm generate: the ranks' tokens {ranks[0]['lm']['generate']}; one process on the "
          f"gathered params {'equal' if want == ranks[0]['lm']['generate'] else want}; "
          f"{differ} tokens differ from the one-process-trained run's")
    if ranks[0]["lm"]["generate"] != ranks[1]["lm"]["generate"] or want != ranks[0]["lm"]["generate"]:
        fail("tp lm: generate() after TP training is not one process's decode")
    del wf, one
    torch.cuda.empty_cache()
    # the (data=2, model=2) mesh of four ranks
    gen = np.random.default_rng(DP_RBM["seed"])
    b, v, h = DP_RBM["b"], DP_RBM["v"], DP_RBM["h"]
    case = {"v0": (gen.random((b, v)) > 0.5).astype(np.float32),
            "mask": (np.arange(b) < DP_RBM["valid"]).astype(np.float32),
            "weights": gen.normal(0.0, 0.01, (v, h)).astype(np.float32),
            "vbias": np.zeros(v, np.float32), "hbias": np.zeros(h, np.float32)}
    np.savez(os.path.join(out_dir, "rbm_case.npz"), **case)
    four, four_s = _tp_ranks(4, out_dir)
    _f32_exact(torch)
    prng.seed_all(55)
    from znicz_tpu_torch.loader import datasets

    wf = StandardWorkflow(datasets.mnist(n_train=128, n_test=0, minibatch_size=32, flat=False),
                          TP_CONV, decision_config={"max_epochs": 3},
                          default_hyper={"learning_rate": 0.05, "gradient_moment": 0.9},
                          device="cuda")
    wf.initialize(seed=55)
    base = [e["train"]["loss"] for e in wf.run().history]
    rel = _rel_list(four[0]["conv"], base)
    snap = os.path.join(out_dir, "tp_snaps", "workflow_epoch2.pickle.gz")
    state, _ = load_snapshot(snap)
    kernel = list(np.asarray(state[0][0]["weights"]).shape)
    print(f"tp mesh (2, 2): four ranks in {four_s:.1f} s; conv losses {four[0]['conv']} against "
          f"one process {base}: largest relative difference {rel:.3e} (limit {TP_TOL['conv']}); "
          f"a rank's conv1 kernel {four[0]['conv_w0']}, the snapshot's {kernel}; "
          f"positions {[r['index'] for r in four]}")
    if (any(r["conv"] != four[0]["conv"] for r in four) or rel > TP_TOL["conv"]
            or four[0]["conv_w0"] != [5, 5, 1, 4] or kernel != [5, 5, 1, 8]
            or [r["index"] for r in four] != [[0, 0], [0, 1], [1, 0], [1, 1]]):
        fail("tp mesh: the four-rank TP conv run is not one process's, or its snapshot not whole")
    resumed = StandardWorkflow(datasets.mnist(n_train=128, n_test=0, minibatch_size=32,
                                              flat=False), TP_CONV, device="cuda")
    resumed.initialize(snapshot=snap)
    if list(resumed.state.params[0]["weights"].shape) != [5, 5, 1, 8]:
        fail("tp mesh: the TP snapshot does not load into a run without TP")
    som = [np.load(os.path.join(out_dir, f"tp_som_rank{r}.npy")) for r in range(4)]
    from znicz_tpu_torch.core.config import root as troot
    from znicz_tpu_torch.models import kohonen

    troot.kohonen.update({"loader": {"n_train": DP_UNSUP["train"], "n_test": DP_UNSUP["test"]}})
    prng.seed_all(1234)
    wf = kohonen.build_workflow(device="cuda")
    wf.initialize(seed=1234)
    wf.run_epoch()
    ref = wf.state.params["weights"].cpu().numpy()
    if any(not np.array_equal(s, som[0]) for s in som) or any(r["som_sharded"] for r in four):
        fail("tp mesh som: the ranks' maps differ or were sharded")
    _rel_err("tp mesh som: four ranks against one process, weights", torch.from_numpy(som[0]),
             torch.from_numpy(ref), TP_TOL["som"])
    params = {k: torch.as_tensor(case[k], device="cuda") for k in ("weights", "vbias", "hbias")}
    parts = [rbk.statistics(params, torch.as_tensor(case["v0"][d * b // 2:(d + 1) * b // 2],
                                                    device="cuda"),
                            torch.as_tensor(case["mask"][d * b // 2:(d + 1) * b // 2],
                                            device="cuda"),
                            rbk.seed_tensor(2 * DP_RBM["seed"] + d, "cuda"), cd_k=1)
             for d in (0, 1)]
    want, want_err = rbk._apply_update(params, *[x + y for x, y in zip(*parts)], 0.1)
    got = [np.load(os.path.join(out_dir, f"tp_rbm_rank{r}.npz")) for r in range(4)]
    for k in want:
        if any(not np.array_equal(g[k], got[0][k]) for g in got):
            fail(f"tp mesh rbm: the ranks' {k} differ")
        _rel_err(f"tp mesh rbm: four ranks against the two data rows' summed shards, {k}",
                 torch.from_numpy(got[0][k]), want[k].cpu(), TP_TOL["rbm"])
    unsup = {"kohonen_accumulate": [r["kohonen_launches"] for r in four],
             "rbm_cd": [r["rbm_launches"] for r in four]}
    print(f"tp mesh: unsupervised kernel launches by rank {unsup}")
    if unsup != {"kohonen_accumulate": [DP_UNSUP["train"] // 100] * 4, "rbm_cd": [1] * 4}:
        fail(f"tp mesh: unsupervised kernel launches {unsup}")
    launches.update(unsup)
    res["mesh"] = {"seconds": four_s, "conv_loss_rel": rel}
    return launches, res


SP_PP = dict(batch=4, steps=3, micro=4)  # phase 32's ranks: batch 16 -> 4, 3 train steps
SP_ONE_STEPS = 3  # 32a's train steps at batch 16
SP_PP_WAIT_S = 600  # a gloo rank's wait
# "change": each param leaf's change over the epoch, a rank's gathered
# against one process's, ||p_rank - p_one|| / ||p_one - p_init||; a wrong
# backward exchange (swapped dK/dV, a mispaired hop) moves a leaf by O(1)
SP_PP_TOL = {"ring_of_one": 1e-6, "ranks": 1e-4, "change": 1e-3}
SP_PP_WORLD = {"sp": 2, "pp": 2, "pptp": 4}
SP_PP_TIMED = 2  # timed train steps a run (after 1 warm-up), and as many with the exchanges timed


def _sp_pp_tokens(n):
    import numpy as np

    return np.random.default_rng(32).integers(0, LM_MID["vocab"], (n, LM_T)).astype(np.int32)


def _cpu_params(torch, tree):
    """``{keystr path: a CPU copy}`` of a params tree's leaves."""
    from znicz_tpu_torch.workflow.workflow import param_paths

    return {path: t.detach().to("cpu", copy=True) for path, t in param_paths(tree)}


def _sp_pp_lm(torch, label, batch, steps, keep_init=False, **kw):
    """The mid LM (f32 flash, lr 0.001) for one epoch of ``steps`` train
    steps of ``batch`` sequences, each flash wrapper's count set to 0 just
    before and read just after, and the (shape, causal) of every forward
    launch; with ``keep_init`` the initial params' tree on the CPU under
    ``"init"``.  Returns (workflow, results)."""
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu_torch.nn import optimizer
    from znicz_tpu_torch.ops.kernels import attention as fa
    from znicz_tpu_torch.workflow import transformer

    _f32_exact(torch)
    prng.seed_all(1234)
    ld = FullBatchLoader({"train": _sp_pp_tokens(batch * steps)}, minibatch_size=batch)
    wf = transformer.TransformerLMWorkflow(
        ld, **LM_MID, attention="flash", device="cuda",
        hyper=optimizer.HyperParams(learning_rate=0.001, gradient_moment=0.9), **kw)
    wf.initialize(seed=1234)
    init = ([{k: v.detach().to("cpu", copy=True) for k, v in layer.items()}
             for layer in wf.state.params] if keep_init else None)
    shapes = set()
    orig = fa._launch

    def logged(name, fn, x, tensors, causal, scale):  # every launch passes here
        if name == "flash_fwd":
            shapes.add((tuple(x.shape), bool(causal)))
        return orig(name, fn, x, tensors, causal, scale)

    for name in FLASH:
        getattr(fa, name).launches = 0
    fa._launch = logged
    try:
        loss = wf.run_epoch()["summary"]["train"]["loss"]
        torch.cuda.synchronize()
    finally:
        fa._launch = orig
    launches = {name: getattr(fa, name).launches for name in FLASH}
    res = {"label": label, "loss": loss, "launches": launches,
           "shapes": sorted([list(s), c] for s, c in shapes)}
    if keep_init:
        res["init"] = init
    return wf, res


def _gloo_card_check(torch, world, rank):
    """The two gloo collectives the ring and the pipeline move the card's
    tensors with, on this rank's card: ``all_gather_into_tensor`` and
    ``all_to_all_single`` at equal splits, each against the blocks every
    rank sent (gloo's point-to-point fails on CUDA tensors with ``writev:
    Bad address``, so nothing here uses it)."""
    import torch.distributed as dist

    x = torch.arange(8.0, device="cuda") + 100 * rank
    want = torch.cat([torch.arange(8.0, device="cuda") + 100 * r for r in range(world)])
    got = torch.empty(8 * world, device="cuda")
    dist.all_gather_into_tensor(got, x)
    routed = torch.empty(8 * world, device="cuda")
    dist.all_to_all_single(routed, x.repeat(world))
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(routed, want)):
        raise RuntimeError(f"gloo on the card: rank {rank} of {world} got {got.tolist()} "
                           f"(all_gather_into_tensor), {routed.tolist()} (all_to_all_single), "
                           f"want {want.tolist()}")


def _sp_pp_run(torch, kind, out_dir, rank):
    """Phase 32's run on one gloo rank: ``"sp"`` the ring over (data=2)
    with DataParallel, ``"pp"`` two stages over (1, 1, 2) with mesh=
    alone, ``"pptp"`` PP x TP over (1, 2, 2) with a snapshot saved and
    resumed; then ms a step and the exchanges' share of it."""
    from znicz_tpu_torch.parallel import DataParallel, make_mesh
    from znicz_tpu_torch.workflow.snapshotter import Snapshotter

    snap_dir = os.path.join(out_dir, "pp_snaps")
    if kind == "sp":
        mesh = make_mesh(2)
        kw = dict(sequence_parallel=True, mesh=mesh, parallel=DataParallel(mesh))
    elif kind == "pp":
        kw = dict(pipeline_parallel=True, mesh=make_mesh(1, 1, 2),
                  pipeline_microbatches=SP_PP["micro"])
    else:
        kw = dict(pipeline_parallel=True, tensor_parallel=True,
                  parallel=DataParallel(make_mesh(1, 2, 2)), pipeline_microbatches=SP_PP["micro"],
                  snapshotter=Snapshotter(snap_dir, "pplm", interval=1, compress=False))
    wf, res = _sp_pp_lm(torch, kind, SP_PP["batch"], SP_PP["steps"], **kw)
    res["position"] = [int(c) for c in wf.parallel.mesh.get_coordinate()]
    whole = wf.parallel.gather_state(wf.state.params)  # the run's params, whole
    if rank == 0:
        torch.save(_cpu_params(torch, whole), os.path.join(out_dir, f"{kind}_params.pt"))
    if kind == "pptp":
        # the coordinator's snapshot resumed on every rank: each stage
        # leaf, gathered whole, the run's
        kw.pop("snapshotter")
        import torch.distributed as dist

        from znicz_tpu_torch.core import prng

        dist.barrier()  # the coordinator has written the snapshot
        from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
        from znicz_tpu_torch.workflow import transformer

        prng.seed_all(1234)
        wf2 = transformer.TransformerLMWorkflow(
            FullBatchLoader({"train": _sp_pp_tokens(SP_PP["batch"] * SP_PP["steps"])},
                            minibatch_size=SP_PP["batch"]),
            **LM_MID, attention="flash", device="cuda", **kw)
        wf2.initialize(snapshot=os.path.join(snap_dir, "pplm_epoch0.pickle"))
        a = _leaves(whole)
        b = _leaves(wf2.parallel.gather_state(wf2.state.params))
        res["resumed_equal"] = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
        res["local_wq"] = list(wf.state.params["stages"][0]["wq"].shape)
        del wf2
        torch.cuda.empty_cache()
    res.update(_tp_timed(torch, wf, wf.parallel, SP_PP_TIMED))
    return res


def sp_pp_worker(rank, world, addr, out_dir, kind):
    """A phase 32 rank: a gloo group of ``world`` ranks on this process's
    card running ``kind``'s workload."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=SP_PP_WAIT_S))
    try:
        _gloo_card_check(torch, world, rank)
        res = _sp_pp_run(torch, kind, out_dir, rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{kind}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _sp_pp_ranks(kind, out_dir):
    """Start ``kind``'s ranks (this script with ``--sp-pp-rank``) and wait
    for them; any rank's failure fails the phase.  Returns their results
    and the seconds they took."""
    world = SP_PP_WORLD[kind]
    t0 = time.perf_counter()
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sp-pp-rank", str(r),
                               str(world), addr, out_dir, kind], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=SP_PP_WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in failed:
        print(f"sp_pp {kind}: rank {r}'s output:\n{outs[r][-4000:]}")
    if failed:
        fail(f"sp_pp {kind}: ranks {failed} of {world} exited with "
             f"{[procs[r].returncode for r in failed]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{kind}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, time.perf_counter() - t0


def _ring_of_one(torch, smi):
    """Phase 32a: one NCCL rank, the mid LM at batch 16 with
    ``sequence_parallel`` over ``make_mesh(1)`` (a ring of one) against
    the run without it: the merge's weights are exactly 1 and 0 and the
    lse cotangent cancels to 0, so the same bits are predicted."""
    import torch.distributed as dist

    from znicz_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            fail(f"sp_pp ring of one: multihost.initialize made a {dist.get_backend()} group")
        runs = {}
        for key, kw in (("plain", {}), ("ring", dict(sequence_parallel=True, mesh=make_mesh(1)))):
            runs[key] = _sp_pp_lm(torch, key, LM_B, SP_ONE_STEPS, **kw)
        n_bad, worst = _differ(torch, runs["plain"][0].state.params, runs["ring"][0].state.params)
        scale = max(float(t.detach().abs().max()) for t in _leaves(runs["plain"][0].state.params))
        got, want = runs["ring"][1], runs["plain"][1]
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        print(f"sp_pp ring of one (one NCCL rank, batch {LM_B}, {SP_ONE_STEPS} train steps): "
              f"loss {got['loss']} against {want['loss']} without the ring (relative "
              f"{rel:.3e}, limit {SP_PP_TOL['ring_of_one']}); {n_bad} param tensors differ, "
              f"largest |diff| {worst:.3e} of max |param| {scale:.3e}; launches "
              f"{got['launches']} against {want['launches']}; shapes {got['shapes']}; {smi}")
        if (rel > SP_PP_TOL["ring_of_one"] or worst > SP_PP_TOL["ring_of_one"] * scale
                or got["launches"] != want["launches"] or not math.isfinite(got["loss"])):
            fail("sp_pp: the ring of one is not the run without it")
        del runs
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"loss_rel": rel, "tensors_differ": n_bad, "largest_diff": worst,
            "launches": got["launches"]}


def phase_sp_pp(torch, smi):
    """Phase 32: sequence and pipeline parallelism.  32a one NCCL rank (a
    ring of one); 32b two gloo ranks on the card, the ring over (data=2)
    with DataParallel; 32c two as (1, 1, 2) with pipeline_parallel; 32d
    four as (1, 2, 2) with pipeline and tensor parallelism, a snapshot
    saved and resumed; each against one process on the card."""
    import numpy as np

    from znicz_tpu_torch.workflow import transformer
    from znicz_tpu_torch.workflow.snapshotter import load_snapshot

    out_dir = os.path.join(WORK_DIR, "sp_pp")
    os.makedirs(out_dir, exist_ok=True)
    res, launches = {"ring_of_one": _ring_of_one(torch, smi)}, {}
    print(f"sp_pp: cuts: the mid LM's batch 16 -> {SP_PP['batch']} on the gloo ranks "
          f"({SP_PP['steps']} train steps of {SP_PP['batch']} sequences of {LM_T}, "
          f"{SP_PP['micro']} microbatches of 1 under the pipeline); depth and widths uncut")
    one_wf, one = _sp_pp_lm(torch, "one", SP_PP["batch"], SP_PP["steps"], keep_init=True)
    one_init, one_final = one.pop("init"), [
        {k: v.detach().to("cpu", copy=True) for k, v in layer.items()}
        for layer in one_wf.state.params]
    one.update(_tp_timed(torch, one_wf, None, SP_PP_TIMED))
    del one_wf
    torch.cuda.empty_cache()
    n_layers, b, heads = LM_MID["n_layers"], SP_PP["batch"], LM_MID["n_heads"]
    steps, micro, hd = SP_PP["steps"], SP_PP["micro"], LM_MID["d_model"] // heads
    # each kernel's launches a rank, predicted: the ring of two runs the
    # diagonal block on both ranks and the past block on rank 1 only, a
    # layer a step; a stage runs its 6 layers on each of the 4 microbatches
    want = {
        "sp": [n_layers * steps, 2 * n_layers * steps],
        "pp": [n_layers // 2 * micro * steps] * 2,
        "pptp": [n_layers // 2 * micro * steps] * 4,
    }
    shapes = {
        "sp": [[[[b, LM_T // 2, heads, hd], True]],
               [[[b, LM_T // 2, heads, hd], False], [[b, LM_T // 2, heads, hd], True]]],
        "pp": [[[[1, LM_T, heads, hd], True]]] * 2,
        "pptp": [[[[1, LM_T, heads // 2, hd], True]]] * 4,
    }
    for kind in ("sp", "pp", "pptp"):
        ranks, secs = _sp_pp_ranks(kind, out_dir)
        losses = [r["loss"] for r in ranks]
        rel = abs(losses[0] - one["loss"]) / abs(one["loss"])
        per = [r["launches"] for r in ranks]
        print(f"sp_pp {kind}: {len(ranks)} gloo ranks on the card in {secs:.1f} s (their start "
              f"included), positions {[r['position'] for r in ranks]}; loss {losses} against "
              f"one process {one['loss']}: relative {rel:.3e} (limit {SP_PP_TOL['ranks']}); "
              f"flash launches by rank {per} (predicted {want[kind]} each kernel), one process "
              f"{one['launches']}; shapes launched by rank {[r['shapes'] for r in ranks]}; ms a "
              f"train step one process {one['step_ms']:.2f}, a rank "
              f"{[round(r['step_ms'], 2) for r in ranks]}, the exchanges' wall share "
              f"{[round(r['collective_share'], 4) for r in ranks]} "
              f"({[round(r['collectives_a_step']) for r in ranks]} a step); {smi}")
        if any(x != losses[0] for x in losses) or rel > SP_PP_TOL["ranks"] or not math.isfinite(
                losses[0]):
            fail(f"sp_pp {kind}: the ranks are not one process")
        if any(p != dict.fromkeys(FLASH, w) for p, w in zip(per, want[kind])):
            fail(f"sp_pp {kind}: flash launches {per}, predicted {want[kind]}")
        if [r["shapes"] for r in ranks] != shapes[kind]:
            fail(f"sp_pp {kind}: flash shapes {[r['shapes'] for r in ranks]}, want {shapes[kind]}")
        # each leaf's change over the epoch against one process's, the
        # pipelined runs in the stacked layout
        ref = [one_init, one_final]
        if kind != "sp":
            ref = [transformer.stack_lm_blocks(t, 2) for t in ref]
        init, final = (_cpu_params(torch, t) for t in ref)
        got = torch.load(os.path.join(out_dir, f"{kind}_params.pt"))
        if sorted(got) != sorted(final) or any(got[k].shape != final[k].shape for k in final):
            fail(f"sp_pp {kind}: the gathered params are not one process's tree")
        change = {k: float((got[k].double() - final[k].double()).norm()
                           / (final[k].double() - init[k].double()).norm().clamp_min(1e-30))
                  for k in final}
        worst = max(change, key=change.get)
        print(f"sp_pp {kind}: each of {len(change)} param leaves' change over the epoch, "
              f"rank 0's gathered against one process's: largest relative difference "
              f"{change[worst]:.3e} at {worst} (limit {SP_PP_TOL['change']}), median "
              f"{statistics.median(change.values()):.3e}")
        if not all(math.isfinite(v) and v <= SP_PP_TOL["change"] for v in change.values()):
            fail(f"sp_pp {kind}: a param leaf's change is not one process's")
        for name in FLASH:
            launches.setdefault(name, {})[kind] = [p[name] for p in per]
        res[kind] = {"seconds": secs, "loss_rel": rel, "change_rel": change[worst],
                     "one_step_ms": one["step_ms"],
                     "rank_step_ms": [r["step_ms"] for r in ranks],
                     "exchange_share": [r["collective_share"] for r in ranks],
                     "exchanges_a_step": [r["collectives_a_step"] for r in ranks]}
        if kind == "pptp":
            state, _ = load_snapshot(os.path.join(out_dir, "pp_snaps", "pplm_epoch0.pickle"))
            stages = state[0]["stages"]
            whole = {k: list(np.asarray(stages[0][k]).shape) for k in ("wq", "wo", "w_up")}
            print(f"sp_pp pptp: a rank's wq block {ranks[0]['local_wq']}; the snapshot's stage "
                  f"leaves {whole} ({len(stages)} blocks a stage); resumed on every rank "
                  f"equal to the run: {[r['resumed_equal'] for r in ranks]}")
            d = LM_MID["d_model"]
            if (whole != {"wq": [2, d, d], "wo": [2, d, d], "w_up": [2, d, 4 * d]}
                    or len(stages) != n_layers // 2 or ranks[0]["local_wq"] != [1, d, d // 2]
                    or not all(r["resumed_equal"] for r in ranks)):
                fail("sp_pp pptp: the pipelined snapshot is not whole or does not resume")
    return launches, res


LAUNCHER_SEED = 1234  # --random-seed: phase 20's seed
LAUNCHER_WAIT_S = 300  # a CLI subprocess's wait
NATIVE_SAMPLES = 4  # validation images through the native engine
# (rtol, atol): tighter than tests/test_native.py's 1e-3 / 1e-4 for conv stacks, whose
# atol is a tenth of a near-uniform 1000-class output after one epoch (p ~ 1e-3)
NATIVE_TOL = (1e-4, 1e-6)
EVAL_RTOL = 1e-4
SERVICE_EPOCHS = 2
# the supervised and preempted runs' workflow module: tests/test_torch_launcher.py's
# (tests/test_self_healing.py's for the JAX package), MNIST's MLP at 3 steps an epoch
LAUNCHER_CHILD = '''
import json
import os
import signal
import time

import torch

from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.workflow import StandardWorkflow


def _age():
    """This process's age in seconds (its start from /proc, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start / os.sysconf("SC_CLK_TCK")


# the interpreter's start, torch's import and the port's, to this module's load
LOADED_S = _age()

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 16}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]


def run(load, main):
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loader = datasets.mnist(n_train=192, n_test=32, minibatch_size=64)
    wf = load(
        StandardWorkflow, loader, LAYERS,
        decision_config={"max_epochs": 4},
        default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
    )
    t2 = time.perf_counter()
    sigterm_step = int(os.environ.get("ZNICZ_TEST_SIGTERM_STEP", "0"))
    if sigterm_step:
        def pol(base, step):
            if step == sigterm_step:
                os.kill(os.getpid(), signal.SIGTERM)
            return base
        wf.lr_policy = pol
    main()
    torch.cuda.synchronize()
    print("PHASES " + json.dumps({"start_to_module_s": LOADED_S, "cuda_init_s": t1 - t0,
                                  "build_s": t2 - t1, "main_s": time.perf_counter() - t2}))
    dec = wf.decision
    print("RESULT " + json.dumps({
        "epochs": dec.epoch,
        "history": [[h["train"]["n_err"], h["train"]["loss"]] for h in dec.history],
        "params": [{k: v.tolist() for k, v in layer.items()} for layer in wf.state.params],
    }))
'''
# phase 33f's config module: the MNIST model's builder wrapped so that the
# workflow it builds carries the epoch services, all writing under OUT
LAUNCHER_SERVICES = '''
import os
import sys

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.services import (
    AccumulatingPlotter, MarkdownReporter, MetricsCSVWriter, StatusWriter)

OUT = {out!r}
root.mnist.decision.update({{"max_epochs": {epochs}}})
_module = sys.modules["__znicz_workflow__"]
_build = _module.build_workflow


class _Seen:
    """Which files the services before it have written, each epoch."""

    def __init__(self):
        self.files = []

    def on_epoch(self, workflow, verdict):
        self.files.append(sorted(os.listdir(OUT)))


SEEN = _Seen()


def build_workflow(**overrides):
    wf = _build(**overrides)
    wf.services += [MetricsCSVWriter(OUT), StatusWriter(OUT), MarkdownReporter(OUT),
                    AccumulatingPlotter(OUT), SEEN]
    return wf


_module.build_workflow = build_workflow
'''


def _repo_root():
    return os.path.dirname(os.path.abspath(__file__))


def _cli(args, env_extra=None):
    """``python -m znicz_tpu_torch ARGS`` from the checkout's root: (the
    finished process, its wall seconds).  A run past its wait is killed,
    with whatever it started (a supervisor's child has its own session)."""
    env = {k: v for k, v in os.environ.items() if k != "ZNICZ_FAULTS"}
    env["PYTHONPATH"] = _repo_root()
    env.update(env_extra or {})
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "znicz_tpu_torch", *args], cwd=_repo_root(),
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=LAUNCHER_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        _kill_matching(args[0])
        err += f"\n(killed after {LAUNCHER_WAIT_S} s)"
    proc.seconds = time.perf_counter() - t0
    proc.out, proc.err = out, err
    return proc


def _timed(torch, fn, split, key):
    """``fn`` wrapped to add each call's seconds, to a card sync after it,
    to ``split[key]``."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            split[key] = split.get(key, 0.0) + time.perf_counter() - t0
    return timed


def _kill_matching(needle):
    """SIGKILL every process of this user whose command line holds
    ``needle`` (a supervisor's orphaned child)."""
    import signal

    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if needle.encode() in f.read():
                    os.kill(int(pid), signal.SIGKILL)
        except OSError:
            continue


def _cli_result(label, proc, rc=0):
    if proc.returncode != rc:
        print(proc.out[-4000:])
        print(proc.err[-6000:])
        fail(f"launcher {label}: exit {proc.returncode}, want {rc}")
    for line in reversed(proc.out.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    fail(f"launcher {label}: no RESULT line")


def _artifact(path):
    """A ZNICZT01 file: (header, {(layer, name): float32 array})."""
    import numpy as np

    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != b"ZNICZT01":
        fail(f"launcher export: {path} is not a ZNICZT01 artifact")
    n = int.from_bytes(blob[8:12], "little")
    header = json.loads(blob[12:12 + n])
    arrays = {}
    for i, layer in enumerate(header["layers"]):
        for name, meta in layer["params"].items():
            arrays[i, name] = np.frombuffer(blob, np.float32, count=meta["size"],
                                            offset=12 + n + meta["offset"]).reshape(meta["shape"])
    return header, arrays


def _supervised_and_preempted(out_dir):
    """Phase 33d-e in threads: an uninterrupted CLI run of the child module,
    the same under ``--supervise`` with a crash entering epoch 2, and a
    SIGTERM mid epoch 1 then ``--resume auto``; each a process (or a
    supervisor and its children) on the card."""
    from concurrent.futures import ThreadPoolExecutor

    child = os.path.join(out_dir, "wf_child.py")
    with open(child, "w") as f:
        f.write(LAUNCHER_CHILD)
    dirs = {k: os.path.join(out_dir, k) for k in ("base", "supervised", "preempted")}
    seed = [child, "--random-seed", "7"]

    def preempted():
        from znicz_tpu_torch.workflow.snapshotter import find_latest_valid

        first = _cli(seed + ["--snapshot-dir", dirs["preempted"]],
                     {"ZNICZ_TEST_SIGTERM_STEP": "4"})
        if first.returncode != 75:
            return first, None, None
        # the newest snapshot before the resumed run writes its own
        emergency = find_latest_valid(dirs["preempted"])
        return first, emergency, _cli(seed + ["--snapshot-dir", dirs["preempted"],
                                              "--resume", "auto"])

    pool = ThreadPoolExecutor(3)
    jobs = {
        "base": pool.submit(_cli, seed + ["--snapshot-dir", dirs["base"],
                                          "--snapshot-interval", "1"]),
        "supervised": pool.submit(
            _cli, seed + ["--snapshot-dir", dirs["supervised"], "--snapshot-interval", "1",
                          "--resume", "auto", "--supervise", "--max-restarts", "2",
                          "--restart-backoff", "0.1"],
            {"ZNICZ_FAULTS": "train.crash:after=2:times=1"}),
        "preempted": pool.submit(preempted),
    }
    pool.shutdown(wait=False)
    return jobs, dirs


def phase_launcher(torch, lrn_kernel, alexnet, model_lib, prng, smi):
    """Phase 33: the launcher, ``python -m znicz_tpu_torch``, on the card."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from znicz_tpu_torch import export as export_lib, launcher
    from znicz_tpu_torch.core.config import root as troot

    t_phase = time.perf_counter()
    out_dir = os.path.abspath(os.path.join(WORK_DIR, "launcher"))
    os.makedirs(out_dir, exist_ok=True)
    root = _repo_root()
    # the native engine's build and 33d-e's processes run beside 33a-c
    engine = os.path.join(root, "build", "native", "znicz_infer")
    os.makedirs(os.path.dirname(engine), exist_ok=True)
    gxx = ThreadPoolExecutor(1).submit(
        subprocess.run, ["g++", "-O2", "-std=c++17", os.path.join(root, "native", "znicz_infer.cc"),
                         "-o", engine], capture_output=True, text=True, timeout=300)
    jobs, dirs = _supervised_and_preempted(out_dir)
    parts = {}

    # 33a: AlexNet through the CLI, in this process
    alexnet_py = os.path.join(root, "znicz_tpu_torch", "models", "alexnet.py")
    snaps, artifact = os.path.join(out_dir, "snaps"), os.path.join(out_dir, "alexnet.znicz")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    t0 = time.perf_counter()
    # a fresh process's streams: as in 33c's process, --random-seed reseeds
    # them at initialize, after the build has drawn the data and weights
    prng.reset()
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    split = {}
    load, export = launcher.Launcher.load, launcher.Launcher._maybe_export

    def timed_load(self, *args, **kwargs):
        # the build; the workflow it returns gets its parts timed
        wf = _timed(torch, load, split, "build")(self, *args, **kwargs)
        wf.initialize = _timed(torch, wf.initialize, split, "initialize")
        wf.run = _timed(torch, wf.run, split, "run")
        wf.snapshotter.maybe_save = _timed(torch, wf.snapshotter.maybe_save, split, "snapshot")
        return wf

    launcher.Launcher.load = timed_load
    launcher.Launcher._maybe_export = _timed(torch, export, split, "export")
    try:
        cli = launcher.run_args([alexnet_py, "--random-seed", str(LAUNCHER_SEED), "--stop-after",
                                 "1", "--snapshot-dir", snaps, "--export", artifact])
        torch.cuda.synchronize()
    finally:
        launcher.Launcher.load, launcher.Launcher._maybe_export = load, export
        for s, h in handlers.items():
            signal.signal(s, h)
    launches = {"lrn_fwd": lrn_kernel.lrn_forward.launches,
                "lrn_bwd": lrn_kernel.lrn_backward.launches}
    parts["a_cli_s"] = time.perf_counter() - t0
    wf = cli.workflow
    # the epoch: run() less the snapshotter's saves at its end
    split["epoch"] = split["run"] - split["snapshot"]
    parts.update({f"a_{k}_s": split[k] for k in
                  ("build", "initialize", "epoch", "snapshot", "export")})
    n_train, n_eval = wf.loader.n_minibatches("train"), wf.loader.n_minibatches("valid")
    want = {"lrn_fwd": 2 * (n_train + n_eval), "lrn_bwd": 2 * n_train}
    print(f"launcher: AlexNet through `python -m znicz_tpu_torch` in {parts['a_cli_s']:.2f} s: "
          f"the build {split['build']:.2f} s, initialize {split['initialize']:.2f} s, one epoch "
          f"of {n_train} train and {n_eval} eval steps {split['epoch']:.2f} s, the best "
          f"snapshot's save {split['snapshot']:.2f} s, the export {split['export']:.2f} s (each "
          f"part ends in a card sync); {json.dumps(cli.result.history)}; LRN launches "
          f"{launches}, want {want}; {smi}")
    if (n_train, n_eval) != (4, 1) or launches != want or want != {"lrn_fwd": 10, "lrn_bwd": 8}:
        fail(f"launcher: LRN launches {launches} over ({n_train}, {n_eval}) steps, want 10 / 8")
    if (wf.device.type != "cuda" or wf.model.compute_dtype != torch.bfloat16
            or wf.model.output_shape != (1000,) or tuple(wf.loader.sample_shape) != (227, 227, 3)
            or wf.loader.max_minibatch_size != 128):
        fail("launcher: the CLI's AlexNet is not the published one on the card")

    # 33c, started now: --evaluate of the best snapshot in a process of its own
    best = os.path.join(snaps, "AlexNetWorkflow_best.pickle.gz")
    evaluate = ThreadPoolExecutor(1).submit(_cli, [alexnet_py, "--snapshot", best,
                                                   "--evaluate", "valid"])

    # 33b: the artifact holds the trained f32 masters, bitwise
    t0 = time.perf_counter()
    header, arrays = _artifact(artifact)
    params = wf.state.params
    n_diff = sum(not np.array_equal(arrays[i, k], params[i][k].detach().cpu().numpy())
                 for i, k in arrays)
    n_params = sum(a.size for a in arrays.values())
    if n_diff or len(arrays) != sum(len(p) for p in params):
        fail(f"launcher export: {n_diff} of {len(arrays)} blobs differ from the trained params")
    t1 = time.perf_counter()
    again = os.path.join(out_dir, "again.znicz")
    export_lib.export_model(wf.model._replace(params=params), again)
    parts["b_export_s"] = time.perf_counter() - t1
    with open(artifact, "rb") as f, open(again, "rb") as g:
        if f.read() != g.read():
            fail("launcher export: a second export of the same params differs")
    os.remove(again)
    mb = next(iter(wf.loader.batches("valid", shuffle=False)))
    x = (torch.as_tensor(mb.data[:NATIVE_SAMPLES]).float() * (1.0 / 255.0) - 0.5).contiguous()
    x_path, y_path = os.path.join(out_dir, "x.f32"), os.path.join(out_dir, "y.f32")
    x.numpy().tofile(x_path)
    built = gxx.result()
    if built.returncode != 0:
        fail(f"launcher: g++ failed on native/znicz_infer.cc: {built.stderr[-3000:]}")
    t_eng = time.perf_counter()
    native = subprocess.Popen([engine, artifact, x_path, y_path, str(NATIVE_SAMPLES)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the port's own f32 forward of the same params on the card, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    m32 = model_lib.build(alexnet.DEFAULTS["layers"], wf.loader.sample_shape, device="cuda")
    with torch.no_grad():
        want_p = m32.predict(params, x.cuda()).cpu().numpy()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del m32

    # 33a's check: the same workflow built directly (phase 20's construction)
    t0 = time.perf_counter()
    prng.reset()
    direct = alexnet.build_workflow(device="cuda", decision_config={"max_epochs": 1})
    direct.initialize(seed=LAUNCHER_SEED)
    dec = direct.run()
    n_bad, worst = _differ(torch, direct.state.params, params)
    parts["a_direct_s"] = time.perf_counter() - t0
    print(f"launcher: the same workflow built directly (fresh streams, initialize(seed="
          f"{LAUNCHER_SEED}), one epoch) in "
          f"{parts['a_direct_s']:.2f} s: history {json.dumps(dec.history)}; "
          f"{n_bad} param tensors differ from the CLI run's (largest |diff| {worst:.3e})")
    if dec.history != cli.result.history or n_bad:
        fail("launcher: the CLI's epoch is not the directly built workflow's, bitwise")
    del direct
    torch.backends.cudnn.deterministic = False

    e_out, e_err = native.communicate(timeout=LAUNCHER_WAIT_S)
    parts["b_engine_host_s"] = time.perf_counter() - t_eng
    if native.returncode != 0:
        fail(f"launcher: native/znicz_infer exited {native.returncode}: {e_err[-3000:]}")
    got_p = np.fromfile(y_path, np.float32).reshape(want_p.shape)
    rtol, atol = NATIVE_TOL
    excess = float(np.max(np.abs(got_p - want_p) - rtol * np.abs(want_p)))
    err = float(np.max(np.abs(got_p - want_p)))
    print(f"launcher: export of {n_params:,} params ({os.path.getsize(artifact) / 1e6:.1f} MB, "
          f"{len(header['layers'])} layers) in {parts['b_export_s']:.2f} s, bitwise the trained "
          f"masters; native/znicz_infer on {NATIVE_SAMPLES} validation images (host CPU, "
          f"{parts['b_engine_host_s']:.2f} s wall, the g++ build beside it) against the port's "
          f"f32 forward on the card (TF32 off): max |diff| {err:.3e} of max prob "
          f"{float(want_p.max()):.3e}, worst |diff| - rtol |p| {excess:.3e} (atol {atol}, "
          f"rtol {rtol}); argmax equal {bool((got_p.argmax(1) == want_p.argmax(1)).all())}")
    if not excess <= atol or got_p.shape != (NATIVE_SAMPLES, 1000):
        fail("launcher: the native engine disagrees with the port's forward")

    # 33c: --evaluate's JSON against Workflow.evaluate on the same params
    t0 = time.perf_counter()
    ev = evaluate.result()
    if ev.returncode != 0:
        print(ev.err[-6000:])
        fail(f"launcher --evaluate: exit {ev.returncode}")
    got = json.loads(ev.out.strip().splitlines()[-1])
    with torch.no_grad():
        ref = wf.evaluate("valid", confusion=True)
    ref["confusion"] = ref["confusion"].tolist()
    keys = ("loss", "n_err", "err_pct", "n_samples")
    worst_rel = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in keys)
    conf_ok = np.allclose(got["confusion"], ref["confusion"], rtol=EVAL_RTOL, atol=0)
    parts["c_evaluate_s"] = ev.seconds
    print(f"launcher: --evaluate valid of the best snapshot (a process of its own, "
          f"{ev.seconds:.2f} s with its start): {json.dumps({k: got[k] for k in keys})}; "
          f"Workflow.evaluate on the same params {json.dumps({k: ref[k] for k in keys})}; "
          f"worst relative {worst_rel:.3e} (limit {EVAL_RTOL}); the confusion matrices equal "
          f"within it: {conf_ok}")
    if got.get("split") != "valid" or worst_rel > EVAL_RTOL or not conf_ok:
        fail("launcher --evaluate disagrees with Workflow.evaluate")
    del wf, cli, params
    torch.cuda.empty_cache()

    # 33f: the services, attached by a config module, on the card
    import importlib.util
    import logging

    t0 = time.perf_counter()
    svc_dir = os.path.join(out_dir, "services")
    os.makedirs(svc_dir, exist_ok=True)
    config = os.path.join(out_dir, "services_config.py")
    with open(config, "w") as f:
        f.write(LAUNCHER_SERVICES.format(out=svc_dir, epochs=SERVICE_EPOCHS))
    failed = []

    class _Failed(logging.Handler):
        def emit(self, record):
            failed.append((record.getMessage(), record.exc_info and record.exc_info[0].__name__))

    # the workflow's class logger: run_args replaces the root logger's handlers
    wf_log, keep = logging.getLogger("StandardWorkflow"), _Failed(logging.ERROR)
    wf_log.addHandler(keep)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    saved, tree = prng.state_dict(), troot.to_dict()
    try:
        svc = launcher.run_args([os.path.join(root, "znicz_tpu_torch", "models", "mnist.py"),
                                 config, "--random-seed", "5"])
        torch.cuda.synchronize()
    finally:
        wf_log.removeHandler(keep)
        for s, h in handlers.items():
            signal.signal(s, h)
        troot.clear()
        troot.update(tree)
    seen = sys.modules["__znicz_config__"].SEEN.files
    for name in ("__znicz_workflow__", "__znicz_config__"):
        sys.modules.pop(name, None)
    prng.load_state_dict(saved)
    parts["f_services_s"] = time.perf_counter() - t0
    with open(os.path.join(svc_dir, "status.json")) as f:
        status = json.load(f)
    with open(os.path.join(svc_dir, "metrics.csv")) as f:
        rows = f.read().splitlines()[1:]
    each = {"metrics.csv", "status.json", "status.html", "metrics.prom"}
    matplotlib = importlib.util.find_spec("matplotlib") is not None
    plot_failed = [f for f in failed if f[0] == "service AccumulatingPlotter failed"]
    plotted = os.path.exists(os.path.join(svc_dir, "loss.png"))
    outcome = ("matplotlib present: the plotter wrote loss.png" if matplotlib else
               f"matplotlib absent: the plotter failed and was logged each epoch "
               f"({plot_failed[:1]}) while training went on")
    print(f"launcher: services on the card through a config module, MNIST {SERVICE_EPOCHS} "
          f"epochs in {parts['f_services_s']:.2f} s: files each epoch {seen}; metrics.csv "
          f"{len(rows)} rows; status.json devices {status['devices']}; {outcome}; other "
          f"failures {[f for f in failed if f not in plot_failed]}")
    if (not svc.result.epoch == len(seen) == len(rows) == SERVICE_EPOCHS
            or not all(each <= set(s) for s in seen) or "report.md" not in seen[-1]
            or "report.md" in seen[0] or not status["devices"][0].startswith("cuda:0 ")
            or len(plot_failed) != (0 if matplotlib else SERVICE_EPOCHS)
            or plotted != matplotlib or len(failed) != len(plot_failed)):
        fail("launcher: the epoch services did not write as they should")
    del svc

    # 33d-e: the supervised crash and the preemption, against the uninterrupted run
    base_proc = jobs["base"].result()
    base = _cli_result("uninterrupted", base_proc)
    sup = jobs["supervised"].result()
    with open(os.path.join(dirs["supervised"], "supervisor.json")) as f:
        history = json.load(f)
    got = _cli_result("--supervise", sup)
    runs = history["history"]
    child_s = runs[1]["unix"] - runs[0]["unix"] - 0.1 if len(runs) == 2 else float("nan")
    # the restarted child's own clocks (the crashed one printed none)
    phases = [json.loads(ln[len("PHASES "):]) for ln in sup.out.splitlines()
              if ln.startswith("PHASES ")]
    if len(phases) != 1:
        fail(f"launcher --supervise: {len(phases)} PHASES lines, want the restarted child's")
    restart = phases[0]
    print(f"launcher: --supervise with a crash entering epoch 2: exit {sup.returncode} in "
          f"{sup.seconds:.2f} s; supervisor.json restarts {history['restarts']}, child exits "
          f"{[h['exit_code'] for h in runs]}; the restarted child {child_s:.2f} s from the "
          f"first one's exit to its own (less the 0.1 s backoff), by its own clocks: process "
          f"start to the module's load (the interpreter, torch's and the port's imports) "
          f"{restart['start_to_module_s']:.2f} s, CUDA's init {restart['cuda_init_s']:.2f} s, "
          f"the build {restart['build_s']:.2f} s, initialize with the resume and 2 epochs "
          f"{restart['main_s']:.2f} s; the uninterrupted run {base_proc.seconds:.2f} s "
          f"(4 epochs); history and params equal to it: {got == base}")
    if (history["restarts"] != 1 or runs[0]["exit_code"] in (0, 75) or runs[-1]["exit_code"] != 0
            or got != base or base["epochs"] != 4):
        fail("launcher: the supervised run did not resume to the uninterrupted one")
    first, emergency, second = jobs["preempted"].result()
    if first.returncode != 75:
        print(first.err[-6000:])
        fail(f"launcher: SIGTERM mid-epoch gave exit {first.returncode}, want 75")
    got = _cli_result("--resume auto", second)
    print(f"launcher: SIGTERM at train step 4 (mid epoch 1): exit 75 in {first.seconds:.2f} s, "
          f"emergency snapshot {os.path.basename(emergency or '')}; --resume auto exit "
          f"{second.returncode} in {second.seconds:.2f} s; history and params equal to the "
          f"uninterrupted run: {got == base}")
    if not emergency or "emergency" not in emergency or got != base:
        fail("launcher: the preempted run did not resume to the uninterrupted one")
    parts.update({f"d_restart_{k}": v for k, v in restart.items()})
    parts.update(d_supervised_s=sup.seconds, d_restarted_child_s=child_s,
                 e_sigterm_s=first.seconds, e_resume_s=second.seconds,
                 uninterrupted_s=base_proc.seconds)
    parts["phase_s"] = time.perf_counter() - t_phase
    for k, v in parts.items():
        print(f"launcher: {k} {v:.2f}")
    print(f"launcher: {smi}")
    return launches, {k: round(v, 3) for k, v in parts.items()}


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dp-rank"]:  # a phase 30b rank, started by phase_dp_gloo
        return dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--tp-rank"]:  # a phase 31 rank, started by phase_tp
        return tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if sys.argv[1:2] == ["--sp-pp-rank"]:  # a phase 32 rank, started by phase_sp_pp
        return sp_pp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                            sys.argv[6])
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root as troot
    from znicz_tpu_torch.loader import datasets
    from znicz_tpu_torch.loader import image as image_lib, imagenet as imagenet_lib
    from znicz_tpu_torch.loader import native as native_lib
    from znicz_tpu_torch.models import alexnet, cifar, kohonen, mnist, mnist_rbm, transformer_lm
    from znicz_tpu_torch.models import kanji, mnist_ae, video_ae, yale_faces
    from znicz_tpu_torch.ops import deconv, kohonen as kh_op
    from znicz_tpu_torch.ops.kernels import attention as fa, cuda_build, lrn as lrn_kernel
    from znicz_tpu_torch.ops.kernels import kohonen as khk, rbm as rbk
    from znicz_tpu_torch.workflow import model as model_lib, transformer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    import triton

    print(f"versions: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, triton {triton.__version__}; "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    built = build_all(cuda_build)
    lrn_ptxas = phase_lrn_build(built["lrn"])
    err, rows = phase_kernels(torch, lrn_kernel)
    lrn_extra = phase_lrn_bwd_extra(torch, lrn_kernel)
    launches, synthetic = phase_slice(torch, lrn_kernel, alexnet, model_lib, prng)
    t0 = time.perf_counter()
    phase_flash_build(built["flash_attention"], fa, cuda_build, torch)
    flash_err, flash_bf16_err, flash_f64_err = phase_flash_checks(torch, fa)
    phase_flash_inputs(torch, fa)
    flash_rows = phase_flash_times(torch, fa)
    flash_launches, lm_steps, lm_loader = phase_lm(
        torch, fa, transformer_lm, transformer, model_lib, troot, prng
    )
    print(f"flash phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_unsup_build(built, khk, rbk, cuda_build)
    unsup_err, unsup_f64 = {}, {}
    unsup_err["kohonen_accumulate"], unsup_f64["kohonen_accumulate"] = phase_kohonen_checks(
        torch, khk, kh_op, datasets, prng)
    unsup_err["rbm_cd"], unsup_f64["rbm_cd"] = phase_rbm_checks(torch, rbk, datasets, prng)
    unsup_rows = phase_unsup_times(torch, khk, kh_op, rbk)
    unsup_launches = {
        "kohonen_accumulate": phase_kohonen_model(torch, kohonen, khk, kh_op, troot, prng)[0],
        "rbm_cd": phase_rbm_model(torch, mnist_rbm, rbk, troot, prng)[0],
    }
    print(f"unsupervised phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_mnist(torch, mnist, prng, smi)
    cifar_launches, cifar_err, cifar_rows, _ = phase_cifar(
        torch, cifar, lrn_kernel, model_lib, prng, smi)
    print(f"mnist and cifar phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tree, imagenet_dir, crop = phase_loaders(torch, image_lib, imagenet_lib, native_lib, smi)
    disk_launches, disk = phase_alexnet_disk(
        torch, lrn_kernel, alexnet, imagenet_lib, model_lib, prng, troot, imagenet_dir,
        synthetic, smi)
    ae = phase_autoencoders(
        torch, {"mnist_ae": mnist_ae, "video_ae": video_ae, "kanji": kanji,
                "yale_faces": yale_faces}, deconv, troot, prng, tree, smi)
    print(f"loader, AlexNet-from-disk and autoencoder phases: {time.perf_counter() - t0:.1f} s; "
          + json.dumps({"crop": crop, "alexnet_disk": disk, "synthetic": synthetic, **ae}))
    t0 = time.perf_counter()
    loop_launches, host_loop = phase_host_loop(
        torch, lrn_kernel, alexnet, prng, troot, imagenet_dir, disk, smi)
    host_loop["thread_cost"] = phase_thread_cost(
        torch, {"kohonen": kohonen, "mnist_rbm": mnist_rbm, "mnist": mnist, "cifar": cifar},
        troot, prng, smi)
    print(f"host loop phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(host_loop))
    t0 = time.perf_counter()
    heal_launches, heal = phase_self_healing(
        torch, lrn_kernel, alexnet, {"kohonen": kohonen, "mnist_rbm": mnist_rbm, "mnist": mnist},
        prng, smi)
    print(f"self-healing phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(heal))
    t0 = time.perf_counter()
    scan_launches, scan = phase_scan(
        torch, {"alexnet": alexnet}, {"imagenet": imagenet_lib, "native": native_lib}, prng,
        host_loop["images_per_s"], smi)
    print(f"scan phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(scan))
    t0 = time.perf_counter()
    moe_launches, moe = phase_moe(torch, fa, transformer, model_lib, prng, lm_loader,
                                  lm_steps["f32"][1], smi)
    moe_graph = phase_moe_graph(torch, prng)
    print(f"moe phases: {time.perf_counter() - t0:.1f} s; " + json.dumps(moe))
    t0 = time.perf_counter()
    decode, lm_params = phase_decode(torch, transformer, prng, lm_loader, smi)
    decode["serve"] = phase_serve(torch, lm_params, smi)
    del lm_params
    print(f"decode phases: {time.perf_counter() - t0:.1f} s; " + json.dumps(decode))
    t0 = time.perf_counter()
    engine = phase_engine(torch, transformer, model_lib, prng, smi)
    print(f"engine phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(engine))
    t0 = time.perf_counter()
    frontdoor = phase_frontdoor(torch, transformer, prng, smi, engine)
    print(f"frontdoor phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(frontdoor))
    t0 = time.perf_counter()
    cluster = phase_cluster(torch, transformer, prng, smi,
                            "after phases 22 and 28's profiler sessions")
    print(f"cluster phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(cluster))
    t0 = time.perf_counter()
    dp_launches, dp = phase_dp_nccl(
        torch, fa, lrn_kernel, khk, rbk,
        {"alexnet": alexnet, "kohonen": kohonen, "mnist_rbm": mnist_rbm}, transformer,
        lm_loader, troot, smi)
    dp_gloo_launches, dp["gloo"] = phase_dp_gloo(torch, smi)
    print(f"data-parallel phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(dp))
    t0 = time.perf_counter()
    tp_launches, tp = phase_tp(torch, smi)
    print(f"tensor-parallel phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(tp))
    t0 = time.perf_counter()
    sp_pp_launches, sp_pp = phase_sp_pp(torch, smi)
    print(f"sequence- and pipeline-parallel phase: {time.perf_counter() - t0:.1f} s; "
          + json.dumps(sp_pp))
    t0 = time.perf_counter()
    launcher_launches, launcher_parts = phase_launcher(torch, lrn_kernel, alexnet, model_lib,
                                                       prng, smi)
    print(f"launcher phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(launcher_parts))

    kernels = []
    for kname in ("lrn_fwd", "lrn_bwd"):
        rs = rows[kname]["bfloat16"]  # one train step's work: norm1 + norm2, bf16
        entry = {
            "name": kname,
            "route": LRN_ROUTE[kname][0],
            "source": LRN_ROUTE[kname][1],
            "replaces": REPLACES[kname],
            "launches": launches[kname],
            "max_abs_err": err[kname]["bfloat16"],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rs) else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
            # each shape and dtype beside its bound; the f32 check's error
            "shapes": {f"{r['shape']} {d}": {k: v for k, v in r.items() if k != "shape"}
                       for d, dr in rows[kname].items() for r in dr},
            "f32_max_abs_err": err[kname]["float32"],
        }
        if kname == "lrn_bwd":  # phases 2-3b passed: bitwise repeats, canaries untouched
            entry.update(repeat="bitwise", canary="untouched", other_shapes_max_abs_err=lrn_extra,
                         ptxas_registers_spill_bytes=lrn_ptxas)
        # the CIFAR-10 path (f32): its epoch's launches, the kernel at its
        # norm shape in f32, with bf16 beside it
        (c32,), (c16,) = cifar_rows[kname]["float32"], cifar_rows[kname]["bfloat16"]
        entry["cifar"] = {
            "shape": list(CIFAR_NORM["cifar"]),
            "launches": cifar_launches[kname],
            "max_abs_err": cifar_err[kname]["float32"],
            **{k: v for k, v in c32.items() if k != "shape"},
            "bf16": {"max_abs_err": cifar_err[kname]["bfloat16"],
                     **{k: v for k, v in c16.items() if k != "shape"}},
        }
        # AlexNet from packed files on disk (phase 18): its epoch's launches
        entry["alexnet_disk"] = {"launches": disk_launches[kname]}
        # the same through the workflow's host loop (phase 20): prefetch
        # thread, pinned copies
        entry["host_loop"] = {"launches": loop_launches[kname]}
        # the self-healing phase's poisoned AlexNet run (phase 21): its
        # train and eval steps, the rolled-back ones included
        entry["self_healing"] = {"launches": heal_launches[kname]}
        # the graph dispatch's AlexNet runs (phase 22), both resident pools:
        # their replayed epochs' launches, read from the trace
        entry["scan"] = {"launches": scan_launches[kname]}
        # phase 30's one-NCCL-rank AlexNet run: its train steps' launches
        entry["dp"] = {"launches": dp_launches[kname]}
        # phase 31: each (data=1, model=2) gloo rank's AlexNet epochs
        entry["tp"] = {"gloo_ranks": tp_launches[kname]}
        # phase 33: AlexNet's epoch through `python -m znicz_tpu_torch`
        entry["launcher"] = {"launches": launcher_launches[kname]}
        kernels.append(entry)
    for kname in FLASH:
        row = flash_rows[(kname, "float32")]  # the counted epoch's dtype
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": FLASH_SOURCE,
            "replaces": REPLACES[kname],
            "launches": flash_launches[kname],
            "max_abs_err": flash_err[kname],
            **row,
            # the f32 kernel against float64, beside the f32 plain version
            "float64_err": {g: dict(zip(("kernel", "plain"), e))
                            for g, e in flash_f64_err.items() if g in F64_OUTPUTS[kname]},
            # bf16 attention: its timed steps' launches, the slice shape's check
            "bf16": {
                "launches": lm_steps["bf16"][2][kname],
                "max_abs_err": flash_bf16_err[kname],
                **flash_rows[(kname, "bfloat16")],
            },
            # the graph dispatch's LM run (phase 22): its replayed epoch's
            # launches, read from the trace
            "scan": {"launches": scan_launches[kname]},
            # the MoE LM (phases 23-24): each dispatch's epoch at full
            # width, and its graph dispatch's replayed epoch at 2 layers
            "moe": {"launches": {d: moe_launches[d][kname] for d in MOE_DISPATCHES},
                    "scan_launches": {d: moe_graph[d][kname] for d in MOE_DISPATCHES}},
            # phase 30's one-NCCL-rank mid LM: its train steps' launches
            "dp": {"launches": dp_launches[kname]},
            # phase 31: each (data=1, model=2) gloo rank's epoch of the mid
            # LM and of the MoE LM in each dispatch, over its local heads
            "tp": {"gloo_ranks": tp_launches[kname]},
            # phase 32: each gloo rank's epoch of the mid LM through the
            # ring (sp), two stages (pp) and two stages over two model
            # ranks (pptp)
            "sp_pp": {"gloo_ranks": sp_pp_launches[kname],
                      "ring_of_one": sp_pp["ring_of_one"]["launches"][kname]},
        })
    for kname in UNSUP_SOURCE:
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": UNSUP_SOURCE[kname],
            "replaces": REPLACES[kname],
            "launches": unsup_launches[kname],
            "max_abs_err": unsup_err[kname],
            **unsup_rows[(kname, "model")],  # the main path's shape
            # the check shapes' times beside their bounds
            "shapes": {tag: row for (k, tag), row in unsup_rows.items()
                       if k == kname and tag != "model"},
            # the outputs against float64 at the model's shape, beside the
            # f32 plain version's
            "float64_err": {g: dict(zip(("kernel", "plain"), e))
                            for g, e in unsup_f64[kname].items()},
            # the graph dispatch's resident, deferred run (phase 22): its
            # replayed epochs' launches, read from the trace
            "scan": {"launches": scan_launches[kname]},
            # phase 30: the one-NCCL-rank epoch's launches, and each gloo
            # rank's (30b)
            "dp": {"launches": dp_launches[kname], "gloo_ranks": dp_gloo_launches[kname]},
            # phase 31: each rank's of the (data=2, model=2) mesh
            "tp": {"gloo_ranks": tp_launches[kname]},
        })
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
