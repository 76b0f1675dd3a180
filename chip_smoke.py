#!/usr/bin/env python3
"""Drive ``apex_tpu_torch`` on one NVIDIA GPU and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``) and ``triton``::

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is caught):

1. set-up — build the CUDA kernels from ``apex_tpu_torch/csrc`` (one
   ``nvcc`` per source and dtype, started together), count the ``HGMMA``
   instructions in the wgmma libraries, the LM-head CE's, the flash
   forward's and backward's, the fp8 matmul's and the fused bottleneck's
   (``cuobjdump -sass``; none fails), turn TF32
   off, print the card's name and power limit; the
   fp8 codec's e4m3 cast and scale on the card against the CPU's,
   bitwise;
2. kernels — each kernel's wrapper at its main path's shapes against its
   plain version on the same inputs, with the tolerance stated beside each
   check, timed with CUDA events (L2 flushed before every launch, and a
   device sleep queued before the start event, so that the pair holds
   device time only) beside
   its plain version, a PyTorch library call where one computes the same
   function, and its bound (the least time for its bytes at 3.35 TB/s or
   its operations at 989 TFLOP/s bf16, whichever is larger);
3. serve paths — three ``ServeEngine``s, each after a warm-up engine and
   with the launch counters reset just before, serve 16 requests (prompts
   of 64-512 tokens, 64 new tokens each) through the 12-layer h1024 GPT
   (``bench.py``'s ``_bench_gpt`` shape, random weights from seed 0): the
   bf16 engine, ``fp8_weights`` + ``fp8_kv``, and ``fp8_weights`` +
   ``spec_k=4`` (6-layer draft); asserts every request's length, that
   every page went back, and each kernel's exact launch count; prints
   tokens/s, decode-step and prefill times, pool bytes, the accept rate;
4. serve checks — for two finished requests of the bf16 and the fp8
   engine, the no-cache forward through the plain versions of every kernel
   (over the same e4m3 weights for the fp8 engine), over prompt + generated
   tokens, against the engine's recorded logits; the speculative engine's
   tokens against a plain ``fp8_weights`` engine's;
5. train path — the same GPT trained at O2 (bf16 model, fp32 master
   weights, dynamic loss scale) with ``FusedAdam`` through
   ``amp.make_train_step`` on one fixed b8 s1024 batch: a warm-up step,
   then 8 timed steps with the launch counters reset just before; asserts
   the losses are finite and fall, the scale never moved and each kernel's
   launches per step (every flash forward and single-pass backward on the
   wgmma route); prints step-time median, p90 and tokens/s;
6. gradient check — from the same initial parameters, the loss and every
   parameter's gradient through the kernels against
   ``GPT.loss(reference=True)`` (the plain versions, differentiated by
   autograd);
7. overflow — one step whose gradients overflow fp32 leaves the master
   weights, the moments and the step counter bitwise unchanged and halves
   the scale;
8. dropout train path — the same O2 step in training mode with Megatron's
   ``attention_dropout`` and ``hidden_dropout`` 0.1, on the train path's
   model and optimizer state (its GPT carries the rates and its
   deterministic steps ignore them; one host generator for the attention
   seeds and the hidden masks): a warm-up step, then 4 timed steps with
   the counters reset just before; asserts finite, falling losses and
   every flash launch on the wgmma dropout variants (12 forwards and 12
   single passes a step); prints step time and tokens/s beside the step
   without dropout; then, on the gradient check's model after its
   deterministic check, the loss and every gradient through the kernels
   against ``reference=True`` with a generator in the same state (the
   same seeds and hidden masks; loss 1e-3, gradients 3 %);
9. trace — ``torch.profiler`` over decode steps and prefills of the bf16
   and the fp8 engine and over train steps (the s1024 step with and
   without dropout among them), and the train step's device
   time by phase (forward + backward, unscale, optimizer, scaler update)
   from CUDA events;
10. long-sequence train path — the same GPT at O2 with ``FusedAdam`` at
   b2 s4096 (``bench.py``'s ``_bench_gpt_long_seq``), where the flash
   backward takes its two-kernel split: a warm-up step, then 4 timed steps
   with the counters reset just before; asserts finite losses and per
   step 12 dq and 12 dk/dv launches, every one on the wgmma route
   (``csrc/flash_bwd_sm90.cu``), and no single-pass one; traced; then the
   same step in training mode with Megatron's dropout 0.1 on its model and
   state (train-dropout-gpt12-h1024-b2s4096, one host generator): a
   warm-up, 4 timed steps with the counters reset just before, 2 traced;
   finite, falling losses and per step 12 launches each of B1's, B3's and
   B4's dropout variants and none without dropout; then, on a fresh
   2-layer GPT at full width (the depth cut: the plain attention of 12
   layers would hold ~2 GB fp32 tensors several times a layer), the loss
   and every gradient at b2 s4096 through the kernels against
   ``reference=True``, deterministic and with dropout from a generator in
   the same state on both sides (loss 1e-3, gradients 3 %; peak memory
   logged);
11. ResNet-50 path — ``bench.py``'s ``_build_step`` at b256 224x224: O2
    (bf16 convs, fp32 batch norms and statistics, fp32 masters),
    ``FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)``, the mean of
    ``softmax_cross_entropy_with_smoothing(logits, y, 0.1)``, inputs and
    labels from numpy seed 0: a warm-up step, then 8 timed steps with the
    counters reset just before; asserts finite losses, one launch of each
    cross-entropy kernel per step and fp32 batch norms; prints images/s;
    traced; then an overflowing step (skipped bitwise: masters, momentum
    buffers and their flag; the scale halved) and one step's loss and
    gradients through the kernels against the plain twin;
12. ZeRO-3 path — the same GPT at b8 s1024 through ``amp.initialize(...,
    zero=True)`` with ``ZeroOptimizer(adam, shard_params=True,
    weight_decay=0.01)`` and ``zero.make_train_step`` at world 1: a warm-up
    step, then 8 timed steps with the counters reset just before; asserts
    finite falling losses and one fused-update (B13) launch a step; the
    masters, m and v after the warm-up step and after all 9 against the
    dense FusedAdam step of phase 5 from the same fp32 init; the step's
    device time by phase beside the dense FusedAdam's in this run; traced;
    then an
    overflowing step (shards, masters, m, v, step bitwise unchanged, the
    scale halved);
13. tier-2 LAMB path — ``DistributedFusedLAMB(lr=1e-3, weight_decay=0.01,
    max_grad_norm=1.0)`` through ``amp.make_train_step`` at O2: a warm-up,
    3 counted steps (one B13 LAMB launch each), then one step on the card
    against the same step of a CPU twin;
14. probe path — ``apex_tpu_torch.scripts.vpu_probe``'s run: each of the
    six ops (B14) chained 16 times over [64, 512, 512] fp32 and summed,
    timed as the script times it; asserts the launch count;
15. bottleneck path — ``apex_tpu_torch.scripts.bottleneck_proto``'s run at
    the proto's full shape (N 32, 56 x 56 x 256 bf16): the fused kernel
    (B15) within the proto's 0.15 of the cuDNN composition, both timed;
16. spatial path — ``contrib.bottleneck.SpatialBottleneck`` at world 1 at
    ResNet-50's conv2_x width (x [32, 256, 56, 56] bf16, fp32 norms):
    forward and backward against ``models.resnet.Bottleneck`` with the
    same weights, then 4 O2 ``FusedSGD`` steps with a finite, falling
    loss;
17. O0 path — the GPT at full width with 2 layers in fp32 (b8 s1024): the
    loss and every gradient through the kernels (fp32 flash, LayerNorm and
    LM-head CE) against ``GPT.loss(reference=True)``, then 3 counted
    ``FusedAdam`` steps through ``amp.make_train_step`` at O0 (the CE, the
    flash forward and the flash backward on their FFMA routes), and one
    more under ``torch.profiler``: its device time by kernel class;
18. O0 long path — the same 2-layer fp32 GPT at b2 s4096, past the
    flash backward's gate: a warm-up and 2 counted O0 steps, every forward
    (``csrc/flash_fwd_f32.cuh``) and every split's dk/dv and dq
    (``csrc/flash_bwd_f32.cuh``) on the fp32 FFMA routes; then one step
    under ``torch.profiler``, its device time by kernel class;
19. train-mha18-e1024-b16s512-bias — ``contrib.multihead_attn``: 18
    ``SelfMultiheadAttn(1024, 16, use_bias=True, include_norm_add=True,
    impl="fast")`` layers in sequence (apex's own perf harness widths,
    ``apex/contrib/examples/multihead_attn/perf_test_multihead_attn.py``)
    at O2 with ``FusedAdam`` and a dynamic scale through
    ``amp.make_train_step``, x [512, 16, 1024] bf16 from seed 0, key
    padding of 384-512 real tokens a sequence, fairseq's additive future
    mask [512, 512] (-inf above the diagonal) as ``attn_mask``, the mean
    squared error against a fixed random target: a warm-up, 4 timed steps
    with the counters reset just before, 2 traced; finite, falling losses
    and per step 18 launches of B1's and of B2's bias variants, 18 of each
    LayerNorm kernel and no other flash launch;
20. train-mha18-e1024-b120s64-dropout — the harness's largest point: the
    same recipe over 18 layers at ``dropout=0.1`` (no masks, no norm_add,
    no projection biases: the stack adds each attention sublayer's output
    to its input) on 120 sequences of 64 tokens, one host generator: 18
    launches a step of B1's and of B2's dropout variants and no bias
    launch;
21. train-mha16-e1024h8-b1s3072-bias — fairseq's ``transformer_lm_wiki103``
    widths and context (16 decoder layers, embed 1024, 8 heads, one
    3072-token sample a step, ``--sample-break-mode none``): 16
    ``SelfMultiheadAttn(1024, 8, use_bias=True, include_norm_add=True,
    impl="fast")`` layers through the same recipe over x [3072, 1, 1024]
    bf16 with no padding, the future mask as the bias: per step 16
    launches each of B1's, B3's and B4's bias variants (the gate splits
    every biased backward at s3072 d128), 16 of each LayerNorm kernel and
    no other flash launch; then the 2-layer full-width grad checks (the
    kernels against ``reference=True``, the same generator on both sides;
    loss 1e-3, gradients 3 %) of both train-mha18 configurations, of this
    one at s3072, of ``SelfMultiheadAttn(1024, 16)`` at b8 s1024 with the
    future mask and key padding of 768-1024 tokens (the split at d 64),
    and of ``EncdecMultiheadAttn(1024, 16)`` at sq 256, sk 512 (the single
    pass) and sq 512, sk 1024 (the split), b16, each with a finite [16, 1,
    sq, sk] bias and key padding; each asserts which bias variants ran;
22. train-mha16-e1024h8-b1s3072-bias-dropout — the same path at
    ``dropout=0.1`` (``transformer_lm_wiki103``'s ``attention_dropout``;
    apex's module has one ``dropout``, which also drives norm_add's
    residual dropout), one host generator: per step 16 launches each of
    B1's, B3's and B4's variants with both, 16 of each LayerNorm kernel and
    no other flash launch; then, among the grad checks above, three with
    the bias and dropout 0.1 together, each asserting that the variants
    with both ran: this path's configuration at s3072 (d 128),
    ``SelfMultiheadAttn(1024, 16)`` at b16 s512 with the future mask and
    key padding of 384-512 tokens (d 64; with both the gate splits s512)
    and ``EncdecMultiheadAttn(1024, 16)`` at sq 512, sk 1024, b16;
23. train-mha6-e1024h16-b28s128-bias-dropout — the decoder self-attention
    of fairseq's ``transformer_wmt_en_de_big`` (embed 1024, 16 heads, 6
    decoder layers, ``attention_dropout`` 0.1, the future mask over padded
    target sentences, a batch of ``--max-tokens 3584``): 6
    ``SelfMultiheadAttn(1024, 16, use_bias=True, include_norm_add=True,
    impl="fast", dropout=0.1)`` layers through the same recipe over x [128,
    28, 1024] bf16 with key padding of 96-128 real tokens a sentence and
    the future mask as the bias: per step 6 launches each of B1's and B2's
    variants with both (the gate keeps s128 on the single pass), 6 of each
    LayerNorm kernel and no other flash launch; then, among the grad checks
    above, two on the single pass's variant with both: this path's
    configuration at b28 s128 and ``EncdecMultiheadAttn(1024, 16)`` at sq
    256, sk 384, b16 with a finite bias and dropout 0.1;
24. train-o0-dropout-gpt2-b8s1024 — the O0 path's 2-layer fp32 GPT at b8
    s1024 with Megatron's attention and hidden dropout 0.1: the loss and
    every gradient through the kernels against ``reference=True`` with a
    host generator in the same state on both sides (loss 1e-5 relative,
    gradients 1e-4), then 3 counted O0 steps with 2 launches each of the
    FFMA forward's and single pass's dropout variants a step and none of
    the FFMA kernels without dropout, and one step under the profiler;
25. train-o0-dropout-gpt2-b2s4096 — the same at the O0 long path's b2
    s4096, where the gate splits: the grad check at the full shape (the
    plain twin's peak memory logged), a warm-up and 2 counted steps with 2
    launches each of the FFMA forward's and the FFMA split's dk/dv and dq
    dropout variants a step and none of the FFMA kernels without them,
    finite losses, and one step under the profiler;
26. train-o0-mha16-e1024h8-b1s3072-bias — train-mha16's configuration at
    O0 (fp32 x and parameters, ``FusedAdam`` without a loss scale;
    fairseq trains in fp32 without ``--fp16``), dropout 0: per step 16
    launches each of the FFMA forward's and the FFMA split's dk/dv and dq
    bias variants (the gate splits every biased fp32 backward at s3072
    d128), 16 of each LayerNorm kernel and no other flash launch; then its
    2-layer full-width grad check in fp32 (loss 1e-5, gradients 1e-4 in
    relative norm), the bias variants' launches asserted;
27. train-o0-mha6-e1024h16-b28s128-bias — train-mha6's configuration at
    O0 with dropout 0: per step 6 launches each of the FFMA forward's and
    single pass's bias variants (the gate keeps s128 on the single pass),
    6 of each LayerNorm kernel and no other flash launch; then its 2-layer
    grad check in fp32 as above;
28. train-o0-mha16-e1024h8-b1s3072-bias-dropout — path 26 at fairseq's
    attention dropout 0.1 (one host generator for the attention seeds and
    the residual dropout's masks): per step 16 launches each of the FFMA
    forward's and split's variants with both (the gate splits fp32 with
    both from s400 at d 128), 16 of each LayerNorm kernel and no other
    flash launch; then its 2-layer grad check in fp32 with the host
    generator in the same state on both sides;
29. train-o0-mha6-e1024h16-b28s128-bias-dropout — path 27 at dropout 0.1:
    per step 6 launches each of the FFMA forward's and single pass's
    variants with both, 6 of each LayerNorm kernel; then its grad check
    as path 28's.

The kernel phase also holds the shapes and dtypes ROADMAP §C records as
repaired against the plain versions: flash forward and backward (single
pass and split) at fp16 and fp32, at head dims 80, 96, 256, 320 and 512
(fp32 included), and over q, k, v of mixed dtypes; paged decode at group
16 in both pool modes, with fp16/fp32 queries, at head dims 80, 96, 100,
256 and 512 in both pool modes and with queries over a pool of another
dtype; the LM-head CE (B8 and B9 on wgmma/TMA for bf16 and fp16, the
FFMA route for fp32) at h 64, 100, 1536, 1600, 2048, fp16 and fp32 (and
fp32 at 1601 over a ragged 1000 x 1003), and B9 bitwise on a second run,
its device launches in one call counted by ``torch.profiler`` (each of
its three products once a token chunk, no other kernel); the fp8 matmul
at K = N = 1000. And B15 (the fused
bottleneck, ``csrc/bottleneck.cu``: persistent, weights resident in
shared memory, wgmma/TMA) at N 32 within two bf16 ulps plus 2^-5 of its
plain version and 0.15 of the cuDNN composition, bitwise on a rerun, at
n 3 against the plain version, each image of an n 5 batch bitwise the same
image alone, one device launch a call (profiler),
``HGMMA`` in its SASS and no spill; B14
bitwise (mul, max, where, iota_cmp_where) or within 2 ulps (exp, exp2).

B1's and B2's bias variants (``flash_fwd_sm90`` and
``flash_bwd_fused_sm90`` with their ``BIAS`` parameter: the tile's bias /
scale loaded into the S accumulators, which the S product adds to) are
held at the train-mha18 path's attention (b16 h16 s512 d64 bf16, the
future mask as a [1, 1, 512, 512] fp32 bias, key padding as segment ids)
against the plain versions with the same bias (the bf16 forwards' and
backwards' limits), bitwise on a rerun, their positions bitwise (one-hot
bias rows: out is v permuted and dv is do permuted, bit for bit), over
bf16 and fp16, head dims 64 and 128, the four broadcast shapes, sq != sk,
odd sk, segment padding and a row whose bias is -inf everywhere (out 0,
lse -1e30, dq 0); each timed with and without the bias beside its plain
version and SDPA with the same mask as ``attn_mask``; ptxas shows no
spill in either variant. B3's and B4's bias variants (``flash_dkdv_sm90``
and ``flash_dq_sm90`` with their ``BIAS`` parameter) are held kernel by
kernel against their plain versions over the same shapes, their
positions bitwise (one-hot rows into sk > sq keys, v = e_0 and a zero
output: dq, dk and dv exact products), then at b8 h16 s1024 d64 (key
padding) and at the train-mha16 path's b1 h8 s3072 d128 the pair as
routed against the plain backward, bitwise on a rerun, each timed with
and without the bias beside its plain version and SDPA's backward with
the mask (B1's bias variant beside SDPA's forward there too); ptxas
shows no spill in B4's and no more in B3's than in their twins.

B1's, B3's, B4's and B2's variants with both the bias and dropout
(``flash_fwd_sm90``, ``flash_dkdv_sm90``, ``flash_dq_sm90`` and
``flash_bwd_fused_sm90`` with ``DROP`` and ``BIAS``) are held at the bias
variants' shapes with dropout 0.1 against the plain versions with the same
bias and seed (the bf16 limits; the folded delta 1e-5), each bitwise on a
rerun (B2's dq through its ordered turns), dead rows exactly zero; B2's is
timed at the train-mha6 path's b28 h16 s128 d64 with key padding, alone
and as called, beside its twins, its plain version and SDPA's backward
with the mask and ``dropout_p=0.1``; at rate 0.5 their keep pattern
bitwise through identity operands under a bias finite everywhere, and
their positions bitwise through one-hot bias rows (the kept elements
doubled, exact products); then at b16 h16 s512 d64 (train-mha18's
attention with key padding) and at b1 h8 s3072 d128 (the
train-mha16-bias-dropout path's) the forward and the pair as routed
against the plain versions, each timed beside its twins with the bias
alone and with dropout alone, its plain version, and SDPA with the mask as
``attn_mask`` and ``dropout_p=0.1``, forward and backward; ptxas shows no
spill in B1's and B4's and no more in B3's than in its twin without a
variant.

B1's and B2's dropout variants (``flash_fwd_sm90`` and
``flash_bwd_fused_sm90`` built with the keep hash of
``csrc/dropout_hash.cuh``) are held at the dropout step's b8 h16 s1024 d64
causal, rate 0.1, against the plain versions with the same seed (the
bf16 forwards' and backwards' limits), bitwise on a rerun, another seed
another result, and by a mask check (rate 0.5, non-causal, sk = d keys, v
the identity: the zero pattern of the output is the plain mask bit for
bit); each timed with and without dropout beside SDPA's dropout call, and
ptxas shows no spill in either variant. B1's variant is also held and
timed at the long-sequence step's b2 h16 s4096. B3's and B4's dropout
variants (``flash_dkdv_sm90`` and ``flash_dq_sm90`` with the keep hash)
are held at b2 h16 s4096 d64 causal, rate 0.1, where the gate sends the
backward with dropout to the split: the pair against the plain backward
and each kernel against its plain version with the same seed (the bf16
backwards' limits; the folded delta 1e-5), bitwise on a rerun, another
seed another result, and their masks bit for bit at rate 0.5 (dk/dv with
q = 0 and do = I, so dv is the dropped p transposed; dq with k = I and a
zero output, so dq is zero exactly where a key is dropped); each timed
with and without dropout beside its plain version and SDPA's dropout
backward; ptxas shows no spill in B4's variants and no more in B3's than
in the same kernel without dropout.

The flash forward and single-pass backward are held on both routes: the
wgmma route (``csrc/flash_fwd_sm90.cu``; ``flash_bwd_fused_sm90`` of
``csrc/flash_bwd_sm90.cu``) at the serve prefill's, the s1024 and the
s4096 train cells' shapes, ragged shapes, fp16 and a padded head dim, the
forward and the single pass's dk and dv bitwise on a rerun, with ptxas's
registers and no spill. Every bf16 main path (the GPT cells, ZeRO-3,
LAMB, serve) takes the wgmma route for every flash launch, the O0 paths
none.

B1's and B2's dropout variants on the fp32 FFMA route
(``flash_fwd_f32_dropout_kernel``, ``flash_bwd_f32_dropout_kernel``) are
held at d 64 and 128, causal and not, sq != sk, segment padding and the O0
dropout path's b8 h16 s1024 d64 causal against the plain versions with
the same seed (out 1e-5, lse 1e-5 relative, gradients 1e-4), bitwise on a
rerun, their keep pattern the plain mask bit for bit at rate 0.5, one
device launch of the single pass's variant a call (profiler), no spill;
each timed beside its twin without dropout, its plain version and SDPA
fp32 with ``dropout_p=0.1``.

B3's and B4's dropout variants on the fp32 FFMA route
(``flash_dkdv_f32_dropout_kernel``, ``flash_dq_f32_dropout_kernel``) are
held the same way with the split forced, kernel by kernel against
``flash_bwd_dkdv_reference`` and ``flash_bwd_dq_reference`` with the same
seed, bitwise on a rerun, their keep patterns the
plain mask bit for bit at rate 0.5 (dk/dv: q = 0, do = I; dq: one key
e_0 beside zero keys, v = I, do = 1), then at b2 h16 s4096 d64 causal
the pair as routed against the plain backward, one device launch each a
call (profiler), no spill; each timed beside its twin without dropout,
its plain version and SDPA fp32's backward with ``dropout_p=0.1``.
B1's, B2's, B3's and B4's bias variants on the FFMA route
(``flash_fwd_f32_bias_kernel``, ``flash_bwd_f32_bias_kernel``,
``flash_dkdv_f32_bias_kernel``, ``flash_dq_f32_bias_kernel``: the tile's
bias / scale loaded into the S accumulators) are held at the bias
variants' shapes in fp32 (head dims 64 and 128, the four broadcast
shapes, sq != sk, odd sk, segment padding, a row -inf everywhere, a row
-inf but for key 0, whose output is v[0] bit for bit) against the plain
versions (1e-5 forward and lse, 1e-4 gradients), the forward, the single
pass and the split's two kernels each bitwise on a rerun; then at
train-o0-mha16's b1 h8 s3072 d128 (the future mask; the split) and
train-o0-mha6's b28 h16 s128 d64 (the future mask and key padding; the
single pass, one device launch a call) as routed, each kernel timed
beside its twin without the bias, its plain version and SDPA fp32 with the
same mask; no spill. Their variants with both the bias and dropout
(``flash_*_f32_bias_dropout_kernel``) are held the same way at dropout 0.1
(the one-key row's output v[0] / (1 - rate) or 0 by its keep bit, bit for
bit), their keep pattern bitwise under a finite bias, then at the same
two paths' shapes and at b8 h16 s1024 d64 (the split) as routed, each
timed beside its twins (the bias alone, dropout alone), its plain version
and SDPA fp32 with the mask and ``dropout_p``; no spill. Every bias
variant, wgmma and FFMA, with dropout and without, single pass and split,
is held on rows whose bias sits at the -1e30 fill or just above it on
every kept key (live: out the kept mean, lse the fill, the backward's p =
1 on each kept key) against the plain forward and backward end to end.

The fp32 forward's FFMA route (``csrc/flash_fwd_f32.cuh``, B1) is held at
the O0 paths' b8 h16 s1024 and b2 h16 s4096 d64 causal and at the shapes
below against the plain version (out 1e-5, lse 1e-5 relative), bitwise on
a rerun and for one batch alone, padding rows exactly zero, one device
launch a call (profiler), no spill, and timed beside SDPA's fp32 forward
and flash_fwd.cu's shuffle-product kernel (its C entry), also at d 128.

The fp32 backward's FFMA route (``csrc/flash_bwd_f32.cuh``: the single
pass, B2, and the split's dk/dv, B3) is held at the O0 paths' shapes and
at ragged s (1000 x 1003, sq != sk), rows with no key, padded head dims
(40 -> 64, 80 -> 128), non-causal and padding segment ids (their dq
exactly zero) against the plain backward, dq, dk and dv bitwise on a
rerun and for one batch alone, its device launches of one call counted
by the profiler (the split: one prologue, dk/dv, then dq on the dk/dv
call's transposed scratch), ptxas's log showing no spill, and timed
beside SDPA's fp32 backward and the shuffle-product kernels of
``csrc/flash_bwd.cu`` it replaced there (through their C entries). Every
O0 flash launch takes an FFMA route: the split's dq (B4) is
``flash_dq_f32_kernel``, held also at b8 h16 s1024 and timed as the
split calls it and alone.

B8 and B9's fp32 route (``csrc/lm_head_ce.cu`` on the exact-FFMA core of
``csrc/simt_f32.cuh``) is held at the O0 path's n 8192, V 32768, h 1024
against its plain versions, bitwise on a rerun, with its device launches
counted and ptxas's log showing no spill, and timed beside the fp32
library composition (TF32 off). The single-pass flash backward's dq is
bitwise on a rerun on both routes and, for one batch, the same bits run
alone.

It holds B13 bitwise against its plain version in five modes and under a
set skip flag, at the GPT's 185,759,744 parameters and a ragged n. The
split flash backward (B3, B4) is held on both routes: the wgmma route
(bf16, b2 h16 s4096 d64 causal and a b1 h4 s2304 segment case) kernel by
kernel against its plain versions (dq with the delta it folds in, dk/dv
from that delta), as a pair against the plain backward and bitwise on a
rerun, with each kernel's ``ptxas`` register count; in fp32 at the same
shape both kernels on the FFMA route (above); each timed apart, and the
split beside the single pass at b8 h16 s1024.

B12's prefill regime (``fp8_mm_prefill_kernel`` in
``csrc/fp8_matmul.cu``: wgmma/TMA, the e4m3 weight converted to bf16 in
registers as the products' A operand, x the B operand; 128 or 64 rows a
block and a cluster of two along K where ``_prefill_plan`` says so) is
held at the four block linears at m 512 beside bf16 ``torch.matmul``, its
plain version and its bound, bitwise on a rerun, the rows of a 9-row call
bitwise the same rows of the 512-row call, one device launch a call
(profiler), ``HGMMA`` in its SASS and no spill; the serve engines' fp8
prefill is traced (device time of one 512-token prompt). B7
(``csrc/layer_norm_bwd.cu``, one cooperative launch: a warp a row to h
1024, a block a row past it, the blocks' dgamma/dbeta partials summed in
block order behind a grid barrier) is held at n8192 h1024 (bf16 and fp32
parameters) and h4096 against its plain version, bitwise on a rerun, one
device launch a call, no spill in any of its kernels.

The decode kernels (B12's decode regime, ``csrc/fp8_matmul.cu``; B5,
``csrc/paged_decode.cu``) are held at the serve engines' shapes: B12 at
the four block linears at m 8 beside bf16 ``torch.matmul`` on the
unquantized weight, B5 in both pool modes at the mixed batch, the
speculative engine's draft call (one active row of 300 keys) and verify
call (five rows of one sequence at 300-304 keys), each beside its bound;
``torch.profiler`` counts one device launch a call of each, and ptxas's
log shows no spill in any of their kernels. The speculative engine's
recorded logits rows must all be bitwise the plain engine's, and each
serve engine's decode step is traced (device time beside wall time).

Each profiler session (the device-launch counts of ``device_launches``,
the traces of ``_profile``) counts only if it recorded the whole of its
calls: a session loses the records of its first launches (none to all,
more as the process ages), so 256 marker kernels are launched before the
calls and 2 after, and a session counts when more than 2 markers are in
it; one with fewer is taken again after a longer wait.

The second-last line of standard output is the card as ``nvidia-smi``
names it, the line before it the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

FLUSH_BYTES = 256 << 20          # > the H100's 50 MB L2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor cores, data sheet
FP32_FLOPS_PER_S = 67e12         # fp32 outside the tensor cores, data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bf16_err(got, ref, floor: float, what: str) -> float:
    """Max |got - ref|, checked against two bf16 ulps of ``ref`` plus an
    absolute ``floor``: both sides round an fp32 result to bf16, so equal
    algorithms land at most an ulp or two apart, and ``floor`` covers the
    kernels' own bf16 roundings (p before the PV product) near zero."""
    diff = (got.float() - ref.float()).abs()
    tol = ref.float().abs() * 2.0 ** -6 + floor
    check(bool((diff <= tol).all()),
          f"{what}: beyond two bf16 ulps + {floor} (max err "
          f"{diff.max().item()})")
    return diff.max().item()


def bound(flops: float, nbytes: float, peak: float = BF16_FLOPS_PER_S):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def grad_err(got, ref, what: str, floor_frac: float = 0.02,
             norm_tol: float = 1e-2) -> float:
    """Two bf16 ulps of ``ref`` plus ``floor_frac`` of its largest value
    element-wise, and ``norm_tol`` in relative norm. The backward kernels
    round p, ds (flash) and the softmax gradient tile (LM-head CE) to bf16
    before their products, as the TPU kernels do, where the plain versions
    keep fp32, and sum in other orders (fixed ones: a rerun is bitwise)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    floor = floor_frac * ref.abs().max().item() + 1e-12
    check(bool((diff <= ref.abs() * 2.0 ** -6 + floor).all()),
          f"{what}: beyond two bf16 ulps + {floor:.3g} (max err "
          f"{diff.max().item()})")
    rel = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    check(rel <= norm_tol, f"{what}: relative norm error {rel} > {norm_tol}")
    return diff.max().item()


# cycles of ``torch.cuda._sleep`` queued before each timed launch: ~150 us
# at the H100's 1.98 GHz, more than a wrapper's 25-72 us of host time
SLEEP_CYCLES = 300_000


class Timer:
    """Median milliseconds of ``fn`` over ``iters`` launches, each timed by
    its own CUDA events after an L2 flush. Device time only: a
    ``torch.cuda._sleep`` queued after the flush and before the start event
    keeps the card busy while the host records the start event and runs
    the wrapper, so the kernel is queued before the card reaches the start
    event and the pair holds no host time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                 device="cuda")
        # a second of large products first, so the clocks have ramped up
        # before the first kernel is timed
        a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1.0:
            a @ a
            torch.cuda.synchronize()

    def __call__(self, fn, iters: int = 30, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _fwd_bound(b, h, sq, sk, d, causal, itemsize, peak=BF16_FLOPS_PER_S,
               live_rows=None):
    """The forward's bound: two products of 2 d flops per live (q, k) pair
    (causal: the end-aligned lower triangle; rows past ``live_rows`` see no
    key), q, k, v read once, out and the fp32 lse written once."""
    rows = sq if live_rows is None else live_rows
    if causal:
        off = sk - sq
        pairs = sum(max(0, min(sk, r + off + 1)) for r in range(rows))
    else:
        pairs = rows * sk
    flops = 4.0 * b * h * d * pairs
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * itemsize \
        + b * h * sq * 4
    return bound(flops, nbytes, peak)


def check_flash(torch, timer):
    """The flash forward on both routes. The wgmma route
    (``csrc/flash_fwd_sm90.cu``; bf16 and fp16 at kernel head dims 64 and
    128): the serve prefill's shape (b1 h16 s512 causal, segment ids
    padding from 300; both block heights timed), the train cells' b8 h16
    s1024 and b2 h16 s4096, ragged shapes, sq != sk, fp16 and a padded
    head dim, a bitwise rerun. flash_fwd.cu's route at bf16 d32; the fp32
    forward (the O0 paths'): :func:`check_flash_fwd_f32`."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    def wgmma_moved(w0, f0):
        return (fa.flash_attention.wgmma_launches - w0,
                fa.flash_attention.launches - f0)

    # the ragged edges: a q tile past sq, keys past sk, sq < sk, sq > sk,
    # fp16, d 80 (padded to 128), and d 32 (flash_fwd.cu's route)
    for b, h, sq, sk, d, causal, dtype, wgmma in (
            (2, 3, 77, 77, 64, True, torch.bfloat16, True),
            (1, 2, 40, 130, 128, True, torch.bfloat16, True),
            (1, 2, 300, 129, 128, True, torch.float16, True),
            (2, 2, 257, 257, 80, True, torch.bfloat16, True),
            (2, 2, 100, 100, 32, False, torch.bfloat16, False)):
        q, k, v = (rand(b, h, s_, d, dtype=dtype) for s_ in (sq, sk, sk))
        n0 = (fa.flash_attention.wgmma_launches, fa.flash_attention.launches)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        check(wgmma_moved(*n0) == (int(wgmma), 1),
              f"flash b{b} sq{sq} sk{sk} d{d} {dtype}: wrong route")
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
        bf16_err(out, ref, 4e-3, f"flash b{b} h{h} sq{sq} sk{sk} d{d}")
        check((lse - ref_lse).abs().max().item() <= 1e-3, "flash lse")

    # the serve prefill's shape: b1 h16 s512 causal, padding from 300
    b, h, s, d, live = 1, 16, 512, 64, 300
    q, k, v = rand(b, h, s, d), rand(b, h, s, d), rand(b, h, s, d)
    sid = torch.where(torch.arange(s, device="cuda") < live, 0, -1)
    sid = sid.to(torch.int32)[None].contiguous()
    scale = d ** -0.5
    n0 = (fa.flash_attention.wgmma_launches, fa.flash_attention.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, sid, None, True, scale)
    check(wgmma_moved(*n0) == (1, 1), "flash serve shape: not the wgmma "
          "route")
    again = fa.flash_attention_fwd(q, k, v, sid, None, True, scale)
    ref, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=True, segment_ids_q=sid, scale=scale)
    torch.cuda.synchronize()
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          "flash forward: a rerun gave other bits")
    err = bf16_err(out, ref, 4e-3, "flash")
    lse_err = (lse - ref_lse).abs().max().item()
    # lse is fp32 in both: only the summation order and ex2 differ
    check(lse_err <= 1e-3, f"flash lse max err {lse_err} > 1e-3")
    check(out[:, :, live:].abs().max().item() == 0.0,
          "flash: padded rows are not exactly zero")
    rows = fa.fwd_block_rows(b * h, s, d, torch.cuda.get_device_properties(
        0).multi_processor_count)
    by_rows = {r: timer(lambda: fa._flash_fwd_cuda(
        q, k, v, sid, None, True, scale, block_rows=r)) for r in (64, 128)}
    ms = timer(lambda: fa.flash_attention_fwd(q, k, v, sid, None, True,
                                              scale))
    plain_ms = timer(lambda: fa.flash_attention_reference(
        q, k, v, causal=True, segment_ids_q=sid, scale=scale))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    t_bound, by = _fwd_bound(b, h, s, s, d, True, 2, live_rows=live)

    def train_shape(tb, ts, iters=30):
        """The forward at a train cell's shape (causal, no segment ids)."""
        tq, tk, tv = (rand(tb, h, ts, d) for _ in range(3))
        tout, tlse = fa.flash_attention_fwd(tq, tk, tv, None, None, True,
                                            scale)
        tref, tref_lse = fa.flash_attention_reference(tq, tk, tv,
                                                      causal=True,
                                                      scale=scale)
        torch.cuda.synchronize()
        t_err = bf16_err(tout, tref, 4e-3, f"flash b{tb} s{ts}")
        check((tlse - tref_lse).abs().max().item() <= 1e-3,
              f"flash b{tb} s{ts} lse")
        del tout, tref, tlse, tref_lse
        tb_ms, tb_by = _fwd_bound(tb, h, ts, ts, d, True, 2)
        return dict(
            shape=f"b{tb} h{h} s{ts} d{d} causal", max_abs_err=t_err,
            ms=timer(lambda: fa.flash_attention_fwd(tq, tk, tv, None, None,
                                                    True, scale), iters),
            plain_ms=timer(lambda: fa.flash_attention_reference(
                tq, tk, tv, causal=True, scale=scale), iters=5),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                tq, tk, tv, is_causal=True, scale=scale), iters),
            bound_ms=tb_ms, bound_by=tb_by)

    wgmma = dict(
        name="flash_fwd_sm90", route="cuda",
        source="apex_tpu_torch/csrc/flash_fwd_sm90.cu",
        replaces="apex_tpu/ops/flash_attention.py:251",
        shape=f"b{b} h{h} s{s} d{d} bf16 causal, segment ids -1 from "
              f"{live}; {rows}-row blocks (fwd_block_rows)",
        max_abs_err=err, tolerance="2 bf16 ulp + 4e-3; lse 1e-3; a rerun "
                                   "bitwise",
        lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms,
        library="F.scaled_dot_product_attention(is_causal=True), no "
                "segment ids",
        ms_by_block_rows=by_rows, train_shape=train_shape(8, 1024),
        long_shape=train_shape(2, 4096, iters=10))
    del q, k, v, out, lse, again, ref, ref_lse

    return [wgmma]


def _paged_inputs(torch, gen, b, kv, g, d, page, m, num_pages, seq_lens,
                  one_table=False):
    """bf16 q and pools; a block table with pages of their own for each row
    (from a seeded permutation), or, with ``one_table``, every row over the
    same pages (a speculative verify call: rows of one sequence)."""
    q = torch.randn(b, kv, g, d, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp = torch.randn(kv, num_pages, page, d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn(kv, num_pages, page, d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    rng = np.random.RandomState(2)
    pages = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((b, m), np.int32)
    used = 0
    for i, n in enumerate(seq_lens):
        need = -(-n // page)
        bt[i, :need] = pages[:need] if one_table else pages[used:used + need]
        used += 0 if one_table else need
    bt = torch.from_numpy(bt).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, sl


def _fp8_pool(torch, gen, kv, num_pages, page, d):
    """An e4m3 pool quantized per (kv head, page) with the codec, as the
    fp8 cache writes it (one scale per page, 2 powers of two of headroom)."""
    from apex_tpu_torch.amp import fp8
    x = torch.randn(kv, num_pages, page, d, generator=gen, device="cuda")
    s = fp8.compute_scale(x.abs().amax(dim=(2, 3)), fp8.E4M3_MAX, 2.0)
    return fp8.quantize(x, s[..., None, None], fp8.E4M3), s


# the serve engines' decode calls: the mixed batch of the bf16 and fp8
# engines, the speculative engine's draft call (one active row in the fixed
# batch of 8) and its verify call (k + 1 = 5 rows of one sequence)
PAGED_SHAPES = (("mixed", [0, 1, 127, 128, 129, 300, 640, 1024], False),
                ("spec_draft", [300, 0, 0, 0, 0, 0, 0, 0], False),
                ("spec_verify", [300, 301, 302, 303, 304, 0, 0, 0], True))


def _paged_bound(bt, seq_lens, kv, g, d, page, item, fp8):
    """Each live K and V row read once (rows that share a page, as a verify
    call's do, once), q and out, the tables, and the fp8 scales of the live
    pages; 4 flops a live key, query row and column."""
    bt = bt.cpu().numpy()
    rows, pages = set(), set()
    for i, n in enumerate(seq_lens):
        for t in range(n):
            rows.add((int(bt[i, t // page]), t % page))
            pages.add(int(bt[i, t // page]))
    b, m = bt.shape
    nbytes = (2 * kv * d * item * len(rows) + 2 * b * kv * g * d * 2
              + b * m * 4 + b * 4 + (2 * kv * len(pages) * 4 if fp8 else 0))
    return bound(4.0 * kv * g * d * sum(seq_lens), nbytes)


def _paged_mode(torch, timer, fp8):
    """B5 at the serve engines' shapes (b8, kv16, g1, d64, page 128, m8) in
    one pool mode: each against its plain version (p and the accumulators
    fp32 on both sides: only summation order and the bf16 output rounding),
    the dead rows exact zeros, then kernel and plain timed beside the
    bound; and its device launches in one call."""
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(8 if fp8 else 3)
    kv, g, d, page, m, num_pages = 16, 1, 64, 128, 8, 72
    what = "paged fp8" if fp8 else "paged"
    shapes, launches = [], None
    for name, seq_lens, one_table in PAGED_SHAPES:
        q, kp, vp, bt, sl = _paged_inputs(torch, gen, 8, kv, g, d, page, m,
                                          num_pages, seq_lens, one_table)
        sc = {}
        if fp8:
            (kp, ks), (vp, vs) = (_fp8_pool(torch, gen, kv, num_pages, page,
                                            d) for _ in range(2))
            sc = dict(k_scales=ks, v_scales=vs)
        out = fa.paged_decode_attention(q, kp, vp, bt, sl, **sc)
        ref = fa.paged_attention_reference(q, kp, vp, bt, sl, **sc)
        torch.cuda.synchronize()
        err = bf16_err(out, ref, 1e-3, f"{what} {name}")
        for i, n in enumerate(seq_lens):
            check(n > 0 or out[i].abs().max().item() == 0.0,
                  f"{what} {name}: inactive slot {i} not zero")
        ms = timer(lambda: fa.paged_decode_attention(q, kp, vp, bt, sl,
                                                     **sc))
        plain_ms = timer(lambda: fa.paged_attention_reference(
            q, kp, vp, bt, sl, **sc))
        t_bound, by = _paged_bound(bt, seq_lens, kv, g, d, page,
                                   1 if fp8 else 2, fp8)
        shapes.append(dict(shape=name, seq_lens=seq_lens, max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, bound_ms=t_bound,
                           bound_by=by))
        if launches is None:
            launches = device_launches(
                torch, fa.paged_decode_attention, (q, kp, vp, bt, sl),
                ("paged_decode_kernel",), sc)
            check(launches == {"paged_decode_kernel": 1, "other": 0},
                  f"{what}: device launches {launches} in one call, "
                  "expected one paged_decode_kernel and nothing else")
    return shapes, launches


def check_paged(torch, timer):
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(3)
    # GQA group 3, a dead slot, a partial page
    q, kp, vp, bt, sl = _paged_inputs(torch, gen, 3, 2, 3, 64, 16, 4, 9,
                                      [13, 0, 64])
    out = fa.paged_decode_attention(q, kp, vp, bt, sl)
    ref = fa.paged_attention_reference(q, kp, vp, bt, sl)
    bf16_err(out, ref, 1e-3, "paged GQA group 3")
    check(out[1].abs().max().item() == 0.0, "paged: dead slot not zero")
    shapes, launches = _paged_mode(torch, timer, fp8=False)
    main = shapes[0]
    return dict(name="paged_decode", route="cuda",
                source="apex_tpu_torch/csrc/paged_decode.cu",
                replaces="apex_tpu/ops/flash_attention.py:986",
                shape=f"b8 kv16 g1 d64 page128 m8 seq_lens "
                      f"{main['seq_lens']} (by_shape: the spec draft and "
                      "verify calls too)",
                max_abs_err=max(x["max_abs_err"] for x in shapes),
                tolerance="2 bf16 ulp + 1e-3", ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None, by_shape=shapes,
                device_launches_per_call=launches,
                registers=_decode_registers(_build, "paged_decode"))


def check_paged_fp8(torch, timer):
    shapes, launches = _paged_mode(torch, timer, fp8=True)
    main = shapes[0]
    return dict(name="paged_decode_fp8", route="cuda",
                source="apex_tpu_torch/csrc/paged_decode.cu",
                replaces="apex_tpu/ops/flash_attention.py:986",
                shape=f"b8 kv16 g1 d64 page128 m8 e4m3 pool, [kv, pages] "
                      f"fp32 scales, seq_lens {main['seq_lens']} (by_shape: "
                      "the spec draft and verify calls too)",
                max_abs_err=max(x["max_abs_err"] for x in shapes),
                tolerance="2 bf16 ulp + 1e-3", ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None, by_shape=shapes,
                device_launches_per_call=launches)


# the block linears of the 12-layer h1024 GPT, [in, out]
FP8_SHAPES = (("qkv", 1024, 3072), ("proj", 1024, 1024), ("fc1", 1024, 4096),
              ("fc2", 4096, 1024))


def check_fp8_matmul(torch, timer):
    """B12 in both regimes at the four block linears: the decode regime at
    the fixed batch (m8) and the prefill regime at one padded prompt
    (m512), each beside bf16 ``torch.matmul`` on the unquantized weight,
    the plain version and its bound; one device launch a call of each
    (profiler); the prefill regime bitwise on a rerun and row-independent
    (the rows of a 9-row call are the bits of the same rows of the 512-row
    call)."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import fp8_matmul as mm
    gen = torch.Generator(device="cuda").manual_seed(9)
    by_regime = {"decode": [], "prefill": []}
    launches = {}
    # decode (m = 8) and prefill (m = 512) at the four linears, then decode
    # qkv once more: the spread of the same measurement within one run
    plan = ([(8, s_) for s_ in FP8_SHAPES] + [(512, s_) for s_ in FP8_SHAPES]
            + [(8, FP8_SHAPES[0])])
    for m, (lin, K, N) in plan:
        regime = "decode" if m <= 8 else "prefill"
        x = torch.randn(m, K, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
        q, scale = mm.quantize_weight(w)
        y = mm.fp8_dequant_matmul(x, q, scale)
        ref = mm.fp8_dequant_matmul_reference(x, q, scale)
        torch.cuda.synchronize()
        # exact operands (every e4m3 value and the bf16 x are exact in
        # fp32), fp32 sums in another order, one bf16 rounding of each
        # side; the floor covers outputs near zero (|y| ~ 1 here)
        err = bf16_err(y, ref, 1e-3, f"fp8_matmul {lin} m{m}")
        wb = w.to(torch.bfloat16)
        ms = timer(lambda: mm.fp8_dequant_matmul(x, q, scale))
        plain_ms = timer(lambda: mm.fp8_dequant_matmul_reference(x, q,
                                                                 scale))
        bf16_ms = timer(lambda: torch.matmul(x, wb))
        nbytes = K * N + m * K * 2 + m * N * 2 + 4
        t_bound, by = bound(2.0 * m * K * N, nbytes)
        row = dict(linear=lin, m=m, K=K, N=N, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                   bf16_matmul_ms=bf16_ms,
                   tflops=2.0 * m * K * N / ms / 1e9,
                   plan=list(mm.launch_plan(m, K, N)))
        by_regime[regime].append(row)
        kernel = ("fp8_mm_decode_kernel" if regime == "decode"
                  else "fp8_mm_prefill_kernel")
        if (regime, lin) not in launches:
            got = device_launches(torch, mm.fp8_dequant_matmul,
                                  (x, q, scale), (kernel,))
            check(got == {kernel: 1, "other": 0},
                  f"fp8_matmul {lin} m{m}: device launches {got} in one "
                  f"call, expected one {kernel} and nothing else")
            launches[(regime, lin)] = got
        if regime == "prefill":
            # a rerun, and rows 300..308 alone, bitwise
            check(torch.equal(y, mm.fp8_dequant_matmul(x, q, scale)),
                  f"fp8_matmul {lin} m{m}: a rerun differs")
            part = mm.fp8_dequant_matmul(x[300:309].contiguous(), q, scale)
            check(torch.equal(part, y[300:309]),
                  f"fp8_matmul {lin}: rows 300..308 alone differ from the "
                  "same rows of the m512 call")
    regs = _decode_registers(_build, "fp8_matmul")
    common = dict(route="cuda", source="apex_tpu_torch/csrc/fp8_matmul.cu",
                  replaces="apex_tpu/ops/fp8_matmul.py:76",
                  tolerance="2 bf16 ulp + 1e-3", library_ms=None,
                  library="none computes it in one call; bf16_matmul_ms is "
                          "torch.matmul on the unquantized bf16 weight, "
                          "what fp8 streaming competes with",
                  registers=regs)
    dec, pre = by_regime["decode"], by_regime["prefill"]
    main = dec[0]                          # decode qkv
    decode = dict(
        name="fp8_matmul", **common,
        shape="m8 K1024 N3072 (decode qkv): bf16 x, e4m3 [K, N] weight, "
              "fp32 device scale (by_shape: the four decode linears)",
        max_abs_err=max(r["max_abs_err"] for r in dec), ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], bf16_matmul_ms=main["bf16_matmul_ms"],
        ms_repeat=dec[-1]["ms"], by_shape=dec,
        device_launches_per_call=launches[("decode", "qkv")])
    main = pre[2]                          # prefill fc1
    prefill = dict(
        name="fp8_matmul_prefill", **common,
        shape="m512 K1024 N4096 (prefill fc1, one padded prompt): bf16 x, "
              "e4m3 [K, N] weight, fp32 device scale (by_shape: the four "
              "prefill linears)",
        max_abs_err=max(r["max_abs_err"] for r in pre), ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], bf16_matmul_ms=main["bf16_matmul_ms"],
        by_shape=pre, device_launches_per_call={
            lin: launches[("prefill", lin)] for lin, _, _ in FP8_SHAPES},
        checked="bitwise on a rerun; a 9-row call's rows bitwise the same "
                "rows of the m512 call")
    return [decode, prefill]


def check_e4m3_cast(torch):
    """The codec's quantize on the card against the CPU's, bitwise: fp32
    values over every e4m3 binade, the subnormals and past the maximum."""
    from apex_tpu_torch.amp import fp8
    gen = torch.Generator(device="cuda").manual_seed(10)
    n = 1 << 20
    x = torch.randn(n, generator=gen, device="cuda") * torch.exp2(
        torch.randint(-14, 12, (n,), generator=gen, device="cuda").float())
    for s in (1.0, 0.37, 12.5, 3e-3):
        sc = torch.tensor(s, device="cuda")
        got = fp8.quantize(x, sc, fp8.E4M3).view(torch.uint8).cpu()
        want = fp8.quantize(x.cpu(), sc.cpu(), fp8.E4M3).view(torch.uint8)
        bad = int((got != want).sum())
        check(bad == 0, f"e4m3 cast: {bad} of {n} bytes differ from the "
              f"CPU's at scale {s}")
    amax = x.abs().amax()
    for margin in (0.0, 2.0):
        a = fp8.compute_scale(amax, fp8.E4M3_MAX, margin).cpu()
        b = fp8.compute_scale(amax.cpu(), fp8.E4M3_MAX, margin)
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              "compute_scale on the card differs from the CPU's")
    return dict(values=n, scales=4, bitwise_equal=True)


def check_layer_norm(torch, timer):
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as ln
    gen = torch.Generator(device="cuda").manual_seed(4)
    h = 1024
    w = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    bb = 0.1 * torch.randn(h, generator=gen, device="cuda")
    shapes = []
    # decode (n8) and prefill (n512) with fp32 params; the O2 train path
    # (n8192) with the bf16 params amp's cast gives it
    for n, p_dtype in ((8, torch.float32), (512, torch.float32),
                       (8192, torch.bfloat16)):
        w, bb = w.to(p_dtype), bb.to(p_dtype)
        x = torch.randn(n, h, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        y = ln.fused_layer_norm_affine(x, w, bb, (h,), 1e-5, torch.bfloat16)
        ref = ln.fused_layer_norm_affine_reference(x, w, bb, (h,), 1e-5,
                                                   torch.bfloat16)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        # both round fp32 results to bf16: at most one bf16 ulp apart
        ulp = ref.float().abs() * 2.0 ** -7 + 1e-6
        check(bool((diff <= ulp).all()), f"LN n{n}: beyond one bf16 ulp")
        ms = timer(lambda: ln.fused_layer_norm_affine(x, w, bb, (h,), 1e-5,
                                                      torch.bfloat16))
        plain_ms = timer(lambda: ln.fused_layer_norm_affine_reference(
            x, w, bb, (h,), 1e-5, torch.bfloat16))
        wb, bbb = w.to(torch.bfloat16), bb.to(torch.bfloat16)
        lib_ms = timer(lambda: F.layer_norm(x, (h,), wb, bbb, 1e-5))
        nbytes = 2 * n * h * 2 + 2 * h * w.element_size()
        t_bound, by = bound(10.0 * n * h, nbytes)
        shapes.append(dict(n=n, h=h, params=str(p_dtype), max_abs_err=err,
                           ms=ms,
                           plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                           library_ms=lib_ms))
    main = shapes[1]                       # the prefill shape, n = 512
    return dict(name="layer_norm_fwd", route="triton",
                source="apex_tpu_torch/ops/layer_norm.py",
                replaces="apex_tpu/ops/layer_norm.py:131",
                shape=f"n512 h{h} bf16 in/out, fp32 params (by_shape: n8, "
                      "and n8192 with bf16 params as on the train path)",
                max_abs_err=max(s["max_abs_err"] for s in shapes),
                tolerance="one bf16 ulp", ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                library="F.layer_norm with bf16 weight/bias",
                by_shape=shapes)


def _grad_of(torch, fn, inputs, dout):
    """A closure timing the autograd backward of ``fn(*inputs)`` (the
    forward runs once, outside the timed call)."""
    ins = [t.detach().requires_grad_() for t in inputs]
    out = fn(*ins)
    return lambda: torch.autograd.grad(out, ins, dout, retain_graph=True)


def _bwd_bound(b, h, s, d, itemsize, peak=BF16_FLOPS_PER_S):
    """The single pass's bound at a causal self-attention shape: five
    products of 2 d flops per live pair (s, dp, dv, dk, dq); q, k, v, out,
    do read and dq, dk, dv written once, lse and delta read once (fp32)."""
    pairs = s * (s + 1) // 2
    return bound(5 * 2.0 * b * h * d * pairs,
                 8 * b * h * s * d * itemsize + 2 * b * h * s * 4, peak)


def check_flash_bwd(torch, timer):
    """The single-pass backward on both routes. The wgmma route
    (``flash_bwd_fused_sm90`` of ``csrc/flash_bwd_sm90.cu``) at the train
    cell's b8 h16 s1024 d64 causal: as called (the delta pass, the zeroing
    of dq_acc and its turn counters, and the cast included) and alone on a
    given delta and dq_acc, beside the split forced at the same shape and
    SDPA's backward; dq, dk and dv bitwise on a rerun and, for the first
    batch, bitwise the same run alone (dq is summed in a fixed order of
    key blocks); segment ids with padding rows, whose dq is exactly zero
    (ptxas's registers and spills: check_flash_split). The fp32 single
    pass (the O0 path's): :func:`check_flash_f32`."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(5)
    f = fa.flash_attention_bwd

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    def moved(n0):
        return (f.wgmma_launches - n0[0], f.launches - n0[1])

    # segment ids with padding rows, at the training width
    b, h, s, d, live = 2, 16, 1024, 64, 700
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    sid = torch.where(torch.arange(s, device="cuda") < live, 0, -1)
    sid = sid.to(torch.int32)[None].expand(b, s).contiguous()
    out, lse = fa.flash_attention_fwd(q, k, v, sid, None, True)
    n0 = (f.wgmma_launches, f.launches)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, sid, None,
                                        True)
    check(moved(n0) == (1, 1), "flash_bwd segments: not the wgmma route")
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, segment_ids_q=sid)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        grad_err(g, r, f"flash_bwd segments {name}")
    check(dq[:, :, live:].abs().max().item() == 0.0,
          "flash_bwd: padding rows got a nonzero dq")

    # the training path's shape: b8 h16 s1024 d64 causal
    b = 8
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                 scale)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                   scale)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, scale=scale)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
          "flash_bwd: dq, dk or dv changed on a rerun")
    _check_first_batch_alone(torch, fa, got, q, k, v, out, lse, do, scale,
                             "flash_bwd")
    err = max(grad_err(g, r, f"flash_bwd {n}")
              for n, g, r in zip(("dq", "dk", "dv"), got, ref))
    del got, again, ref
    delta = (do.float() * out.float()).sum(dim=-1)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    alone_ms = timer(lambda: fa._flash_bwd_fused_cuda(
        q, k, v, do, lse, delta, None, None, True, scale, dq_acc))
    ms = timer(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, None,
                                              None, True, scale))
    split_ms = timer(lambda: fa._flash_bwd_cuda(
        q, k, v, out, lse, do, None, None, True, scale, split=True))
    plain_ms = timer(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True, scale=scale), iters=10)
    lib_ms = timer(_grad_of(torch, lambda a, b_, c: (
        F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                       scale=scale)), (q, k, v), do))
    t_bound, by = _bwd_bound(b, h, s, d, 2)
    wgmma = dict(
        name="flash_bwd_fused_sm90", route="cuda",
        source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
        replaces="apex_tpu/ops/flash_attention.py:604",
        shape=f"b{b} h{h} s{s} d{d} bf16 causal (also b2 with segment ids, "
              f"padding from {live})",
        max_abs_err=err,
        tolerance="2 bf16 ulp + 2% of max, 1% relative norm; dq, dk, dv "
                  "bitwise on a rerun and for one batch alone",
        ms=alone_ms, as_called_ms=ms, split_ms=split_ms, plain_ms=plain_ms,
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms,
        library="backward of F.scaled_dot_product_attention("
                "is_causal=True)")
    del q, k, v, do, out, lse, delta, dq_acc

    return wgmma


# Megatron's --attention-dropout and --hidden-dropout defaults
# (apex/transformer/tensor_parallel/tests/arguments.py:345-348)
DROPOUT_RATE = 0.1
# integer operations of the keep hash an element (csrc/dropout_hash.cuh):
# the xor of the row's and the key's terms, fmix32's three shifts, three
# xors and two multiplies, the compare with the threshold; counted at the
# card's CUDA-core rate (67 TFLOP/s fp32, data sheet), which its int32 rate
# does not exceed, so the bound stays a least time
DROPOUT_HASH_OPS = 10


def _with_hash(t_bound, by, pairs):
    """A flash kernel's bound with its dropout hash: the larger of its
    bytes and products' bound and the hash's integer operations over
    ``pairs`` live elements (separate units: the larger, not the sum)."""
    t_hash = pairs * DROPOUT_HASH_OPS / FP32_FLOPS_PER_S * 1e3
    return (t_hash, "operations") if t_hash > t_bound else (t_bound, by)


def check_flash_dropout(torch, timer):
    """B1's and B2's dropout variants (``flash_fwd_sm90<..., DROP>``,
    ``flash_bwd_fused_sm90<..., DROP>``) at the dropout step's b8 h16 s1024
    d64 bf16 causal, rate 0.1: against the plain versions with the same
    seed (the forward at the bf16 forwards' limits, the plain forward
    rounding the dropped p to bf16 as the kernel does; the gradients at the
    bf16 backwards'); bitwise on a rerun with the seed, another seed
    another result; the mask check (rate 0.5, non-causal, sk = d keys, v
    the identity: out is zero exactly where the plain mask drops, bit for
    bit); each timed with and without dropout beside SDPA's dropout call.
    The forward's variant also at the long-sequence step's b2 h16 s4096
    (``long_shape``): against the plain forward, a bitwise rerun, timed
    the same way."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(7)
    f, g = fa.flash_attention, fa.flash_attention_bwd
    b, h, s, d = TRAIN_B, 16, TRAIN_S, 64
    scale, seed = d ** -0.5, 20261018
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=seed)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    n0 = (f.dropout_launches, g.dropout_launches)
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale,
                                      **drop)
    again = fa.flash_attention_fwd(q, k, v, None, None, True, scale, **drop)
    other = fa.flash_attention_fwd(q, k, v, None, None, True, scale,
                                   DROPOUT_RATE, seed ^ 1)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                   scale, **drop)
    grads2 = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                    scale, **drop)
    other_grads = fa.flash_attention_bwd(q, k, v, other[0], other[1], do,
                                         None, None, True, scale,
                                         DROPOUT_RATE, seed ^ 1)
    torch.cuda.synchronize()
    check((f.dropout_launches - n0[0], g.dropout_launches - n0[1])
          == (3, 3), "flash dropout: the dropout variants did not launch")
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          "flash dropout forward: a rerun gave other bits")
    check(all(torch.equal(a, b_) for a, b_ in zip(grads, grads2)),
          "flash dropout backward: a rerun gave other bits")
    check(not torch.equal(out, other[0])
          and not torch.equal(grads[2], other_grads[2]),
          "flash dropout: another seed gave the same result")
    del again, other, grads2, other_grads
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True,
                                                scale=scale, **drop)
    err = bf16_err(out, ref, 4e-3, "flash dropout forward")
    lse_err = (lse - ref_lse).abs().max().item()
    check(lse_err <= 1e-3, f"flash dropout lse max err {lse_err}")
    del ref, ref_lse
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, scale=scale, **drop)
    berr = max(grad_err(gr, r, f"flash dropout backward {n}")
               for n, gr, r in zip(("dq", "dk", "dv"), grads, ref))
    del grads, ref
    torch.cuda.empty_cache()

    # the mask check: p > 0 everywhere (no mask but dropout), v the
    # identity, so out[q, key] != 0 exactly where the key is kept
    mq, mk = (torch.randn(b, h, n_, d, generator=gen, device="cuda",
                          dtype=torch.bfloat16) for n_ in (s, d))
    eye = torch.eye(d, device="cuda", dtype=torch.bfloat16).expand(
        b, h, d, d).contiguous()
    mout, _ = fa.flash_attention_fwd(mq, mk, eye, None, None, False, scale,
                                     0.5, seed)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    check(torch.equal(mout != 0, keep),
          "flash dropout: the kernel's mask is not the plain mask")
    mask = dict(shape=f"b{b} h{h} sq{s} sk{d} d{d}, rate 0.5, v = I",
                elements=keep.numel(),
                keep_share=keep.float().mean().item(), bitwise=True)
    del mq, mk, eye, mout, keep

    pairs = b * h * s * (s + 1) // 2
    f_bound, f_by = _with_hash(*_fwd_bound(b, h, s, s, d, True, 2), pairs)
    fwd = dict(
        name="flash_fwd_sm90_dropout", route="cuda",
        source="apex_tpu_torch/csrc/flash_fwd_sm90.cu",
        replaces="apex_tpu/ops/flash_attention.py:251",
        shape=f"b{b} h{h} s{s} d{d} bf16 causal, dropout {DROPOUT_RATE}",
        max_abs_err=err, lse_max_abs_err=lse_err,
        tolerance="2 bf16 ulp + 4e-3 of the plain forward with the same "
                  "seed (the dropped p rounded to bf16 as in the kernel); "
                  "lse 1e-3; a rerun bitwise; the mask bitwise",
        ms=timer(lambda: fa.flash_attention_fwd(q, k, v, None, None, True,
                                                scale, **drop)),
        no_dropout_ms=timer(lambda: fa.flash_attention_fwd(
            q, k, v, None, None, True, scale)),
        plain_ms=timer(lambda: fa.flash_attention_reference(
            q, k, v, causal=True, scale=scale, **drop), iters=5),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, dropout_p=DROPOUT_RATE)),
        library="F.scaled_dot_product_attention(is_causal=True, "
                f"dropout_p={DROPOUT_RATE}): its own random stream, a "
                "yardstick only",
        bound_ms=f_bound, bound_by=f_by, mask_check=mask,
        long_shape=_fwd_dropout_long(torch, timer, gen, seed))
    delta = (do.float() * out.float()).sum(dim=-1)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    args = fa._dropout_args(DROPOUT_RATE, seed)
    b_bound, b_by = _with_hash(*_bwd_bound(b, h, s, d, 2), pairs)
    bwd = dict(
        name="flash_bwd_fused_sm90_dropout", route="cuda",
        source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
        replaces="apex_tpu/ops/flash_attention.py:604",
        shape=f"b{b} h{h} s{s} d{d} bf16 causal, dropout {DROPOUT_RATE}",
        max_abs_err=berr,
        tolerance="2 bf16 ulp + 2% of max, 1% relative norm, of the plain "
                  "backward with the same seed; dq, dk, dv bitwise on a "
                  "rerun",
        ms=timer(lambda: fa._flash_bwd_fused_cuda(
            q, k, v, do, lse, delta, None, None, True, scale, dq_acc, None,
            args)),
        no_dropout_ms=timer(lambda: fa._flash_bwd_fused_cuda(
            q, k, v, do, lse, delta, None, None, True, scale, dq_acc)),
        as_called_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, None, None, True, scale, **drop)),
        plain_ms=timer(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=True, scale=scale, **drop),
            iters=5),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                           scale=scale,
                                           dropout_p=DROPOUT_RATE)),
            (q, k, v), do)),
        library="backward of F.scaled_dot_product_attention("
                f"is_causal=True, dropout_p={DROPOUT_RATE})",
        bound_ms=b_bound, bound_by=b_by)
    del q, k, v, do, out, lse, delta, dq_acc
    torch.cuda.empty_cache()
    return [fwd, bwd]


def _fwd_dropout_long(torch, timer, gen, seed):
    """B1's dropout variant at the long-sequence step's attention shape
    (b2 h16 s4096 d64 bf16 causal, rate 0.1): against the plain forward
    with the same seed, a bitwise rerun, timed with and without dropout
    beside SDPA's dropout call."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    b, h, s, d = SPLIT_B, SPLIT_H, SPLIT_S, SPLIT_D
    scale = d ** -0.5
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=seed)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    n0 = fa.flash_attention.dropout_launches
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale,
                                      **drop)
    again = fa.flash_attention_fwd(q, k, v, None, None, True, scale, **drop)
    torch.cuda.synchronize()
    check(fa.flash_attention.dropout_launches - n0 == 2,
          f"flash dropout s{s}: not the dropout variant")
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"flash dropout forward s{s}: a rerun gave other bits")
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True,
                                                scale=scale, **drop)
    err = bf16_err(out, ref, 4e-3, f"flash dropout forward s{s}")
    lse_err = (lse - ref_lse).abs().max().item()
    check(lse_err <= 1e-3, f"flash dropout s{s} lse max err {lse_err}")
    del out, lse, again, ref, ref_lse
    torch.cuda.empty_cache()
    t_bound, by = _with_hash(*_fwd_bound(b, h, s, s, d, True, 2),
                             b * h * s * (s + 1) // 2)
    return dict(
        shape=f"b{b} h{h} s{s} d{d} bf16 causal, dropout {DROPOUT_RATE}",
        max_abs_err=err, lse_max_abs_err=lse_err,
        ms=timer(lambda: fa.flash_attention_fwd(q, k, v, None, None, True,
                                                scale, **drop), iters=10),
        no_dropout_ms=timer(lambda: fa.flash_attention_fwd(
            q, k, v, None, None, True, scale), iters=10),
        plain_ms=timer(lambda: fa.flash_attention_reference(
            q, k, v, causal=True, scale=scale, **drop), iters=3, warmup=1),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, dropout_p=DROPOUT_RATE),
            iters=10),
        bound_ms=t_bound, bound_by=by)


# ---------------------------------------------------------------------------
# the additive bias in B1 and B2 (their BIAS variants), at the shapes of the
# train-mha18 path's attention: b16 h16 s512 d64, fairseq's future mask as a
# [1, 1, 512, 512] fp32 bias, key padding as segment ids
# ---------------------------------------------------------------------------

MHA_E, MHA_HEADS, MHA_S, MHA_B, MHA_LAYERS = 1024, 16, 512, 16, 18
# train-mha16-e1024h8-b1s3072-bias: fairseq's transformer_lm_wiki103 widths
# and context (16 layers, embed 1024, 8 heads, one 3072-token sample)
MHA16_LAYERS, MHA16_HEADS, MHA16_S, MHA16_B = 16, 8, 3072, 1
# its learning rate: at the other paths' 3e-4, Adam's first steps on the
# one sample overshoot (the loss rose for three steps, through the kernels
# and through the plain versions alike, to 4-5 digits: the dynamics, not
# the kernels); the source warms its rate up from 1e-7
MHA16_LR = 1e-4
MHA_MIN_LEN = 384            # each sequence 384-512 real tokens


def mha_lengths(seed=0):
    """The real tokens of each of the path's :data:`MHA_B` sequences."""
    return np.random.RandomState(seed).randint(MHA_MIN_LEN, MHA_S + 1,
                                               MHA_B)


def future_mask(torch, s, device="cuda"):
    """fairseq's additive future mask: [s, s] fp32, 0 on and below the
    diagonal, -inf above it."""
    return torch.triu(torch.full((s, s), float("-inf"), device=device), 1)


def _bias_live_pairs(torch, bias, sid_kv, h):
    """The (query, key) pairs this run's data needs: a finite bias and a
    real key, summed over the batch and the heads."""
    finite = torch.isfinite(bias).expand(sid_kv.shape[0], -1, -1, -1)
    real = (sid_kv >= 0)[:, None, None, :]
    per = (finite & real).sum(dim=(2, 3)).double()          # [b, h|1]
    return float(per.sum() * (h if bias.shape[1] == 1 else 1))


def _bias_cases(torch):
    """Shapes the bias variants are held at beside the path's: bf16 and
    fp16, head dims 64 and 128, the four broadcast shapes, sq != sk, odd
    sk, segment ids with padding, a row whose bias is -inf everywhere."""
    bf, f16 = torch.bfloat16, torch.float16
    # (dtype, d, bias dims, b, h, sq, sk, causal, segment ids, dead row)
    return [(bf, 64, (1, 1), 2, 4, 512, 512, False, False, 7),
            (f16, 64, (1, 4), 2, 4, 300, 700, True, False, None),
            (bf, 128, (2, 1), 2, 4, 257, 513, False, True, None),
            (f16, 128, (2, 4), 2, 4, 640, 333, False, False, 100),
            (bf, 64, (3, 2), 3, 2, 128, 129, True, True, None),
            (bf, 128, (1, 1), 2, 16, 1024, 1024, False, True, 3)]


def _bias_case_inputs(torch, gen, case, what):
    """One :func:`_bias_cases` shape's q, k, v, do, bias (2 x randn with a
    fifth of its elements -inf, key 0 finite in every row, the dead row
    -inf everywhere), segment ids (or None) and scale, and its name."""
    dtype, d, (bb, bh), b, h, sq, sk, causal, seg, dead = case
    q, do = (torch.randn(b, h, sq, d, generator=gen, device="cuda",
                         dtype=dtype) for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, generator=gen, device="cuda",
                        dtype=dtype) for _ in range(2))
    bias = 2 * torch.randn(bb, bh, sq, sk, generator=gen, device="cuda")
    bias[torch.rand(bias.shape, generator=gen, device="cuda") < 0.2] = \
        float("-inf")
    bias[..., 0] = 0.0
    if dead is not None:
        bias[:, :, dead] = float("-inf")
    sid_q = sid_kv = None
    if seg:
        sid_q = torch.zeros(b, sq, dtype=torch.int32, device="cuda")
        sid_q[-1, sq - 5:] = -1
        sid_kv = torch.zeros(b, sk, dtype=torch.int32, device="cuda")
        sid_kv[0, sk - 9:] = -1
    name = f"{what} {str(dtype)[6:]} d{d} {bb}x{bh} b{b} h{h} sq{sq} " \
           f"sk{sk}{' causal' if causal else ''}"
    return q, k, v, do, bias, sid_q, sid_kv, d ** -0.5, name


def _bias_case(torch, fa, gen, case):
    """One :func:`_bias_cases` shape: the forward at both block heights and
    the single pass (forced: the gate would split some of these) against
    the plain versions with the same bias, the dead row exactly zero with
    lse -1e30; returns the largest forward and gradient errors."""
    *_, causal, _, dead = case
    q, k, v, do, bias, sid_q, sid_kv, scale, what = _bias_case_inputs(
        torch, gen, case, "flash bias")
    ref, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
        scale=scale, bias=bias)
    err = 0.0
    for rows in (64, 128):
        out, lse = fa._flash_fwd_cuda(q, k, v, sid_q, sid_kv, causal, scale,
                                      block_rows=rows, bias=bias)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()),
              f"{what} rows{rows}: a non-finite output")
        err = max(err, bf16_err(out, ref, 4e-3, f"{what} rows{rows}"))
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= 1e-3, f"{what} rows{rows}: lse max err {lse_err}")
        if dead is not None:
            check(out[:, :, dead].abs().max().item() == 0.0
                  and bool((lse[:, :, dead] == -1e30).all()),
                  f"{what}: the row with no live key is not zero, -1e30")
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               scale, split=False, bias=bias)
    rgrads = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
        segment_ids_kv=sid_kv, scale=scale, bias=bias)
    torch.cuda.synchronize()
    gerr = max(grad_err(g, r, f"{what} {n}") for n, g, r in
               zip(("dq", "dk", "dv"), grads, rgrads))
    if dead is not None:
        check(grads[0][:, :, dead].abs().max().item() == 0.0,
              f"{what}: the row with no live key got a nonzero dq")
    return what, err, gerr


# the positions check's dq and dk: exactly 0 in exact arithmetic, rounding
# noise of O(1) fp32 sums on both sides (1.3e-6 on an H100)
POSITIONS_DQ_TOL = 1e-4


def _bias_positions(torch, fa, gen):
    """The bias's positions, bitwise: one-hot rows (0 at key pi(q), a
    different permutation for each (batch, head), -inf elsewhere), so
    each row's p is exactly 1 at pi(q): out is v[pi(q)] bit for bit, lse is
    the score s[q, pi(q)] * scale (1e-3), and in the backward dv is do
    permuted bit for bit (p rounds to exactly 1 in do's dtype). dq and dk
    are exactly 0 in exact arithmetic (ds = p (dp - delta) with dp = delta
    where p is 1): both sides give rounding noise of delta and dp, summed
    in other orders, held below :data:`POSITIONS_DQ_TOL`."""
    b, h, s, d = 2, 3, 256, 64
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    perm = torch.stack([torch.randperm(s, generator=gen, device="cuda")
                        for _ in range(b * h)]).view(b, h, s)
    bias = torch.full((b, h, s, s), float("-inf"), device="cuda")
    bias.scatter_(3, perm[..., None], 0.0)
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, scale=scale, bias=bias)
    idx = perm[..., None].expand(b, h, s, d)
    check(torch.equal(out, v.gather(2, idx)),
          "flash bias positions: out is not v[pi(q)] bit for bit")
    score = (q.float() * k.float().gather(2, idx)).sum(-1) * scale
    lse_err = (lse - score).abs().max().item()
    check(lse_err <= 1e-3, f"flash bias positions: lse max err {lse_err}")
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, False,
                                    scale, split=False, bias=bias)
    want = torch.empty_like(do).scatter_(2, idx, do)
    torch.cuda.synchronize()
    check(torch.equal(dv, want),
          "flash bias positions: dv is not do permuted bit for bit")
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           scale=scale, bias=bias)
    noise = max(t.float().abs().max().item()
                for t in (dq, dk, ref[0], ref[1]))
    check(noise <= POSITIONS_DQ_TOL, f"flash bias positions: dq or dk "
          f"{noise}, exactly 0 in exact arithmetic")
    return dict(shape=f"b{b} h{h} s{s} d{d} bf16, [b, h, s, s] one-hot "
                      "rows", out_bitwise=True, dv_bitwise=True,
                lse_max_abs_err=lse_err, dq_dk_max_abs=noise)


# rows of the fill cases: a bias at the -1e30 fill itself or just above it
# (-8e29: below the fill in base-2 units) on every key the causal mask
# keeps, and a row -inf everywhere
FILL_ROWS = {3: -1e30, 9: -1e30, 5: -8e29, 12: -8e29}
FILL_DEAD_ROW = 7
FILL_SEED = 20261024


def _fill_rows_case(torch, fa, gen, dtype, d, split, rate):
    """Rows whose bias is at the -1e30 fill or just above it on every key
    the causal mask keeps (:data:`FILL_ROWS`) beside finite rows and a row
    -inf everywhere, b2 h2 s256 in ``dtype`` at head dim ``d``, dropout
    ``rate``: the forward (the wgmma route at both block heights) and the
    single pass or the split (``split``, forced) against the plain forward
    and backward end to end (the plain backward from the plain lse: the
    kernels' lse of such a row is the rounded score, which may sit an ulp
    from the plain one). A fill row is live, as in the Pallas kernels: out
    the mean of v over the kept keys (the dropped mean with dropout), lse
    the fill, and the backward's p = 1 on each kept key, so its dq is
    finite and not zero; the -inf row is dead (out and dq exactly 0, lse
    the fill). fp32 takes the fp32 limits, bf16 and fp16 the bias
    variants'."""
    b, h, s = 2, 2, 256
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=dtype) for _ in range(4))
    bias = torch.randn(1, h, s, s, generator=gen, device="cuda")
    for row, fill in FILL_ROWS.items():
        bias[:, :, row] = fill
    bias[:, :, FILL_DEAD_ROW] = float("-inf")
    scale = d ** -0.5
    drop = dict(dropout_rate=rate, dropout_seed=FILL_SEED if rate else None)
    kw = dict(causal=True, scale=scale, bias=bias, **drop)
    what = (f"fill rows {str(dtype)[6:]} d{d} "
            f"{'split' if split else 'single pass'} dropout {rate}")
    fp32 = dtype == torch.float32
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    rgrads = fa.flash_attention_bwd_reference(q, k, v, ref, ref_lse, do, **kw)
    rows = sorted(FILL_ROWS)
    err = lse_err = 0.0
    for block_rows in ((None,) if fp32 else (64, 128)):
        out, lse = fa._flash_fwd_cuda(q, k, v, None, None, True, scale,
                                      block_rows=block_rows, bias=bias,
                                      **drop)
        torch.cuda.synchronize()
        err = max(err, _fp32_err(out, ref, f"{what} forward", FP32_FWD_TOL)
                  if fp32 else bf16_err(out, ref, 4e-3,
                                        f"{what} rows{block_rows}"))
        rel = ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max()
        lse_err = max(lse_err, rel.item())
        check(rel.item() <= (FP32_FWD_TOL if fp32 else 1e-3),
              f"{what} rows{block_rows}: lse relative err {rel.item()}")
        check(bool((lse[:, :, rows] < -6e29).all()) and (rate or bool(
            (out[:, :, rows].float().abs().amax(-1) > 0).all())),
              f"{what} rows{block_rows}: a fill row is not live")
        check(out[:, :, FILL_DEAD_ROW].abs().max().item() == 0.0
              and bool((lse[:, :, FILL_DEAD_ROW] == -1e30).all()),
              f"{what} rows{block_rows}: the -inf row is not zero, -1e30")
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                               scale, split=split, bias=bias, **drop)
    torch.cuda.synchronize()
    gerr = 0.0
    for n, g_, r in zip(("dq", "dk", "dv"), grads, rgrads):
        check(bool(torch.isfinite(g_.float()).all()),
              f"{what} {n}: not finite")
        gerr = max(gerr, _fp32_err(g_, r, f"{what} {n}", FP32_GRAD_TOL)
                   if fp32 else grad_err(g_, r, f"{what} {n}"))
    check(bool((grads[0][:, :, rows].float().abs().amax(-1) > 0).all())
          and grads[0][:, :, FILL_DEAD_ROW].abs().max().item() == 0.0,
          f"{what}: a fill row's dq is zero, or the -inf row's is not")
    return dict(case=what, max_abs_err=err, lse_rel_err=lse_err,
                grad_max_abs_err=gerr)


def _fill_rows_cases(torch, fa, gen, dtypes, splits, rate):
    """:func:`_fill_rows_case` at head dims 64 and 128 for each dtype and
    backward."""
    return [_fill_rows_case(torch, fa, gen, dt, d, sp, rate)
            for dt in dtypes for d in (64, 128) for sp in splits]


def check_flash_bias(torch, timer):
    """B1's and B2's bias variants (``flash_fwd_sm90<..., BIAS>``,
    ``flash_bwd_fused_sm90<..., BIAS>``) at the train-mha18 path's
    attention (b16 h16 s512 d64 bf16, the [1, 1, 512, 512] future mask as
    the bias, key padding as segment ids): against the plain versions with
    the same bias (the bf16 forwards' and backwards' limits), a rerun
    bitwise; the positions check (:func:`_bias_positions`), the other
    shapes (:func:`_bias_cases`) and the rows at the -1e30 fill
    (:func:`_fill_rows_cases`, the single pass); each timed with and
    without the bias beside its plain version and SDPA with the mask as
    ``attn_mask``."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(19)
    f, g = fa.flash_attention, fa.flash_attention_bwd
    checked = [_bias_case(torch, fa, gen, c) for c in _bias_cases(torch)]
    positions = _bias_positions(torch, fa, gen)
    fill = _fill_rows_cases(torch, fa, gen, (torch.bfloat16, torch.float16),
                            (False,), 0.0)
    torch.cuda.empty_cache()

    b, h, s, d = MHA_B, MHA_HEADS, MHA_S, MHA_E // MHA_HEADS
    scale = d ** -0.5
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    bias = future_mask(torch, s)[None, None]
    lens = torch.from_numpy(mha_lengths()).cuda()
    sid_kv = torch.where(torch.arange(s, device="cuda")[None] < lens[:, None],
                         0, -1).to(torch.int32)
    sid_q = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    seg = (sid_q, sid_kv)
    n0 = (f.bias_launches, g.bias_launches)
    out, lse = fa.flash_attention_fwd(q, k, v, *seg, False, scale, bias=bias)
    again = fa.flash_attention_fwd(q, k, v, *seg, False, scale, bias=bias)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, *seg, False, scale,
                                   bias=bias)
    grads2 = fa.flash_attention_bwd(q, k, v, out, lse, do, *seg, False,
                                    scale, bias=bias)
    torch.cuda.synchronize()
    check((f.bias_launches - n0[0], g.bias_launches - n0[1]) == (2, 2),
          "flash bias: the bias variants did not launch")
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          "flash bias forward: a rerun gave other bits")
    check(all(torch.equal(a, b_) for a, b_ in zip(grads, grads2)),
          "flash bias backward: a rerun gave other bits")
    del again, grads2
    ref, ref_lse = fa.flash_attention_reference(
        q, k, v, segment_ids_q=sid_q, segment_ids_kv=sid_kv, scale=scale,
        bias=bias)
    err = bf16_err(out, ref, 4e-3, "flash bias forward")
    lse_err = (lse - ref_lse).abs().max().item()
    check(lse_err <= 1e-3, f"flash bias lse max err {lse_err}")
    del ref, ref_lse
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
        scale=scale, bias=bias)
    berr = max(grad_err(gr, r, f"flash bias backward {n}")
               for n, gr, r in zip(("dq", "dk", "dv"), grads, ref))
    del grads, ref
    torch.cuda.empty_cache()

    # SDPA's yardstick: the same function with the bias and the padding as
    # one additive mask [b, 1, s, s] in q's dtype
    mask = (bias + torch.where(sid_kv < 0, float("-inf"), 0.0)[:, None, None]
            ).to(torch.bfloat16)
    pairs = _bias_live_pairs(torch, bias, sid_kv, h)
    bias_bytes = bias.numel() * 4 + 2 * b * s * 4          # and the ids
    f_bound = bound(4.0 * d * pairs,
                    (4 * b * h * s * d) * 2 + b * h * s * 4 + bias_bytes)
    b_bound = bound(10.0 * d * pairs,
                    8 * b * h * s * d * 2 + 2 * b * h * s * 4 + bias_bytes)
    shape = (f"b{b} h{h} s{s} d{d} bf16, bias [1, 1, {s}, {s}] fp32 (future "
             f"mask), key padding {MHA_MIN_LEN}-{s}")
    fwd = dict(
        name="flash_fwd_sm90_bias", route="cuda",
        source="apex_tpu_torch/csrc/flash_fwd_sm90.cu",
        replaces="apex_tpu/ops/flash_attention.py:251",
        shape=shape, max_abs_err=err, lse_max_abs_err=lse_err,
        tolerance="2 bf16 ulp + 4e-3 of the plain forward with the same "
                  "bias; lse 1e-3; a rerun bitwise; the positions bitwise",
        ms=timer(lambda: fa.flash_attention_fwd(q, k, v, *seg, False, scale,
                                                bias=bias)),
        no_bias_ms=timer(lambda: fa.flash_attention_fwd(q, k, v, *seg, False,
                                                        scale)),
        plain_ms=timer(lambda: fa.flash_attention_reference(
            q, k, v, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
            scale=scale, bias=bias), iters=5),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)),
        library="F.scaled_dot_product_attention(attn_mask=the bias and the "
                "padding as one [b, 1, s, s] bf16 mask)",
        bound_ms=f_bound[0], bound_by=f_bound[1], live_pairs=pairs,
        positions=positions, fill_rows=fill,
        checked=[dict(case=w, max_abs_err=e, grad_max_abs_err=ge)
                 for w, e, ge in checked])
    delta = (do.float() * out.float()).sum(dim=-1)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    bop = fa._bias_operand(bias, b, h, s, s, q.device)
    bwd = dict(
        name="flash_bwd_fused_sm90_bias", route="cuda",
        source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
        replaces="apex_tpu/ops/flash_attention.py:604",
        shape=shape, max_abs_err=berr,
        tolerance="2 bf16 ulp + 2% of max, 1% relative norm, of the plain "
                  "backward with the same bias; dq, dk, dv bitwise on a "
                  "rerun; dv of the positions check bitwise",
        ms=timer(lambda: fa._flash_bwd_fused_cuda(
            q, k, v, do, lse, delta, *seg, False, scale, dq_acc, None,
            (0, 0, 1.0), bop)),
        no_bias_ms=timer(lambda: fa._flash_bwd_fused_cuda(
            q, k, v, do, lse, delta, *seg, False, scale, dq_acc)),
        as_called_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, *seg, False, scale, bias=bias)),
        plain_ms=timer(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, segment_ids_q=sid_q,
            segment_ids_kv=sid_kv, scale=scale, bias=bias), iters=5),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, attn_mask=mask,
                                           scale=scale)), (q, k, v), do)),
        library="backward of F.scaled_dot_product_attention(attn_mask=the "
                "same mask)",
        bound_ms=b_bound[0], bound_by=b_bound[1], live_pairs=pairs)
    del q, k, v, do, out, lse, delta, dq_acc, mask, bop
    torch.cuda.empty_cache()
    return [fwd, bwd]


def _check_first_batch_alone(torch, fa, got, q, k, v, out, lse, do, scale,
                             what):
    """The single pass's gradients of the first batch, run alone, are the
    same bits as in the full batch's run: each query tile's dq is summed in
    an order of its own key blocks, whatever else shares the grid."""
    one = fa.flash_attention_bwd(q[:1], k[:1], v[:1], out[:1], lse[:1],
                                 do[:1], None, None, True, scale)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b_[:1]) for a, b_ in zip(one, got)),
          f"{what}: the first batch's gradients differ run alone")


def check_layer_norm_bwd(torch, timer):
    """B7 (``csrc/layer_norm_bwd.cu``) at the O2 train path's n8192 h1024
    with bf16 and fp32 parameters, and at h4096 (the block-rows kernel):
    against the plain version, bitwise on a rerun, one device launch a call
    (dgamma and dbeta summed and cast in the same launch); timed beside the
    plain version and ``F.layer_norm``'s autograd backward."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import layer_norm as ln
    gen = torch.Generator(device="cuda").manual_seed(6)
    n, h = 8192, 1024
    x = torch.randn(n, h, generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn(n, h, generator=gen, device="cuda").to(torch.bfloat16)
    errs, kernels = [], {}
    for hh, p_dtype in ((h, torch.float32), (4096, torch.bfloat16),
                        (h, torch.bfloat16)):
        xx = x if hh == h else torch.randn(
            n, hh, generator=gen, device="cuda").to(torch.bfloat16)
        dd = dy if hh == h else torch.randn(
            n, hh, generator=gen, device="cuda").to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(hh, generator=gen, device="cuda")).to(
            p_dtype)
        got = ln.layer_norm_bwd(xx, w, dd, (hh,), 1e-5, p_dtype)
        ref = ln.layer_norm_bwd_reference(xx, w, dd, (hh,), 1e-5, p_dtype)
        torch.cuda.synchronize()
        # dx: fp32 math on both sides, one rounding to bf16 (one ulp);
        # dgamma/dbeta: fp32 sums over 8192 rows in another order
        d = (got[0].float() - ref[0].float()).abs()
        check(bool((d <= ref[0].float().abs() * 2.0 ** -7 + 1e-6).all()),
              f"LN bwd h{hh} dx beyond one bf16 ulp (max err "
              f"{d.max().item()})")
        for name, g, r in zip(("dw", "db"), got[1:], ref[1:]):
            ulp = 2.0 ** -7 if p_dtype == torch.bfloat16 else 0.0
            d = (g.float() - r.float()).abs()
            tol = r.float().abs() * ulp + 1e-4 * r.float().abs().max().item()
            check(bool((d <= tol).all()),
                  f"LN bwd h{hh} {name} ({p_dtype}) max err {d.max().item()}")
        errs.append(max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(got, ref)))
        again = ln.layer_norm_bwd(xx, w, dd, (hh,), 1e-5, p_dtype)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"LN bwd h{hh}: a rerun differs")
        variant = ln._ln_bwd_plan(n, hh, ln._sm_count(x.device))[0]
        name = f"ln_bwd_{variant}"
        got = device_launches(torch, ln.layer_norm_bwd,
                              (xx, w, dd, (hh,), 1e-5, p_dtype), (name,))
        check(got == {name: 1, "other": 0},
              f"LN bwd h{hh}: device launches {got} in one call, expected "
              f"one {name} and nothing else")
        kernels[f"h{hh} {p_dtype}"] = got
    # w is the bf16 weight of the O2 main path from here on
    b_ = torch.zeros(h, device="cuda", dtype=torch.bfloat16)
    ms = timer(lambda: ln.layer_norm_bwd(x, w, dy, (h,), 1e-5))
    plain_ms = timer(lambda: ln.layer_norm_bwd_reference(x, w, dy, (h,),
                                                         1e-5))
    lib_ms = timer(_grad_of(torch, lambda a, ww, bb: F.layer_norm(
        a, (h,), ww, bb, 1e-5), (x, w, b_), dy))
    nbytes = 3 * n * h * 2 + 3 * h * 2
    t_bound, by = bound(20.0 * n * h, nbytes)
    return dict(name="layer_norm_bwd", route="cuda",
                source="apex_tpu_torch/csrc/layer_norm_bwd.cu",
                replaces="apex_tpu/ops/layer_norm.py:141",
                shape=f"n{n} h{h} bf16 x/dy, bf16 params (and fp32 params; "
                      "h4096 on the block-rows kernel)",
                max_abs_err=max(errs),
                tolerance="dx one bf16 ulp; dgamma/dbeta one ulp + 1e-4 of "
                          "max",
                ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                library_ms=lib_ms,
                library="backward of F.layer_norm (bf16 w/b)",
                checked="bitwise on a rerun at each shape",
                device_launches_per_call=kernels,
                plan=list(ln._ln_bwd_plan(n, h, ln._sm_count(x.device))),
                registers=_ln_bwd_registers(_build))


CE_PRODUCTS = ("GradEpi", "DxEpi", "DeEpi")   # B9's three epilogues


# torch.cuda._sleep's kernel: launched LEAD_MARKERS times just before the
# profiled calls of each session and TAIL_MARKERS times just after, it
# shows whether the session recorded them all
MARKER = "spin_kernel"
LEAD_MARKERS, TAIL_MARKERS = 256, 2
# host seconds each profiler session waits before its first launch, one
# session after the other
LEADS = (0.1, 0.2, 0.4, 0.8, 1.6, 1.6, 1.6, 1.6)
# profiler sessions taken: every marker recorded, the first markers'
# records lost (still whole), dropped
SESSIONS = {"all markers": 0, "first markers lost": 0, "dropped": 0}


def _whole_sessions(torch, fn):
    """torch.profiler sessions over one run of ``fn``, one for each of
    :data:`LEADS`, yielding ``(kernels, wall_us)`` (its device events
    without the markers, the host time of ``fn`` and a synchronize) for
    each session that recorded the whole run. A session loses the records
    of its first launches, none to all of them, the more the longer the
    process has run (seen on an H100: the first one in every session after
    a few minutes of this script, hundreds or every one in some). So
    :data:`LEAD_MARKERS` marker kernels are launched before ``fn`` and
    :data:`TAIL_MARKERS` after, and a session counts when more than the
    tail's are recorded: then the losses ended before ``fn``. A session
    with fewer is dropped, and the next waits longer before it starts."""
    from torch.profiler import ProfilerActivity, profile
    for lead in LEADS:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(lead)
            for _ in range(LEAD_MARKERS):
                torch.cuda._sleep(1000)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            for _ in range(TAIL_MARKERS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        marks = sum(e.count for e in kern if MARKER in e.key)
        if marks > TAIL_MARKERS:
            SESSIONS["all markers" if marks == LEAD_MARKERS + TAIL_MARKERS
                     else "first markers lost"] += 1
            yield [e for e in kern if MARKER not in e.key], wall_us
        else:
            SESSIONS["dropped"] += 1
            print(f"profiler: a session with a {lead} s lead recorded "
                  f"{marks} of its {LEAD_MARKERS + TAIL_MARKERS} markers; "
                  "taken again", flush=True)


def device_launches(torch, func, args, names, kwargs=None):
    """torch.profiler over one call ``func(*args, **kwargs)`` (after one
    unprofiled): the device kernels it launched, counted by which of
    ``names`` their name holds (each kernel must hold at most one),
    ``other`` for the rest: the counts two profiler sessions that recorded
    the whole call (:func:`_whole_sessions`) agree on."""
    def fn():
        func(*args, **(kwargs or {}))

    fn()
    torch.cuda.synchronize()
    seen = []
    for kern, _ in _whole_sessions(torch, fn):
        counts = dict.fromkeys(tuple(names) + ("other",), 0)
        for ev in kern:
            hit = [p for p in names if p in ev.key]
            counts[hit[0] if len(hit) == 1 else "other"] += ev.count
        if counts in seen:
            return counts
        seen.append(counts)
    check(False, f"device launches of {func.__name__}: no two of the "
          f"profiler sessions that recorded the whole call agree: {seen}")


def check_lm_head_ce(torch, timer):
    """B8 and B9, the wgmma/TMA kernels of ``csrc/lm_head_ce_sm90.cu``, at
    the GPT step's n 8192, V 32768, h 1024 in bf16: against the plain
    versions (label smoothing 0 and 0.1), the backward's dx and dE bitwise
    on a second run, its device launches counted by the profiler (three
    products a token chunk and nothing else), then kernel, plain and
    library timed."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import lm_head_ce as ce
    gen = torch.Generator(device="cuda").manual_seed(7)
    n, V, h = 8192, 32768, 1024
    x = torch.randn(n, h, generator=gen, device="cuda").to(torch.bfloat16)
    e = (0.02 * torch.randn(V, h, generator=gen, device="cuda")).to(
        torch.bfloat16)
    tgt = torch.randint(0, V, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    dl = torch.full((n,), 1.0 / n, device="cuda")
    fwd_err, bwd_err = 0.0, 0.0
    for ls in (0.0, 0.1):
        got = ce.lm_head_ce_fwd(x, e, tgt, ls > 0)
        ref = ce.lm_head_ce_fwd_reference(x, e, tgt, ls > 0)
        torch.cuda.synchronize()
        # fp32 sums of the same exact products in another order
        for name, a, r in zip(("m", "l", "pred", "ssum"), got, ref):
            if r is None:
                continue
            err = (a - r).abs().max().item()
            check(err <= 1e-4 * (r.abs().max().item() + 1.0),
                  f"CE fwd {name} (ls {ls}) max err {err}")
            fwd_err = max(fwd_err, err)
        m, l = ref[0], ref[1]
        dx, de = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, ls)
        rx, re = ce.lm_head_ce_bwd_reference(x, e, tgt, m, l, dl, ls)
        torch.cuda.synchronize()
        bwd_err = max(bwd_err, grad_err(dx, rx, f"CE bwd dx (ls {ls})"),
                      grad_err(de, re, f"CE bwd dE (ls {ls})"))
        dx2, de2 = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, ls)
        check(torch.equal(dx, dx2) and torch.equal(de, de2),
              f"CE bwd (ls {ls}): two runs differ (no atomics: they must "
              "not)")
        del got, ref, dx, de, rx, re, dx2, de2
    m, l, _, _ = ce.lm_head_ce_fwd_reference(x, e, tgt)
    chunks = -(-n // ce.bwd_chunk_tokens(n, V))
    # B9's launches, by the wgmma core's epilogue they carry
    # (``gemm_kernel<GradEpi<...>>`` and so on)
    products = device_launches(torch, ce.lm_head_ce_bwd,
                               (x, e, tgt, m, l, dl), CE_PRODUCTS)
    check(products == {**dict.fromkeys(CE_PRODUCTS, chunks), "other": 0},
          f"CE bwd: device launches {products} in one call, expected each "
          f"of {CE_PRODUCTS} once a chunk ({chunks} chunks) and no other")
    fwd_ms = timer(lambda: ce.lm_head_ce_fwd(x, e, tgt), iters=10)
    fwd_plain = timer(lambda: ce.lm_head_ce_fwd_reference(x, e, tgt),
                      iters=10)
    fwd_lib = timer(lambda: F.cross_entropy(F.linear(x, e).float(),
                                            tgt.long()), iters=10)
    bwd_ms = timer(lambda: ce.lm_head_ce_bwd(x, e, tgt, m, l, dl), iters=10)
    bwd_plain = timer(lambda: ce.lm_head_ce_bwd_reference(
        x, e, tgt, m, l, dl), iters=5)
    bwd_lib = timer(_grad_of(torch, lambda a, w: F.cross_entropy(
        F.linear(a, w).float(), tgt.long()), (x, e),
        torch.ones((), device="cuda")), iters=10)
    prod = 2.0 * n * V * h
    io = n * h * 2 + V * h * 2 + n * 4
    fb, fby = bound(prod, io + 4 * n * 4)
    bb, bby = bound(3 * prod, io + 3 * n * 4 + V * h * 2 + n * h * 2)
    common = dict(route="cuda",
                  source="apex_tpu_torch/csrc/lm_head_ce_sm90.cu",
                  shape=f"n{n} V{V} h{h} bf16 x/E, int32 targets; label "
                        "smoothing 0 and 0.1 checked")
    return [
        dict(name="lm_head_ce_fwd", replaces="apex_tpu/ops/lm_head_ce.py:162",
             max_abs_err=fwd_err, tolerance="1e-4 of max (fp32 stats)",
             ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fb, bound_by=fby,
             library_ms=fwd_lib,
             library="two calls: F.linear then F.cross_entropy on fp32 "
                     "logits", **common),
        dict(name="lm_head_ce_bwd", replaces="apex_tpu/ops/lm_head_ce.py:198",
             max_abs_err=bwd_err,
             tolerance="2 bf16 ulp + 2% of max, 1% relative norm",
             ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
             library_ms=bwd_lib,
             library="autograd backward of F.linear + F.cross_entropy",
             device_launches_per_call=products, **common),
    ]


# B8 and B9's fp32 kernels (csrc/lm_head_ce.cu) by name
CE32_KERNELS = ("ce32_transpose_kernel", "ce32_fwd_kernel",
                "ce32_grad_kernel", "ce32_product_kernel")


def _ce32_registers(build):
    """``ptxas -v``'s registers and spill bytes of each fp32 CE kernel;
    fails on a spill."""
    regs, name = {}, None
    log_text = build.library_path(build.dtype_target("lm_head_ce", 2)) \
        .with_suffix(".log").read_text()
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in CE32_KERNELS if k in m.group(1)), None)
            if name:
                regs[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            regs[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            check(regs[name]["spill_bytes"] == 0,
                  f"lm_head_ce@f32 {name}: ptxas spills "
                  f"{regs[name]['spill_bytes']} bytes")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name]["registers"] = int(m.group(1))
    check(set(regs) == set(CE32_KERNELS),
          f"lm_head_ce@f32: kernels in ptxas's log {sorted(regs)}")
    return regs


def check_lm_head_ce_f32(torch, timer):
    """B8 and B9's fp32 route (``csrc/lm_head_ce.cu`` on the FFMA core of
    ``csrc/simt_f32.cuh``) at the O0 path's n 8192, V 32768, h 1024:
    against the plain versions (label smoothing 0 and 0.1; the statistics
    within 1e-4 of the largest, the gradients FP32_GRAD_TOL), dx and dE
    bitwise on a second run, the device launches of one call counted by
    the profiler (the forward: two transposes and one product kernel; the
    backward: two transposes, then a logits kernel and two products a
    token chunk, and nothing else), ptxas's registers with no spill; then
    kernel, plain and library timed, the library in exact fp32 (TF32 off,
    float32 matmul precision "highest", both recorded)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import lm_head_ce as ce
    gen = torch.Generator(device="cuda").manual_seed(8)
    n, V, h = 8192, 32768, 1024
    x = torch.randn(n, h, generator=gen, device="cuda")
    e = 0.02 * torch.randn(V, h, generator=gen, device="cuda")
    tgt = torch.randint(0, V, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    dl = torch.full((n,), 1.0 / n, device="cuda")
    fwd_err, bwd_err = 0.0, 0.0
    for ls in (0.0, 0.1):
        n0 = (ce.lm_head_ce_fwd.f32_launches, ce.lm_head_ce_bwd.f32_launches)
        got = ce.lm_head_ce_fwd(x, e, tgt, ls > 0)
        ref = ce.lm_head_ce_fwd_reference(x, e, tgt, ls > 0)
        torch.cuda.synchronize()
        # fp32 sums of the same exact products in another order
        for name, a, r in zip(("m", "l", "pred", "ssum"), got, ref):
            if r is None:
                continue
            err = (a - r).abs().max().item()
            check(err <= 1e-4 * (r.abs().max().item() + 1.0),
                  f"CE fp32 fwd {name} (ls {ls}) max err {err}")
            fwd_err = max(fwd_err, err)
        m, l = ref[0], ref[1]
        dx, de = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, ls)
        rx, re_ = ce.lm_head_ce_bwd_reference(x, e, tgt, m, l, dl, ls)
        dx2, de2 = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, ls)
        torch.cuda.synchronize()
        bwd_err = max(bwd_err,
                      _fp32_err(dx, rx, f"CE fp32 dx (ls {ls})",
                                FP32_GRAD_TOL),
                      _fp32_err(de, re_, f"CE fp32 dE (ls {ls})",
                                FP32_GRAD_TOL))
        check(torch.equal(dx, dx2) and torch.equal(de, de2),
              f"CE fp32 bwd (ls {ls}): two runs differ")
        check((ce.lm_head_ce_fwd.f32_launches - n0[0],
               ce.lm_head_ce_bwd.f32_launches - n0[1]) == (1, 2),
              "CE fp32: not the fp32 route")
        del got, ref, dx, de, rx, re_, dx2, de2
    m, l, _, _ = ce.lm_head_ce_fwd_reference(x, e, tgt)
    chunks = -(-n // ce.f32_chunk_tokens(n, V))
    fwd_dev = device_launches(torch, ce.lm_head_ce_fwd, (x, e, tgt),
                              CE32_KERNELS)
    check({k: fwd_dev[k] for k in CE32_KERNELS} == {
        "ce32_transpose_kernel": 2, "ce32_fwd_kernel": 1,
        "ce32_grad_kernel": 0, "ce32_product_kernel": 0},
        f"CE fp32 fwd: device launches {fwd_dev} in one call")
    bwd_dev = device_launches(torch, ce.lm_head_ce_bwd,
                              (x, e, tgt, m, l, dl), CE32_KERNELS)
    check(bwd_dev == {"ce32_transpose_kernel": 2, "ce32_fwd_kernel": 0,
                      "ce32_grad_kernel": chunks,
                      "ce32_product_kernel": 2 * chunks, "other": 0},
          f"CE fp32 bwd: device launches {bwd_dev} in one call, expected "
          f"two transposes, then a logits kernel and two products a chunk "
          f"({chunks} chunks), and no other")
    fwd_ms = timer(lambda: ce.lm_head_ce_fwd(x, e, tgt), iters=10)
    fwd_plain = timer(lambda: ce.lm_head_ce_fwd_reference(x, e, tgt),
                      iters=5)
    fwd_lib = timer(lambda: F.cross_entropy(F.linear(x, e), tgt.long()),
                    iters=10)
    bwd_ms = timer(lambda: ce.lm_head_ce_bwd(x, e, tgt, m, l, dl), iters=5)
    bwd_plain = timer(lambda: ce.lm_head_ce_bwd_reference(
        x, e, tgt, m, l, dl), iters=3, warmup=1)
    bwd_lib = timer(_grad_of(torch, lambda a, w: F.cross_entropy(
        F.linear(a, w), tgt.long()), (x, e), torch.ones((), device="cuda")),
        iters=5)
    prod = 2.0 * n * V * h
    io = n * h * 4 + V * h * 4 + n * 4
    fb, fby = bound(prod, io + 4 * n * 4, FP32_FLOPS_PER_S)
    bb, bby = bound(3 * prod, io + 3 * n * 4 + V * h * 4 + n * h * 4,
                    FP32_FLOPS_PER_S)
    fp32_matmul = dict(allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                       precision=torch.get_float32_matmul_precision())
    common = dict(route="cuda", source="apex_tpu_torch/csrc/lm_head_ce.cu",
                  shape=f"n{n} V{V} h{h} fp32 x/E, int32 targets (the O0 "
                        "path's); label smoothing 0 and 0.1 checked",
                  fp32_matmul=fp32_matmul, registers=_ce32_registers(_build))
    return [
        dict(name="lm_head_ce_fwd_f32",
             replaces="apex_tpu/ops/lm_head_ce.py:162", max_abs_err=fwd_err,
             tolerance="1e-4 of max (fp32 stats)", ms=fwd_ms,
             plain_ms=fwd_plain, bound_ms=fb, bound_by=fby,
             library_ms=fwd_lib, tflops=prod / fwd_ms / 1e9,
             library="F.cross_entropy(F.linear(x, e), t), exact fp32",
             device_launches_per_call=fwd_dev, **common),
        dict(name="lm_head_ce_bwd_f32",
             replaces="apex_tpu/ops/lm_head_ce.py:198", max_abs_err=bwd_err,
             tolerance=f"{FP32_GRAD_TOL} of max and in relative norm; dx, "
                       "dE bitwise on a rerun",
             ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
             library_ms=bwd_lib, tflops=3 * prod / bwd_ms / 1e9,
             library="autograd backward of F.linear + F.cross_entropy, "
                     "exact fp32",
             device_launches_per_call=bwd_dev, **common),
    ]


SPLIT_B, SPLIT_H, SPLIT_S, SPLIT_D = 2, 16, 4096, 64


def _split_counts(fa):
    f = fa.flash_attention_bwd
    return (f.launches, f.dkdv_launches, f.dq_launches,
            f.wgmma_dkdv_launches, f.wgmma_dq_launches, f.f32_dkdv_launches)


def _split_moved(fa, before, wgmma: bool):
    """The split ran once on the named route (the wgmma route, or fp32's:
    dk/dv on the FFMA route, dq on flash_bwd.cu) and the single pass
    not."""
    moved = tuple(a - b for a, b in zip(_split_counts(fa), before))
    return moved == ((0, 1, 1, 1, 1, 0) if wgmma else (0, 1, 1, 0, 0, 1))


# the fp32 route's kernels (csrc/flash_bwd_f32.cuh, in flash_bwd.cu's fp32
# build; csrc/flash_fwd_f32.cuh, in flash_fwd.cu's), and flash_bwd.cu's and
# flash_fwd.cu's own kernels, by name
F32_CORE_KERNELS = ("flash_f32_prologue_kernel", "flash_bwd_f32_kernel",
                    "flash_dkdv_f32_kernel", "flash_dq_f32_kernel")
F32_FWD_KERNELS = ("flash_fwd_f32_kernel",)
FLASH_BWD_KERNELS = ("flash_bwd_kernel", "flash_dkdv_kernel",
                     "flash_dq_kernel")
FLASH_FWD_KERNELS = ("flash_fwd_kernel", "flash_fwd_sm90")
# (b, h, sq, sk, d, causal, segment ids) beside the O0 shapes: ragged and sq
# != sk with padding rows, rows with no key, padded head dims, non-causal
F32_CORE_SHAPES = ((2, 2, 1000, 1003, 64, True, True),
                   (1, 4, 100, 300, 64, True, False),
                   (1, 4, 300, 100, 64, True, False),
                   (1, 4, 500, 500, 40, True, False),
                   (1, 4, 500, 500, 80, True, True),
                   (2, 4, 700, 700, 64, False, True))
F32_PAD_ROWS = 40      # padding rows (segment id -1) at the end of each row


def _ffma_registers(build, source, kernels):
    """``ptxas -v``'s registers and spill bytes of the FFMA route's
    ``kernels`` (each head dim) in ``source``'s fp32 build; fails on a
    spill, and unless each kernel is there at d 64 and d 128."""
    regs, name = {}, None
    text = build.library_path(build.dtype_target(source, 2)) \
        .with_suffix(".log").read_text()
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(%s)(?:ILi(\d+)E)?" % "|".join(kernels),
                          m.group(1))
            name = None
            if k:
                name = k.group(1) + (f" d{k.group(2)}" if k.group(2) else "")
                regs[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            regs[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            check(regs[name]["spill_bytes"] == 0,
                  f"{source}@f32 {name}: ptxas spills "
                  f"{regs[name]['spill_bytes']} bytes")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name]["registers"] = int(m.group(1))
    check(len(regs) == 2 * len(kernels), f"{source}@f32: FFMA kernels in "
          f"ptxas's log {sorted(regs)}")
    return regs


def _f32_inputs(torch, gen, b, h, sq, sk, d, seg):
    """fp32 q, k, v, do and the segment ids of an F32_CORE_SHAPES case
    (two segments, the last F32_PAD_ROWS query rows padding)."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def seg_ids(s, pad):
        sid = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        sid[:, s // 2:] = 1
        if pad:
            sid[:, s - F32_PAD_ROWS:] = -1
        return sid

    q, do = rand(b, h, sq, d), rand(b, h, sq, d)
    k, v = rand(b, h, sk, d), rand(b, h, sk, d)
    sids = (seg_ids(sq, True), seg_ids(sk, sq == sk)) if seg else (None,
                                                                    None)
    return q, k, v, do, sids


def _lse_err(lse, ref, what):
    """fp32 lse within FP32_FWD_TOL relative on rows that see a key, and
    the -1e30 fill exactly on rows that see none."""
    live = ref > -1e29
    err = ((lse - ref).abs() / ref.abs().clamp_min(1.0))[live]
    e = err.max().item() if err.numel() else 0.0
    check(e <= FP32_FWD_TOL, f"{what} lse: relative err {e}")
    check(bool((lse[~live] == ref[~live]).all()),
          f"{what} lse: rows with no key are not the fill")
    return e


def check_flash_fwd_f32(torch, timer):
    """The fp32 forward on the FFMA route (``csrc/flash_fwd_f32.cuh``), the
    O0 paths': at F32_CORE_SHAPES and at the O0 paths' b8 h16 s1024 and b2
    h16 s4096 d64 causal against the plain version (out FP32_FWD_TOL of
    the largest and in relative norm, lse FP32_FWD_TOL relative, padding
    rows exactly zero), bitwise on a rerun and, for the first batch, the
    same bits run alone; the device launches of one call counted by the
    profiler (the kernel, nothing else); ptxas's registers with no spill;
    timed beside the plain version, SDPA's fp32 forward (TF32 off) and the
    shuffle-product kernel it replaces (``flash_fwd.cu``'s, through its C
    entry), also at d 128."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(14)
    f = fa.flash_attention
    what = "flash fp32 forward"

    checked = []
    for b, h, sq, sk, d, causal, seg in F32_CORE_SHAPES:
        q, k, v, _, (sid_q, sid_kv) = _f32_inputs(torch, gen, b, h, sq, sk,
                                                   d, seg)
        n0 = f.f32_launches
        out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
        again = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
        ref, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, segment_ids_q=sid_q,
            segment_ids_kv=sid_kv)
        torch.cuda.synchronize()
        shape = f"b{b} h{h} sq{sq} sk{sk} d{d}" + (" causal" if causal
                                                   else "") + \
            (" segments" if seg else "")
        check(f.f32_launches - n0 == 2, f"{what} {shape}: not the FFMA "
              "route")
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
              f"{what} {shape}: a rerun gave other bits")
        err = _fp32_err(out, ref, f"{what} {shape}", FP32_FWD_TOL)
        lse_err = _lse_err(lse, ref_lse, f"{what} {shape}")
        if seg:
            check(out[:, :, sq - F32_PAD_ROWS:].abs().max().item() == 0.0,
                  f"{what} {shape}: padding rows are not exactly zero")
        checked.append(dict(shape=shape, max_abs_err=err,
                            lse_rel_err=lse_err))
        del q, k, v, out, lse, again, ref, ref_lse

    def o0_shape(b, s, d, iters):
        """The forward at an O0 path's shape: checked, then timed beside
        the plain version, SDPA and flash_fwd.cu's kernel."""
        h, scale = 16, d ** -0.5
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   for _ in range(3))
        n0 = f.f32_launches
        out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
        again = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
        one = fa.flash_attention_fwd(q[:1], k[:1], v[:1], None, None, True,
                                     scale)
        torch.cuda.synchronize()
        check(f.f32_launches - n0 == 3, f"{what} b{b} s{s}: not the FFMA "
              "route")
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
              f"{what} b{b} s{s}: a rerun gave other bits")
        check(torch.equal(out[:1], one[0]) and torch.equal(lse[:1], one[1]),
              f"{what} b{b} s{s}: the first batch differs run alone")
        del again, one
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True,
                                                    scale=scale)
        torch.cuda.synchronize()
        err = _fp32_err(out, ref, f"{what} b{b} s{s} d{d}", FP32_FWD_TOL)
        lse_err = _lse_err(lse, ref_lse, f"{what} b{b} s{s} d{d}")
        del ref, ref_lse
        dev = device_launches(torch, fa.flash_attention_fwd,
                              (q, k, v, None, None, True, scale),
                              F32_FWD_KERNELS + FLASH_FWD_KERNELS)
        check(dev == {"flash_fwd_f32_kernel": 1, "flash_fwd_kernel": 0,
                      "flash_fwd_sm90": 0, "other": 0},
              f"{what} b{b} s{s}: device launches {dev} in one call")
        old = _build.function("flash_fwd@f32", "apex_flash_fwd",
                              fa._FLASH_ARGS)
        o2, l2 = torch.empty_like(out), torch.empty_like(lse)

        def shuffle():
            old(fa._ptr(q), fa._ptr(k), fa._ptr(v), None, None, fa._ptr(o2),
                fa._ptr(l2), b, h, s, s, d, 1, scale, 2, 2, fa._stream(q))

        ms = timer(lambda: fa.flash_attention_fwd(q, k, v, None, None, True,
                                                  scale), iters)
        t_bound = _fwd_bound(b, h, s, s, d, True, 4, FP32_FLOPS_PER_S)
        rec = dict(
            shape=f"b{b} h{h} s{s} d{d} fp32 causal", max_abs_err=err,
            lse_rel_err=lse_err, ms=ms,
            shuffle_kernel_ms=timer(shuffle, iters=3),
            plain_ms=timer(lambda: fa.flash_attention_reference(
                q, k, v, causal=True, scale=scale), iters=3, warmup=1),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale), iters),
            bound_ms=t_bound[0], bound_by=t_bound[1],
            tflops=4.0 * b * h * d * s * (s + 1) / 2 / ms / 1e9,
            device_launches_per_call=dev)
        del q, k, v, out, lse, o2, l2
        return rec

    main = o0_shape(8, 1024, 64, 10)
    long_ = o0_shape(2, 4096, 64, 5)
    d128 = o0_shape(8, 1024, 128, 5)
    return [dict(
        name="flash_fwd_f32", route="cuda",
        source="apex_tpu_torch/csrc/flash_fwd_f32.cuh",
        replaces="apex_tpu/ops/flash_attention.py:251",
        tolerance=f"out {FP32_FWD_TOL} of max and in relative norm; lse "
                  f"{FP32_FWD_TOL} relative; padding rows exactly 0; a "
                  "rerun and one batch alone bitwise",
        library="F.scaled_dot_product_attention(is_causal=True), exact "
                "fp32",
        plain="flash_attention_reference",
        **main, long_shape=long_, d128_shape=d128, checked=checked,
        registers=_ffma_registers(_build, "flash_fwd", F32_FWD_KERNELS))]


def check_flash_f32(torch, timer, split: bool):
    """The fp32 backward on the FFMA route (``csrc/flash_bwd_f32.cuh``):
    the single pass (``split`` False) at the O0 path's b8 h16 s1024 d64
    causal, or the split at the O0 long path's b2 h16 s4096, dk/dv and dq
    on the route (dq reading the dk/dv call's transposed scratch). Each
    against the plain backward (FP32_GRAD_TOL) at F32_CORE_SHAPES and the
    O0 shape, with the padding rows' dq exactly zero, dq, dk and dv
    bitwise on a rerun and the first batch's the same bits run alone;
    the device launches of one call counted by the profiler (a transpose
    of q and dO and the kernels, none of flash_bwd.cu's); ptxas's
    registers with no spill; timed beside the plain version, SDPA's fp32
    backward (TF32 off) and the shuffle-product kernels the route replaces
    (``flash_bwd.cu``'s, through their C entries). The split returns the
    dq kernel's record too."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(13 if split else 12)
    f = fa.flash_attention_bwd
    counters_ = (("f32_dkdv_launches", "f32_dq_launches") if split
                 else ("f32_launches",))
    what = "flash fp32 split" if split else "flash fp32 single pass"

    def moved(n0):
        return tuple(getattr(f, c) - n for c, n in zip(counters_, n0))

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    checked = []
    # the split also at the O0 s1024 shape (forced past its gate)
    extra = ((8, 16, 1024, 1024, 64, True, False),) if split else ()
    for b, h, sq, sk, d, causal, seg in F32_CORE_SHAPES + extra:
        q, k, v, do, (sid_q, sid_kv) = _f32_inputs(torch, gen, b, h, sq, sk,
                                                    d, seg)
        out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
        n0 = tuple(getattr(f, c) for c in counters_)
        got = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv,
                                 causal, d ** -0.5, split=split)
        again = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv,
                                   causal, d ** -0.5, split=split)
        ref = fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
            segment_ids_kv=sid_kv)
        torch.cuda.synchronize()
        shape = f"b{b} h{h} sq{sq} sk{sk} d{d}" + (" causal" if causal
                                                   else "") + \
            (" segments" if seg else "")
        check(moved(n0) == (2,) * len(counters_), f"{what} {shape}: not "
              "the FFMA route")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{what} {shape}: a rerun gave other bits")
        err = max(_fp32_err(g, r, f"{what} {shape} {n}", FP32_GRAD_TOL)
                  for n, g, r in zip(("dq", "dk", "dv"), got, ref))
        if seg:
            check(got[0][:, :, sq - F32_PAD_ROWS:].abs().max().item() == 0.0,
                  f"{what} {shape}: padding rows got a nonzero dq")
        checked.append(dict(shape=shape, max_abs_err=err))
        del q, k, v, do, out, lse, got, again, ref

    b, h, s, d = (2, 16, 4096, 64) if split else (8, 16, 1024, 64)
    scale = d ** -0.5
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
    check(fa.uses_split_backward(s, s, d, 4, 4, True) is split,
          f"{what}: the gate at s{s}")
    n0 = tuple(getattr(f, c) for c in counters_)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                 scale)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                   scale)
    torch.cuda.synchronize()
    check(moved(n0) == (2,) * len(counters_), f"{what} s{s}: not the FFMA "
          "route")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"{what} s{s}: dq, dk or dv changed on a rerun")
    del again
    _check_first_batch_alone(torch, fa, got, q, k, v, out, lse, do, scale,
                             what)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, scale=scale)
    torch.cuda.synchronize()
    errs = {n: _fp32_err(g, r, f"{what} s{s} {n}", FP32_GRAD_TOL)
            for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    del got, ref
    dev = device_launches(torch, fa.flash_attention_bwd,
                          (q, k, v, out, lse, do, None, None, True, scale),
                          F32_CORE_KERNELS + FLASH_BWD_KERNELS)
    # one prologue (the split's dq reads the dk/dv call's transposes)
    want = {"flash_f32_prologue_kernel": 1,
            "flash_bwd_f32_kernel": int(not split),
            "flash_dkdv_f32_kernel": int(split),
            "flash_dq_f32_kernel": int(split), "flash_bwd_kernel": 0,
            "flash_dkdv_kernel": 0, "flash_dq_kernel": 0}
    check({k_: dev[k_] for k_ in want} == want,
          f"{what} s{s}: device launches {dev} in one call, expected {want}")

    delta = (do * out).sum(dim=-1)
    args = (q, k, v, do, lse, delta, None, None, True, scale,
            fa._mixed_rounds(q, k, do))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if split:
        ms = timer(lambda: fa._flash_dkdv_cuda(*args), iters=10)
        old = _build.function("flash_bwd@f32", "apex_flash_bwd_dkdv",
                              fa._FLASH_DKDV_ARGS)

        def shuffle():
            old(fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(do),
                fa._ptr(lse), fa._ptr(delta), None, None, fa._ptr(dk),
                fa._ptr(dv), b, h, s, s, d, 1, scale, 2, args[-1],
                fa._stream(q))
    else:
        ms = timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, None, None, True, scale), iters=10)
        old = _build.function("flash_bwd@f32", "apex_flash_bwd",
                              fa._FLASH_BWD_ARGS)

        def shuffle():
            # a zeroed workspace each call: the turn counters must start
            # at zero
            dq_acc, turns = fa._dq_workspace(q, d, False)
            old(fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(do),
                fa._ptr(lse), fa._ptr(delta), None, None, fa._ptr(dq_acc),
                fa._ptr(turns), fa._ptr(dk), fa._ptr(dv), b, h, s, s, d, 1,
                scale, 2, args[-1], fa._stream(q))
    shuffle_ms = timer(shuffle, iters=3)
    plain_ms = timer(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True, scale=scale), iters=3, warmup=1)
    lib_ms = timer(_grad_of(torch, lambda a, b_, c: (
        F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                       scale=scale)), (q, k, v), do),
        iters=5)
    pairs = b * h * s * (s + 1) // 2
    sd4 = b * h * s * d * 4
    products = 4 if split else 5
    if split:
        kb = bound(4 * 2.0 * d * pairs, 6 * sd4 + 2 * b * h * s * 4,
                   FP32_FLOPS_PER_S)
    else:
        kb = _bwd_bound(b, h, s, d, 4, FP32_FLOPS_PER_S)
    registers = _ffma_registers(_build, "flash_bwd", F32_CORE_KERNELS)
    common = dict(
        route="cuda", source="apex_tpu_torch/csrc/flash_bwd_f32.cuh",
        shape=f"b{b} h{h} s{s} d{d} fp32 causal (the O0 "
        f"{'long ' if split else ''}path's), and {len(checked)} shapes "
        "more (checked)",
        tolerance=f"{FP32_GRAD_TOL} of max and in relative norm; padding "
                  "rows' dq exactly 0; dq, dk, dv bitwise on a rerun and "
                  "for one batch alone",
        plain_ms=plain_ms, library_ms=lib_ms,
        plain="flash_attention_bwd_reference: dq, dk and dv together",
        library="backward of F.scaled_dot_product_attention(is_causal="
                "True), exact fp32: dq, dk and dv together",
        checked=checked, device_launches_per_call=dev, registers=registers)
    rec = dict(
        name="flash_bwd_f32_dkdv" if split else "flash_bwd_f32",
        replaces="apex_tpu/ops/flash_attention.py:" + ("558" if split
                                                      else "604"),
        max_abs_err=max(errs["dk"], errs["dv"]) if split
        else max(errs.values()),
        ms=ms, bound_ms=kb[0], bound_by=kb[1],
        tflops=products * 2.0 * d * pairs / ms / 1e9,
        as_called="_flash_dkdv_cuda on a given delta (two transposes and "
                  "the kernel)" if split else "flash_attention_bwd (delta, "
                  "the zeroed dq workspace, two transposes, the kernel)",
        shuffle_kernel_ms=shuffle_ms, **common)
    if not split:
        del q, k, v, do, out, lse, delta, args, dk, dv
        return [rec]
    # the dq kernel as the split calls it: on the scratch the dk/dv call
    # filled; and alone (its own prologue); flash_bwd.cu's dq kernel
    ws = fa._f32_transposes(q)
    fa._flash_dkdv_cuda(*args, ws=ws)
    dq_ms = timer(lambda: fa._flash_dq_cuda(*args, ws=ws), iters=10)
    dq_alone_ms = timer(lambda: fa._flash_dq_cuda(*args), iters=10)
    old_dq = _build.function("flash_bwd@f32", "apex_flash_bwd_dq",
                             fa._FLASH_DQ_ARGS)
    dq2 = torch.empty_like(q)
    dq_shuffle_ms = timer(lambda: old_dq(
        fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(do), fa._ptr(lse),
        fa._ptr(delta), None, None, fa._ptr(dq2), b, h, s, s, d, 1, scale,
        2, args[-1], fa._stream(q)), iters=3)
    dq_plain_ms = timer(lambda: fa.flash_bwd_dq_reference(
        q, k, v, out, lse, do, causal=True, scale=scale), iters=3, warmup=1)
    split_ms = timer(lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, None, None, True, scale), iters=10)
    dq_bound = bound(3 * 2.0 * d * pairs, 5 * sd4 + 2 * b * h * s * 4,
                     FP32_FLOPS_PER_S)
    del q, k, v, do, out, lse, delta, args, dk, dv, ws, dq2
    return [rec, dict(
        name="flash_bwd_f32_dq",
        replaces="apex_tpu/ops/flash_attention.py:671",
        max_abs_err=errs["dq"], ms=dq_ms, bound_ms=dq_bound[0],
        bound_by=dq_bound[1], tflops=3 * 2.0 * d * pairs / dq_ms / 1e9,
        as_called="_flash_dq_cuda on a given delta and the scratch the "
                  "dk/dv call transposed q and dO into (the split's call)",
        alone_ms=dq_alone_ms, shuffle_kernel_ms=dq_shuffle_ms,
        split_as_called_ms=split_ms, plain_dq_ms=dq_plain_ms, **common)]


# ---------------------------------------------------------------------------
# attention dropout on the fp32 FFMA route (B1's and B2's dropout variants):
# the O0 dropout path's b8 h16 s1024 d64 causal and the shapes below (d 64
# and 128, causal and not, sq != sk both ways, segment padding, a padded
# head dim)
# ---------------------------------------------------------------------------

F32_DROPOUT_SEED = 20261022
F32_DROPOUT_SHAPES = ((2, 2, 1000, 1003, 64, True, True),
                      (1, 4, 300, 100, 128, True, False),
                      (1, 4, 100, 300, 64, True, False),
                      (2, 4, 700, 700, 128, False, True),
                      (1, 4, 500, 500, 80, True, True))


def _f32_dropout_held(torch, fa, q, k, v, do, sids, causal, scale, shape):
    """The FFMA forward and single pass with dropout 0.1 on one input
    against the plain versions with the same seed (out FP32_FWD_TOL, lse
    FP32_FWD_TOL relative, gradients FP32_GRAD_TOL), both bitwise on a
    rerun, padding rows' dq exactly 0, one launch each of the two dropout
    variants a call; returns the forward's output and lse and the
    record."""
    f, g = fa.flash_attention, fa.flash_attention_bwd
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=F32_DROPOUT_SEED)
    what = f"flash fp32 dropout {shape}"
    n0 = (f.f32_dropout_launches, g.f32_dropout_launches)
    out, lse = fa.flash_attention_fwd(q, k, v, *sids, causal, scale, **drop)
    again = fa.flash_attention_fwd(q, k, v, *sids, causal, scale, **drop)
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, *sids, causal, scale,
                               split=False, **drop)
    grads2 = fa._flash_bwd_cuda(q, k, v, out, lse, do, *sids, causal,
                                scale, split=False, **drop)
    torch.cuda.synchronize()
    check((f.f32_dropout_launches - n0[0], g.f32_dropout_launches - n0[1])
          == (2, 2), f"{what}: not the FFMA route's dropout variants")
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1])
          and all(torch.equal(x, y) for x, y in zip(grads, grads2)),
          f"{what}: a rerun gave other bits")
    del again, grads2
    kw = dict(causal=causal, segment_ids_q=sids[0], segment_ids_kv=sids[1],
              scale=scale, **drop)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    err = _fp32_err(out, ref, f"{what} forward", FP32_FWD_TOL)
    lse_err = _lse_err(lse, ref_lse, what)
    del ref, ref_lse
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    gerr = max(_fp32_err(gr, r, f"{what} {n}", FP32_GRAD_TOL)
               for n, gr, r in zip(("dq", "dk", "dv"), grads, ref))
    if sids[0] is not None:
        pad = (sids[0] < 0)[:, None, :].expand(*q.shape[:3])
        check(not bool(grads[0][pad].any()),
              f"{what}: padding rows got a nonzero dq")
    return out, lse, dict(shape=shape, max_abs_err=err, lse_rel_err=lse_err,
                          grad_max_abs_err=gerr)


def _f32_keep_pattern(torch, fa, gen, d, seed):
    """Rate 0.5 (kept elements doubled), no mask: the FFMA forward with
    q = k = 0 and v = I over sk = d keys is 2 / d where a key is kept and
    exactly 0 where dropped; the single pass with q = 0 (p = 1 / s) and
    do = I over sq = d rows gives dv = the dropped p transposed. Both zero
    patterns are the plain mask bit for bit."""
    b, h, s = 2, 3, 333
    eye = torch.eye(d, device="cuda").expand(b, h, d, d).contiguous()
    q = torch.zeros(b, h, s, d, device="cuda")
    k = torch.zeros(b, h, d, d, device="cuda")
    out, _ = fa.flash_attention_fwd(q, k, eye, None, None, False, 1.0, 0.5,
                                    seed)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    what = f"flash fp32 dropout keep pattern d{d}"
    check(torch.equal(out != 0, keep)
          and torch.equal(out[keep], torch.full_like(out[keep], 2.0 / d)),
          f"{what}: the forward's keep pattern is not the plain mask")
    n = keep.numel()
    k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
            for _ in range(2))
    q = torch.zeros(b, h, d, d, device="cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, False, 1.0, 0.5,
                                      seed)
    _, _, dv = fa._flash_bwd_cuda(q, k, v, out, lse, eye, None, None, False,
                                  1.0, split=False, dropout_rate=0.5,
                                  dropout_seed=seed)
    keep = fa.dropout_keep_reference(seed, b, h, d, s, 0.5, device="cuda")
    check(torch.equal(dv != 0, keep.transpose(-1, -2)),
          f"{what}: the single pass's keep pattern is not the plain mask")
    return dict(case=what, rate=0.5, keep_elements=n + keep.numel(),
                bitwise=True)


def check_flash_f32_dropout(torch, timer):
    """B1's and B2's dropout variants on the fp32 FFMA route
    (``flash_fwd_f32_dropout_kernel`` of ``csrc/flash_fwd_f32.cuh``,
    ``flash_bwd_f32_dropout_kernel`` of ``csrc/flash_bwd_f32.cuh``) at
    :data:`F32_DROPOUT_SHAPES` and the O0 dropout path's b8 h16 s1024 d64
    causal, rate 0.1 (:func:`_f32_dropout_held`); the keep pattern bitwise
    at d 64 and 128 (:func:`_f32_keep_pattern`); each timed at the O0 shape
    beside its twin without dropout, its plain version and SDPA fp32 with
    ``dropout_p=0.1`` (TF32 off), the single pass as called; ptxas's
    registers with no spill in either variant. The bounds count the hash's
    integer operations beside the products at the fp32 rate: the same
    cores issue both."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(22)
    checked = []
    for b, h, sq, sk, d, causal, seg in F32_DROPOUT_SHAPES:
        q, k, v, do, sids = _f32_inputs(torch, gen, b, h, sq, sk, d, seg)
        shape = f"b{b} h{h} sq{sq} sk{sk} d{d}" + (" causal" if causal
                                                   else "") + \
            (" segments" if seg else "")
        checked.append(_f32_dropout_held(torch, fa, q, k, v, do, sids,
                                         causal, d ** -0.5, shape)[2])
        del q, k, v, do, sids
    bitwise = [_f32_keep_pattern(torch, fa, gen, 64, 5),
               _f32_keep_pattern(torch, fa, gen, 128, -3)]
    torch.cuda.empty_cache()

    b, h, s, d = O0_B, 16, O0_S, 64
    scale = d ** -0.5
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   for _ in range(4))
    shape = f"b{b} h{h} s{s} d{d} fp32 causal, dropout {DROPOUT_RATE}"
    out, lse, main = _f32_dropout_held(torch, fa, q, k, v, do, (None, None),
                                       True, scale, shape)
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=F32_DROPOUT_SEED)
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd
    pairs = b * h * s * (s + 1) // 2
    sd4 = b * h * s * d * 4
    f_bound = bound(4.0 * d * pairs + DROPOUT_HASH_OPS * pairs,
                    4 * sd4 + b * h * s * 4, FP32_FLOPS_PER_S)
    b_bound = bound(10.0 * d * pairs + DROPOUT_HASH_OPS * pairs,
                    8 * sd4 + 2 * b * h * s * 4, FP32_FLOPS_PER_S)
    times = dict(
        fwd_ms=timer(lambda: fwd(q, k, v, None, None, True, scale, **drop),
                     iters=10),
        fwd_no_dropout_ms=timer(lambda: fwd(q, k, v, None, None, True,
                                            scale), iters=10),
        fwd_plain_ms=timer(lambda: fa.flash_attention_reference(
            q, k, v, causal=True, scale=scale, **drop), iters=3, warmup=1),
        fwd_library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, dropout_p=DROPOUT_RATE),
            iters=10),
        bwd_ms=timer(lambda: bwd(q, k, v, out, lse, do, None, None, True,
                                 scale, **drop), iters=10),
        bwd_no_dropout_ms=timer(lambda: bwd(q, k, v, out, lse, do, None,
                                            None, True, scale), iters=10),
        bwd_plain_ms=timer(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=True, scale=scale, **drop),
            iters=3, warmup=1),
        bwd_library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                           scale=scale,
                                           dropout_p=DROPOUT_RATE)),
            (q, k, v), do), iters=5))
    dev = device_launches(torch, bwd, (q, k, v, out, lse, do, None, None,
                                       True, scale), F32_CORE_KERNELS +
                          ("flash_bwd_f32_dropout_kernel",), drop)
    want = {"flash_f32_prologue_kernel": 1, "flash_bwd_f32_kernel": 0,
            "flash_bwd_f32_dropout_kernel": 1}
    check({k_: dev[k_] for k_ in want} == want,
          f"flash fp32 dropout: device launches {dev} in one single pass, "
          f"expected {want}")
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    common = dict(
        route="cuda", shape=shape, bitwise=bitwise,
        checked=checked, live_pairs=pairs,
        library="F.scaled_dot_product_attention(is_causal=True, dropout_p="
                f"{DROPOUT_RATE}), exact fp32: its own random stream")
    return [
        dict(name="flash_fwd_f32_dropout",
             source="apex_tpu_torch/csrc/flash_fwd_f32.cuh",
             replaces="apex_tpu/ops/flash_attention.py:251",
             max_abs_err=main["max_abs_err"], lse_rel_err=main["lse_rel_err"],
             tolerance=f"out {FP32_FWD_TOL} of max and in relative norm, "
                       f"lse {FP32_FWD_TOL} relative, of the plain forward "
                       "with the same seed; a rerun bitwise; the keep "
                       "pattern bitwise",
             ms=times["fwd_ms"], no_dropout_ms=times["fwd_no_dropout_ms"],
             plain_ms=times["fwd_plain_ms"],
             library_ms=times["fwd_library_ms"], plain="flash_attention_"
             "reference with the same seed", bound_ms=f_bound[0],
             bound_by=f_bound[1],
             registers=_ffma_registers(_build, "flash_fwd",
                                       ("flash_fwd_f32_dropout_kernel",)),
             **common),
        dict(name="flash_bwd_f32_dropout",
             source="apex_tpu_torch/csrc/flash_bwd_f32.cuh",
             replaces="apex_tpu/ops/flash_attention.py:604",
             max_abs_err=main["grad_max_abs_err"],
             tolerance=f"{FP32_GRAD_TOL} of max and in relative norm of the "
                       "plain backward with the same seed; padding rows' dq "
                       "exactly 0; dq, dk, dv bitwise on a rerun; the keep "
                       "pattern bitwise",
             ms=times["bwd_ms"], no_dropout_ms=times["bwd_no_dropout_ms"],
             as_called="flash_attention_bwd (the zeroed turns, two "
                       "transposes and the delta fold, the kernel)",
             plain_ms=times["bwd_plain_ms"],
             library_ms=times["bwd_library_ms"],
             plain="flash_attention_bwd_reference with the same seed",
             bound_ms=b_bound[0], bound_by=b_bound[1],
             device_launches_per_call=dev,
             registers=_ffma_registers(_build, "flash_bwd",
                                       ("flash_bwd_f32_dropout_kernel",)),
             **common)]


# ---------------------------------------------------------------------------
# attention dropout in the fp32 FFMA route's split (B3's and B4's dropout
# variants, flash_dkdv_f32_dropout_kernel and flash_dq_f32_dropout_kernel):
# the O0 long dropout path's b2 h16 s4096 d64 causal and the dropout shapes
# above, the split forced
# ---------------------------------------------------------------------------

F32_SPLIT_DROPOUT_SEED = 20261023
F32_SPLIT_DROPOUT_KERNELS = ("flash_dkdv_f32_dropout_kernel",
                             "flash_dq_f32_dropout_kernel")


def _f32_split_dropout_held(torch, fa, q, k, v, do, sids, causal, scale,
                            shape):
    """The FFMA split's dropout variants at rate 0.1 on one input, the split
    forced as ``_flash_bwd_cuda`` runs it (dk/dv, whose prologue transposes
    q and do into one scratch and folds delta from the dropped output, then
    dq on that scratch; a padded head dim zero-padded to the kernel's):
    dq against ``flash_bwd_dq_reference``, dk and dv against
    ``flash_bwd_dkdv_reference`` on that reference's delta, with the same
    seed (FP32_GRAD_TOL); bitwise on a rerun, padding rows' dq exactly 0,
    one launch each of the two variants a call. Returns the forward's
    output and lse and the record."""
    g = fa.flash_attention_bwd
    drop = dict(dropout_rate=DROPOUT_RATE,
                dropout_seed=F32_SPLIT_DROPOUT_SEED)
    what = f"flash fp32 split dropout {shape}"
    out, lse = fa.flash_attention_fwd(q, k, v, *sids, causal, scale, **drop)
    n0 = (g.f32_dropout_dkdv_launches, g.f32_dropout_dq_launches)
    runs = [fa._flash_bwd_cuda(q, k, v, out, lse, do, *sids, causal, scale,
                               split=True, **drop) for _ in range(2)]
    torch.cuda.synchronize()
    check((g.f32_dropout_dkdv_launches - n0[0],
           g.f32_dropout_dq_launches - n0[1]) == (2, 2),
          f"{what}: not the FFMA split's dropout variants")
    check(all(torch.equal(x, y) for x, y in zip(*runs)),
          f"{what}: a rerun gave other bits")
    dq, dk, dv = runs[0]
    del runs
    kw = dict(causal=causal, segment_ids_q=sids[0], segment_ids_kv=sids[1],
              scale=scale, **drop)
    rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    dq_err = _fp32_err(dq, rdq, f"{what} dq", FP32_GRAD_TOL)
    del rdq
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, rdelta, do, **kw)
    dkdv_err = max(_fp32_err(dk, rdk, f"{what} dk", FP32_GRAD_TOL),
                   _fp32_err(dv, rdv, f"{what} dv", FP32_GRAD_TOL))
    del rdk, rdv, rdelta
    if sids[0] is not None:
        pad = (sids[0] < 0)[:, None, :].expand(*q.shape[:3])
        check(not bool(dq[pad].any()),
              f"{what}: padding rows got a nonzero dq")
    return out, lse, dict(shape=shape, dq_max_abs_err=dq_err,
                          dkdv_max_abs_err=dkdv_err)


def _f32_split_keep_pattern(torch, fa, gen, d, seed):
    """Rate 0.5 (kept elements doubled), no mask, through the split's two
    kernels. dk/dv with q = 0 (p = 1 / s) and do = I over sq = d rows:
    dv is the dropped p transposed. dq over sk = d keys (key 0 = e_0, the
    others 0), v = I, do = 1 and delta 0: dp = 1 everywhere, ds = p keep 2,
    and dq[q] = ds[q, 0] e_0, nonzero exactly where key 0 is kept. Both
    zero patterns are the plain mask bit for bit."""
    b, h, s = 2, 3, 333
    half = fa._dropout_args(0.5, seed)
    eye = torch.eye(d, device="cuda").expand(b, h, d, d).contiguous()
    k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
            for _ in range(2))
    q = torch.zeros(b, h, d, d, device="cuda")
    _, lse = fa.flash_attention_fwd(q, k, v, None, None, False, 1.0, 0.5,
                                    seed)
    zero = torch.zeros(b, h, d, device="cuda")
    _, dv = fa._flash_dkdv_cuda(q, k, v, eye, lse, zero, None, None, False,
                                1.0, fa._NO_ROUNDS, dropout=half)
    keep = fa.dropout_keep_reference(seed, b, h, d, s, 0.5, device="cuda")
    what = f"flash fp32 split dropout keep pattern d{d}"
    check(torch.equal(dv != 0, keep.transpose(-1, -2)),
          f"{what}: dk/dv's keep pattern is not the plain mask")
    n = keep.numel()
    q = torch.randn(b, h, s, d, generator=gen, device="cuda")
    k1 = torch.zeros(b, h, d, d, device="cuda")
    k1[:, :, 0, 0] = 1.0
    _, lse = fa.flash_attention_fwd(q, k1, eye, None, None, False, 1.0)
    dq = fa._flash_dq_cuda(q, k1, eye, torch.ones_like(q), lse,
                           torch.zeros(b, h, s, device="cuda"), None, None,
                           False, 1.0, fa._NO_ROUNDS, dropout=half)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    check(torch.equal(dq[..., 0] != 0, keep[..., 0])
          and not bool(dq[..., 1:].any()),
          f"{what}: dq's keep pattern is not the plain mask")
    return dict(case=what, rate=0.5, keep_elements=n + keep[..., 0].numel(),
                bitwise=True)


def check_flash_f32_split_dropout(torch, timer):
    """B3's and B4's dropout variants on the fp32 FFMA route
    (``flash_dkdv_f32_dropout_kernel`` and ``flash_dq_f32_dropout_kernel``
    of ``csrc/flash_bwd_f32.cuh``) at :data:`F32_DROPOUT_SHAPES` (the
    split forced) and the O0 long dropout path's b2 h16 s4096 d64 causal,
    rate 0.1 (:func:`_f32_split_dropout_held`); the keep patterns bitwise
    at d 64 and 128 (:func:`_f32_split_keep_pattern`); at the path's
    shape the pair as routed against the plain backward, its device
    launches of one call (profiler: one prologue, the two variants, no
    twin), and each kernel timed beside its twin without dropout, its
    plain version and SDPA fp32's backward with ``dropout_p=0.1`` (dq, dk
    and dv together; TF32 off); ptxas's registers with no spill. The
    bounds count the hash's integer operations beside the products at the
    fp32 rate."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(23)
    checked = []
    for b, h, sq, sk, d, causal, seg in F32_DROPOUT_SHAPES:
        q, k, v, do, sids = _f32_inputs(torch, gen, b, h, sq, sk, d, seg)
        shape = f"b{b} h{h} sq{sq} sk{sk} d{d}" + (" causal" if causal
                                                   else "") + \
            (" segments" if seg else "")
        checked.append(_f32_split_dropout_held(torch, fa, q, k, v, do, sids,
                                               causal, d ** -0.5, shape)[2])
        del q, k, v, do, sids
    bitwise = [_f32_split_keep_pattern(torch, fa, gen, 64, 7),
               _f32_split_keep_pattern(torch, fa, gen, 128, -11)]
    torch.cuda.empty_cache()

    b, h, s, d = O0_LONG_B, 16, O0_LONG_S, 64
    scale = d ** -0.5
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   for _ in range(4))
    shape = f"b{b} h{h} s{s} d{d} fp32 causal, dropout {DROPOUT_RATE}"
    check(fa.uses_split_backward(s, s, d, 4, 4, True, dropout=True),
          f"the gate at s{s} d{d} fp32 with dropout: not the split")
    out, lse, main = _f32_split_dropout_held(torch, fa, q, k, v, do,
                                             (None, None), True, scale,
                                             shape)
    drop = dict(dropout_rate=DROPOUT_RATE,
                dropout_seed=F32_SPLIT_DROPOUT_SEED)
    dargs = fa._dropout_args(DROPOUT_RATE, F32_SPLIT_DROPOUT_SEED)
    g = fa.flash_attention_bwd
    n0 = (g.f32_dropout_dkdv_launches, g.f32_dropout_dq_launches, g.launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                 scale, **drop)
    torch.cuda.synchronize()
    check((g.f32_dropout_dkdv_launches - n0[0],
           g.f32_dropout_dq_launches - n0[1], g.launches - n0[2])
          == (1, 1, 0), f"flash fp32 split dropout {shape}: as routed, not "
          "the split's dropout variants")
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, scale=scale, **drop)
    pair_err = {n: _fp32_err(x, r, f"flash fp32 split dropout {shape} as "
                             f"routed {n}", FP32_GRAD_TOL)
                for n, x, r in zip(("dq", "dk", "dv"), got, ref)}
    del got, ref
    torch.cuda.empty_cache()
    dev = device_launches(torch, fa.flash_attention_bwd,
                          (q, k, v, out, lse, do, None, None, True, scale),
                          F32_CORE_KERNELS + F32_SPLIT_DROPOUT_KERNELS, drop)
    want = {"flash_f32_prologue_kernel": 1, "flash_dkdv_f32_kernel": 0,
            "flash_dq_f32_kernel": 0, "flash_bwd_f32_kernel": 0,
            "flash_dkdv_f32_dropout_kernel": 1,
            "flash_dq_f32_dropout_kernel": 1}
    check({k_: dev[k_] for k_ in want} == want,
          f"flash fp32 split dropout: device launches {dev} in one call, "
          f"expected {want}")
    delta = (do * out).sum(dim=-1)
    args = (q, k, v, do, lse, delta, None, None, True, scale, fa._NO_ROUNDS)
    ws = fa._f32_transposes(q)
    fa._flash_dkdv_cuda(*args, ws=ws, dropout=dargs)
    kw = dict(causal=True, scale=scale, **drop)
    times = dict(
        dkdv_ms=timer(lambda: fa._flash_dkdv_cuda(*args, dropout=dargs),
                      iters=10),
        dkdv_no_dropout_ms=timer(lambda: fa._flash_dkdv_cuda(*args),
                                 iters=10),
        dq_ms=timer(lambda: fa._flash_dq_cuda(*args, ws=ws, dropout=dargs),
                    iters=10),
        dq_no_dropout_ms=timer(lambda: fa._flash_dq_cuda(*args, ws=ws),
                               iters=10),
        as_called_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, None, None, True, scale, **drop),
            iters=10),
        dkdv_plain_ms=timer(lambda: fa.flash_bwd_dkdv_reference(
            q, k, v, lse, delta, do, **kw), iters=3, warmup=1),
        dq_plain_ms=timer(lambda: fa.flash_bwd_dq_reference(
            q, k, v, out, lse, do, **kw), iters=3, warmup=1),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                           scale=scale,
                                           dropout_p=DROPOUT_RATE)),
            (q, k, v), do), iters=5))
    pairs = b * h * s * (s + 1) // 2
    sd4, side = b * h * s * d * 4, b * h * s * 4
    dkdv_bound = bound(4 * 2.0 * d * pairs + DROPOUT_HASH_OPS * pairs,
                       6 * sd4 + 2 * side, FP32_FLOPS_PER_S)
    dq_bound = bound(3 * 2.0 * d * pairs + DROPOUT_HASH_OPS * pairs,
                     5 * sd4 + 2 * side, FP32_FLOPS_PER_S)
    del q, k, v, do, out, lse, delta, args, ws
    torch.cuda.empty_cache()
    common = dict(
        route="cuda", source="apex_tpu_torch/csrc/flash_bwd_f32.cuh",
        shape=shape, bitwise=bitwise, checked=checked, live_pairs=pairs,
        tolerance=f"{FP32_GRAD_TOL} of max and in relative norm of the "
                  "plain split kernel with the same seed; padding rows' dq "
                  "exactly 0; a rerun bitwise; the keep pattern bitwise",
        as_called_ms=times["as_called_ms"], pair_max_abs_err=pair_err,
        device_launches_per_call=dev, library_ms=times["library_ms"],
        library="backward of F.scaled_dot_product_attention(is_causal=True,"
                f" dropout_p={DROPOUT_RATE}), exact fp32, its own random "
                "stream: dq, dk and dv together",
        registers=_ffma_registers(_build, "flash_bwd",
                                  F32_SPLIT_DROPOUT_KERNELS))
    return [
        dict(name="flash_bwd_f32_dkdv_dropout",
             replaces="apex_tpu/ops/flash_attention.py:558",
             max_abs_err=main["dkdv_max_abs_err"], ms=times["dkdv_ms"],
             no_dropout_ms=times["dkdv_no_dropout_ms"],
             plain_ms=times["dkdv_plain_ms"],
             plain="flash_bwd_dkdv_reference with the same seed",
             bound_ms=dkdv_bound[0], bound_by=dkdv_bound[1], **common),
        dict(name="flash_bwd_f32_dq_dropout",
             replaces="apex_tpu/ops/flash_attention.py:671",
             max_abs_err=main["dq_max_abs_err"], ms=times["dq_ms"],
             no_dropout_ms=times["dq_no_dropout_ms"],
             plain_ms=times["dq_plain_ms"],
             plain="flash_bwd_dq_reference with the same seed",
             bound_ms=dq_bound[0], bound_by=dq_bound[1], **common)]


# ---------------------------------------------------------------------------
# the additive bias on the fp32 FFMA route (B1's, B2's, B3's and B4's bias
# variants): the shapes below (d 64 and 128, the four broadcast shapes, sq
# != sk, odd sk, segment padding, a row -inf everywhere, a row -inf but for
# key 0, which the mask keeps), then the O0 MHA paths' attentions:
# train-o0-mha16's b1 h8 s3072 d128 (the future mask; split) and
# train-o0-mha6's b28 h16 s128 d64 (the future mask and key padding; single
# pass)
# ---------------------------------------------------------------------------

F32_BIAS_FWD_KERNELS = ("flash_fwd_f32_bias_kernel",)
F32_BIAS_BWD_KERNELS = ("flash_bwd_f32_bias_kernel",
                        "flash_dkdv_f32_bias_kernel",
                        "flash_dq_f32_bias_kernel")
F32_ONE_KEY_ROW = 1    # the row whose bias masks every key but key 0


# the FFMA route's variant counters (:func:`_f32_variant_counts`): with both
# the bias and dropout, with the bias alone, with dropout alone (slot 2);
# each the forward's, the single pass's, the split's dk/dv and dq
F32_BOTH, F32_BIAS_ALONE = 0, 1


def _f32_variant_counts(fa):
    f, g = fa.flash_attention, fa.flash_attention_bwd
    return (f.f32_bias_dropout_launches, g.f32_bias_dropout_launches,
            g.f32_bias_dropout_dkdv_launches, g.f32_bias_dropout_dq_launches,
            f.f32_bias_launches, g.f32_bias_launches,
            g.f32_bias_dkdv_launches, g.f32_bias_dq_launches,
            f.f32_dropout_launches, g.f32_dropout_launches,
            g.f32_dropout_dkdv_launches, g.f32_dropout_dq_launches)


def _f32_moved(fa, n0, launches, variant, what):
    """Since ``n0`` (:func:`_f32_variant_counts`), ``launches`` (forward,
    single pass, dk/dv, dq) of the FFMA ``variant`` and none of the
    others."""
    moved = tuple(a - b for a, b in zip(_f32_variant_counts(fa), n0))
    want = [0] * 12
    want[4 * variant:4 * variant + 4] = launches
    check(moved == tuple(want), f"{what}: FFMA variant launches (with both, "
          f"the bias alone, dropout alone; each forward, single pass, "
          f"dk/dv, dq) {moved}, expected {tuple(want)}")


def _f32_bias_case(torch, fa, gen, case, rate=0.0):
    """One :func:`_bias_cases` shape in fp32 with row
    :data:`F32_ONE_KEY_ROW` -inf but for key 0, which the mask keeps (its
    p exactly 1 there), at dropout ``rate`` (above 0: the variants with
    both, seed :data:`F32_BIAS_DROPOUT_SEED`): the forward against the
    plain version (out and lse FP32_FWD_TOL), the single pass and the
    split's two kernels (dk/dv folding delta, then dq on its scratch; both
    forced) against theirs (FP32_GRAD_TOL), each bitwise on a rerun, on the
    variant's counters alone; the one-key row's out v[0] bit for bit (with
    dropout v[0] / (1 - rate) where key 0 is kept, 0 where dropped); a
    dead row's out and dq exactly 0 and its lse the fill. Returns the
    case's record."""
    *_, causal, _, dead = case
    q, k, v, do, bias, sid_q, sid_kv, scale, what = _bias_case_inputs(
        torch, gen, case, "flash fp32 bias" + (" dropout" if rate else ""))
    bias[:, :, F32_ONE_KEY_ROW] = float("-inf")
    bias[:, :, F32_ONE_KEY_ROW, 0] = 0.0
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    seed = F32_BIAS_DROPOUT_SEED if rate else None
    drop = dict(dropout_rate=rate, dropout_seed=seed)
    kw = dict(causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
              scale=scale, bias=bias, **drop)
    n0 = _f32_variant_counts(fa)
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, scale,
                                      bias=bias, **drop)
    again = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, scale,
                                   bias=bias, **drop)
    single = [fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv,
                                 causal, scale, split=False, bias=bias,
                                 **drop) for _ in range(2)]
    bop = fa._bias_operand(bias, b, h, sq, sk, q.device, scale)
    dargs = fa._dropout_args(rate, seed)
    split = []
    for _ in range(2):
        delta = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
        args = (q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale,
                fa._NO_ROUNDS)
        ws = fa._f32_transposes(q)
        dk, dv = fa._flash_dkdv_cuda(*args, out=out, ws=ws, dropout=dargs,
                                     bias=bop)
        split.append((fa._flash_dq_cuda(*args, ws=ws, dropout=dargs,
                                        bias=bop), dk, dv, delta))
    torch.cuda.synchronize()
    _f32_moved(fa, n0, (2, 2, 2, 2), F32_BOTH if rate else F32_BIAS_ALONE,
               what)
    one = v[:, :, 0]
    if rate:
        keep = fa.dropout_keep_reference(seed, b, h, sq, sk, rate,
                                         device="cuda")
        inv = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                           device="cuda")
        one = torch.where(keep[:, :, F32_ONE_KEY_ROW, :1], one * inv,
                          torch.zeros_like(one))
        del keep
    check(torch.equal(out[:, :, F32_ONE_KEY_ROW], one),
          f"{what}: the row with one live key is not v[0] bit for bit "
          "(with dropout, v[0] / (1 - rate) or 0 by its keep bit)")
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1])
          and all(torch.equal(x, y) for x, y in zip(*single))
          and all(torch.equal(x, y) for x, y in zip(*split)),
          f"{what}: a rerun gave other bits")
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    err = _fp32_err(out, ref, f"{what} forward", FP32_FWD_TOL)
    lse_err = _lse_err(lse, ref_lse, what)
    del ref, ref_lse
    rgrads = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    gerr = max(_fp32_err(x, r, f"{what} single pass {n}", FP32_GRAD_TOL)
               for n, x, r in zip(("dq", "dk", "dv"), single[0], rgrads))
    del rgrads
    dq, dk, dv, delta = split[0]
    rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    _fp32_err(delta, rdelta, f"{what} delta fold", FP32_FWD_TOL)
    dq_err = _fp32_err(dq, rdq, f"{what} split dq", FP32_GRAD_TOL)
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw)
    dkdv_err = max(_fp32_err(dk, rdk, f"{what} split dk", FP32_GRAD_TOL),
                   _fp32_err(dv, rdv, f"{what} split dv", FP32_GRAD_TOL))
    if dead is not None:
        check(out[:, :, dead].abs().max().item() == 0.0
              and bool((lse[:, :, dead] == -1e30).all())
              and single[0][0][:, :, dead].abs().max().item() == 0.0
              and dq[:, :, dead].abs().max().item() == 0.0,
              f"{what}: the row with no live key is not zero, -1e30")
    return dict(case=what, max_abs_err=err, lse_rel_err=lse_err,
                single_pass_max_abs_err=gerr, dq_max_abs_err=dq_err,
                dkdv_max_abs_err=dkdv_err)


def _f32_bias_shape(torch, b, h, s, d, min_len, gen):
    """fp32 q, k, v, do at one O0 MHA path's attention, the future mask
    as a [1, 1, s, s] bias, key padding of ``min_len``-``s`` real tokens a
    sequence as segment ids (or none), the SDPA mask of both and the live
    pairs this run's data needs."""
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   for _ in range(4))
    bias = future_mask(torch, s)[None, None]
    if min_len is None:
        sids, pad = (None, None), 0.0
        sid_kv = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    else:
        lens = torch.from_numpy(mha6_lengths()).cuda()
        sid_kv = torch.where(torch.arange(s, device="cuda")[None]
                             < lens[:, None], 0, -1).to(torch.int32)
        sids = (torch.zeros(b, s, dtype=torch.int32, device="cuda"), sid_kv)
        pad = torch.where(sid_kv < 0, float("-inf"), 0.0)[:, None, None]
    return (q, k, v, do, bias, sids, bias + pad,
            _bias_live_pairs(torch, bias, sid_kv, h))


def check_flash_f32_bias(torch, timer):
    """B1's, B2's, B3's and B4's bias variants on the fp32 FFMA route
    (``flash_fwd_f32_bias_kernel`` of ``csrc/flash_fwd_f32.cuh``;
    ``flash_bwd_f32_bias_kernel``, ``flash_dkdv_f32_bias_kernel`` and
    ``flash_dq_f32_bias_kernel`` of ``csrc/flash_bwd_f32.cuh``: the tile's
    bias / scale loaded into the S accumulators before the product) at
    :func:`_bias_cases`' shapes in fp32 (:func:`_f32_bias_case`); then at
    train-o0-mha16's b1 h8 s3072 d128 (the future mask; the gate splits)
    the forward and the split as routed against the plain versions, and
    at train-o0-mha6's b28 h16 s128 d64 (the future mask and key padding;
    the single pass) the single pass as routed, its device launches of
    one call (profiler: one prologue, the variant); each kernel timed
    beside its twin without the bias (the same shape, no mask), its plain
    version and SDPA fp32 with the same mask as ``attn_mask`` (TF32 off);
    the bounds count the live pairs this run's data needs (a finite bias
    and a real key) and the bias read once; ptxas's registers with no
    spill."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(24)
    checked = [_f32_bias_case(torch, fa, gen, (torch.float32, *c[1:]))
               for c in _bias_cases(torch)]
    torch.cuda.empty_cache()

    # train-o0-mha16's attention: the forward and the split
    b, h, s, d = MHA16_B, MHA16_HEADS, MHA16_S, MHA_E // MHA16_HEADS
    scale = d ** -0.5
    q, k, v, do, bias, sids, mask, pairs = _f32_bias_shape(torch, b, h, s, d,
                                                           None, gen)
    split_shape = f"b{b} h{h} s{s} d{d} fp32, bias [1, 1, {s}, {s}] (the " \
                  "future mask)"
    check(fa.uses_split_backward(s, s, d, 4, 4, bias=True),
          f"the gate at s{s} d{d} fp32 with a bias: not the split")
    f, g = fa.flash_attention, fa.flash_attention_bwd
    n0 = (f.f32_bias_launches, g.f32_bias_dkdv_launches,
          g.f32_bias_dq_launches, g.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, *sids, False, scale,
                                      bias=bias)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, *sids, False, scale,
                                 bias=bias)
    torch.cuda.synchronize()
    moved = (f.f32_bias_launches - n0[0], g.f32_bias_dkdv_launches - n0[1],
             g.f32_bias_dq_launches - n0[2], g.launches - n0[3])
    check(moved == (1, 1, 1, 0), f"flash fp32 bias {split_shape}: launches "
          f"(forward, dk/dv, dq, single pass) {moved}, expected the bias "
          "variants once each")
    kw = dict(scale=scale, bias=bias)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    fwd_err = _fp32_err(out, ref, f"flash fp32 bias {split_shape} forward",
                        FP32_FWD_TOL)
    _lse_err(lse, ref_lse, f"flash fp32 bias {split_shape}")
    del ref, ref_lse
    rgrads = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    split_err = {n: _fp32_err(x, r, f"flash fp32 bias {split_shape} {n}",
                              FP32_GRAD_TOL)
                 for n, x, r in zip(("dq", "dk", "dv"), got, rgrads)}
    del got, rgrads
    delta = (do * out).sum(dim=-1)
    args = (q, k, v, do, lse, delta, None, None, False, scale,
            fa._NO_ROUNDS)
    bop = fa._bias_operand(bias, b, h, s, s, q.device, scale)
    ws = fa._f32_transposes(q)
    fa._flash_dkdv_cuda(*args, ws=ws)
    sd4, side = b * h * s * d * 4, b * h * s * 4
    bias_bytes = bias.numel() * 4
    split_times = dict(
        fwd_ms=timer(lambda: fa.flash_attention_fwd(
            q, k, v, None, None, False, scale, bias=bias), iters=10),
        fwd_no_bias_ms=timer(lambda: fa.flash_attention_fwd(
            q, k, v, None, None, False, scale), iters=10),
        fwd_plain_ms=timer(lambda: fa.flash_attention_reference(
            q, k, v, **kw), iters=3, warmup=1),
        fwd_library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), iters=10),
        dkdv_ms=timer(lambda: fa._flash_dkdv_cuda(*args, bias=bop),
                      iters=10),
        dkdv_no_bias_ms=timer(lambda: fa._flash_dkdv_cuda(*args), iters=10),
        dq_ms=timer(lambda: fa._flash_dq_cuda(*args, ws=ws, bias=bop),
                    iters=10),
        dq_no_bias_ms=timer(lambda: fa._flash_dq_cuda(*args, ws=ws),
                            iters=10),
        as_called_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, None, None, False, scale, bias=bias),
            iters=10),
        dkdv_plain_ms=timer(lambda: fa.flash_bwd_dkdv_reference(
            q, k, v, lse, delta, do, **kw), iters=3, warmup=1),
        dq_plain_ms=timer(lambda: fa.flash_bwd_dq_reference(
            q, k, v, out, lse, do, **kw), iters=3, warmup=1),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, attn_mask=mask,
                                           scale=scale)), (q, k, v), do),
            iters=5))
    f_bound = bound(4.0 * d * pairs, 4 * sd4 + side + bias_bytes,
                    FP32_FLOPS_PER_S)
    dkdv_bound = bound(4 * 2.0 * d * pairs, 6 * sd4 + 2 * side + bias_bytes,
                       FP32_FLOPS_PER_S)
    dq_bound = bound(3 * 2.0 * d * pairs, 5 * sd4 + 2 * side + bias_bytes,
                     FP32_FLOPS_PER_S)
    split_pairs = pairs
    del q, k, v, do, out, lse, delta, args, ws, bias, mask, bop
    torch.cuda.empty_cache()

    # train-o0-mha6's attention: the single pass
    b, h, s, d = MHA6_B, MHA_HEADS, MHA6_S, MHA_E // MHA_HEADS
    scale = d ** -0.5
    q, k, v, do, bias, sids, mask, pairs = _f32_bias_shape(
        torch, b, h, s, d, MHA6_MIN_LEN, gen)
    single_shape = f"b{b} h{h} s{s} d{d} fp32, bias [1, 1, {s}, {s}] (the " \
                   f"future mask), key padding {MHA6_MIN_LEN}-{s}"
    check(not fa.uses_split_backward(s, s, d, 4, 4, bias=True),
          f"the gate at s{s} d{d} fp32 with a bias: not the single pass")
    out, lse = fa.flash_attention_fwd(q, k, v, *sids, False, scale,
                                      bias=bias)
    n0 = (g.f32_bias_launches, g.dkdv_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, *sids, False, scale,
                                 bias=bias)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, *sids, False,
                                   scale, bias=bias)
    torch.cuda.synchronize()
    check((g.f32_bias_launches - n0[0], g.dkdv_launches - n0[1]) == (2, 0),
          f"flash fp32 bias {single_shape}: not the single pass's bias "
          "variant")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"flash fp32 bias {single_shape}: a rerun gave other bits")
    kw = dict(segment_ids_q=sids[0], segment_ids_kv=sids[1], scale=scale,
              bias=bias)
    single_err = {n: _fp32_err(x, r, f"flash fp32 bias {single_shape} {n}",
                               FP32_GRAD_TOL)
                  for n, x, r in zip(("dq", "dk", "dv"), got,
                                     fa.flash_attention_bwd_reference(
                                         q, k, v, out, lse, do, **kw))}
    dev = device_launches(torch, fa.flash_attention_bwd,
                          (q, k, v, out, lse, do, *sids, False, scale),
                          F32_CORE_KERNELS + F32_BIAS_BWD_KERNELS,
                          dict(bias=bias))
    want = {"flash_f32_prologue_kernel": 1, "flash_bwd_f32_kernel": 0,
            "flash_bwd_f32_bias_kernel": 1, "flash_dkdv_f32_bias_kernel": 0,
            "flash_dq_f32_bias_kernel": 0}
    check({k_: dev[k_] for k_ in want} == want,
          f"flash fp32 bias single pass: device launches {dev} in one call, "
          f"expected {want}")
    sd4, side = b * h * s * d * 4, b * h * s * 4
    bias_bytes = bias.numel() * 4 + 2 * b * s * 4
    single_times = dict(
        ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, *sids, False, scale, bias=bias),
            iters=10),
        no_bias_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, *sids, False, scale), iters=10),
        plain_ms=timer(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, **kw), iters=3, warmup=1),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, attn_mask=mask,
                                           scale=scale)), (q, k, v), do),
            iters=10))
    b_bound = bound(10.0 * d * pairs, 8 * sd4 + 2 * side + bias_bytes,
                    FP32_FLOPS_PER_S)
    del q, k, v, do, out, lse, got, again, bias, mask
    torch.cuda.empty_cache()
    common = dict(
        route="cuda", checked=checked,
        tolerance=f"out and lse {FP32_FWD_TOL}, gradients {FP32_GRAD_TOL}, "
                  "of max and in relative norm, of the plain versions with "
                  "the same bias; a dead row's out and dq exactly 0, its "
                  "lse the fill; a rerun bitwise",
        library="F.scaled_dot_product_attention(attn_mask=the bias and the "
                "padding as one fp32 mask), exact fp32 (backward: dq, dk "
                "and dv together)")
    fwd_regs = _ffma_registers(_build, "flash_fwd", F32_BIAS_FWD_KERNELS)
    bwd_regs = _ffma_registers(_build, "flash_bwd", F32_BIAS_BWD_KERNELS)
    split_common = dict(common, shape=split_shape, live_pairs=split_pairs,
                        source="apex_tpu_torch/csrc/flash_bwd_f32.cuh",
                        library_ms=split_times["library_ms"],
                        as_called_ms=split_times["as_called_ms"],
                        pair_max_abs_err=split_err, registers=bwd_regs)
    return [
        dict(name="flash_fwd_f32_bias", source="apex_tpu_torch/csrc/"
             "flash_fwd_f32.cuh", replaces="apex_tpu/ops/flash_attention.py"
             ":251", max_abs_err=fwd_err, ms=split_times["fwd_ms"],
             no_bias_ms=split_times["fwd_no_bias_ms"],
             plain_ms=split_times["fwd_plain_ms"],
             plain="flash_attention_reference with the same bias",
             library_ms=split_times["fwd_library_ms"], bound_ms=f_bound[0],
             bound_by=f_bound[1], shape=split_shape, live_pairs=split_pairs,
             registers=fwd_regs, **common),
        dict(name="flash_bwd_f32_bias",
             source="apex_tpu_torch/csrc/flash_bwd_f32.cuh",
             replaces="apex_tpu/ops/flash_attention.py:604",
             max_abs_err=max(single_err.values()), ms=single_times["ms"],
             no_bias_ms=single_times["no_bias_ms"],
             plain_ms=single_times["plain_ms"],
             plain="flash_attention_bwd_reference with the same bias",
             library_ms=single_times["library_ms"], bound_ms=b_bound[0],
             bound_by=b_bound[1], shape=single_shape, live_pairs=pairs,
             as_called="flash_attention_bwd (the zeroed turns, two "
                       "transposes and the delta fold, the kernel)",
             device_launches_per_call=dev, registers=bwd_regs, **common),
        dict(name="flash_bwd_f32_dkdv_bias",
             replaces="apex_tpu/ops/flash_attention.py:558",
             max_abs_err=max(split_err["dk"], split_err["dv"]),
             ms=split_times["dkdv_ms"],
             no_bias_ms=split_times["dkdv_no_bias_ms"],
             plain_ms=split_times["dkdv_plain_ms"],
             plain="flash_bwd_dkdv_reference with the same bias",
             bound_ms=dkdv_bound[0], bound_by=dkdv_bound[1], **split_common),
        dict(name="flash_bwd_f32_dq_bias",
             replaces="apex_tpu/ops/flash_attention.py:671",
             max_abs_err=split_err["dq"], ms=split_times["dq_ms"],
             no_bias_ms=split_times["dq_no_bias_ms"],
             plain_ms=split_times["dq_plain_ms"],
             plain="flash_bwd_dq_reference with the same bias",
             bound_ms=dq_bound[0], bound_by=dq_bound[1], **split_common)]


# ---------------------------------------------------------------------------
# the bias with dropout on the fp32 FFMA route (B1's, B2's, B3's and B4's
# variants with both): train-o0-mha16's attention at dropout 0.1 (b1 h8
# s3072 d128, the future mask; the split), train-o0-mha6's (b28 h16 s128
# d64, the future mask and key padding; the single pass) and a d-64 split
# shape (b8 h16 s1024, the future mask as the bias)
# ---------------------------------------------------------------------------

F32_BIAS_DROPOUT_SEED = 20261024
F32_BIAS_DROPOUT_FWD_KERNELS = ("flash_fwd_f32_bias_dropout_kernel",)
F32_BIAS_DROPOUT_BWD_KERNELS = ("flash_bwd_f32_bias_dropout_kernel",
                                "flash_dkdv_f32_bias_dropout_kernel",
                                "flash_dq_f32_bias_dropout_kernel")
# the d-64 split shape: b8 h16 s1024, which the gate splits with both (fp32
# from s452 at d 64)
F32_BOTH_D64_SPLIT = (8, MHA_HEADS, 1024, 64)


def _f32_bias_dropout_keep_pattern(torch, fa, gen, d, seed):
    """Rate 0.5 under a finite bias (0.5 randn, [1, h, s, s]), no mask. The
    forward with q = k = 0 and v = I over sk = d keys: out[q, k] = 2 p[q,
    k] where the key is kept, exactly 0 where it is dropped. The single
    pass and the split's dk/dv with q = 0 and do = I over sq = d rows: dv
    = the dropped p transposed. The split's dq with key 0 = e_0 and the
    others 0, v = I, do = 1 and delta 0: dq[q] = ds[q, 0] e_0, nonzero
    exactly where key 0 is kept. Every zero pattern is the plain mask bit
    for bit."""
    b, h, s = 2, 3, 333
    half = dict(dropout_rate=0.5, dropout_seed=seed)
    what = f"flash fp32 bias dropout keep pattern d{d}"
    eye = torch.eye(d, device="cuda").expand(b, h, d, d).contiguous()
    bias_fwd = 0.5 * torch.randn(1, h, s, d, generator=gen, device="cuda")
    q = torch.zeros(b, h, s, d, device="cuda")
    k = torch.zeros(b, h, d, d, device="cuda")
    out, _ = fa.flash_attention_fwd(q, k, eye, None, None, False, 1.0,
                                    bias=bias_fwd, **half)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    check(torch.equal(out != 0, keep),
          f"{what}: the forward's keep pattern is not the plain mask")
    n = keep.numel()
    bias_bwd = 0.5 * torch.randn(1, h, d, s, generator=gen, device="cuda")
    k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
            for _ in range(2))
    q = torch.zeros(b, h, d, d, device="cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, False, 1.0,
                                      bias=bias_bwd, **half)
    keep = fa.dropout_keep_reference(seed, b, h, d, s, 0.5, device="cuda")
    for split in (False, True):
        _, _, dv = fa._flash_bwd_cuda(q, k, v, out, lse, eye, None, None,
                                      False, 1.0, split=split, bias=bias_bwd,
                                      **half)
        check(torch.equal(dv != 0, keep.transpose(-1, -2)),
              f"{what}: the {'split' if split else 'single pass'}'s keep "
              "pattern is not the plain mask")
    n += 2 * keep.numel()
    q = torch.randn(b, h, s, d, generator=gen, device="cuda")
    kk = torch.zeros(b, h, d, d, device="cuda")
    kk[:, :, 0, 0] = 1.0
    ones = torch.ones(b, h, s, d, device="cuda")
    _, lse = fa.flash_attention_fwd(q, kk, eye, None, None, False, 1.0,
                                    bias=bias_fwd)
    delta = torch.zeros(b, h, s, device="cuda")
    dq = fa._flash_dq_cuda(q, kk, eye, ones, lse, delta, None, None, False,
                           1.0, fa._NO_ROUNDS,
                           dropout=fa._dropout_args(0.5, seed),
                           bias=fa._bias_operand(bias_fwd, b, h, s, d,
                                                 q.device, 1.0))
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    check(torch.equal(dq[..., 0] != 0, keep[..., 0])
          and not bool(dq[..., 1:].any()),
          f"{what}: the split dq's keep pattern is not the plain mask")
    return dict(case=what, rate=0.5, keep_elements=n + b * h * s,
                bitwise=True)


def _f32_both_split_timed(torch, fa, F, timer, gen, b, h, s, d):
    """The FFMA forward and split with both at b h s d (the [1, 1, s, s]
    future mask as the bias, no padding, dropout 0.1; the gate splits):
    the forward and the pair as routed against the plain versions, a
    rerun bitwise, each split kernel against its own plain version; the
    forward, dk/dv and dq timed beside their twins (the bias alone over
    the same tiles; dropout alone over the same tiles, unmasked), their
    plain versions and SDPA fp32 (``attn_mask``, ``dropout_p``: its own
    random stream, a time only); the bounds over the live pairs with the
    hash's integer operations beside the products."""
    scale = d ** -0.5
    q, k, v, do, bias, sids, mask, pairs = _f32_bias_shape(torch, b, h, s, d,
                                                           None, gen)
    shape = (f"b{b} h{h} s{s} d{d} fp32, bias [1, 1, {s}, {s}] (the future "
             f"mask), dropout {DROPOUT_RATE}")
    check(fa.uses_split_backward(s, s, d, 4, 4, bias=True, dropout=True),
          f"the gate at s{s} d{d} fp32 with both: not the split")
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=F32_BIAS_DROPOUT_SEED)
    kw = dict(scale=scale, bias=bias, **drop)
    n0 = _f32_variant_counts(fa)
    n1 = fa.flash_attention_bwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, *sids, False, scale,
                                      bias=bias, **drop)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, *sids, False, scale,
                                 bias=bias, **drop)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, *sids, False,
                                   scale, bias=bias, **drop)
    torch.cuda.synchronize()
    _f32_moved(fa, n0, (1, 0, 2, 2), F32_BOTH,
               f"flash fp32 bias dropout {shape}")
    check(fa.flash_attention_bwd.launches == n1,
          f"flash fp32 bias dropout {shape}: a single pass ran")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"flash fp32 bias dropout {shape}: a rerun gave other bits")
    del again
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    fwd_err = _fp32_err(out, ref, f"flash fp32 bias dropout {shape} "
                        "forward", FP32_FWD_TOL)
    lse_err = _lse_err(lse, ref_lse, f"flash fp32 bias dropout {shape}")
    del ref, ref_lse
    rgrads = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    pair_err = {n: _fp32_err(x, r, f"flash fp32 bias dropout {shape} {n}",
                             FP32_GRAD_TOL)
                for n, x, r in zip(("dq", "dk", "dv"), got, rgrads)}
    del got, rgrads
    delta = (do * out).sum(dim=-1)
    args = (q, k, v, do, lse, delta, None, None, False, scale, fa._NO_ROUNDS)
    bop = fa._bias_operand(bias, b, h, s, s, q.device, scale)
    dargs = fa._dropout_args(DROPOUT_RATE, F32_BIAS_DROPOUT_SEED)
    ws = fa._f32_transposes(q)
    dk, dv = fa._flash_dkdv_cuda(*args, ws=ws, dropout=dargs, bias=bop)
    dq = fa._flash_dq_cuda(*args, ws=ws, dropout=dargs, bias=bop)
    rdq, _ = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    dq_err = _fp32_err(dq, rdq, f"flash fp32 bias dropout {shape} dq alone",
                       FP32_GRAD_TOL)
    del rdq
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw)
    dkdv_err = max(
        _fp32_err(dk, rdk, f"flash fp32 bias dropout {shape} dk alone",
                  FP32_GRAD_TOL),
        _fp32_err(dv, rdv, f"flash fp32 bias dropout {shape} dv alone",
                  FP32_GRAD_TOL))
    del rdk, rdv, dk, dv, dq
    torch.cuda.empty_cache()
    ldrop = dict(dropout_p=DROPOUT_RATE)
    t = dict(
        fwd_ms=timer(lambda: fa.flash_attention_fwd(
            q, k, v, None, None, False, scale, bias=bias, **drop), iters=10),
        fwd_bias_only_ms=timer(lambda: fa.flash_attention_fwd(
            q, k, v, None, None, False, scale, bias=bias), iters=10),
        fwd_dropout_only_ms=timer(lambda: fa.flash_attention_fwd(
            q, k, v, None, None, False, scale, **drop), iters=10),
        fwd_plain_ms=timer(lambda: fa.flash_attention_reference(
            q, k, v, **kw), iters=3, warmup=1),
        fwd_library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, **ldrop), iters=10),
        dkdv_ms=timer(lambda: fa._flash_dkdv_cuda(*args, dropout=dargs,
                                                  bias=bop), iters=10),
        dkdv_bias_only_ms=timer(lambda: fa._flash_dkdv_cuda(*args, bias=bop),
                                iters=10),
        dkdv_dropout_only_ms=timer(lambda: fa._flash_dkdv_cuda(
            *args, dropout=dargs), iters=10),
        dq_ms=timer(lambda: fa._flash_dq_cuda(*args, ws=ws, dropout=dargs,
                                              bias=bop), iters=10),
        dq_bias_only_ms=timer(lambda: fa._flash_dq_cuda(*args, ws=ws,
                                                        bias=bop), iters=10),
        dq_dropout_only_ms=timer(lambda: fa._flash_dq_cuda(
            *args, ws=ws, dropout=dargs), iters=10),
        as_called_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, None, None, False, scale, bias=bias,
            **drop), iters=10),
        dkdv_plain_ms=timer(lambda: fa.flash_bwd_dkdv_reference(
            q, k, v, lse, delta, do, **kw), iters=3, warmup=1),
        dq_plain_ms=timer(lambda: fa.flash_bwd_dq_reference(
            q, k, v, out, lse, do, **kw), iters=3, warmup=1),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, attn_mask=mask,
                                           scale=scale, **ldrop)),
            (q, k, v), do), iters=5))
    sd4, side = b * h * s * d * 4, b * h * s * 4
    bias_bytes = bias.numel() * 4
    hashed = DROPOUT_HASH_OPS * pairs
    f_bound = bound(4.0 * d * pairs + hashed, 4 * sd4 + side + bias_bytes,
                    FP32_FLOPS_PER_S)
    dkdv_bound = bound(4 * 2.0 * d * pairs + hashed,
                       6 * sd4 + 2 * side + bias_bytes, FP32_FLOPS_PER_S)
    dq_bound = bound(3 * 2.0 * d * pairs + hashed,
                     5 * sd4 + 2 * side + bias_bytes, FP32_FLOPS_PER_S)
    del q, k, v, do, out, lse, delta, args, ws, bias, mask, bop
    torch.cuda.empty_cache()
    return dict(shape=shape, live_pairs=pairs, fwd_max_abs_err=fwd_err,
                lse_rel_err=lse_err, pair_max_abs_err=pair_err,
                dkdv_max_abs_err=dkdv_err, dq_max_abs_err=dq_err,
                fwd_bound_ms=f_bound[0], fwd_bound_by=f_bound[1],
                dkdv_bound_ms=dkdv_bound[0], dkdv_bound_by=dkdv_bound[1],
                dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1], **t)


def _f32_both_single_timed(torch, fa, F, timer, gen):
    """The FFMA forward and single pass with both at train-o0-mha6's
    attention (b28 h16 s128 d64 fp32, the future mask as the bias, key
    padding as segment ids, dropout 0.1; the gate keeps the single pass):
    both as routed against the plain versions, a rerun bitwise, the device
    launches of one backward call (profiler: one prologue, the variant);
    the single pass timed as called beside its twins (the bias alone; the
    dropout alone over the same tiles, unmasked), its plain version and
    SDPA fp32 (``attn_mask``, ``dropout_p``); the bound over the live
    pairs with the hash beside the products."""
    b, h, s, d = MHA6_B, MHA_HEADS, MHA6_S, MHA_E // MHA_HEADS
    scale = d ** -0.5
    q, k, v, do, bias, sids, mask, pairs = _f32_bias_shape(
        torch, b, h, s, d, MHA6_MIN_LEN, gen)
    shape = (f"b{b} h{h} s{s} d{d} fp32, bias [1, 1, {s}, {s}] (the future "
             f"mask), key padding {MHA6_MIN_LEN}-{s}, dropout {DROPOUT_RATE}")
    check(not fa.uses_split_backward(s, s, d, 4, 4, bias=True, dropout=True),
          f"the gate at s{s} d{d} fp32 with both: not the single pass")
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=F32_BIAS_DROPOUT_SEED)
    kw = dict(segment_ids_q=sids[0], segment_ids_kv=sids[1], scale=scale,
              bias=bias, **drop)
    n0 = _f32_variant_counts(fa)
    n1 = fa.flash_attention_bwd.dkdv_launches
    out, lse = fa.flash_attention_fwd(q, k, v, *sids, False, scale,
                                      bias=bias, **drop)
    again = fa.flash_attention_fwd(q, k, v, *sids, False, scale, bias=bias,
                                   **drop)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, *sids, False, scale,
                                 bias=bias, **drop)
    got2 = fa.flash_attention_bwd(q, k, v, out, lse, do, *sids, False, scale,
                                  bias=bias, **drop)
    torch.cuda.synchronize()
    _f32_moved(fa, n0, (2, 2, 0, 0), F32_BOTH,
               f"flash fp32 bias dropout {shape}")
    check(fa.flash_attention_bwd.dkdv_launches == n1,
          f"flash fp32 bias dropout {shape}: the split ran")
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1])
          and all(torch.equal(x, y) for x, y in zip(got, got2)),
          f"flash fp32 bias dropout {shape}: a rerun gave other bits")
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    fwd_err = _fp32_err(out, ref, f"flash fp32 bias dropout {shape} "
                        "forward", FP32_FWD_TOL)
    _lse_err(lse, ref_lse, f"flash fp32 bias dropout {shape}")
    err = {n: _fp32_err(x, r, f"flash fp32 bias dropout {shape} {n}",
                        FP32_GRAD_TOL)
           for n, x, r in zip(("dq", "dk", "dv"), got,
                              fa.flash_attention_bwd_reference(
                                  q, k, v, out, lse, do, **kw))}
    dev = device_launches(torch, fa.flash_attention_bwd,
                          (q, k, v, out, lse, do, *sids, False, scale),
                          F32_CORE_KERNELS + F32_BIAS_BWD_KERNELS
                          + F32_BIAS_DROPOUT_BWD_KERNELS,
                          dict(bias=bias, **drop))
    want = {k_: 0 for k_ in F32_CORE_KERNELS + F32_BIAS_BWD_KERNELS
            + F32_BIAS_DROPOUT_BWD_KERNELS}
    want.update(flash_f32_prologue_kernel=1,
                flash_bwd_f32_bias_dropout_kernel=1)
    check({k_: dev[k_] for k_ in want} == want, f"flash fp32 bias dropout "
          f"single pass: device launches {dev} in one call, expected {want}")
    ldrop = dict(dropout_p=DROPOUT_RATE)
    t = dict(
        ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, *sids, False, scale, bias=bias, **drop),
            iters=10),
        bias_only_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, *sids, False, scale, bias=bias),
            iters=10),
        dropout_only_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, *sids, False, scale, **drop), iters=10),
        plain_ms=timer(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, **kw), iters=3, warmup=1),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, attn_mask=mask,
                                           scale=scale, **ldrop)),
            (q, k, v), do), iters=10))
    sd4, side = b * h * s * d * 4, b * h * s * 4
    bias_bytes = bias.numel() * 4 + 2 * b * s * 4
    b_bound = bound(10.0 * d * pairs + DROPOUT_HASH_OPS * pairs,
                    8 * sd4 + 2 * side + bias_bytes, FP32_FLOPS_PER_S)
    del q, k, v, do, out, lse, got, got2, again, bias, mask
    torch.cuda.empty_cache()
    return dict(shape=shape, live_pairs=pairs, fwd_max_abs_err=fwd_err,
                max_abs_err=max(err.values()), grad_max_abs_err=err,
                bound_ms=b_bound[0], bound_by=b_bound[1],
                device_launches_per_call=dev, **t)


def check_flash_f32_bias_dropout(torch, timer):
    """The variants with both the bias and dropout of B1, B2, B3 and B4 on
    the fp32 FFMA route (``flash_fwd_f32_bias_dropout_kernel`` of
    ``csrc/flash_fwd_f32.cuh``; ``flash_bwd_f32_bias_dropout_kernel``,
    ``flash_dkdv_f32_bias_dropout_kernel`` and
    ``flash_dq_f32_bias_dropout_kernel`` of ``csrc/flash_bwd_f32.cuh``) at
    :func:`_bias_cases`' shapes in fp32 with dropout 0.1
    (:func:`_f32_bias_case`), the keep pattern bitwise at d 64 and
    128 (:func:`_f32_bias_dropout_keep_pattern`), the rows at the -1e30
    fill (:func:`_fill_rows_cases`, single pass and split); then at
    train-o0-mha16's shape (the forward and the split,
    :func:`_f32_both_split_timed`: the rows' numbers), at the d-64 split
    shape :data:`F32_BOTH_D64_SPLIT` (the same) and at train-o0-mha6's
    shape (the forward and the single pass, :func:`_f32_both_single_timed`:
    B2's row); ptxas's registers with no spill."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(25)
    checked = [_f32_bias_case(torch, fa, gen, (torch.float32, *c[1:]),
                              DROPOUT_RATE) for c in _bias_cases(torch)]
    bitwise = [_f32_bias_dropout_keep_pattern(torch, fa, gen, 64, 5),
               _f32_bias_dropout_keep_pattern(torch, fa, gen, 128, -3)]
    fill = _fill_rows_cases(torch, fa, gen, (torch.float32,), (False, True),
                            DROPOUT_RATE)
    torch.cuda.empty_cache()
    main = _f32_both_split_timed(torch, fa, F, timer, gen, MHA16_B,
                                 MHA16_HEADS, MHA16_S, MHA_E // MHA16_HEADS)
    d64 = _f32_both_split_timed(torch, fa, F, timer, gen,
                                *F32_BOTH_D64_SPLIT)
    single = _f32_both_single_timed(torch, fa, F, timer, gen)
    fwd_regs = _ffma_registers(_build, "flash_fwd",
                               F32_BIAS_DROPOUT_FWD_KERNELS)
    bwd_regs = _ffma_registers(_build, "flash_bwd",
                               F32_BIAS_DROPOUT_BWD_KERNELS)
    common = dict(
        route="cuda", bitwise=bitwise, fill_rows=fill,
        checked=checked,
        tolerance=f"out and lse {FP32_FWD_TOL}, gradients {FP32_GRAD_TOL}, "
                  "of max and in relative norm, of the plain versions with "
                  "the same bias and seed; the one-key row bit for bit; a "
                  "dead row's out and dq exactly 0, its lse the fill; a "
                  "rerun bitwise; the keep pattern bitwise",
        library="F.scaled_dot_product_attention(attn_mask=the bias and the "
                f"padding as one fp32 mask, dropout_p={DROPOUT_RATE}), exact "
                "fp32, its own random stream (a time, not an oracle; "
                "backward: dq, dk and dv together)")
    split_common = dict(common, shape=main["shape"],
                        live_pairs=main["live_pairs"],
                        source="apex_tpu_torch/csrc/flash_bwd_f32.cuh",
                        library_ms=main["library_ms"],
                        as_called_ms=main["as_called_ms"],
                        pair_max_abs_err=main["pair_max_abs_err"],
                        registers=bwd_regs, d64_shape=d64)
    return [
        dict(name="flash_fwd_f32_bias_dropout",
             source="apex_tpu_torch/csrc/flash_fwd_f32.cuh",
             replaces="apex_tpu/ops/flash_attention.py:251",
             max_abs_err=main["fwd_max_abs_err"],
             lse_rel_err=main["lse_rel_err"], ms=main["fwd_ms"],
             bias_only_ms=main["fwd_bias_only_ms"],
             dropout_only_ms=main["fwd_dropout_only_ms"],
             plain_ms=main["fwd_plain_ms"],
             plain="flash_attention_reference with the same bias and seed",
             library_ms=main["fwd_library_ms"], bound_ms=main["fwd_bound_ms"],
             bound_by=main["fwd_bound_by"], shape=main["shape"],
             live_pairs=main["live_pairs"], registers=fwd_regs,
             d64_shape=d64, single_pass_shape=dict(
                 shape=single["shape"],
                 fwd_max_abs_err=single["fwd_max_abs_err"]), **common),
        dict(name="flash_bwd_f32_bias_dropout",
             source="apex_tpu_torch/csrc/flash_bwd_f32.cuh",
             replaces="apex_tpu/ops/flash_attention.py:604",
             max_abs_err=single["max_abs_err"],
             pair_max_abs_err=single["grad_max_abs_err"], ms=single["ms"],
             bias_only_ms=single["bias_only_ms"],
             dropout_only_ms=single["dropout_only_ms"],
             plain_ms=single["plain_ms"],
             plain="flash_attention_bwd_reference with the same bias and "
                   "seed",
             library_ms=single["library_ms"], bound_ms=single["bound_ms"],
             bound_by=single["bound_by"], shape=single["shape"],
             live_pairs=single["live_pairs"],
             as_called="flash_attention_bwd (the zeroed turns, two "
                       "transposes and the delta fold, the kernel)",
             device_launches_per_call=single["device_launches_per_call"],
             registers=bwd_regs, **common),
        dict(name="flash_bwd_f32_dkdv_bias_dropout",
             replaces="apex_tpu/ops/flash_attention.py:558",
             max_abs_err=main["dkdv_max_abs_err"], ms=main["dkdv_ms"],
             bias_only_ms=main["dkdv_bias_only_ms"],
             dropout_only_ms=main["dkdv_dropout_only_ms"],
             plain_ms=main["dkdv_plain_ms"],
             plain="flash_bwd_dkdv_reference with the same bias and seed",
             bound_ms=main["dkdv_bound_ms"], bound_by=main["dkdv_bound_by"],
             **split_common),
        dict(name="flash_bwd_f32_dq_bias_dropout",
             replaces="apex_tpu/ops/flash_attention.py:671",
             max_abs_err=main["dq_max_abs_err"], ms=main["dq_ms"],
             bias_only_ms=main["dq_bias_only_ms"],
             dropout_only_ms=main["dq_dropout_only_ms"],
             plain_ms=main["dq_plain_ms"],
             plain="flash_bwd_dq_reference with the same bias and seed",
             bound_ms=main["dq_bound_ms"], bound_by=main["dq_bound_by"],
             **split_common)]


# the wgmma flash kernels in ptxas's log: the split's two, the forward (its
# second parameter the rows a block: 1 or 2 consumer warpgroups) and the
# single pass; their DROP and (forward, single pass) BIAS parameters
_SM90_KERNEL = re.compile(r"(flash_dkdv_sm90|flash_dq_sm90|flash_fwd_sm90|"
                          r"flash_bwd_fused_sm90)I\d+\w+?Li(\d+)E(?:Li(\d+)E)?"
                          r"(?:Lb([01])E)?(?:Lb([01])E)?")
# the kernels held to no spill, with their dropout and bias variants, and
# every dropout and bias variant but the split's dk/dv (the dk/dv kernel at
# d 64 spills 8 bytes: ROADMAP §C), which may spill no more than its twin
# without; the variants by their names' suffixes, both first
_NO_SPILL = ("flash_fwd_sm90", "flash_bwd_fused_sm90")
_VARIANTS = (" dropout bias", " dropout", " bias")


def _variant(name):
    """The variant suffix of a :func:`_sm90_registers` name, or ''."""
    return next((v for v in _VARIANTS if name.endswith(v)), "")


def _sm90_registers(build):
    """``ptxas -v``'s register count and spill bytes of each kernel in the
    wgmma flash libraries (before ``setmaxnreg``: the producer warpgroup
    gives up to 40 a thread, 24 in a dropout or the single pass's bias
    variant, and the consumer warpgroups take 232, 240); fails on a spill
    in the forward's and the single pass's kernels and in every dropout
    (`` dropout``), bias (`` bias``) and both (`` dropout bias``)
    variant, but for the split's dk/dv, which fails where a variant spills
    more than the same kernel without a variant."""
    regs = {}
    for target in build.targets(["flash_fwd_sm90", "flash_bwd_sm90"]):
        name = None
        for line in build.library_path(target).with_suffix(".log") \
                .read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:     # e.g. ...15flash_dkdv_sm90I13__nv_bfloat16Li64EE...
                k = _SM90_KERNEL.search(m.group(1))
                name = None
                if k:
                    name = f"{target} {k.group(1)} d{k.group(2)}"
                    if k.group(3):
                        name += f" rows{64 * int(k.group(3))}"
                    if k.group(4) == "1":
                        name += " dropout"
                    if k.group(5) == "1":
                        name += " bias"
                    regs[name] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = int(m.group(1)) + int(m.group(2))
                regs[name]["spill_bytes"] = spill
                check(spill == 0 or not (name.split()[1] in _NO_SPILL or (
                    _variant(name)
                    and name.split()[1] != "flash_dkdv_sm90")),
                      f"{name}: ptxas spills {spill} bytes")
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                regs[name]["registers"] = int(m.group(1))
    for name, reg in regs.items():
        variant = _variant(name)
        if variant:
            twin = regs[name[:-len(variant)]]
            check(reg["spill_bytes"] <= twin["spill_bytes"],
                  f"{name}: ptxas spills {reg['spill_bytes']} bytes, "
                  f"its twin without{variant} {twin['spill_bytes']}")
    # the split's variants: two dtypes, two kernels, two head dims
    for variant in _VARIANTS:
        check(sum(_variant(n) == variant and n.split()[1] in (
            "flash_dkdv_sm90", "flash_dq_sm90") for n in regs) == 8,
              f"the split's{variant} variants in ptxas's log: "
              f"{sorted(regs)}")
    # the bias variants: two dtypes; the forward at two head dims and two
    # block heights, the single pass and the split's two kernels at two
    # head dims
    check(sum(_variant(n) == " bias" for n in regs) == 20,
          f"the bias variants in ptxas's log: {sorted(regs)}")
    # the variants with both: two dtypes, two head dims; the forward at two
    # block heights (8), the split's dk/dv (4) and dq (4), the single pass
    # (4)
    both = [n for n in regs if _variant(n) == " dropout bias"]
    check(len(both) == 20 and sum(n.split()[1] == "flash_fwd_sm90"
                                  for n in both) == 8
          and sum(n.split()[1] == "flash_bwd_fused_sm90" for n in both) == 4,
          f"the variants with both in ptxas's log: {sorted(regs)}")
    return regs


# the decode kernels in ptxas's log: B12's decode regime (one kernel) and
# every instantiation of B5 (q dtype, head dim, rows a block, e4m3 pool,
# general path)
_DECODE_KERNEL = re.compile(
    r"(fp8_mm_decode_kernel)|paged_decode_kernelI(13__nv_bfloat16|6__half|f)"
    r"Li(\d+)ELi(\d+)ELb([01])ELb([01])E")
# the prefill regime's kernels (rows a block, splits) and the LayerNorm
# backward's (template arguments as mangled)
_PREFILL_KERNEL = re.compile(r"fp8_mm_prefill_kernelILi(\d+)ELi(\d+)E")
_LN_BWD_KERNEL = re.compile(r"(ln_bwd_warp_rows|ln_bwd_block_rows)I(\w+?)EEv")
_DTYPE_NAMES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}


def _decode_registers(build, source):
    """``ptxas -v``'s registers and spill bytes of each kernel of the decode
    library ``source`` (``fp8_matmul`` or ``paged_decode``, every dtype
    target); fails on any spill in them."""
    regs = {}
    for target in build.targets([source]):
        name = None
        for line in build.library_path(target).with_suffix(".log") \
                .read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = _DECODE_KERNEL.search(m.group(1))
                p = _PREFILL_KERNEL.search(m.group(1))
                name = None
                if p:
                    name = f"fp8_mm_prefill_kernel bm{p.group(1)} " \
                        f"splits{p.group(2)}"
                elif k and k.group(1):
                    name = k.group(1)
                elif k:
                    name = (f"paged_decode_kernel {_DTYPE_NAMES[k.group(2)]} "
                            f"d{k.group(3)} g{k.group(4)}"
                            + (" e4m3" if k.group(5) == "1" else "")
                            + (" general" if k.group(6) == "1" else ""))
                if name:
                    regs[name] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = int(m.group(1)) + int(m.group(2))
                regs[name]["spill_bytes"] = spill
                check(spill == 0, f"{target} {name}: ptxas spills {spill} "
                      "bytes")
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                regs[name]["registers"] = int(m.group(1))
    check(len(regs) > 0, f"{source}: no decode kernel in ptxas's log")
    return regs


def _ln_bwd_registers(build):
    """``ptxas -v``'s registers and spill bytes of each LayerNorm backward
    kernel (``csrc/layer_norm_bwd.cu``); fails on any spill."""
    regs, name = {}, None
    for line in build.library_path("layer_norm_bwd").with_suffix(".log") \
            .read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = _LN_BWD_KERNEL.search(m.group(1))
            name = f"{k.group(1)}<{k.group(2)}>" if k else None
            if name:
                regs[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
            regs[name]["spill_bytes"] = spill
            check(spill == 0, f"layer_norm_bwd {name}: ptxas spills {spill} "
                  "bytes")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name]["registers"] = int(m.group(1))
    check(len(regs) > 0, "layer_norm_bwd: no kernel in ptxas's log")
    return regs


def check_flash_split(torch, timer):
    """The two-kernel backward (dq, then dk/dv on the wgmma route; dk/dv,
    then dq on flash_bwd.cu's) at the long-sequence GPT's attention shape,
    b2 h16 s4096 d64 causal, where the JAX package's gate sends it. The
    wgmma route (bf16): each kernel against its plain version (dq and the
    delta it folds in; dk and dv from that delta), the pair against the
    plain backward, a bitwise rerun, a ragged shape with padding segment
    ids; each kernel timed apart, the pair beside the single-pass
    backward forced at the same shape, and beside B2 at b8 h16 s1024. The
    fp32 split (the O0 long path's): :func:`check_flash_f32`."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    # past the gate with segment ids: padding rows get zero dq
    b, h, s, d, live = 1, 4, 2304, 64, 2000
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    sid = torch.where(torch.arange(s, device="cuda") < live, 0, -1)
    sid = sid.to(torch.int32)[None].contiguous()
    check(fa.uses_split_backward(s, s, d, 2, 2, True), "gate at s2304")
    out, lse = fa.flash_attention_fwd(q, k, v, sid, None, True)
    n0 = _split_counts(fa)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, sid, None, True)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, segment_ids_q=sid)
    torch.cuda.synchronize()
    check(_split_moved(fa, n0, True),
          "s2304 did not take the split's wgmma route")
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        grad_err(g, r, f"flash split segments {name}")
    check(got[0][:, :, live:].abs().max().item() == 0.0,
          "flash split: padding rows got a nonzero dq")
    del q, k, v, do, out, lse, got, ref

    b, h, s, d = SPLIT_B, SPLIT_H, SPLIT_S, SPLIT_D
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    scale = d ** -0.5
    check(fa.uses_split_backward(s, s, d, 2, 2, True), "gate at s4096")
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
    n0 = _split_counts(fa)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                 scale)
    torch.cuda.synchronize()
    check(_split_moved(fa, n0, True),
          "s4096 did not route to the split's wgmma route")
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                   scale)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          "flash split: a rerun gave other bits")
    del again
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, scale=scale)
    torch.cuda.synchronize()
    errs = {n: grad_err(g, r, f"flash split {n}")
            for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    single = fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                                scale, split=False)
    torch.cuda.synchronize()
    single_err = max(grad_err(g, r, f"flash single pass s{s} {n}")
                     for n, g, r in zip(("dq", "dk", "dv"), single, ref))
    del got, ref, single
    # each kernel against its plain version: dq (with the delta it folds
    # in: fp32 sums of the same exact products, 1e-5 of the largest) and
    # dk/dv from that delta
    rounds = fa._mixed_rounds(q, k, do)
    delta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, None, None, True, scale, rounds)
    dq = fa._flash_dq_cuda(*args, out=out)
    dk, dv = fa._flash_dkdv_cuda(*args)
    rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do,
                                            causal=True, scale=scale)
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do,
                                           causal=True, scale=scale)
    torch.cuda.synchronize()
    delta_err = _fp32_err(delta, rdelta, "flash split delta fold", 1e-5)
    dq_err = grad_err(dq, rdq, "flash split dq kernel")
    dkdv_err = max(grad_err(dk, rdk, "flash split dk kernel"),
                   grad_err(dv, rdv, "flash split dv kernel"))
    del dq, dk, dv, rdq, rdelta, rdk, rdv
    dkdv_ms = timer(lambda: fa._flash_dkdv_cuda(*args), iters=10)
    dq_ms = timer(lambda: fa._flash_dq_cuda(*args, out=out), iters=10)
    split_ms = timer(lambda: fa._flash_bwd_cuda(
        q, k, v, out, lse, do, None, None, True, scale, split=True), iters=10)
    single_ms = timer(lambda: fa._flash_bwd_cuda(
        q, k, v, out, lse, do, None, None, True, scale, split=False),
        iters=10)
    plain_ms = timer(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True, scale=scale), iters=3, warmup=1)
    lib_ms = timer(_grad_of(torch, lambda a, b_, c: (
        F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                       scale=scale)), (q, k, v), do),
        iters=10)
    pairs = b * h * s * (s + 1) // 2
    # dk/dv reads q, k, v, do, lse, delta and writes dk, dv; dq reads q, k,
    # v, do, o, lse and writes dq and delta
    sd2 = b * h * s * d * 2
    dkdv_bound = bound(4 * 2.0 * d * pairs, 6 * sd2 + 2 * b * h * s * 4)
    dq_bound = bound(3 * 2.0 * d * pairs, 6 * sd2 + 2 * b * h * s * 4)
    single_bound = bound(5 * 2.0 * d * pairs, 7 * sd2 + 2 * b * h * s * 4)
    del q, k, v, do, out, lse, delta, args

    # the split beside B2 at the s1024 train cell's shape (the single pass
    # runs there), as data for B2's redesign
    q, k, v, do = (rand(8, h, 1024, d) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
    b8 = dict(split_ms=timer(lambda: fa._flash_bwd_cuda(
        q, k, v, out, lse, do, None, None, True, scale, split=True)),
        single_pass_ms=timer(lambda: fa._flash_bwd_cuda(
            q, k, v, out, lse, do, None, None, True, scale, split=False)))
    del q, k, v, do, out, lse

    wgmma = dict(
        route="cuda", source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
        shape=f"b{b} h{h} s{s} d{d} bf16 causal (also b1 h4 s2304 with "
              "segment ids, padding from 2000)",
        tolerance="2 bf16 ulp + 2% of max, 1% relative norm; the folded "
                  "delta 1e-5 of max; a rerun bitwise",
        plain_ms=plain_ms, library_ms=lib_ms,
        plain="flash_attention_bwd_reference: dq, dk and dv together",
        library="backward of F.scaled_dot_product_attention(is_causal="
                "True): dq, dk and dv together",
        split_ms=split_ms, single_pass_ms=single_ms,
        single_pass_bound_ms=single_bound[0],
        single_pass_max_abs_err=single_err, pair_max_abs_err=errs,
        delta_fold_max_abs_err=delta_err, b8_s1024=b8,
        registers=_sm90_registers(_build))
    return [
        dict(name="flash_bwd_dkdv_sm90", replaces="apex_tpu/ops/"
             "flash_attention.py:558", max_abs_err=dkdv_err, ms=dkdv_ms,
             bound_ms=dkdv_bound[0], bound_by=dkdv_bound[1], **wgmma),
        dict(name="flash_bwd_dq_sm90", replaces="apex_tpu/ops/"
             "flash_attention.py:671", max_abs_err=dq_err, ms=dq_ms,
             bound_ms=dq_bound[0], bound_by=dq_bound[1], **wgmma),
    ]


def check_flash_split_dropout(torch, timer):
    """B3's and B4's dropout variants (``flash_dkdv_sm90<..., DROP>``,
    ``flash_dq_sm90<..., DROP>``) at the long-sequence step's b2 h16 s4096
    d64 bf16 causal, rate 0.1, where the gate sends the backward with
    dropout to the split: the pair as routed against the plain backward
    with the same seed, each kernel against its plain version (dq and the
    delta it folds in from the dropped output; dk, dv from that delta) at
    the bf16 backwards' limits; a bitwise rerun, another seed another
    result; the masks bitwise at rate 0.5 with no attention mask (dk/dv:
    q = 0 and do = I over sq = d rows, so dv is the dropped p, 2 / sk,
    transposed; dq: k = I
    over sk = d keys and out = 0, so delta = 0 and dq is zero exactly
    where a key is dropped); each kernel timed with and without dropout
    beside its plain version and SDPA's dropout backward (ptxas's spills:
    :func:`_sm90_registers`)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(13)
    g = fa.flash_attention_bwd
    b, h, s, d = SPLIT_B, SPLIT_H, SPLIT_S, SPLIT_D
    scale, seed = d ** -0.5, 20261019
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def counts():
        return (g.launches, g.dropout_launches, g.dkdv_launches,
                g.dq_launches, g.dropout_dkdv_launches,
                g.dropout_dq_launches)

    check(fa.uses_split_backward(s, s, d, 2, 2, True, dropout=True),
          f"gate at s{s} with dropout")
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale,
                                      **drop)
    other_out, other_lse = fa.flash_attention_fwd(
        q, k, v, None, None, True, scale, DROPOUT_RATE, seed ^ 1)
    n0 = counts()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                 scale, **drop)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                   scale, **drop)
    other = fa.flash_attention_bwd(q, k, v, other_out, other_lse, do, None,
                                   None, True, scale, DROPOUT_RATE, seed ^ 1)
    torch.cuda.synchronize()
    moved = tuple(a - b_ for a, b_ in zip(counts(), n0))
    check(moved == (0, 0, 3, 3, 3, 3), f"flash split dropout s{s}: "
          f"launches (single pass, its dropout, dk/dv, dq, their dropout) "
          f"{moved}, expected the split's dropout variants 3 times each")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          "flash split dropout: a rerun gave other bits")
    check(not torch.equal(got[0], other[0])
          and not torch.equal(got[2], other[2]),
          "flash split dropout: another seed gave the same dq or dv")
    del again, other, other_out, other_lse
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, scale=scale, **drop)
    pair_errs = {n: grad_err(gr, r, f"flash split dropout {n}")
                 for n, gr, r in zip(("dq", "dk", "dv"), got, ref)}
    del got, ref
    torch.cuda.empty_cache()

    # each kernel against its plain version
    rounds = fa._mixed_rounds(q, k, do)
    delta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, None, None, True, scale, rounds)
    dargs = fa._dropout_args(DROPOUT_RATE, seed)
    dq = fa._flash_dq_cuda(*args, out=out, dropout=dargs)
    dk, dv = fa._flash_dkdv_cuda(*args, dropout=dargs)
    rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do,
                                            causal=True, scale=scale, **drop)
    torch.cuda.synchronize()
    delta_err = _fp32_err(delta, rdelta, "flash split dropout delta fold",
                          1e-5)
    dq_err = grad_err(dq, rdq, "flash split dropout dq kernel")
    del dq, rdq, rdelta
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do,
                                           causal=True, scale=scale, **drop)
    dkdv_err = max(grad_err(dk, rdk, "flash split dropout dk kernel"),
                   grad_err(dv, rdv, "flash split dropout dv kernel"))
    del dk, dv, rdk, rdv
    torch.cuda.empty_cache()

    # the masks, bitwise, at rate 0.5 with no attention mask (p > 0)
    mseed, half = seed ^ 0x5A5A, fa._dropout_args(0.5, seed ^ 0x5A5A)
    eye = torch.eye(d, device="cuda", dtype=torch.bfloat16).expand(
        b, h, d, d).contiguous()
    mq = torch.zeros(b, h, d, d, device="cuda", dtype=torch.bfloat16)
    mk, mv = rand(b, h, s, d), rand(b, h, s, d)
    _, mlse = fa.flash_attention_fwd(mq, mk, mv, None, None, False, scale)
    zero = torch.zeros((b, h, d), dtype=torch.float32, device="cuda")
    _, mdv = fa._flash_dkdv_cuda(mq, mk, mv, eye, mlse, zero, None, None,
                                 False, scale, rounds, dropout=half)
    keep = fa.dropout_keep_reference(mseed, b, h, d, s, 0.5, device="cuda")
    check(torch.equal(mdv != 0, keep.transpose(-1, -2)),
          "flash split dropout: the dk/dv kernel's mask is not the plain "
          "mask")
    dkdv_mask = keep.numel()
    del mq, mk, mv, mlse, zero, mdv, keep
    mq, mv, mdo = rand(b, h, s, d), rand(b, h, d, d), rand(b, h, s, d)
    _, mlse = fa.flash_attention_fwd(mq, eye, mv, None, None, False, scale)
    mdelta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    mdq = fa._flash_dq_cuda(mq, eye, mv, mdo, mlse, mdelta, None, None,
                            False, scale, rounds,
                            out=torch.zeros_like(mq), dropout=half)
    keep = fa.dropout_keep_reference(mseed, b, h, s, d, 0.5, device="cuda")
    check(mdelta.abs().max().item() == 0.0,
          "flash split dropout: the folded delta of out = 0 is not 0")
    check(torch.equal(mdq != 0, keep),
          "flash split dropout: the dq kernel's mask is not the plain mask")
    masks = dict(rate=0.5, dkdv=f"b{b} h{h} sq{d} sk{s}, do = I: dv is "
                 "the dropped p transposed", dkdv_elements=dkdv_mask,
                 dq=f"b{b} h{h} sq{s} sk{d}, k = I, out = 0",
                 dq_elements=keep.numel(),
                 keep_share=keep.float().mean().item(), bitwise=True)
    del mq, mv, mdo, mlse, mdelta, mdq, keep, eye
    torch.cuda.empty_cache()

    dkdv_ms = timer(lambda: fa._flash_dkdv_cuda(*args, dropout=dargs),
                    iters=10)
    dkdv_nd_ms = timer(lambda: fa._flash_dkdv_cuda(*args), iters=10)
    dq_ms = timer(lambda: fa._flash_dq_cuda(*args, out=out, dropout=dargs),
                  iters=10)
    dq_nd_ms = timer(lambda: fa._flash_dq_cuda(*args, out=out), iters=10)
    as_called_ms = timer(lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, None, None, True, scale, **drop), iters=10)
    dq_plain_ms = timer(lambda: fa.flash_bwd_dq_reference(
        q, k, v, out, lse, do, causal=True, scale=scale, **drop), iters=3,
        warmup=1)
    dkdv_plain_ms = timer(lambda: fa.flash_bwd_dkdv_reference(
        q, k, v, lse, delta, do, causal=True, scale=scale, **drop), iters=3,
        warmup=1)
    lib_ms = timer(_grad_of(torch, lambda a, b_, c: (
        F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                       scale=scale,
                                       dropout_p=DROPOUT_RATE)),
        (q, k, v), do), iters=10)
    pairs = b * h * s * (s + 1) // 2
    sd2 = b * h * s * d * 2
    dkdv_bound = _with_hash(*bound(4 * 2.0 * d * pairs,
                                   6 * sd2 + 2 * b * h * s * 4), pairs)
    dq_bound = _with_hash(*bound(3 * 2.0 * d * pairs,
                                 6 * sd2 + 2 * b * h * s * 4), pairs)
    del q, k, v, do, out, lse, delta, args
    torch.cuda.empty_cache()
    common = dict(
        route="cuda", source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
        shape=f"b{b} h{h} s{s} d{d} bf16 causal, dropout {DROPOUT_RATE}",
        tolerance="2 bf16 ulp + 2% of max, 1% relative norm, of the plain "
                  "versions with the same seed; the folded delta 1e-5 of "
                  "max; a rerun bitwise; the masks bitwise",
        library_ms=lib_ms,
        library="backward of F.scaled_dot_product_attention(is_causal="
                f"True, dropout_p={DROPOUT_RATE}): dq, dk and dv together, "
                "its own random stream",
        as_called_ms=as_called_ms, pair_max_abs_err=pair_errs,
        delta_fold_max_abs_err=delta_err, mask_check=masks)
    return [
        dict(name="flash_bwd_dkdv_sm90_dropout",
             replaces="apex_tpu/ops/flash_attention.py:558",
             max_abs_err=dkdv_err, ms=dkdv_ms, no_dropout_ms=dkdv_nd_ms,
             plain_ms=dkdv_plain_ms, plain="flash_bwd_dkdv_reference",
             bound_ms=dkdv_bound[0], bound_by=dkdv_bound[1], **common),
        dict(name="flash_bwd_dq_sm90_dropout",
             replaces="apex_tpu/ops/flash_attention.py:671",
             max_abs_err=dq_err, ms=dq_ms, no_dropout_ms=dq_nd_ms,
             plain_ms=dq_plain_ms, plain="flash_bwd_dq_reference",
             bound_ms=dq_bound[0], bound_by=dq_bound[1], **common),
    ]


def _split_bias_case(torch, fa, gen, case):
    """One :func:`_bias_cases` shape through the split's bias variants
    (forced): dq with the delta it folds in, then dk/dv from that delta,
    each against its plain version with the same bias (the bf16
    backwards' limits; the delta 1e-5); a dead row's dq exactly zero, no
    non-finite gradient; returns the largest gradient error."""
    _, _, _, b, h, sq, sk, causal, _, dead = case
    q, k, v, do, bias, sid_q, sid_kv, scale, what = _bias_case_inputs(
        torch, gen, case, "flash split bias")
    kw = dict(causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
              scale=scale, bias=bias)
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, scale,
                                      bias=bias)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale,
            fa._mixed_rounds(q, k, do))
    bop = fa._bias_operand(bias, b, h, sq, sk, q.device, scale)
    dq = fa._flash_dq_cuda(*args, out=out, bias=bop)
    dk, dv = fa._flash_dkdv_cuda(*args, bias=bop)
    rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    _fp32_err(delta, rdelta, f"{what} delta fold", 1e-5)
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw)
    check(all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv)),
          f"{what}: a non-finite gradient")
    gerr = max(grad_err(g, r, f"{what} {n}") for n, g, r in
               zip(("dq", "dk", "dv"), (dq, dk, dv), (rdq, rdk, rdv)))
    if dead is not None:
        check(dq[:, :, dead].abs().max().item() == 0.0,
              f"{what}: the row with no live key got a nonzero dq")
    return what, gerr


def _split_bias_positions(torch, fa, gen, dtype, d, sq, sk):
    """The split's bias positions, bitwise: one-hot bias rows (0 at key
    pi(q) of an injective map of the queries into the keys, a different
    one for each (batch, head), -inf elsewhere), v = e_0 (each key's value
    the first unit vector) and a zero output (the folded delta 0), so p is
    1 at (q, pi(q)) and 0 elsewhere, dp = do[q, 0] and ds = p dp: dv is do
    scattered to the keys pi(q), dk the keys pi(q)'s do[q, 0] q[q] scale
    and dq do[q, 0] k[pi(q)] scale, each exact in fp32 (a product of two
    operands of 8 or 11 bits, times a power of two) and so bit for bit."""
    b, h, scale = 2, 3, 0.125
    q, k, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                            dtype=dtype) for s in (sq, sk, sq))
    v = torch.zeros(b, h, sk, d, device="cuda", dtype=dtype)
    v[..., 0] = 1
    pi = torch.stack([torch.randperm(sk, generator=gen, device="cuda")[:sq]
                      for _ in range(b * h)]).view(b, h, sq)
    bias = torch.full((b, h, sq, sk), float("-inf"), device="cuda")
    bias.scatter_(3, pi[..., None], 0.0)
    _, lse = fa.flash_attention_fwd(q, k, v, scale=scale, bias=bias)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, None, None, False, scale,
            fa._mixed_rounds(q, k, do))
    bop = fa._bias_operand(bias, b, h, sq, sk, q.device, scale)
    dq = fa._flash_dq_cuda(*args, out=torch.zeros_like(q), bias=bop)
    dk, dv = fa._flash_dkdv_cuda(*args, bias=bop)
    idx = pi[..., None].expand(b, h, sq, d)
    d0 = do[..., :1].float()
    want_dv = torch.zeros_like(v).scatter_(2, idx, do)
    want_dk = torch.zeros_like(k).scatter_(2, idx, (d0 * q.float() * scale)
                                           .to(dtype))
    want_dq = (d0 * k.float().gather(2, idx) * scale).to(dtype)
    torch.cuda.synchronize()
    what = f"flash split bias positions {str(dtype)[6:]} d{d} sq{sq} sk{sk}"
    check(delta.abs().max().item() == 0.0, f"{what}: the delta of out = 0")
    check(torch.equal(dv, want_dv), f"{what}: dv is not do scattered to "
          "pi(q) bit for bit")
    check(torch.equal(dk, want_dk), f"{what}: dk is not do[q, 0] q scale "
          "at pi(q) bit for bit")
    check(torch.equal(dq, want_dq), f"{what}: dq is not do[q, 0] k[pi(q)] "
          "scale bit for bit")
    return f"b{b} h{h} sq{sq} sk{sk} d{d} {str(dtype)[6:]}, [b, h, sq, sk] " \
           "one-hot rows: dq, dk, dv bitwise"


# the shapes the split's bias variants are timed at: the d 64 grad check's
# (b8 h16 s1024, the future mask and key padding of 768-1024 tokens) and
# the train-mha16 path's attention (b1 h8 s3072 d128, the future mask)
SPLIT_BIAS_SHAPES = ((8, 16, 1024, 64, 768), (MHA16_B, MHA16_HEADS,
                                             MHA16_S, MHA_E // MHA16_HEADS,
                                             None))


def _split_bias_timed(torch, fa, F, timer, gen, b, h, s, d, min_len):
    """The split's bias variants at one :data:`SPLIT_BIAS_SHAPES` shape,
    each timed with and without the bias (its twin, the same kernel with
    a null bias), the pair as called, their plain versions and SDPA's
    backward with the same mask; with their bounds (the live pairs this
    run's data needs: a finite bias and a real key; the bias's bytes read
    once). Also B1's bias variant beside SDPA's forward."""
    scale = d ** -0.5
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    bias = future_mask(torch, s)[None, None]
    sid_q = sid_kv = None
    if min_len is not None:
        lens = torch.from_numpy(np.random.RandomState(4).randint(
            min_len, s + 1, b)).cuda()
        sid_kv = torch.where(torch.arange(s, device="cuda")[None]
                             < lens[:, None], 0, -1).to(torch.int32)
        sid_q = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        pad = torch.where(sid_kv < 0, float("-inf"), 0.0)[:, None, None]
    else:
        sid_kv = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        pad = 0.0
    check(fa.uses_split_backward(s, s, d, bias=True),
          f"the gate at s{s} d{d} with a bias")
    seg = (sid_q, sid_kv) if min_len is not None else (None, None)
    out, lse = fa.flash_attention_fwd(q, k, v, *seg, False, scale, bias=bias)
    g = fa.flash_attention_bwd
    n0 = (g.launches, g.bias_dkdv_launches, g.bias_dq_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, *seg, False, scale,
                                 bias=bias)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, *seg, False, scale,
                                   bias=bias)
    torch.cuda.synchronize()
    moved = tuple(a - b_ for a, b_ in zip(
        (g.launches, g.bias_dkdv_launches, g.bias_dq_launches), n0))
    what = f"flash split bias b{b} h{h} s{s} d{d}"
    check(moved == (0, 2, 2), f"{what}: launches (single pass, bias dk/dv, "
          f"bias dq) {moved}, expected the split's bias variants twice")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"{what}: a rerun gave other bits")
    del again
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, segment_ids_q=seg[0], segment_ids_kv=seg[1],
        scale=scale, bias=bias)
    pair_errs = {n: grad_err(gr, r, f"{what} {n}")
                 for n, gr, r in zip(("dq", "dk", "dv"), got, ref)}
    del got, ref
    torch.cuda.empty_cache()

    delta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, *seg, False, scale,
            fa._mixed_rounds(q, k, do))
    bop = fa._bias_operand(bias, b, h, s, s, q.device, scale)
    dq = fa._flash_dq_cuda(*args, out=out, bias=bop)
    dk, dv = fa._flash_dkdv_cuda(*args, bias=bop)
    kw = dict(segment_ids_q=seg[0], segment_ids_kv=seg[1], scale=scale,
              bias=bias)
    rdq, _ = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    dq_err = grad_err(dq, rdq, f"{what} dq kernel")
    del dq, rdq
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw)
    dkdv_err = max(grad_err(dk, rdk, f"{what} dk kernel"),
                   grad_err(dv, rdv, f"{what} dv kernel"))
    del dk, dv, rdk, rdv
    torch.cuda.empty_cache()

    mask = (bias + pad).to(torch.bfloat16)
    pairs = _bias_live_pairs(torch, bias, sid_kv, h)
    sd2, side = b * h * s * d * 2, b * h * s * 4
    bias_bytes = bias.numel() * 4 + (0 if min_len is None else 2 * b * s * 4)
    # dq: q, k, v, do, out read (the delta fold), dq and delta written, lse
    # read; dk/dv: q, k, v, do read, dk and dv written, lse and delta read
    dq_bound = bound(3 * 2.0 * d * pairs, 6 * sd2 + 2 * side + bias_bytes)
    dkdv_bound = bound(4 * 2.0 * d * pairs, 6 * sd2 + 2 * side + bias_bytes)
    f_bound = bound(4.0 * d * pairs, 4 * sd2 + side + bias_bytes)
    row = dict(
        shape=f"b{b} h{h} s{s} d{d} bf16, bias [1, 1, {s}, {s}] fp32 (future "
              "mask)" + ("" if min_len is None else
                         f", key padding {min_len}-{s}"),
        live_pairs=pairs, pair_max_abs_err=pair_errs,
        dq_max_abs_err=dq_err, dkdv_max_abs_err=dkdv_err,
        dq_ms=timer(lambda: fa._flash_dq_cuda(*args, out=out, bias=bop),
                    iters=10),
        dq_no_bias_ms=timer(lambda: fa._flash_dq_cuda(*args, out=out),
                            iters=10),
        dkdv_ms=timer(lambda: fa._flash_dkdv_cuda(*args, bias=bop),
                      iters=10),
        dkdv_no_bias_ms=timer(lambda: fa._flash_dkdv_cuda(*args), iters=10),
        as_called_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, *seg, False, scale, bias=bias), iters=10),
        dq_plain_ms=timer(lambda: fa.flash_bwd_dq_reference(
            q, k, v, out, lse, do, **kw), iters=3, warmup=1),
        dkdv_plain_ms=timer(lambda: fa.flash_bwd_dkdv_reference(
            q, k, v, lse, delta, do, **kw), iters=3, warmup=1),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, attn_mask=mask,
                                           scale=scale)), (q, k, v), do),
            iters=10),
        dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
        dkdv_bound_ms=dkdv_bound[0], dkdv_bound_by=dkdv_bound[1],
        fwd_bias_ms=timer(lambda: fa.flash_attention_fwd(
            q, k, v, *seg, False, scale, bias=bias), iters=10),
        fwd_library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), iters=10),
        fwd_bound_ms=f_bound[0], fwd_bound_by=f_bound[1])
    del q, k, v, do, out, lse, delta, args, bop, mask
    torch.cuda.empty_cache()
    return row


def check_flash_split_bias(torch, timer):
    """B3's and B4's bias variants (``flash_dkdv_sm90<..., BIAS>``,
    ``flash_dq_sm90<..., BIAS>``: the tile's bias / scale loaded into the
    S accumulators, which the S product adds to) at :func:`_bias_cases`'
    shapes (bf16 and fp16, head dims 64 and 128, the four broadcast
    shapes, sq != sk, odd sk, segment padding, a row -inf everywhere;
    unmasked tiles with -inf entries beside masked ones), each kernel
    against its plain version with the same bias at the bf16 backwards'
    limits; the positions bitwise (:func:`_split_bias_positions`); the
    rows at the -1e30 fill (:func:`_fill_rows_cases`, the split); then at
    :data:`SPLIT_BIAS_SHAPES` the pair as routed against the plain
    backward, a bitwise rerun, each kernel against its plain version, and
    the times (:func:`_split_bias_timed`). The rows' numbers are the
    train-mha16 path's shape (the last)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(20)
    checked = [_split_bias_case(torch, fa, gen, c) for c in _bias_cases(torch)]
    positions = [_split_bias_positions(torch, fa, gen, torch.bfloat16, 64,
                                       256, 321),
                 _split_bias_positions(torch, fa, gen, torch.float16, 128,
                                       300, 512)]
    fill = _fill_rows_cases(torch, fa, gen, (torch.bfloat16, torch.float16),
                            (True,), 0.0)
    torch.cuda.empty_cache()
    by_shape = [_split_bias_timed(torch, fa, F, timer, gen, *shape)
                for shape in SPLIT_BIAS_SHAPES]
    main = by_shape[-1]
    common = dict(
        route="cuda", source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
        shape=main["shape"],
        tolerance="2 bf16 ulp + 2% of max, 1% relative norm, of the plain "
                  "versions with the same bias; the folded delta 1e-5 of "
                  "max; a rerun bitwise; the positions bitwise",
        library_ms=main["library_ms"],
        library="backward of F.scaled_dot_product_attention(attn_mask=the "
                "bias and the padding as one bf16 mask): dq, dk and dv "
                "together",
        as_called_ms=main["as_called_ms"], live_pairs=main["live_pairs"],
        pair_max_abs_err=main["pair_max_abs_err"], positions=positions,
        checked=[dict(case=w, grad_max_abs_err=e) for w, e in checked],
        fill_rows=fill, by_shape=by_shape)
    return [
        dict(name="flash_bwd_dkdv_sm90_bias",
             replaces="apex_tpu/ops/flash_attention.py:558",
             max_abs_err=main["dkdv_max_abs_err"], ms=main["dkdv_ms"],
             no_bias_ms=main["dkdv_no_bias_ms"],
             plain_ms=main["dkdv_plain_ms"], plain="flash_bwd_dkdv_reference",
             bound_ms=main["dkdv_bound_ms"], bound_by=main["dkdv_bound_by"],
             **common),
        dict(name="flash_bwd_dq_sm90_bias",
             replaces="apex_tpu/ops/flash_attention.py:671",
             max_abs_err=main["dq_max_abs_err"], ms=main["dq_ms"],
             no_bias_ms=main["dq_no_bias_ms"], plain_ms=main["dq_plain_ms"],
             plain="flash_bwd_dq_reference", bound_ms=main["dq_bound_ms"],
             bound_by=main["dq_bound_by"], **common),
    ]


# ---------------------------------------------------------------------------
# the bias with dropout (B1's, B3's and B4's variants with both), at the
# train-mha16 path's attention with dropout 0.1 (b1 h8 s3072 d128, the
# future mask) and at train-mha18's with dropout 0.1 (b16 h16 s512 d64, the
# future mask and key padding), both of which the gate splits
# ---------------------------------------------------------------------------

BIAS_DROPOUT_SEED = 20261021
BIAS_DROPOUT_SHAPES = ((MHA_B, MHA_HEADS, MHA_S, MHA_E // MHA_HEADS,
                        MHA_MIN_LEN),
                       (MHA16_B, MHA16_HEADS, MHA16_S, MHA_E // MHA16_HEADS,
                        None))


def _bias_dropout_case(torch, fa, gen, case):
    """One :func:`_bias_cases` shape with dropout 0.1: the forward at both
    block heights, the split (forced: dq with the delta it folds in from
    the dropped output, then dk/dv from that delta) and the single pass
    (forced) against their plain versions with the same bias and seed (the
    bf16 limits; the delta 1e-5), each bitwise on a rerun (the single
    pass's dq through its ordered turns), a dead row's output and dq
    exactly 0; returns the largest forward, split and single-pass gradient
    errors."""
    _, _, _, b, h, sq, sk, causal, _, dead = case
    q, k, v, do, bias, sid_q, sid_kv, scale, what = _bias_case_inputs(
        torch, gen, case, "flash bias dropout")
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=BIAS_DROPOUT_SEED)
    kw = dict(causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
              scale=scale, bias=bias, **drop)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    err = 0.0
    for rows in (64, 128):
        out, lse = fa._flash_fwd_cuda(q, k, v, sid_q, sid_kv, causal, scale,
                                      block_rows=rows, bias=bias, **drop)
        again = fa._flash_fwd_cuda(q, k, v, sid_q, sid_kv, causal, scale,
                                   block_rows=rows, bias=bias, **drop)
        torch.cuda.synchronize()
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
              f"{what} rows{rows}: a rerun gave other bits")
        err = max(err, bf16_err(out, ref, 4e-3, f"{what} rows{rows}"))
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= 1e-3, f"{what} rows{rows}: lse max err {lse_err}")
        if dead is not None:
            check(out[:, :, dead].abs().max().item() == 0.0
                  and bool((lse[:, :, dead] == -1e30).all()),
                  f"{what}: the row with no live key is not zero, -1e30")
    del ref, ref_lse, again
    delta = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale,
            fa._mixed_rounds(q, k, do))
    bop = fa._bias_operand(bias, b, h, sq, sk, q.device, scale)
    dargs = fa._dropout_args(DROPOUT_RATE, BIAS_DROPOUT_SEED)
    dq = fa._flash_dq_cuda(*args, out=out, dropout=dargs, bias=bop)
    dk, dv = fa._flash_dkdv_cuda(*args, dropout=dargs, bias=bop)
    dq2 = fa._flash_dq_cuda(*args, out=out, dropout=dargs, bias=bop)
    dk2, dv2 = fa._flash_dkdv_cuda(*args, dropout=dargs, bias=bop)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in
              zip((dq, dk, dv), (dq2, dk2, dv2))),
          f"{what}: the split's rerun gave other bits")
    rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    _fp32_err(delta, rdelta, f"{what} delta fold", 1e-5)
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw)
    check(all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv)),
          f"{what}: a non-finite gradient")
    gerr = max(grad_err(g, r, f"{what} {n}") for n, g, r in
               zip(("dq", "dk", "dv"), (dq, dk, dv), (rdq, rdk, rdv)))
    del rdq, rdk, rdv
    fused = [fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv,
                                causal, scale, split=False, bias=bias,
                                **drop) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(*fused)),
          f"{what}: the single pass's rerun gave other bits")
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    serr = max(grad_err(g, r, f"{what} single pass {n}") for n, g, r in
               zip(("dq", "dk", "dv"), fused[0], ref))
    if dead is not None:
        check(dq[:, :, dead].abs().max().item() == 0.0
              and fused[0][0][:, :, dead].abs().max().item() == 0.0,
              f"{what}: the row with no live key got a nonzero dq")
    return what, err, gerr, serr


def _bias_dropout_bitwise(torch, fa, gen, dtype, d, seed):
    """At rate 0.5 (1 / (1 - rate) = 2, exact), the keep pattern and the
    positions bit for bit. Keep pattern, under a bias in [-1, 1)
    everywhere (p > 0): the forward with q = k = 0 and v = I over sk = d
    keys is zero exactly where an element is dropped; the split's dk/dv
    with q = 0 and do = I over sq = d rows gives dv = the dropped p
    transposed; its dq with k = I over sk = d keys and a zero output (the
    folded delta 0) is zero exactly where a key is dropped. Positions,
    through one-hot bias rows (0 at key pi(q) of an injective map into sk
    > sq keys, -inf elsewhere), v = e_0 and a zero output: p is 1 at (q,
    pi(q)), so out is 2 v[pi(q)] where kept, dv 2 do[q] at pi(q), dk 2
    do[q, 0] q scale there and dq 2 do[q, 0] k[pi(q)] scale, each 0 where
    dropped: exact products."""
    b, h, s = 2, 3, 333
    half = fa._dropout_args(0.5, seed)
    eye = torch.eye(d, device="cuda", dtype=dtype).expand(b, h, d, d)
    eye = eye.contiguous()
    rounds = fa._mixed_rounds(eye, eye, eye)
    what = f"flash bias dropout bitwise {str(dtype)[6:]} d{d}"

    def unit(*shape):
        return 2 * torch.rand(*shape, generator=gen, device="cuda") - 1

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    zq = torch.zeros(b, h, s, d, device="cuda", dtype=dtype)
    zk = torch.zeros(b, h, d, d, device="cuda", dtype=dtype)
    out, _ = fa.flash_attention_fwd(zq, zk, eye, None, None, False, 1.0, 0.5,
                                    seed, bias=unit(1, h, s, d))
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    check(torch.equal(out != 0, keep),
          f"{what}: the forward's keep pattern is not the plain mask")
    n_fwd = keep.numel()
    k, v = rand(b, h, s, d), rand(b, h, s, d)
    bias = unit(b, 1, d, s)
    _, lse = fa.flash_attention_fwd(zk, k, v, None, None, False, 1.0,
                                    bias=bias)
    zero = torch.zeros(b, h, d, dtype=torch.float32, device="cuda")
    _, dv = fa._flash_dkdv_cuda(zk, k, v, eye, lse, zero, None, None, False,
                                1.0, rounds, dropout=half,
                                bias=fa._bias_operand(bias, b, h, d, s,
                                                      k.device, 1.0))
    keep = fa.dropout_keep_reference(seed, b, h, d, s, 0.5, device="cuda")
    check(torch.equal(dv != 0, keep.transpose(-1, -2)),
          f"{what}: the dk/dv kernel's keep pattern is not the plain mask")
    q, v, do = rand(b, h, s, d), rand(b, h, d, d), rand(b, h, s, d)
    bias = unit(1, 1, s, d)
    _, lse = fa.flash_attention_fwd(q, eye, v, None, None, False, 1.0,
                                    bias=bias)
    delta = torch.empty(b, h, s, dtype=torch.float32, device="cuda")
    dq = fa._flash_dq_cuda(q, eye, v, do, lse, delta, None, None, False,
                           1.0, rounds, out=torch.zeros_like(q),
                           dropout=half, bias=fa._bias_operand(
                               bias, b, h, s, d, q.device, 1.0))
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    check(delta.abs().max().item() == 0.0 and torch.equal(dq != 0, keep),
          f"{what}: the dq kernel's keep pattern is not the plain mask")

    sq, sk, scale = 300, 513, 0.125
    q, do, k = rand(b, h, sq, d), rand(b, h, sq, d), rand(b, h, sk, d)
    v = torch.zeros(b, h, sk, d, device="cuda", dtype=dtype)
    v[..., 0] = 1
    pi = torch.stack([torch.randperm(sk, generator=gen, device="cuda")[:sq]
                      for _ in range(b * h)]).view(b, h, sq)
    bias = torch.full((b, h, sq, sk), float("-inf"), device="cuda")
    bias.scatter_(3, pi[..., None], 0.0)
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, False, scale, 0.5,
                                      seed, bias=bias)
    kept = fa.dropout_keep_reference(seed, b, h, sq, sk, 0.5,
                                     device="cuda").gather(3, pi[..., None])
    idx = pi[..., None].expand(b, h, sq, d)
    two = torch.where(kept, 2.0, 0.0)
    check(torch.equal(out, (two * v.float().gather(2, idx)).to(dtype)),
          f"{what}: out is not 2 v[pi(q)] where kept, bit for bit")
    delta = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, None, None, False, scale, rounds)
    bop = fa._bias_operand(bias, b, h, sq, sk, q.device, scale)
    dq = fa._flash_dq_cuda(*args, out=torch.zeros_like(q), dropout=half,
                           bias=bop)
    dk, dv = fa._flash_dkdv_cuda(*args, dropout=half, bias=bop)
    d0 = two * do[..., :1].float()
    torch.cuda.synchronize()
    check(torch.equal(dv, torch.zeros_like(v).scatter_(
        2, idx, (two * do.float()).to(dtype))),
          f"{what}: dv is not 2 do at pi(q) where kept, bit for bit")
    check(torch.equal(dk, torch.zeros_like(k).scatter_(
        2, idx, (d0 * q.float() * scale).to(dtype))),
          f"{what}: dk is not 2 do[q, 0] q scale at pi(q), bit for bit")
    check(torch.equal(dq, (d0 * k.float().gather(2, idx) * scale)
                      .to(dtype)),
          f"{what}: dq is not 2 do[q, 0] k[pi(q)] scale, bit for bit")
    return dict(case=what, rate=0.5, keep_elements=n_fwd + 2 * keep.numel(),
                kept_positions=int(kept.sum()),
                positions=f"b{b} h{h} sq{sq} sk{sk} one-hot rows",
                bitwise=True)


def _bias_dropout_timed(torch, fa, F, timer, gen, b, h, s, d, min_len):
    """The variants with both at one :data:`BIAS_DROPOUT_SHAPES` shape
    (the future mask as a [1, 1, s, s] fp32 bias, key padding where
    ``min_len``, dropout 0.1): the forward and the pair as routed against
    the plain versions with the same bias and seed, each split kernel
    against its plain version, a bitwise rerun; each kernel timed beside
    its twins (the same kernel with the bias alone and with dropout alone)
    and its plain version, the pair as called, SDPA with the mask as
    ``attn_mask`` and ``dropout_p=0.1`` forward and backward; with the
    bounds (the live pairs this run's data needs: a finite bias and a real
    key; the bias read once; the hash's integer operations on each live
    pair)."""
    scale = d ** -0.5
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=BIAS_DROPOUT_SEED)
    dargs = fa._dropout_args(DROPOUT_RATE, BIAS_DROPOUT_SEED)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    bias = future_mask(torch, s)[None, None]
    if min_len is not None:
        lens = torch.from_numpy(mha_lengths()).cuda()
        sid_kv = torch.where(torch.arange(s, device="cuda")[None]
                             < lens[:, None], 0, -1).to(torch.int32)
        sid_q = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        seg = (sid_q, sid_kv)
        pad = torch.where(sid_kv < 0, float("-inf"), 0.0)[:, None, None]
    else:
        sid_kv = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        seg, pad = (None, None), 0.0
    what = f"flash bias dropout b{b} h{h} s{s} d{d}"
    check(fa.uses_split_backward(s, s, d, bias=True, dropout=True),
          f"the gate at s{s} d{d} with a bias and dropout")
    f, g = fa.flash_attention, fa.flash_attention_bwd

    def counts():
        return (f.bias_dropout_launches, g.bias_dropout_dkdv_launches,
                g.bias_dropout_dq_launches, f.bias_launches,
                f.dropout_launches, g.bias_dkdv_launches,
                g.dropout_dkdv_launches, g.launches)

    n0 = counts()
    out, lse = fa.flash_attention_fwd(q, k, v, *seg, False, scale, bias=bias,
                                      **drop)
    again = fa.flash_attention_fwd(q, k, v, *seg, False, scale, bias=bias,
                                   **drop)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, *seg, False, scale,
                                 bias=bias, **drop)
    grads2 = fa.flash_attention_bwd(q, k, v, out, lse, do, *seg, False,
                                    scale, bias=bias, **drop)
    torch.cuda.synchronize()
    moved = tuple(a - b_ for a, b_ in zip(counts(), n0))
    check(moved == (2, 2, 2, 0, 0, 0, 0, 0), f"{what}: launches (both: "
          f"forward, dk/dv, dq; bias forward, dropout forward, bias dk/dv, "
          f"dropout dk/dv, single pass) {moved}")
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1])
          and all(torch.equal(x, y) for x, y in zip(got, grads2)),
          f"{what}: a rerun gave other bits")
    del again, grads2
    kw = dict(segment_ids_q=seg[0], segment_ids_kv=seg[1], scale=scale,
              bias=bias, **drop)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    fwd_err = bf16_err(out, ref, 4e-3, f"{what} forward")
    lse_err = (lse - ref_lse).abs().max().item()
    check(lse_err <= 1e-3, f"{what}: lse max err {lse_err}")
    del ref, ref_lse
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    pair_errs = {n: grad_err(gr, r, f"{what} {n}")
                 for n, gr, r in zip(("dq", "dk", "dv"), got, ref)}
    del got, ref
    torch.cuda.empty_cache()

    delta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, *seg, False, scale,
            fa._mixed_rounds(q, k, do))
    bop = fa._bias_operand(bias, b, h, s, s, q.device, scale)
    dq = fa._flash_dq_cuda(*args, out=out, dropout=dargs, bias=bop)
    dk, dv = fa._flash_dkdv_cuda(*args, dropout=dargs, bias=bop)
    rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    delta_err = _fp32_err(delta, rdelta, f"{what} delta fold", 1e-5)
    dq_err = grad_err(dq, rdq, f"{what} dq kernel")
    del dq, rdq, rdelta
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw)
    dkdv_err = max(grad_err(dk, rdk, f"{what} dk kernel"),
                   grad_err(dv, rdv, f"{what} dv kernel"))
    del dk, dv, rdk, rdv
    torch.cuda.empty_cache()

    mask = (bias + pad).to(torch.bfloat16)
    pairs = _bias_live_pairs(torch, bias, sid_kv, h)
    sd2, side = b * h * s * d * 2, b * h * s * 4
    bias_bytes = bias.numel() * 4 + (0 if min_len is None else 2 * b * s * 4)
    f_bound = _with_hash(*bound(4.0 * d * pairs,
                                4 * sd2 + side + bias_bytes), pairs)
    dq_bound = _with_hash(*bound(3 * 2.0 * d * pairs,
                                 6 * sd2 + 2 * side + bias_bytes), pairs)
    dkdv_bound = _with_hash(*bound(4 * 2.0 * d * pairs,
                                   6 * sd2 + 2 * side + bias_bytes), pairs)
    fwd = fa.flash_attention_fwd
    row = dict(
        shape=f"b{b} h{h} s{s} d{d} bf16, bias [1, 1, {s}, {s}] fp32 (future "
              f"mask), dropout {DROPOUT_RATE}" + (
                  "" if min_len is None else f", key padding {min_len}-{s}"),
        live_pairs=pairs, fwd_max_abs_err=fwd_err, lse_max_abs_err=lse_err,
        pair_max_abs_err=pair_errs, delta_fold_max_abs_err=delta_err,
        dq_max_abs_err=dq_err, dkdv_max_abs_err=dkdv_err,
        fwd_ms=timer(lambda: fwd(q, k, v, *seg, False, scale, bias=bias,
                                 **drop), iters=10),
        fwd_bias_only_ms=timer(lambda: fwd(q, k, v, *seg, False, scale,
                                           bias=bias), iters=10),
        fwd_dropout_only_ms=timer(lambda: fwd(q, k, v, *seg, False, scale,
                                              **drop), iters=10),
        fwd_plain_ms=timer(lambda: fa.flash_attention_reference(
            q, k, v, **kw), iters=3, warmup=1),
        fwd_library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, dropout_p=DROPOUT_RATE),
            iters=10),
        dq_ms=timer(lambda: fa._flash_dq_cuda(*args, out=out, dropout=dargs,
                                              bias=bop), iters=10),
        dq_bias_only_ms=timer(lambda: fa._flash_dq_cuda(*args, out=out,
                                                        bias=bop), iters=10),
        dq_dropout_only_ms=timer(lambda: fa._flash_dq_cuda(
            *args, out=out, dropout=dargs), iters=10),
        dq_plain_ms=timer(lambda: fa.flash_bwd_dq_reference(
            q, k, v, out, lse, do, **kw), iters=3, warmup=1),
        dkdv_ms=timer(lambda: fa._flash_dkdv_cuda(*args, dropout=dargs,
                                                  bias=bop), iters=10),
        dkdv_bias_only_ms=timer(lambda: fa._flash_dkdv_cuda(*args, bias=bop),
                                iters=10),
        dkdv_dropout_only_ms=timer(lambda: fa._flash_dkdv_cuda(
            *args, dropout=dargs), iters=10),
        dkdv_plain_ms=timer(lambda: fa.flash_bwd_dkdv_reference(
            q, k, v, lse, delta, do, **kw), iters=3, warmup=1),
        as_called_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, *seg, False, scale, bias=bias, **drop),
            iters=10),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, attn_mask=mask,
                                           scale=scale,
                                           dropout_p=DROPOUT_RATE)),
            (q, k, v), do), iters=10),
        fwd_bound_ms=f_bound[0], fwd_bound_by=f_bound[1],
        dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
        dkdv_bound_ms=dkdv_bound[0], dkdv_bound_by=dkdv_bound[1])
    del q, k, v, do, out, lse, delta, args, bop, mask
    torch.cuda.empty_cache()
    return row


def _single_pass_bias_dropout_timed(torch, fa, F, timer, gen):
    """B2's variant with both at the train-mha6 path's attention (b28 h16
    s128 d64 bf16, the future mask as a [1, 1, 128, 128] fp32 bias, key
    padding of 96-128 tokens as segment ids, dropout 0.1): the pair as
    routed (the forward, then the single pass, which the gate keeps)
    against the plain backward with the same bias and seed, bitwise on a
    rerun, the counter of the single pass with both alone moving; the
    single pass timed alone and as called beside its twins (the same
    kernel with the bias alone and with dropout alone), its plain version
    and SDPA's backward with the mask as ``attn_mask`` and
    ``dropout_p=0.1``; its bound counts the live pairs this data needs (a
    finite bias and a real key; the bias read once) and the hash's
    integer operations on each."""
    b, h, s, d = MHA6_B, MHA_HEADS, MHA6_S, MHA_E // MHA_HEADS
    scale = d ** -0.5
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=BIAS_DROPOUT_SEED)
    dargs = fa._dropout_args(DROPOUT_RATE, BIAS_DROPOUT_SEED)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    bias = future_mask(torch, s)[None, None]
    lens = torch.from_numpy(mha6_lengths()).cuda()
    sid_kv = torch.where(torch.arange(s, device="cuda")[None]
                         < lens[:, None], 0, -1).to(torch.int32)
    sid_q = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    seg = (sid_q, sid_kv)
    what = f"flash single pass bias dropout b{b} h{h} s{s} d{d}"
    check(not fa.uses_split_backward(s, s, d, bias=True, dropout=True),
          f"{what}: the gate splits")
    g = fa.flash_attention_bwd

    def counts():
        return (g.bias_dropout_fused_launches, g.bias_launches,
                g.dropout_launches, g.bias_dropout_dkdv_launches,
                g.bias_dropout_dq_launches)

    out, lse = fa.flash_attention_fwd(q, k, v, *seg, False, scale, bias=bias,
                                      **drop)
    n0 = counts()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, *seg, False, scale,
                                 bias=bias, **drop)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, *seg, False,
                                   scale, bias=bias, **drop)
    torch.cuda.synchronize()
    moved = tuple(a - b_ for a, b_ in zip(counts(), n0))
    check(moved == (2, 0, 0, 0, 0), f"{what}: launches (single pass with "
          f"both, with the bias, with dropout; split with both) {moved}")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"{what}: a rerun gave other bits")
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
        scale=scale, bias=bias, **drop)
    errs = {n: grad_err(gr, r, f"{what} {n}")
            for n, gr, r in zip(("dq", "dk", "dv"), got, ref)}
    del got, again, ref

    delta = (do.float() * out.float()).sum(dim=-1)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    bop = fa._bias_operand(bias, b, h, s, s, q.device, scale)

    def alone(dropout, bias_op):
        return lambda: fa._flash_bwd_fused_cuda(
            q, k, v, do, lse, delta, *seg, False, scale, dq_acc, None,
            dropout, bias_op)

    mask = (bias + torch.where(sid_kv < 0, float("-inf"), 0.0)[:, None, None]
            ).to(torch.bfloat16)
    pairs = _bias_live_pairs(torch, bias, sid_kv, h)
    bias_bytes = bias.numel() * 4 + 2 * b * s * 4          # and the ids
    b_bound = _with_hash(*bound(10.0 * d * pairs,
                                8 * b * h * s * d * 2 + 2 * b * h * s * 4
                                + bias_bytes), pairs)
    row = dict(
        shape=f"b{b} h{h} s{s} d{d} bf16, bias [1, 1, {s}, {s}] fp32 (future "
              f"mask), key padding {MHA6_MIN_LEN}-{s}, dropout "
              f"{DROPOUT_RATE}", live_pairs=pairs, pair_max_abs_err=errs,
        max_abs_err=max(errs.values()),
        ms=timer(alone(dargs, bop)),
        bias_only_ms=timer(alone((0, 0, 1.0), bop)),
        dropout_only_ms=timer(alone(dargs, (None, 0, 0))),
        as_called_ms=timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, *seg, False, scale, bias=bias, **drop)),
        plain_ms=timer(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, segment_ids_q=sid_q,
            segment_ids_kv=sid_kv, scale=scale, bias=bias, **drop),
            iters=5),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, attn_mask=mask,
                                           scale=scale,
                                           dropout_p=DROPOUT_RATE)),
            (q, k, v), do)),
        bound_ms=b_bound[0], bound_by=b_bound[1])
    del q, k, v, do, out, lse, delta, dq_acc, bop, mask
    torch.cuda.empty_cache()
    return row


def check_flash_bias_dropout(torch, timer):
    """The variants with both of B1, B3, B4 and B2 (``flash_fwd_sm90<...,
    DROP, BIAS>``, ``flash_dkdv_sm90<..., DROP, BIAS>``,
    ``flash_dq_sm90<..., DROP, BIAS>``, ``flash_bwd_fused_sm90<..., DROP,
    BIAS>``) at :func:`_bias_cases`' shapes with dropout 0.1 (bf16 and
    fp16, head dims 64 and 128, the four broadcast shapes, sq != sk, odd
    sk, segment padding, a row -inf everywhere) against their plain
    versions with the same bias and seed (:func:`_bias_dropout_case`); the
    keep pattern and the positions bitwise (:func:`_bias_dropout_bitwise`);
    the rows at the -1e30 fill (:func:`_fill_rows_cases`, the single pass
    and the split); then at :data:`BIAS_DROPOUT_SHAPES` the checks and the
    times of the forward and the split (:func:`_bias_dropout_timed`; the
    rows' numbers are the train-mha16-bias-dropout path's shape, the last),
    and at the train-mha6 path's shape those of the single pass
    (:func:`_single_pass_bias_dropout_timed`)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(21)
    checked = [_bias_dropout_case(torch, fa, gen, c)
               for c in _bias_cases(torch)]
    bitwise = [_bias_dropout_bitwise(torch, fa, gen, torch.bfloat16, 64, 5),
               _bias_dropout_bitwise(torch, fa, gen, torch.float16, 128, -3)]
    fill = _fill_rows_cases(torch, fa, gen, (torch.bfloat16, torch.float16),
                            (False, True), DROPOUT_RATE)
    torch.cuda.empty_cache()
    by_shape = [_bias_dropout_timed(torch, fa, F, timer, gen, *shape)
                for shape in BIAS_DROPOUT_SHAPES]
    single = _single_pass_bias_dropout_timed(torch, fa, F, timer, gen)
    main = by_shape[-1]
    common = dict(
        route="cuda", shape=main["shape"], live_pairs=main["live_pairs"],
        bitwise=bitwise, by_shape=by_shape, fill_rows=fill,
        checked=[dict(case=w, max_abs_err=e, grad_max_abs_err=ge,
                      single_pass_grad_max_abs_err=se)
                 for w, e, ge, se in checked])
    bwd = dict(
        source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
        tolerance="2 bf16 ulp + 2% of max, 1% relative norm, of the plain "
                  "versions with the same bias and seed; the folded delta "
                  "1e-5 of max; a rerun bitwise; the keep pattern and the "
                  "positions bitwise",
        library_ms=main["library_ms"],
        library="backward of F.scaled_dot_product_attention(attn_mask=the "
                f"bias as a bf16 mask, dropout_p={DROPOUT_RATE}): dq, dk and "
                "dv together, its own random stream",
        as_called_ms=main["as_called_ms"],
        pair_max_abs_err=main["pair_max_abs_err"],
        delta_fold_max_abs_err=main["delta_fold_max_abs_err"], **common)
    return [
        dict(name="flash_fwd_sm90_bias_dropout",
             source="apex_tpu_torch/csrc/flash_fwd_sm90.cu",
             replaces="apex_tpu/ops/flash_attention.py:251",
             max_abs_err=main["fwd_max_abs_err"],
             lse_max_abs_err=main["lse_max_abs_err"],
             tolerance="2 bf16 ulp + 4e-3 of the plain forward with the same "
                       "bias and seed; lse 1e-3; a rerun bitwise; the keep "
                       "pattern and the positions bitwise",
             ms=main["fwd_ms"], bias_only_ms=main["fwd_bias_only_ms"],
             dropout_only_ms=main["fwd_dropout_only_ms"],
             plain_ms=main["fwd_plain_ms"], library_ms=main["fwd_library_ms"],
             library="F.scaled_dot_product_attention(attn_mask=the bias as a "
                     f"bf16 mask, dropout_p={DROPOUT_RATE}): its own random "
                     "stream",
             bound_ms=main["fwd_bound_ms"], bound_by=main["fwd_bound_by"],
             **common),
        dict(name="flash_bwd_dkdv_sm90_bias_dropout",
             replaces="apex_tpu/ops/flash_attention.py:558",
             max_abs_err=main["dkdv_max_abs_err"], ms=main["dkdv_ms"],
             bias_only_ms=main["dkdv_bias_only_ms"],
             dropout_only_ms=main["dkdv_dropout_only_ms"],
             plain_ms=main["dkdv_plain_ms"], plain="flash_bwd_dkdv_reference",
             bound_ms=main["dkdv_bound_ms"], bound_by=main["dkdv_bound_by"],
             **bwd),
        dict(name="flash_bwd_dq_sm90_bias_dropout",
             replaces="apex_tpu/ops/flash_attention.py:671",
             max_abs_err=main["dq_max_abs_err"], ms=main["dq_ms"],
             bias_only_ms=main["dq_bias_only_ms"],
             dropout_only_ms=main["dq_dropout_only_ms"],
             plain_ms=main["dq_plain_ms"], plain="flash_bwd_dq_reference",
             bound_ms=main["dq_bound_ms"], bound_by=main["dq_bound_by"],
             **bwd),
        dict(single, name="flash_bwd_fused_sm90_bias_dropout", route="cuda",
             source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
             replaces="apex_tpu/ops/flash_attention.py:604",
             plain="flash_attention_bwd_reference with the same bias and "
                   "seed",
             library=bwd["library"], checked=common["checked"],
             tolerance="2 bf16 ulp + 2% of max, 1% relative norm, of the "
                       "plain backward with the same bias and seed; dq, dk, "
                       "dv bitwise on a rerun; a dead row's dq exactly 0"),
    ]


# the ResNet-50 head (n256 V1000 fp32, the bench's smoothing) and the GPT's
# vocabulary at its token count (n8192 V32768 bf16, smoothing 0.1 and 0)
XENT_SHAPES = ((256, 1000, "float32", (0.1,)),
               (8192, 32768, "bfloat16", (0.1, 0.0)))


def check_xentropy(torch, timer):
    """Both softmax cross-entropy kernels through the autograd function
    against the plain twin, with rows labelled ``padding_idx`` (0); the
    forward and the backward timed apart beside the twin's halves and
    ``F.cross_entropy`` with the same smoothing."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import fused_ce as xe
    gen = torch.Generator(device="cuda").manual_seed(12)
    fwd, bwd = [], []
    for n, V, dt, smoothings in XENT_SHAPES:
        dtype = getattr(torch, dt)
        x = (3 * torch.randn(n, V, generator=gen, device="cuda")).to(dtype)
        y = torch.randint(0, V, (n,), generator=gen, device="cuda")
        y[::16] = 0
        dl = torch.full((n,), 1.0 / n, device="cuda")
        f_err = b_err = 0.0
        for ls in smoothings:
            xa = x.clone().requires_grad_()
            xb = x.clone().requires_grad_()
            la = xe.softmax_cross_entropy_with_smoothing(xa, y, ls, 0)
            ga, = torch.autograd.grad(la, xa, dl)
            lb = xe.softmax_cross_entropy_reference(xb, y, ls, 0)
            gb, = torch.autograd.grad(lb, xb, dl)
            torch.cuda.synchronize()
            # fp32 losses: sums and exponentials in another order
            d = (la - lb).abs()
            check(bool((d <= 1e-5 * lb.abs() + 1e-6).all()),
                  f"xentropy loss n{n} V{V} ls{ls}: max err {d.max().item()}")
            check(not bool(la[::16].any()) and not bool(ga[::16].any()),
                  "xentropy: a padding row got a loss or a gradient")
            f_err = max(f_err, d.max().item())
            # gradients: one rounding of an fp32 value to the logits' dtype
            # on each side, p recomputed from (m, l) against exp(x - lse)
            ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
            d = (ga.float() - gb.float()).abs()
            floor = 1e-6 * gb.float().abs().max().item() + 1e-12
            check(bool((d <= gb.float().abs() * 2 * ulp + floor).all()),
                  f"xentropy grad n{n} V{V} ls{ls}: max err "
                  f"{d.max().item()}")
            b_err = max(b_err, d.max().item())
            del xa, xb, la, lb, ga, gb
        ls = smoothings[0]
        tgt = y.to(torch.int32)
        loss, m, l = xe._xent_fwd_cuda(x, tgt, ls)
        _, lse = xe._xent_fwd(x, y, ls, None)
        itm = x.element_size()
        f_ms = timer(lambda: xe._xent_fwd_cuda(x, tgt, ls))
        f_plain = timer(lambda: xe._xent_fwd(x, y, ls, None), iters=10)
        f_lib = timer(lambda: F.cross_entropy(x, y, label_smoothing=ls,
                                              reduction="none"))
        b_ms = timer(lambda: xe._xent_bwd_cuda(x, tgt, m, l, dl, ls))
        b_plain = timer(lambda: xe._xent_bwd(x, y, lse, dl, ls, None),
                        iters=10)
        b_lib = timer(_grad_of(torch, lambda a: F.cross_entropy(
            a, y, label_smoothing=ls, reduction="none").float(), (x,), dl))
        # ~10 fp32 operations and two exponentials an element forward, ~6
        # and one backward, on the CUDA cores
        fb = bound(12.0 * n * V, n * V * itm + n * 4 + 3 * n * 4,
                   FP32_FLOPS_PER_S)
        bb = bound(7.0 * n * V, 2 * n * V * itm + 4 * n * 4,
                   FP32_FLOPS_PER_S)
        shape = f"n{n} V{V} {dt} smoothing {ls}"
        fwd.append(dict(shape=shape, max_abs_err=f_err, ms=f_ms,
                        plain_ms=f_plain, library_ms=f_lib, bound_ms=fb[0],
                        bound_by=fb[1]))
        bwd.append(dict(shape=shape, max_abs_err=b_err, ms=b_ms,
                        plain_ms=b_plain, library_ms=b_lib, bound_ms=bb[0],
                        bound_by=bb[1]))
        del x, y, loss, m, l, lse
    common = dict(
        route="triton", source="apex_tpu_torch/ops/fused_ce.py",
        shape="n256 V1000 fp32 smoothing 0.1 (the ResNet-50 head; by_shape: "
              "n8192 V32768 bf16, smoothing 0.1 and 0 checked), rows "
              "labelled padding_idx 0")
    out = []
    for name, replaces, rows, tol, lib in (
            ("xentropy_fwd", "apex_tpu/ops/fused_ce.py:111", fwd,
             "fp32 loss 1e-5 relative + 1e-6",
             "F.cross_entropy(label_smoothing=s, reduction='none')"),
            ("xentropy_bwd", "apex_tpu/ops/fused_ce.py:139", bwd,
             "2 ulps of the logits' dtype + 1e-6 of max",
             "autograd backward of that F.cross_entropy")):
        main = rows[0]
        out.append(dict(name=name, replaces=replaces,
                        max_abs_err=max(r["max_abs_err"] for r in rows),
                        tolerance=tol, ms=main["ms"],
                        plain_ms=main["plain_ms"],
                        library_ms=main["library_ms"], library=lib,
                        bound_ms=main["bound_ms"],
                        bound_by=main["bound_by"], by_shape=rows, **common))
    return out


# the 12-layer h1024 GPT's parameters, every one in the ZeRO flat buffer
# (148 leaves), and a ragged size that is no multiple of 4
MTU_SIZES = (185_759_744, 1_000_003)
MTU_BETAS = (0.9, 0.999)
# (kind, adam_w_mode, weight_decay, bias_correction, grad_averaging)
MTU_MODES = (("adam", True, 0.01, True, True),       # AdamW, the ZeRO path
             ("adam", False, 0.01, True, True),      # L2 into the gradient
             ("adam", True, 0.01, False, True),      # no bias correction
             ("lamb", True, 0.01, True, True),       # LAMB, beta3 = 1 - b1
             ("lamb", True, 0.01, True, False))      # LAMB, beta3 = 1


def _mtu_hyper(mode):
    kind, aw, wd, bc, ga = mode
    return dict(kind=kind, betas=MTU_BETAS, eps=1e-8, weight_decay=wd,
                adam_w_mode=aw, bias_correction=bc, grad_averaging=ga)


def check_multi_tensor_update(torch, timer):
    """B13 against its plain version (``zero/update.py`` + ``torch.where``
    on skip), bitwise on every output, in each mode and with a set skip
    flag, at the GPT's parameter count and at a ragged size; timed at the
    GPT's size beside the plain version and one fused AdamW step of
    ``torch.optim`` over the same buffers (timed only: it adds eps outside
    the bias correction, apex inside)."""
    from apex_tpu_torch.zero import fused_update as fu
    gen = torch.Generator(device="cuda").manual_seed(13)
    lr = 3e-4
    step = torch.full((), 7, dtype=torch.int32, device="cuda")
    skip = torch.ones((), dtype=torch.bool, device="cuda")
    checked = []
    for n in MTU_SIZES:
        def rand(scale):
            return scale * torch.randn(n, generator=gen, device="cuda")
        p, g, m = rand(0.05), rand(0.01), rand(1e-3)
        v = rand(1e-2).square_()
        for mode in MTU_MODES:
            hyper = _mtu_hyper(mode)
            scal = fu.update_scalars(lr, step, MTU_BETAS, hyper[
                "bias_correction"], "cuda")
            ref = fu.fused_shard_update_reference(
                p, g, m, v, step, lr=scal[0], corrections=(scal[1], scal[2]),
                **hyper)
            kp, km, kv = p.clone(), m.clone(), v.clone()
            got = fu.fused_shard_update(kp, g, km, kv, step, lr=lr, **hyper)
            torch.cuda.synchronize()
            for name, a, r in zip(("p/upd", "m", "v"), got, ref):
                check(torch.equal(a, r), f"B13 {mode} n{n} {name}: max err "
                      f"{(a - r).abs().max().item()}")
            del ref, got
            for dst, src in ((kp, p), (km, m), (kv, v)):
                dst.copy_(src)
            got = fu.fused_shard_update(kp, g, km, kv, step, lr=lr,
                                        skip=skip, **hyper)
            torch.cuda.synchronize()
            check(torch.equal(kp, p) and torch.equal(km, m)
                  and torch.equal(kv, v), f"B13 {mode} n{n}: skip wrote")
            if hyper["kind"] == "lamb":
                check(not bool(got[0].any()), "B13 LAMB skip: upd not zero")
            checked.append(f"{mode[0]} aw{int(mode[1])} bc{int(mode[3])} "
                           f"ga{int(mode[4])} n{n}")
            del kp, km, kv, got
        if n != MTU_SIZES[0]:
            del p, g, m, v
            continue
        adamw = _mtu_hyper(MTU_MODES[0])
        lamb = _mtu_hyper(MTU_MODES[3])
        kp, km, kv = p.clone(), m.clone(), v.clone()
        ms = timer(lambda: fu.fused_shard_update(kp, g, km, kv, step, lr=lr,
                                                 **adamw), iters=20)
        lamb_ms = timer(lambda: fu.fused_shard_update(kp, g, km, kv, step,
                                                      lr=lr, **lamb),
                        iters=20)
        plain_ms = timer(lambda: fu.fused_shard_update_reference(
            p, g, m, v, step, lr=lr, **adamw), iters=5, warmup=1)
        del kp, km, kv
        flat = torch.nn.Parameter(p.clone())
        flat.grad = g
        lib = torch.optim.AdamW([flat], lr=lr, betas=MTU_BETAS, eps=1e-8,
                                weight_decay=0.01, fused=True)
        lib_ms = timer(lib.step, iters=20)
        del lib, flat
        big = (n, ms, lamb_ms, plain_ms, lib_ms)
        del p, g, m, v
        torch.cuda.empty_cache()
    n, ms, lamb_ms, plain_ms, lib_ms = big
    # reads p, g, m, v and writes p (or upd), m, v: 7 fp32 buffers; ~15
    # fp32 operations an element on the CUDA cores
    t_bound, by = bound(15.0 * n, 7 * 4 * n, FP32_FLOPS_PER_S)
    return dict(name="multi_tensor_update", route="cuda",
                source="apex_tpu_torch/csrc/multi_tensor_update.cu",
                replaces="apex_tpu/zero/fused_update.py:54",
                shape=f"n{n} fp32 flat (the 12-layer h1024 GPT), in place; "
                      f"also n{MTU_SIZES[1]}",
                max_abs_err=0.0, tolerance="bitwise (torch.equal) on every "
                "output, every mode, and under skip",
                checked=checked, ms=ms, lamb_ms=lamb_ms, plain_ms=plain_ms,
                bound_ms=t_bound, bound_by=by, library_ms=lib_ms,
                library="torch.optim.AdamW(fused=True).step() over the same "
                        "flat fp32 buffer (eps placement differs)")


# ---------------------------------------------------------------------------
# serve path
# ---------------------------------------------------------------------------

N_REQUESTS, N_NEW = 16, 64

# the serve paths: the bf16 engine (PR 1), fp8 weights + fp8 KV, and
# speculative decoding over fp8 weights with the default 6-layer draft
SERVE_PATHS = {
    "serve": {},
    "serve-fp8": dict(fp8_weights=True, fp8_kv=True),
    "serve-spec-fp8w": dict(fp8_weights=True, spec_k=4),
}


def gpt_config(max_seq_len=1024):
    import torch
    from apex_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=32768, max_seq_len=max_seq_len,
                     hidden_size=1024, num_layers=12, num_heads=16,
                     dtype=torch.bfloat16)


def make_engine(cfg, params, **kw):
    from apex_tpu_torch.serve import ServeEngine
    return ServeEngine(cfg, params, num_pages=72, page_size=128,
                       max_seq_len=1024, max_prompt_len=512, max_batch=8,
                       record_logits=True, **kw)


def counters():
    """Each kernel's launch counter as (wrapper, attribute): the fp8
    variant of paged decode counts apart from the bf16 kernel, the split
    flash backward's two kernels apart from the single pass, and the
    wgmma route of the flash forward, the single pass and the split
    (``*_sm90``) apart from both routes together (``flash_fwd``,
    ``flash_bwd``, ``flash_bwd_dkdv``/``flash_bwd_dq``;
    :func:`read_counters` leaves flash_fwd.cu's and flash_bwd.cu's own
    launches there), and the wgmma forward's, single pass's and split's
    dropout variants (``*_dropout``) apart from their variants without,
    and the wgmma forward's, single pass's and split's bias variants
    (``*_bias``) apart from both, and the wgmma forward's, single pass's
    and split's variants with both (``*_bias_dropout``) apart from all
    three, and the fp32 FFMA forward's, single pass's and split's dropout
    and bias variants (``flash_*_f32_*dropout``, ``flash_*_f32_*bias``)
    and their variants with both (``flash_*_f32_*bias_dropout``) apart
    from their kernels without."""
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fp8_matmul as mm
    from apex_tpu_torch.ops import fused_ce as xe
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import lm_head_ce as ce
    from apex_tpu_torch.scripts import bottleneck_proto as bp
    from apex_tpu_torch.scripts import vpu_probe as vp
    from apex_tpu_torch.zero import fused_update as fu
    return {"flash_fwd": (fa.flash_attention, "launches"),
            "flash_fwd_sm90": (fa.flash_attention, "wgmma_launches"),
            "flash_fwd_sm90_dropout": (fa.flash_attention,
                                       "dropout_launches"),
            "flash_fwd_sm90_bias": (fa.flash_attention, "bias_launches"),
            "flash_fwd_sm90_bias_dropout": (fa.flash_attention,
                                            "bias_dropout_launches"),
            "flash_fwd_f32": (fa.flash_attention, "f32_launches"),
            "flash_fwd_f32_dropout": (fa.flash_attention,
                                      "f32_dropout_launches"),
            "flash_fwd_f32_bias": (fa.flash_attention, "f32_bias_launches"),
            "flash_fwd_f32_bias_dropout": (fa.flash_attention,
                                           "f32_bias_dropout_launches"),
            "paged_decode": (fa.paged_decode_attention, "launches"),
            "paged_decode_fp8": (fa.paged_decode_attention, "fp8_launches"),
            "layer_norm_fwd": (ln.fused_layer_norm_affine, "launches"),
            "flash_bwd": (fa.flash_attention_bwd, "launches"),
            "flash_bwd_fused_sm90": (fa.flash_attention_bwd,
                                     "wgmma_launches"),
            "flash_bwd_fused_sm90_dropout": (fa.flash_attention_bwd,
                                             "dropout_launches"),
            "flash_bwd_fused_sm90_bias": (fa.flash_attention_bwd,
                                          "bias_launches"),
            "flash_bwd_fused_sm90_bias_dropout": (
                fa.flash_attention_bwd, "bias_dropout_fused_launches"),
            "flash_bwd_f32": (fa.flash_attention_bwd, "f32_launches"),
            "flash_bwd_f32_dropout": (fa.flash_attention_bwd,
                                      "f32_dropout_launches"),
            "flash_bwd_f32_bias": (fa.flash_attention_bwd,
                                   "f32_bias_launches"),
            "flash_bwd_f32_bias_dropout": (fa.flash_attention_bwd,
                                           "f32_bias_dropout_launches"),
            "layer_norm_bwd": (ln.layer_norm_bwd, "launches"),
            "lm_head_ce_fwd": (ce.lm_head_ce_fwd, "launches"),
            "lm_head_ce_bwd": (ce.lm_head_ce_bwd, "launches"),
            "lm_head_ce_fwd_f32": (ce.lm_head_ce_fwd, "f32_launches"),
            "lm_head_ce_bwd_f32": (ce.lm_head_ce_bwd, "f32_launches"),
            "fp8_matmul": (mm.fp8_dequant_matmul, "launches"),
            "fp8_matmul_prefill": (mm.fp8_dequant_matmul,
                                   "prefill_launches"),
            "flash_bwd_dkdv": (fa.flash_attention_bwd, "dkdv_launches"),
            "flash_bwd_dq": (fa.flash_attention_bwd, "dq_launches"),
            "flash_bwd_dkdv_sm90": (fa.flash_attention_bwd,
                                    "wgmma_dkdv_launches"),
            "flash_bwd_dq_sm90": (fa.flash_attention_bwd,
                                  "wgmma_dq_launches"),
            "flash_bwd_dkdv_sm90_dropout": (fa.flash_attention_bwd,
                                            "dropout_dkdv_launches"),
            "flash_bwd_dq_sm90_dropout": (fa.flash_attention_bwd,
                                          "dropout_dq_launches"),
            "flash_bwd_dkdv_sm90_bias": (fa.flash_attention_bwd,
                                         "bias_dkdv_launches"),
            "flash_bwd_dq_sm90_bias": (fa.flash_attention_bwd,
                                       "bias_dq_launches"),
            "flash_bwd_dkdv_sm90_bias_dropout": (
                fa.flash_attention_bwd, "bias_dropout_dkdv_launches"),
            "flash_bwd_dq_sm90_bias_dropout": (fa.flash_attention_bwd,
                                               "bias_dropout_dq_launches"),
            "flash_bwd_f32_dkdv": (fa.flash_attention_bwd,
                                   "f32_dkdv_launches"),
            "flash_bwd_f32_dq": (fa.flash_attention_bwd, "f32_dq_launches"),
            "flash_bwd_f32_dkdv_dropout": (fa.flash_attention_bwd,
                                           "f32_dropout_dkdv_launches"),
            "flash_bwd_f32_dq_dropout": (fa.flash_attention_bwd,
                                         "f32_dropout_dq_launches"),
            "flash_bwd_f32_dkdv_bias": (fa.flash_attention_bwd,
                                        "f32_bias_dkdv_launches"),
            "flash_bwd_f32_dq_bias": (fa.flash_attention_bwd,
                                      "f32_bias_dq_launches"),
            "flash_bwd_f32_dkdv_bias_dropout": (
                fa.flash_attention_bwd, "f32_bias_dropout_dkdv_launches"),
            "flash_bwd_f32_dq_bias_dropout": (
                fa.flash_attention_bwd, "f32_bias_dropout_dq_launches"),
            "xentropy_fwd": (xe.softmax_cross_entropy_with_smoothing,
                             "launches"),
            "xentropy_bwd": (xe.softmax_cross_entropy_with_smoothing,
                             "bwd_launches"),
            "multi_tensor_update": (fu.fused_shard_update, "launches"),
            "multi_tensor_update_lamb": (fu.fused_shard_update,
                                         "lamb_launches"),
            "bottleneck": (bp.fused_block, "launches"),
            "vpu_probe": (vp.vpu_probe_kernel, "launches")}


def reset_counters():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counters():
    """Launches by kernel since :func:`reset_counters`; the flash
    counters of every route less the wgmma route's and the fp32 FFMA
    route's (``flash_fwd_f32``, ``flash_bwd_f32``, ``flash_bwd_f32_dkdv``,
    ``flash_bwd_f32_dq``), so that
    ``flash_fwd``, ``flash_bwd``, ``flash_bwd_dkdv`` and ``flash_bwd_dq``
    count flash_fwd.cu's and flash_bwd.cu's own kernels alone, and the
    LM-head CE's
    less the fp32 route's, so that ``lm_head_ce_fwd``/``_bwd`` count the
    wgmma route's (``lm_head_ce_sm90.cu``) and ``*_f32`` the fp32 route's
    (``lm_head_ce.cu``); the fp8 matmul's less its prefill regime's, so
    that ``fp8_matmul`` counts the decode regime and
    ``fp8_matmul_prefill`` the prefill regime; the wgmma forward's, single
    pass's and split's less their dropout variants', so that
    ``flash_fwd_sm90``, ``flash_bwd_fused_sm90``, ``flash_bwd_dkdv_sm90``
    and ``flash_bwd_dq_sm90`` count the kernels without dropout and
    ``*_dropout`` those with; and the wgmma forward's, single pass's and
    split's less their bias variants' (``*_bias``) and the variants with
    both (``*_bias_dropout``; a launch with both counts there alone); and
    the FFMA forward's, single pass's and split's less their dropout and
    bias variants' and their variants with both, so that
    ``flash_fwd_f32``, ``flash_bwd_f32``, ``flash_bwd_f32_dkdv`` and
    ``flash_bwd_f32_dq`` count the kernels without a variant and
    ``*_dropout``, ``*_bias``, ``*_bias_dropout`` those with (a launch
    with both counts there alone)."""
    out = {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
    out["fp8_matmul"] -= out["fp8_matmul_prefill"]
    out["lm_head_ce_fwd"] -= out["lm_head_ce_fwd_f32"]
    out["lm_head_ce_bwd"] -= out["lm_head_ce_bwd_f32"]
    out["flash_fwd"] -= out["flash_fwd_sm90"] + out["flash_fwd_f32"]
    out["flash_bwd"] -= out["flash_bwd_fused_sm90"] + out["flash_bwd_f32"]
    out["flash_bwd_dkdv"] -= out["flash_bwd_dkdv_sm90"] + \
        out["flash_bwd_f32_dkdv"]
    out["flash_bwd_dq"] -= out["flash_bwd_dq_sm90"] + out["flash_bwd_f32_dq"]
    out["flash_fwd_f32"] -= out["flash_fwd_f32_dropout"] + \
        out["flash_fwd_f32_bias"] + out["flash_fwd_f32_bias_dropout"]
    out["flash_bwd_f32"] -= out["flash_bwd_f32_dropout"] + \
        out["flash_bwd_f32_bias"] + out["flash_bwd_f32_bias_dropout"]
    out["flash_bwd_f32_dkdv"] -= out["flash_bwd_f32_dkdv_dropout"] + \
        out["flash_bwd_f32_dkdv_bias"] + out["flash_bwd_f32_dkdv_bias_dropout"]
    out["flash_bwd_f32_dq"] -= out["flash_bwd_f32_dq_dropout"] + \
        out["flash_bwd_f32_dq_bias"] + out["flash_bwd_f32_dq_bias_dropout"]
    out["flash_fwd_sm90"] -= out["flash_fwd_sm90_dropout"] + \
        out["flash_fwd_sm90_bias"] + out["flash_fwd_sm90_bias_dropout"]
    out["flash_bwd_fused_sm90"] -= out["flash_bwd_fused_sm90_dropout"] + \
        out["flash_bwd_fused_sm90_bias"] + \
        out["flash_bwd_fused_sm90_bias_dropout"]
    out["flash_bwd_dkdv_sm90"] -= out["flash_bwd_dkdv_sm90_dropout"] + \
        out["flash_bwd_dkdv_sm90_bias"] + \
        out["flash_bwd_dkdv_sm90_bias_dropout"]
    out["flash_bwd_dq_sm90"] -= out["flash_bwd_dq_sm90_dropout"] + \
        out["flash_bwd_dq_sm90_bias"] + out["flash_bwd_dq_sm90_bias_dropout"]
    return out


def serve_prompts(cfg):
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 513, size=N_REQUESTS)
    return [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]


def expected_serve_launches(path, eng, n_prefill, n_decode):
    """Launches of each kernel over a drained run: per layer one flash
    forward per prefill and one paged decode per decode step (verify call
    under speculation), 2 LayerNorms per layer plus the final one per
    forward, 4 block linears per layer through the fp8 matmul with fp8
    weights (a prefill in its prefill regime, a decode step in its decode
    regime); a draft call runs the draft's layers the same way, in the
    decode regime."""
    L = eng.cfg.num_layers
    exp = {k: 0 for k in counters()}
    steps = n_prefill + n_decode
    exp["flash_fwd_sm90"] = L * n_prefill       # bf16 d64: the wgmma route
    exp["layer_norm_fwd"] = (2 * L + 1) * steps
    decode = "paged_decode_fp8" if eng.ccfg.fp8 else "paged_decode"
    exp[decode] = L * n_decode
    if eng.fp8_weights:
        # a prefill runs one padded prompt (m 512: the prefill regime), a
        # decode step the fixed batch of 8 rows (the decode regime)
        exp["fp8_matmul"] = 4 * L * n_decode
        exp["fp8_matmul_prefill"] = 4 * L * n_prefill
    if eng.spec_k:
        Ld, calls = eng.draft_cfg.num_layers, eng.draft_calls
        exp["paged_decode"] += Ld * calls
        exp["layer_norm_fwd"] += (2 * Ld + 1) * calls
        exp["fp8_matmul"] += 4 * Ld * calls
    return exp


def run_serve_path(torch, cfg, params, path, n_requests=N_REQUESTS):
    """Drain ``n_requests`` requests through the engine of ``path`` after a
    warm-up engine (cuBLAS handles, Triton's first compile and the
    kernels' first loads stay out of the timed, counted run)."""
    kw = SERVE_PATHS[path]
    warm = make_engine(cfg, params, **kw)
    warm.add_request(list(range(1, 65)), 6)
    warm.run()
    del warm
    torch.cuda.synchronize()

    eng = make_engine(cfg, params, **kw)
    prompts = serve_prompts(cfg)[:n_requests]
    ids = [eng.add_request(p, N_NEW) for p in prompts]
    reset_counters()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()

    check(all(len(out[i]) == N_NEW for i in ids),
          f"{path}: a request did not return {N_NEW} tokens")
    check(eng.sched.allocator.free_pages == eng.ccfg.num_pages - 1,
          f"{path}: pages were not all returned")
    check(eng.slots == [None] * eng.max_batch, f"{path}: a slot leaked")
    check(sum(eng.seqs[i].n_preemptions for i in ids) == 0,
          f"{path}: a preemption happened: the launch counts assume none")
    n_prefill = len(eng.prefill_times)
    n_decode = len(eng.decode_step_times)
    check(n_prefill == n_requests, f"{path}: {n_prefill} prefills")
    expect = expected_serve_launches(path, eng, n_prefill, n_decode)
    for k in expect:
        check(launches[k] == expect[k],
              f"{path} {k}: {launches[k]} launches, expected {expect[k]}")
    if eng.fp8_weights:
        check(launches["fp8_matmul"] > 0 and
              launches["fp8_matmul_prefill"] > 0,
              f"{path}: a regime of the fp8 matmul never ran")
    if eng.ccfg.fp8:
        check(launches["paged_decode_fp8"] > 0 and
              launches["paged_decode"] == 0,
              f"{path}: decode did not go through the fp8 kernel alone")

    dec_ms = [1e3 * t for t in eng.decode_step_times]
    full = [1e3 * t for t, n in zip(eng.decode_step_times,
                                    eng.decode_step_sizes)
            if n == eng.max_batch]
    stats = dict(
        path=path, engine_flags=kw, requests=n_requests, new_tokens=N_NEW,
        wall_s=wall, tokens_per_s=eng.tokens_generated / wall,
        prefill_ms_by_len=sorted((n, 1e3 * t) for n, t in eng.prefill_times),
        prefill_ms_median=float(np.median([1e3 * t for _, t in
                                           eng.prefill_times])),
        decode_steps=n_decode,
        decode_step_ms_median=float(np.median(dec_ms)),
        decode_step_ms_p90=float(np.percentile(dec_ms, 90)),
        decode_tokens_per_s=sum(eng.decode_step_sizes)
        / sum(eng.decode_step_times),
        pool_bytes=eng.ccfg.pool_bytes(),
        launches=launches)
    if full:
        stats.update(decode_step_ms_batch8_median=float(np.median(full)),
                     decode_step_ms_batch8_p90=float(np.percentile(full, 90)),
                     decode_steps_batch8=len(full))
    if eng.spec_k:
        stats.update(spec_k=eng.spec_k, draft_layers=eng.draft_cfg.num_layers,
                     spec_rounds=eng.spec_rounds,
                     draft_calls=eng.draft_calls,
                     draft_tokens=eng.draft_tokens,
                     accepted_tokens=eng.accepted_tokens,
                     accept_rate=eng.accepted_tokens
                     / max(1, eng.draft_tokens),
                     tokens_per_round=(eng.accepted_tokens
                                       + eng.spec_rounds)
                     / max(1, eng.spec_rounds),
                     draft_pool_bytes=eng.draft_ccfg.pool_bytes())
    return eng, ids, out, stats


def spec_identity(torch, cfg, params, spec, ids, out):
    """The speculative engine's tokens against a plain ``fp8_weights``
    engine's on the same requests (the JAX contract: a verify row is
    bitwise the plain-decode row). Returns the first differing (request,
    token index) or None, and how many recorded logits rows are bitwise
    equal."""
    plain = make_engine(cfg, params, fp8_weights=True)
    pids = [plain.add_request(p, N_NEW) for p in serve_prompts(cfg)]
    pout = plain.run()
    torch.cuda.synchronize()
    first = None
    for sid, pid in zip(ids, pids):
        a, b = out[sid], pout[pid]
        diff = [i for i in range(N_NEW) if a[i] != b[i]]
        if diff and first is None:
            first = (sid, diff[0])
    rows = same = 0
    for sid, pid in zip(ids, pids):
        for pos, row in plain.logits_log[pid].items():
            other = spec.logits_log[sid].get(pos)
            if other is not None:
                rows += 1
                same += int(np.array_equal(row, other))
    return dict(requests=len(ids), first_token_divergence=first,
                logits_rows_compared=rows, logits_rows_bitwise_equal=same)


def teacher_forced(torch, cfg, params, eng, ids):
    """The plain no-cache forward over prompt + generated tokens against the
    engine's recorded logits, every generated position of two requests.
    ``params`` is what the engine serves (the quantized view under fp8
    weights, whose plain forward runs the dequant-matmul's plain version)."""
    from apex_tpu_torch.serve.model import full_forward_logits
    worst, worst_gap, n_pos, n_flip, mag = 0.0, 0.0, 0, 0, 0.0
    for sid in ids[:2]:
        seq = eng.seqs[sid]
        lp = len(seq.prompt)
        positions = list(range(lp, lp + N_NEW))
        S = lp + N_NEW
        for lo in range(0, len(positions), 16):
            chunk = positions[lo:lo + 16]
            batch = np.zeros((len(chunk), S), np.int64)
            for r, p in enumerate(chunk):
                batch[r, :p] = seq.tokens[:p]
            with torch.no_grad():
                ref = full_forward_logits(
                    cfg, params, torch.from_numpy(batch).cuda(),
                    torch.tensor(chunk, device="cuda"), reference=True)
            ref = ref.cpu().numpy()
            for r, p in enumerate(chunk):
                got = eng.logits_log[sid][p]
                worst = max(worst, float(np.abs(got - ref[r]).max()))
                mag = max(mag, float(np.abs(ref[r]).max()))
                n_pos += 1
                a, b = int(got.argmax()), int(ref[r].argmax())
                if a != b:
                    n_flip += 1
                    worst_gap = max(worst_gap, float(ref[r][b] - ref[r][a]))
    return dict(positions=n_pos, max_abs_diff=worst, max_abs_logit=mag,
                argmax_flips=n_flip, worst_flip_gap=worst_gap)


# fp8 KV against the plain forward over the same quantized weights: the
# e4m3 round trip of K and V is the only difference besides the kernels';
# the bound tests/test_serve.py holds the JAX fp8 cache to
TF_FP8_FRAC = 0.15

# max |logit| diff, bf16 engine vs the plain forward: ~6 bf16 ulps at the
# largest logits (|logit| < 4, ulp 2^-6); an argmax flip is allowed only
# where the plain logits of the two tokens are within 2 * TF_TOL
TF_TOL = 0.1
TF_TIE = 2 * TF_TOL


# ---------------------------------------------------------------------------
# train path
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS, LR = 8, 1024, 8, 3e-4
# every flash launch of the bf16 d64 step on the wgmma route
TRAIN_PER_STEP = {"flash_fwd": 0, "flash_fwd_sm90": 12, "flash_fwd_f32": 0,
                  "flash_fwd_sm90_dropout": 0, "flash_fwd_sm90_bias": 0,
                  "flash_bwd": 0, "flash_bwd_fused_sm90": 12,
                  "flash_bwd_fused_sm90_dropout": 0,
                  "flash_bwd_fused_sm90_bias": 0, "layer_norm_fwd": 25,
                  "layer_norm_bwd": 25, "lm_head_ce_fwd": 1,
                  "lm_head_ce_bwd": 1, "lm_head_ce_fwd_f32": 0,
                  "lm_head_ce_bwd_f32": 0, "paged_decode": 0,
                  "paged_decode_fp8": 0, "fp8_matmul": 0,
                  "fp8_matmul_prefill": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
                  "flash_bwd_dkdv_sm90": 0, "flash_bwd_dq_sm90": 0,
                  "flash_bwd_dkdv_sm90_dropout": 0,
                  "flash_bwd_dq_sm90_dropout": 0,
                  "flash_bwd_dkdv_sm90_bias": 0,
                  "flash_bwd_dq_sm90_bias": 0,
                  "flash_fwd_sm90_bias_dropout": 0,
                  "flash_bwd_dkdv_sm90_bias_dropout": 0,
                  "flash_bwd_dq_sm90_bias_dropout": 0,
                  "flash_bwd_fused_sm90_bias_dropout": 0,
                  "flash_fwd_f32_dropout": 0, "flash_bwd_f32_dropout": 0,
                  "flash_bwd_f32": 0, "flash_bwd_f32_dkdv": 0,
                  "flash_bwd_f32_dq": 0, "flash_fwd_f32_bias": 0,
                  "flash_bwd_f32_bias": 0, "flash_bwd_f32_dkdv_bias": 0,
                  "flash_bwd_f32_dq_bias": 0,
                  "flash_bwd_f32_dkdv_dropout": 0,
                  "flash_bwd_f32_dq_dropout": 0,
                  "flash_fwd_f32_bias_dropout": 0,
                  "flash_bwd_f32_bias_dropout": 0,
                  "flash_bwd_f32_dkdv_bias_dropout": 0,
                  "flash_bwd_f32_dq_bias_dropout": 0, "xentropy_fwd": 0,
                  "xentropy_bwd": 0, "multi_tensor_update": 0,
                  "multi_tensor_update_lamb": 0}


def train_batch(torch, cfg, b=TRAIN_B, s=TRAIN_S):
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int64)
    ids = torch.from_numpy(ids).cuda()
    return ids, torch.roll(ids, -1, dims=1)


def o2_setup(torch, cfg):
    """The O2 recipe: init -> amp.initialize -> cast_params -> opt.init ->
    make_train_step."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import GPT
    from apex_tpu_torch.optimizers import FusedAdam
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    amp_model, opt = amp.initialize(model, FusedAdam(lr=LR), opt_level="O2",
                                    loss_scale="dynamic", verbosity=0)
    amp_model.cast_params()
    state = opt.init(model.parameters())
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    return model, opt, state, step


def run_train_path(torch, cfg):
    model, opt, state, step = o2_setup(torch, cfg)
    ids, labels = train_batch(torch, cfg)
    sstate = opt._scaler.state
    # warm-up: cuBLAS handles and Triton's compiles stay out of the count
    _, state, sstate, _ = step(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    scale0 = float(sstate.loss_scale)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counters()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(float(sstate.loss_scale) == scale0 == 2.0 ** 16,
          "the loss scale moved (an overflow) during the timed steps")
    for k, per in TRAIN_PER_STEP.items():
        check(launches[k] == per * TRAIN_STEPS,
              f"train {k}: {launches[k]} launches, expected "
              f"{per * TRAIN_STEPS}")
    ms = [1e3 * t for t in times]
    stats = dict(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                 losses=losses, warmup_loss_scale=scale0,
                 step_ms_median=float(np.median(ms)),
                 step_ms_p90=float(np.percentile(ms, 90)),
                 step_ms_all=ms,
                 tokens_per_s=TRAIN_B * TRAIN_S / (np.median(ms) / 1e3),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=launches)
    return model, opt, state, sstate, step, stats


def step_phases(torch, cfg, model, opt, state, sstate, reps=3):
    """Device time of each phase of the train step, by CUDA events around
    the functions ``make_train_step`` calls, called one by one in its
    order: forward + backward of the scaled loss, unscale (gradient
    concatenation, overflow check, multiply), the optimizer step on the
    flat buffer, the scaler update. Median of ``reps``; returns the phase
    times and the state after them."""
    from apex_tpu_torch.amp import scaler as scaler_mod
    ids, labels = train_batch(torch, cfg)
    params = [p for g in opt.param_groups for p in g["params"]]
    names = ("forward_backward", "unscale", "optimizer", "scaler_update")
    ms = {k: [] for k in names}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        ev[0].record()
        scaler_mod.scale_value(model.loss(ids, labels), sstate).backward()
        ev[1].record()
        g32, found_inf = scaler_mod.unscale(
            [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params], sstate)
        for p in params:
            p.grad = None
        ev[2].record()
        state = opt.apply_flat(state, g32, skip=found_inf)
        ev[3].record()
        sstate = opt._scaler.update_state(sstate, found_inf)
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            ms[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: float(np.median(v)) for k, v in ms.items()}, state, sstate


# loss through the kernels vs the plain versions, same bf16 params: the
# kernels round p (flash) at the same points as the plain forward; only
# summation order differs, through 12 layers. Measured on the H100 at
# full size: 10.60548 vs 10.60557, a gap of 9e-5 (PERF.md).
GRAD_LOSS_TOL = 1e-3
# per-parameter relative norm of the gradient difference: the backward
# kernels round p, ds and the softmax-gradient tile to bf16 before their
# products (the plain versions, differentiated by autograd, keep fp32).
# Measured on the H100 at full size: worst 1.26 %, median 0.90 %.
GRAD_NORM_TOL = 3e-2


def grad_check(torch, cfg, dropout_seed, b=TRAIN_B, s=TRAIN_S):
    """The loss and every gradient through the kernels against
    ``reference=True``, on one fresh O2 GPT of ``cfg`` (which may carry
    dropout rates) at batch ``b`` and sequence ``s``: first deterministic,
    then in training mode with the config's dropout from a host generator
    of ``dropout_seed`` on both sides (the same attention seeds and hidden
    masks). Returns the two checks' records, each with the peak device
    memory of its check."""
    model, _, _, _ = o2_setup(torch, cfg)
    ids, labels = train_batch(torch, cfg, b, s)
    params = list(model.named_parameters())

    def one(what, **kw):
        def loss_of(reference):
            if kw:
                kw["generator"] = torch.Generator().manual_seed(dropout_seed)
            return model.loss(ids, labels, reference=reference, **kw)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loss = loss_of(False)
        grads = torch.autograd.grad(loss, [p for _, p in params])
        ref_loss = loss_of(True)
        ref = torch.autograd.grad(ref_loss, [p for _, p in params])
        loss, ref_loss = loss.detach(), ref_loss.detach()
        dloss = abs(float(loss) - float(ref_loss))
        check(dloss <= GRAD_LOSS_TOL, f"{what}loss kernels {float(loss)} vs "
              f"plain {float(ref_loss)}")
        worst = []
        for (name, _), g, r in zip(params, grads, ref):
            rel = ((g.float() - r.float()).norm()
                   / r.float().norm().clamp_min(1e-30)).item()
            worst.append((rel, name))
            check(rel <= GRAD_NORM_TOL,
                  f"{what}grad {name}: relative norm error {rel}")
        worst.sort(reverse=True)
        del grads, ref
        return dict(layers=cfg.num_layers, batch=b, seq=s,
                    loss_kernels=float(loss),
                    loss_plain=float(ref_loss), loss_abs_diff=dloss,
                    params=len(params), worst_rel_norm=worst[:5],
                    median_rel_norm=float(np.median([w for w, _ in worst])),
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)

    return one(""), one("dropout ", deterministic=False)


def overflow_check(torch, cfg, model, opt, state, sstate):
    """One step whose gradients overflow: the loss times 1e38 (the
    overflow factory of tests/test_amp.py), so loss * scale and the
    gradient seed overflow fp32 and every gradient is inf or nan."""
    from apex_tpu_torch import amp
    ids, labels = train_batch(torch, cfg)
    big = amp.make_train_step(lambda m, i, l: m.loss(i, l) * 1e38, opt)
    g = state.groups[0]
    before = (g.master.clone(), {k: v.clone() for k, v in g.slots.items()},
              int(g.step), [p.detach().clone() for p in model.parameters()])
    scale0 = float(sstate.loss_scale)
    _, state2, sstate2, loss = big(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    g2 = state2.groups[0]
    check(torch.equal(g2.master, before[0]), "overflow: master changed")
    for k, v in before[1].items():
        check(torch.equal(g2.slots[k], v), f"overflow: {k} changed")
    check(int(g2.step) == before[2], "overflow: step counter moved")
    check(all(torch.equal(p, b) for p, b in zip(model.parameters(),
                                                before[3])),
          "overflow: model params changed")
    check(bool(sstate2.overflow), "overflow: not detected")
    check(float(sstate2.loss_scale) == scale0 / 2, "overflow: scale not "
          "halved")
    return dict(loss=float(loss), scale_before=scale0,
                scale_after=float(sstate2.loss_scale), step=int(g2.step))


# ---------------------------------------------------------------------------
# the s1024 O2 step in training mode with Megatron's dropout: attention
# dropout in B1's and B2's dropout variants, hidden dropout on both residual
# branches, from one host generator
# ---------------------------------------------------------------------------

DROP_STEPS = 4
DROP_GEN_SEED = 0
DROP_PER_STEP = {**TRAIN_PER_STEP, "flash_fwd_sm90": 0,
                 "flash_bwd_fused_sm90": 0, "flash_fwd_sm90_dropout": 12,
                 "flash_bwd_fused_sm90_dropout": 12}


def dropout_config(cfg):
    """``cfg`` with Megatron's attention and hidden dropout."""
    return dataclasses.replace(cfg, attention_dropout=DROPOUT_RATE,
                               hidden_dropout=DROPOUT_RATE)


def run_dropout_path(torch, model, opt, state, sstate, b=TRAIN_B,
                     s=TRAIN_S, per_step=DROP_PER_STEP, what="train-dropout"):
    """The O2 ``FusedAdam`` step of :func:`run_train_path` (or, at ``b``
    and ``s``, of :func:`run_long_seq_path`) in training mode, on its model
    (of :func:`dropout_config`) and optimizer state: a second
    ``make_train_step`` over ``GPT.loss(deterministic=False)`` with one
    host generator; a warm-up, then :data:`DROP_STEPS` timed steps with the
    counters reset just before; finite, falling losses and each kernel's
    launches a step as ``per_step`` has them (every flash launch on the
    dropout variants). Returns the stats, the state and the step."""
    from apex_tpu_torch import amp
    gen = torch.Generator().manual_seed(DROP_GEN_SEED)
    step = amp.make_train_step(lambda m, i, l: m.loss(
        i, l, deterministic=False, generator=gen), opt)
    ids, labels = train_batch(torch, model.cfg, b, s)
    _, state, sstate, _ = step(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counters()
    for _ in range(DROP_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite {what} loss: {losses}")
    check(losses[-1] < losses[0], f"{what} loss did not fall: {losses}")
    for k, per in per_step.items():
        check(launches[k] == per * DROP_STEPS,
              f"{what} {k}: {launches[k]} launches, expected "
              f"{per * DROP_STEPS}")
    ms = [1e3 * t for t in times]
    stats = dict(steps=DROP_STEPS, batch=b, seq=s,
                 attention_dropout=DROPOUT_RATE, hidden_dropout=DROPOUT_RATE,
                 losses=losses, step_ms_median=float(np.median(ms)),
                 step_ms_p90=float(np.percentile(ms, 90)), step_ms_all=ms,
                 tokens_per_s=b * s / (np.median(ms) / 1e3),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=launches)
    return stats, state, sstate, step


# ---------------------------------------------------------------------------
# long-sequence GPT training: the same O2 FusedAdam step at b2 s4096
# (bench.py's _bench_gpt_long_seq), past the flash backward's gate
# ---------------------------------------------------------------------------

LONG_B, LONG_S, LONG_STEPS = 2, 4096, 4
# every split launch of the bf16 step takes the wgmma route
LONG_PER_STEP = {**TRAIN_PER_STEP, "flash_bwd_fused_sm90": 0,
                 "flash_bwd_dkdv": 0,
                 "flash_bwd_dq": 0, "flash_bwd_dkdv_sm90": 12,
                 "flash_bwd_dq_sm90": 12}
# the same step in training mode: every flash launch on a dropout variant
LONG_DROP_PER_STEP = {**LONG_PER_STEP, "flash_fwd_sm90": 0,
                      "flash_fwd_sm90_dropout": 12,
                      "flash_bwd_dkdv_sm90": 0, "flash_bwd_dq_sm90": 0,
                      "flash_bwd_dkdv_sm90_dropout": 12,
                      "flash_bwd_dq_sm90_dropout": 12}
# the s4096 gradient check's depth: the width stays, the plain attention
# of 12 layers would hold ~2 GB fp32 tensors several times a layer
LONG_GRAD_LAYERS = 2


def run_long_seq_path(torch):
    """The O2 step at b2 s4096 on a GPT of :func:`dropout_config` (its
    deterministic steps ignore the rates); returns the stats, the trace
    and ``(model, opt, state, sstate)`` for the dropout steps after it."""
    cfg = dropout_config(gpt_config(max_seq_len=LONG_S))
    model, opt, state, step = o2_setup(torch, cfg)
    ids, labels = train_batch(torch, cfg, LONG_B, LONG_S)
    sstate = opt._scaler.state
    _, state, sstate, _ = step(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counters()
    for _ in range(LONG_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite s4096 loss: {losses}")
    for k, per in LONG_PER_STEP.items():
        check(launches[k] == per * LONG_STEPS,
              f"train s{LONG_S} {k}: {launches[k]} launches, expected "
              f"{per * LONG_STEPS}")
    ms = [1e3 * t for t in times]
    stats = dict(steps=LONG_STEPS, batch=LONG_B, seq=LONG_S, losses=losses,
                 step_ms_median=float(np.median(ms)),
                 step_ms_p90=float(np.percentile(ms, 90)), step_ms_all=ms,
                 tokens_per_s=LONG_B * LONG_S / (np.median(ms) / 1e3),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=launches)
    box = [state, sstate]

    def one():
        _, box[0], box[1], _ = step(model, box[0], box[1], ids, labels)

    return stats, _profile(torch, one, 2), (model, opt, box[0], box[1])


# ---------------------------------------------------------------------------
# contrib.multihead_attn: O2 training of an 18-layer SelfMultiheadAttn stack
# at hidden 1024 and 16 heads (apex's perf_test_multihead_attn.py widths),
# with fairseq's future mask as the kernels' bias and key padding; then the
# harness's largest point with attention dropout
# ---------------------------------------------------------------------------

MHA_STEPS = 4
# the bias path: the LayerNorm pair of norm_add and the flash bias variants
MHA_BIAS_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP},
                     "flash_fwd_sm90_bias": MHA_LAYERS,
                     "flash_bwd_fused_sm90_bias": MHA_LAYERS,
                     "layer_norm_fwd": MHA_LAYERS,
                     "layer_norm_bwd": MHA_LAYERS}
# the dropout path (no norm_add, no masks): the flash dropout variants
MHA_DROP_B, MHA_DROP_S = 120, 64
MHA_DROP_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP},
                     "flash_fwd_sm90_dropout": MHA_LAYERS,
                     "flash_bwd_fused_sm90_dropout": MHA_LAYERS}
MHA_BIAS_KW = dict(dropout=0.0, use_bias=True, include_norm_add=True,
                   impl="fast")
MHA_DROP_KW = dict(dropout=DROPOUT_RATE, use_bias=False,
                   include_norm_add=False, impl="fast")
MHA_GRAD_LAYERS = 2
# the long-context path: the flash forward's and the split's bias variants
# (the gate splits every biased backward at s3072 d128) and the LayerNorm
# pair of norm_add
MHA16_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP},
                  "flash_fwd_sm90_bias": MHA16_LAYERS,
                  "flash_bwd_dkdv_sm90_bias": MHA16_LAYERS,
                  "flash_bwd_dq_sm90_bias": MHA16_LAYERS,
                  "layer_norm_fwd": MHA16_LAYERS,
                  "layer_norm_bwd": MHA16_LAYERS}
# the same path at fairseq transformer_lm_wiki103's attention dropout 0.1
# (apex's module has one ``dropout``, which also drives norm_add's residual
# dropout): the forward's and the split's variants with both
MHA_BIAS_DROP_KW = dict(MHA_BIAS_KW, dropout=DROPOUT_RATE)
MHA16_DROP_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP},
                       "flash_fwd_sm90_bias_dropout": MHA16_LAYERS,
                       "flash_bwd_dkdv_sm90_bias_dropout": MHA16_LAYERS,
                       "flash_bwd_dq_sm90_bias_dropout": MHA16_LAYERS,
                       "layer_norm_fwd": MHA16_LAYERS,
                       "layer_norm_bwd": MHA16_LAYERS}
# train-mha6-e1024h16-b28s128-bias-dropout: the decoder self-attention of
# fairseq's transformer_wmt_en_de_big (embed 1024, 16 heads, 6 decoder
# layers, attention_dropout 0.1, the future mask over padded target
# sentences) in a batch of --max-tokens 3584 (Ott et al., "Scaling Neural
# Machine Translation", 2018): 28 sentences of 128 positions, 96-128 real
# tokens each; the gate keeps every biased backward with dropout at s128 on
# the single pass: the forward's and the single pass's variants with both
MHA6_LAYERS, MHA6_B, MHA6_S, MHA6_MIN_LEN = 6, 28, 128, 96
MHA6_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP},
                 "flash_fwd_sm90_bias_dropout": MHA6_LAYERS,
                 "flash_bwd_fused_sm90_bias_dropout": MHA6_LAYERS,
                 "layer_norm_fwd": MHA6_LAYERS,
                 "layer_norm_bwd": MHA6_LAYERS}


def mha6_lengths(seed=6):
    """The real tokens of each of the wmt path's :data:`MHA6_B`
    sentences."""
    return np.random.RandomState(seed).randint(MHA6_MIN_LEN, MHA6_S + 1,
                                               MHA6_B)


def mha_stack(torch, layers, kw, heads=MHA_HEADS):
    """``layers`` ``SelfMultiheadAttn(1024, heads, **kw)`` on the card,
    their parameters from the flax initialisers' distributions (seed 0)."""
    from torch import nn
    from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
    gen = torch.Generator().manual_seed(0)
    return nn.ModuleList([SelfMultiheadAttn(MHA_E, heads, device="cuda",
                                            generator=gen, **kw)
                          for _ in range(layers)])


def mha_loss(stack, x, target, kpm, mask, generator=None, reference=False):
    """The stack in sequence over ``x`` [s, b, e], then the mean squared
    error against ``target`` in fp32. A layer with norm_add adds its own
    residual; one without is the attention sublayer alone, so the stack
    adds its output to its input, as a transformer composes it (18
    sublayers chained without a residual pass a vanishing signal, and no
    step could lower the loss)."""
    for layer in stack:
        y = layer(x, key_padding_mask=kpm, attn_mask=mask,
                  generator=generator, reference=reference)
        x = y if layer.include_norm_add else x + y
    return (x.float() - target).square().mean()


def mha_batch(torch, s, b, mask: bool, lens=None, dtype=None):
    """``(x, target, key_padding_mask, attn_mask)``: x from numpy seed 0 in
    ``dtype`` (bf16 when None), the target fp32 from seed 1; with ``mask``
    fairseq's future mask, with ``lens`` (each sequence's real tokens) the
    key padding."""
    x = torch.from_numpy(np.random.RandomState(0).randn(
        s, b, MHA_E).astype(np.float32)).cuda().to(dtype or torch.bfloat16)
    target = torch.from_numpy(np.random.RandomState(1).randn(
        s, b, MHA_E).astype(np.float32)).cuda()
    kpm = None
    if lens is not None:
        kpm = (torch.arange(s, device="cuda")[None]
               >= torch.from_numpy(lens).cuda()[:, None])
    return x, target, kpm, future_mask(torch, s) if mask else None


def run_mha_path(torch, kw, s, b, per_step, what, mask, lens=None,
                 layers=MHA_LAYERS, heads=MHA_HEADS, lr=LR, opt_level="O2"):
    """The ``FusedAdam`` step (``amp.make_train_step``) at ``opt_level``
    (O2: a dynamic scale and a bf16 batch; O0: fp32 throughout) of a
    ``layers``-layer stack of ``heads`` heads over :func:`mha_batch`'s
    batch: a warm-up, then :data:`MHA_STEPS` timed steps with the counters
    reset just before, 2 traced; finite, falling losses and each kernel's
    launches a step as ``per_step`` has them. Attention dropout from one
    host generator."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam
    stack = mha_stack(torch, layers, kw, heads)
    o2 = opt_level == "O2"
    amp_model, opt = amp.initialize(stack, FusedAdam(lr=lr),
                                    opt_level=opt_level, verbosity=0,
                                    **(dict(loss_scale="dynamic") if o2
                                       else {}))
    amp_model.cast_params()
    state = opt.init(stack.parameters())
    sstate = opt._scaler.state
    gen = torch.Generator().manual_seed(DROP_GEN_SEED)
    step = amp.make_train_step(
        lambda m, x, t, kpm, mask: mha_loss(m, x, t, kpm, mask, gen), opt)
    batch = mha_batch(torch, s, b, mask, lens,
                      None if o2 else torch.float32)
    _, state, sstate, _ = step(stack, state, sstate, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counters()
    for _ in range(MHA_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(stack, state, sstate, *batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite {what} loss: {losses}")
    check(losses[-1] < losses[0], f"{what} loss did not fall: {losses}")
    for k, per in per_step.items():
        check(launches[k] == per * MHA_STEPS,
              f"{what} {k}: {launches[k]} launches, expected "
              f"{per * MHA_STEPS}")
    ms = [1e3 * t for t in times]
    box = [state, sstate]

    def one():
        _, box[0], box[1], _ = step(stack, box[0], box[1], *batch)

    trace = _profile(torch, one, 2)
    stats = dict(layers=layers, embed=MHA_E, heads=heads, batch=b, lr=lr,
                 seq=s, opt_level=opt_level, module_options=kw,
                 steps=MHA_STEPS, losses=losses,
                 step_ms_median=float(np.median(ms)),
                 step_ms_p90=float(np.percentile(ms, 90)), step_ms_all=ms,
                 tokens_per_s=b * s / (np.median(ms) / 1e3),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=launches, trace=trace)
    del stack, opt, state, sstate, step, box
    torch.cuda.empty_cache()
    return stats


def run_mha_bias_path(torch):
    return run_mha_path(torch, MHA_BIAS_KW, MHA_S, MHA_B, MHA_BIAS_PER_STEP,
                        "train-mha18-bias", True, mha_lengths())


def run_mha_dropout_path(torch):
    return run_mha_path(torch, MHA_DROP_KW, MHA_DROP_S, MHA_DROP_B,
                        MHA_DROP_PER_STEP, "train-mha18-dropout", False)


def run_mha16_path(torch):
    """train-mha16-e1024h8-b1s3072-bias: one 3072-token sample a step with
    no padding (``--sample-break-mode none``) under the future mask."""
    return run_mha_path(torch, MHA_BIAS_KW, MHA16_S, MHA16_B, MHA16_PER_STEP,
                        "train-mha16-s3072-bias", True,
                        layers=MHA16_LAYERS, heads=MHA16_HEADS, lr=MHA16_LR)


def run_mha16_dropout_path(torch):
    """train-mha16-e1024h8-b1s3072-bias-dropout: the train-mha16 path at
    attention dropout 0.1, one host generator for the attention seeds and
    the residual dropout's masks."""
    return run_mha_path(torch, MHA_BIAS_DROP_KW, MHA16_S, MHA16_B,
                        MHA16_DROP_PER_STEP, "train-mha16-s3072-bias-dropout",
                        True, layers=MHA16_LAYERS, heads=MHA16_HEADS,
                        lr=MHA16_LR)


def run_mha6_path(torch):
    """train-mha6-e1024h16-b28s128-bias-dropout: 6 layers over one
    3584-token batch of 28 padded sentences under the future mask at
    dropout 0.1, one host generator for the attention seeds and the
    residual dropout's masks."""
    from apex_tpu_torch.ops import flash_attention as fa
    check(not fa.uses_split_backward(MHA6_S, MHA6_S, MHA_E // MHA_HEADS,
                                     bias=True, dropout=True),
          f"the gate at s{MHA6_S} with a bias and dropout: not the single "
          "pass")
    return run_mha_path(torch, MHA_BIAS_DROP_KW, MHA6_S, MHA6_B,
                        MHA6_PER_STEP, "train-mha6-s128-bias-dropout", True,
                        mha6_lengths(), layers=MHA6_LAYERS)


def _twin_grads(torch, what, params, loss_of, loss_tol=GRAD_LOSS_TOL,
                norm_tol=GRAD_NORM_TOL):
    """The loss and every gradient (``params``: name -> tensor) through the
    kernels against the plain versions (``loss_of(reference)``): loss
    ``loss_tol`` (:data:`GRAD_LOSS_TOL`), each gradient ``norm_tol``
    (:data:`GRAD_NORM_TOL`) in relative norm."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    names, ts = zip(*params.items())
    loss = loss_of(False)
    grads = torch.autograd.grad(loss, ts)
    ref_loss = loss_of(True)
    ref = torch.autograd.grad(ref_loss, ts)
    loss, ref_loss = loss.detach(), ref_loss.detach()
    dloss = abs(float(loss) - float(ref_loss))
    check(dloss <= loss_tol, f"{what}: loss kernels {float(loss)} vs "
          f"plain {float(ref_loss)}")
    worst = []
    for name, g, r in zip(names, grads, ref):
        rel = ((g.float() - r.float()).norm()
               / r.float().norm().clamp_min(1e-30)).item()
        worst.append((rel, name))
        check(rel <= norm_tol, f"{what} grad {name}: relative norm "
              f"error {rel}")
    worst.sort(reverse=True)
    return dict(loss_kernels=float(loss), loss_plain=float(ref_loss),
                loss_abs_diff=dloss, grads=len(names),
                worst_rel_norm=worst[:5],
                median_rel_norm=float(np.median([w for w, _ in worst])),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)


def _bias_routes(fa):
    """The bias variants' counters: the forward's, the single pass's and
    the split's two; then the variants with dropout too: the forward's,
    the split's two and the single pass's."""
    f, g = fa.flash_attention, fa.flash_attention_bwd
    return (f.bias_launches, g.bias_launches, g.bias_dkdv_launches,
            g.bias_dq_launches, f.bias_dropout_launches,
            g.bias_dropout_dkdv_launches, g.bias_dropout_dq_launches,
            g.bias_dropout_fused_launches)


# :func:`_bias_routes` of one attention: the single pass with the bias, the
# split with the bias, the split with the bias and dropout, the single pass
# with both, and none
ROUTES_SINGLE = (1, 1, 0, 0, 0, 0, 0, 0)
ROUTES_SPLIT = (1, 0, 1, 1, 0, 0, 0, 0)
ROUTES_BOTH = (0, 0, 0, 0, 1, 1, 1, 0)
ROUTES_SINGLE_BOTH = (0, 0, 0, 0, 1, 0, 0, 1)
ROUTES_NONE = (0,) * 8
_ROUTE_NAMES = ("(forward, single pass, split dk/dv, split dq; with dropout: "
                "forward, split dk/dv, split dq, single pass)")


def _encdec_grad_check(torch, fa, what, sq, sk, b, routes, dropout=0.0):
    """One ``EncdecMultiheadAttn(1024, 16, dropout=dropout)`` at sq x sk,
    batch ``b``, with a finite [b, 1, sq, sk] bias and key padding of sk /
    2 to sk tokens (in training where ``dropout``, a host generator in the
    same state on both sides): its inputs' and parameters' gradients
    through the kernels against ``reference=True``; ``routes`` the bias
    variants' launches (:func:`_bias_routes`) the kernels' run must
    make."""
    from apex_tpu_torch.contrib.multihead_attn import EncdecMultiheadAttn
    gen = torch.Generator(device="cuda").manual_seed(23)
    m = EncdecMultiheadAttn(MHA_E, MHA_HEADS, dropout=dropout, use_bias=True,
                            include_norm_add=True, device="cuda",
                            generator=torch.Generator().manual_seed(1))
    m = m.bfloat16()
    xq = torch.randn(sq, b, MHA_E, generator=gen, device="cuda").bfloat16()
    xk = torch.randn(sk, b, MHA_E, generator=gen, device="cuda").bfloat16()
    bias = torch.randn(b, 1, sq, sk, generator=gen, device="cuda")
    lens = torch.from_numpy(np.random.RandomState(2).randint(
        sk // 2, sk + 1, b)).cuda()
    kpm = torch.arange(sk, device="cuda")[None] >= lens[:, None]
    target = torch.randn(sq, b, MHA_E, generator=gen, device="cuda")
    params = {"query": xq.requires_grad_(), "key": xk.requires_grad_(),
              **dict(m.named_parameters())}
    n0 = _bias_routes(fa)

    def loss_of(reference):
        y = m(xq, xk, key_padding_mask=kpm, attn_mask=bias,
              is_training=dropout > 0, reference=reference,
              generator=torch.Generator().manual_seed(DROP_GEN_SEED + 4))
        return (y.float() - target).square().mean()

    out = _twin_grads(torch, what, params, loss_of)
    moved = tuple(a - b_ for a, b_ in zip(_bias_routes(fa), n0))
    check(moved == routes, f"{what}: bias launches {_ROUTE_NAMES} {moved}, "
          f"expected {routes}")
    out["shape"] = (f"sq{sq} sk{sk} b{b} e{MHA_E} h{MHA_HEADS}, bias [{b}, "
                    f"1, {sq}, {sk}], key padding, dropout {dropout}")
    del m, params
    torch.cuda.empty_cache()
    return out


def mha_grad_checks(torch):
    """The 2-layer full-width grad checks (the depth cut; the width is the
    paths'): each configuration's stack, cast to bf16 as O2 casts it,
    through the kernels against ``reference=True`` with a host generator in
    the same state on both sides — the train-mha18 paths' two, the
    train-mha16 path's at s3072 (d 128: the split's bias variants over
    unmasked tiles), and ``SelfMultiheadAttn(1024, 16)`` at b8 s1024 with
    the future mask and key padding of 768-1024 tokens (d 64: masked
    tiles; the gate splits only for the bias); and
    ``EncdecMultiheadAttn(1024, 16)`` at sq 256, sk 512, b16 (the single
    pass) and at sq 512, sk 1024, b16 (sq != sk on the split), each with a
    finite [16, 1, sq, sk] bias and key padding, its inputs' and
    parameters' gradients; then with the bias and dropout 0.1 together
    (the forward's and the split's variants with both): the train-mha16
    path's configuration at s3072 (d 128), ``SelfMultiheadAttn(1024, 16)``
    at b16 s512 with the future mask and key padding of 384-512 tokens
    (d 64: the gate splits s512 with both) and ``EncdecMultiheadAttn(1024,
    16)`` at sq 512, sk 1024, b16; and on the single pass's variant with
    both, the train-mha6 path's configuration (b28 s128, the future mask,
    key padding of 96-128 tokens) and ``EncdecMultiheadAttn(1024, 16)`` at
    sq 256, sk 384, b16. Each check asserts which bias variants ran."""
    from apex_tpu_torch.ops import flash_attention as fa
    out = {}
    lens1024 = np.random.RandomState(5).randint(768, 1025, 8)
    for name, kw, s, b, heads, mask, lens, routes in (
            ("bias", MHA_BIAS_KW, MHA_S, MHA_B, MHA_HEADS, True,
             mha_lengths(), ROUTES_SINGLE),
            ("dropout", MHA_DROP_KW, MHA_DROP_S, MHA_DROP_B, MHA_HEADS,
             False, None, ROUTES_NONE),
            ("bias-s3072-h8", MHA_BIAS_KW, MHA16_S, MHA16_B, MHA16_HEADS,
             True, None, ROUTES_SPLIT),
            ("bias-s1024-h16", MHA_BIAS_KW, 1024, 8, MHA_HEADS, True,
             lens1024, ROUTES_SPLIT),
            ("bias-dropout-s3072-h8", MHA_BIAS_DROP_KW, MHA16_S, MHA16_B,
             MHA16_HEADS, True, None, ROUTES_BOTH),
            ("bias-dropout-s512-h16", MHA_BIAS_DROP_KW, MHA_S, MHA_B,
             MHA_HEADS, True, mha_lengths(), ROUTES_BOTH),
            ("bias-dropout-s128-h16-b28", MHA_BIAS_DROP_KW, MHA6_S, MHA6_B,
             MHA_HEADS, True, mha6_lengths(), ROUTES_SINGLE_BOTH)):
        stack = mha_stack(torch, MHA_GRAD_LAYERS, kw, heads).bfloat16()
        batch = mha_batch(torch, s, b, mask, lens)

        def loss_of(reference):
            gen = torch.Generator().manual_seed(DROP_GEN_SEED + 3)
            return mha_loss(stack, *batch, generator=gen,
                            reference=reference)

        n0 = _bias_routes(fa)
        out[name] = _twin_grads(torch, f"mha grad check {name}",
                                dict(stack.named_parameters()), loss_of)
        moved = tuple(a - b_ for a, b_ in zip(_bias_routes(fa), n0))
        want = tuple(MHA_GRAD_LAYERS * r for r in routes)
        check(moved == want, f"mha grad check {name}: bias launches "
              f"{_ROUTE_NAMES} {moved}, expected {want}")
        out[name]["shape"] = f"s{s} b{b} h{heads}, dropout {kw['dropout']}"
        del stack, batch
    out["encdec"] = _encdec_grad_check(torch, fa, "encdec grad check", 256,
                                       512, MHA_B, ROUTES_SINGLE)
    out["encdec-sq512-sk1024"] = _encdec_grad_check(
        torch, fa, "encdec grad check sq512 sk1024", 512, 1024, MHA_B,
        ROUTES_SPLIT)
    out["encdec-sq512-sk1024-dropout"] = _encdec_grad_check(
        torch, fa, "encdec grad check sq512 sk1024 dropout", 512, 1024,
        MHA_B, ROUTES_BOTH, dropout=DROPOUT_RATE)
    check(not fa.uses_split_backward(256, 384, MHA_E // MHA_HEADS,
                                     bias=True, dropout=True),
          "the gate at sq256 sk384 with a bias and dropout: not the single "
          "pass")
    out["encdec-sq256-sk384-dropout"] = _encdec_grad_check(
        torch, fa, "encdec grad check sq256 sk384 dropout", 256, 384,
        MHA_B, ROUTES_SINGLE_BOTH, dropout=DROPOUT_RATE)
    return out


# ---------------------------------------------------------------------------
# ResNet-50 O2 training (bench.py's _build_step): FusedSGD, label-smoothed
# softmax cross entropy through the fused kernels, b256 224x224
# ---------------------------------------------------------------------------

RN_B, RN_STEPS = 256, 8
RN_PER_STEP = {k: 0 for k in TRAIN_PER_STEP}
RN_PER_STEP.update(xentropy_fwd=1, xentropy_bwd=1)


def rn50_batch(torch):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(RN_B, 3, 224, 224).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, RN_B).astype(np.int64))
    return (x.cuda().contiguous(memory_format=torch.channels_last),
            y.cuda())


def rn50_setup(torch):
    """The bench's recipe: ResNet50(dtype=bf16) -> amp.initialize(O2,
    FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)) -> cast_params ->
    opt.init -> make_train_step over mean(softmax_cross_entropy_with_
    smoothing(logits, y, 0.1)). Random weights from seed 0, channels-last
    layout for the convs."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import ResNet50
    from apex_tpu_torch.ops import softmax_cross_entropy_with_smoothing
    from apex_tpu_torch.optimizers import FusedSGD
    model = ResNet50.init_params(num_classes=1000, dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cuda")
    model = model.to(memory_format=torch.channels_last)
    amp_model, opt = amp.initialize(
        model, FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4),
        opt_level="O2", verbosity=0)
    amp_model.cast_params()
    for name, p in model.named_parameters():
        want = torch.float32 if "_BNWrap" in name else torch.bfloat16
        check(p.dtype == want, f"O2 cast: {name} is {p.dtype}")
    check(all(b.dtype == torch.float32 for b in model.buffers()),
          "O2 cast: a running statistic is not fp32")
    state = opt.init(model.parameters())

    def loss_fn(m, x, y):
        return softmax_cross_entropy_with_smoothing(amp_model(x), y,
                                                    0.1).mean()

    return model, amp_model, opt, state, loss_fn


def run_rn50_path(torch):
    from apex_tpu_torch import amp
    # cuDNN picks its conv algorithms in the warm-up step
    torch.backends.cudnn.benchmark = True
    model, amp_model, opt, state, loss_fn = rn50_setup(torch)
    step = amp.make_train_step(loss_fn, opt)
    x, y = rn50_batch(torch)
    sstate = opt._scaler.state
    # warm-up: cuDNN's algorithm search and Triton's compiles stay out
    _, state, sstate, _ = step(model, state, sstate, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counters()
    for _ in range(RN_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(model, state, sstate, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite ResNet-50 loss: {losses}")
    for k, per in RN_PER_STEP.items():
        check(launches[k] == per * RN_STEPS,
              f"train-rn50 {k}: {launches[k]} launches, expected "
              f"{per * RN_STEPS}")
    check(all(p.dtype == torch.float32 for n, p in model.named_parameters()
              if "_BNWrap" in n)
          and all(b.dtype == torch.float32 for b in model.buffers()),
          "ResNet-50: batch-norm params or statistics are not fp32")
    ms = [1e3 * t for t in times]
    stats = dict(steps=RN_STEPS, batch=RN_B, image=224, losses=losses,
                 loss_scale=float(sstate.loss_scale),
                 step_ms_median=float(np.median(ms)),
                 step_ms_p90=float(np.percentile(ms, 90)), step_ms_all=ms,
                 images_per_s=RN_B / (np.median(ms) / 1e3),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=launches)
    box = [state, sstate]

    def one():
        _, box[0], box[1], _ = step(model, box[0], box[1], x, y)

    trace_rn = _profile(torch, one, 2)
    return model, amp_model, opt, box[0], stats, trace_rn


# ResNet-50 step through the kernels vs through the plain twin, same
# params, deterministic cuDNN: the logits are identical, so the losses
# differ only by the fp32 CE (kernel vs twin, equal in both readings on the
# H100) and the gradients by the last-bit differences of the fp32 logits'
# gradient, which flip bf16 roundings that 53 bf16 conv and batch-norm
# backwards carry on. Per-parameter relative norm, read in three runs at
# worst 5.9 %, 6.8 % and 9.6 % (each time the stem batch norm's bias, whose
# gradient sums the whole stem activation; every other parameter <= 1.5 %)
# and at median 0.97-0.99 %: held at 25 % for the worst and 3 % for the
# median
RN_LOSS_TOL = 1e-5
RN_GRAD_NORM_TOL = 0.25
RN_GRAD_MEDIAN_TOL = 0.03


def rn50_grad_check(torch, model, amp_model):
    from apex_tpu_torch.ops import fused_ce as xe
    x, y = rn50_batch(torch)
    params = list(model.named_parameters())
    bench, det = torch.backends.cudnn.benchmark, \
        torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        loss = xe.softmax_cross_entropy_with_smoothing(amp_model(x), y,
                                                       0.1).mean()
        grads = torch.autograd.grad(loss, [p for _, p in params])
        ref_loss = xe.softmax_cross_entropy_reference(amp_model(x), y,
                                                      0.1).mean()
        ref = torch.autograd.grad(ref_loss, [p for _, p in params])
    finally:
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.deterministic = det
    loss, ref_loss = loss.item(), ref_loss.item()
    worst = sorted((((g.float() - r.float()).norm()
                     / r.float().norm().clamp_min(1e-30)).item(), name)
                   for (name, _), g, r in zip(params, grads, ref))[::-1]
    out = dict(loss_kernels=loss, loss_plain=ref_loss,
               loss_abs_diff=abs(loss - ref_loss), params=len(params),
               worst_rel_norm=worst[:5],
               median_rel_norm=float(np.median([w for w, _ in worst])))
    log("train-rn50 grad check readings: " + json.dumps(out))
    check(out["loss_abs_diff"] <= RN_LOSS_TOL,
          f"ResNet-50 loss kernels {loss} vs plain {ref_loss}")
    check(worst[0][0] <= RN_GRAD_NORM_TOL,
          f"ResNet-50 grad {worst[0][1]}: relative norm error {worst[0][0]}")
    check(out["median_rel_norm"] <= RN_GRAD_MEDIAN_TOL,
          f"ResNet-50 grads: median relative norm error "
          f"{out['median_rel_norm']}")
    return out


def rn50_overflow_check(torch, model, amp_model, opt, state):
    """A step whose loss overflows under a dynamic scale (the O2 default
    for bf16 is a static 1): masters, momentum buffers and their
    ``initialized`` flag bitwise unchanged, the scale halved."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.ops import softmax_cross_entropy_with_smoothing
    x, y = rn50_batch(torch)
    dyn = amp.LossScaler("dynamic", device="cuda")
    big = amp.make_train_step(
        lambda m, xx, yy: softmax_cross_entropy_with_smoothing(
            amp_model(xx), yy, 0.1).mean() * 1e38, opt, scaler=dyn)
    g = state.groups[0]
    before = (g.master.clone(), {k: v.clone() for k, v in g.slots.items()},
              int(g.step), [p.detach().clone() for p in model.parameters()])
    check(bool(g.slots["initialized"]), "momentum not initialized yet")
    scale0 = float(dyn.state.loss_scale)
    _, state2, sstate2, loss = big(model, state, dyn.state, x, y)
    torch.cuda.synchronize()
    g2 = state2.groups[0]
    check(torch.equal(g2.master, before[0]), "RN50 overflow: master changed")
    for k, v in before[1].items():
        check(g2.slots[k].dtype == v.dtype and torch.equal(g2.slots[k], v),
              f"RN50 overflow: {k} changed")
    check(int(g2.step) == before[2], "RN50 overflow: step counter moved")
    check(all(torch.equal(p, b) for p, b in zip(model.parameters(),
                                                before[3])),
          "RN50 overflow: model params changed")
    check(bool(sstate2.overflow), "RN50 overflow: not detected")
    check(float(sstate2.loss_scale) == scale0 / 2,
          "RN50 overflow: scale not halved")
    return dict(loss=float(loss), scale_before=scale0,
                scale_after=float(sstate2.loss_scale), step=int(g2.step))


# ---------------------------------------------------------------------------
# the repaired shapes and dtypes (ROADMAP §C): each kernel at what the JAX
# package computes and the port raised on before
# ---------------------------------------------------------------------------

# 16-bit flash outputs: two ulps of the dtype (bf16 ulps bound fp16's) plus
# the 4e-3 floor of the bf16 checks (p is rounded to the operands' dtype
# before the PV product); fp32: both sides fp32, the kernel's exponentials
# are __expf (2 ulps) and its sums run in another order
FP32_FWD_TOL = 1e-5
# fp32 gradients: relative norm and largest-value fraction (no rounding of
# p or ds in fp32, so only summation order and __expf)
FP32_GRAD_TOL = 1e-4


def _fp32_err(got, ref, what, tol):
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    lim = tol * max(ref.abs().max().item(), 1.0)
    check(diff.max().item() <= lim, f"{what}: max err {diff.max().item()} "
          f"> {lim}")
    rel = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    check(rel <= tol, f"{what}: relative norm error {rel} > {tol}")
    return diff.max().item()


def check_flash_repairs(torch):
    """Flash forward and backward (single pass and split) at fp16 and
    fp32, at head dims 80, 96 and 256 (padded to 128 and run at 256), past
    256 (320 padded to 512, and 512: the contraction staged in chunks) and
    fp32 past 128; and over q, k, v of mixed dtypes (promoted, p and ds
    rounded as the JAX kernels round them)."""
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [((bf,) * 3, 80), ((bf,) * 3, 96), ((bf,) * 3, 256),
             ((f16,) * 3, 64), ((f16,) * 3, 128), ((f16,) * 3, 256),
             ((f32,) * 3, 64), ((f32,) * 3, 128), ((f32,) * 3, 256),
             ((bf,) * 3, 320), ((bf,) * 3, 512), ((f16,) * 3, 512),
             ((f32,) * 3, 512), ((f32, bf, bf), 64), ((bf, f32, f32), 64),
             ((bf, bf, f16), 64)]
    out = []
    for dtypes, d in cases:
        b, h, s = 2, 4, 300
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                                   dtype=dt)
                       for dt in (*dtypes, dtypes[0]))
        dtype = dtypes[0] if len(set(dtypes)) == 1 else None
        f0 = fa.flash_attention.launches
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        ro, rl = fa.flash_attention_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        check(fa.flash_attention.launches == f0 + 1, "flash repair: no "
              "kernel launch")
        dnames = "/".join(str(dt)[6:] for dt in dtypes) if dtype is None \
            else str(dtype)[6:]
        name = f"flash {dnames} d{d}"
        rec = dict(dtype=dnames, d=d, shape=f"b{b} h{h} s{s} causal",
                   kernel_head_dim=fa.kernel_head_dim(d))
        check(o.dtype == dtypes[0], f"{name}: output dtype {o.dtype}")
        if dtype == torch.float32:
            rec["fwd_err"] = _fp32_err(o, ro, name, FP32_FWD_TOL)
        else:
            rec["fwd_err"] = bf16_err(o, ro, 4e-3, name)
        check((lse - rl).abs().max().item() <= 1e-3, f"{name} lse")
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                               causal=True)
        for split in (False, True):
            grads = fa._flash_bwd_cuda(q, k, v, o, lse, do, None, None, True,
                                       d ** -0.5, split=split)
            torch.cuda.synchronize()
            errs = []
            for gname, g, r in zip(("dq", "dk", "dv"), grads, ref):
                what = f"{name} {'split' if split else 'single'} {gname}"
                errs.append(_fp32_err(g, r, what, FP32_GRAD_TOL)
                            if dtype == torch.float32
                            else grad_err(g, r, what))
            rec["bwd_split_err" if split else "bwd_err"] = max(errs)
        out.append(rec)
    return out


def check_paged_repairs(torch):
    """Paged decode at GQA group 16 (chunks of 8 rows) in the bf16 and the
    e4m3 pool mode, with fp16 and fp32 queries over pools of their dtype
    and over e4m3, at head dims 80, 96, 100 (masked loads), 256 and 512 in
    both pool modes (the pool read in place), and with queries over a
    pool of another dtype."""
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    out = []
    for dtype, g, pool, d in ((bf, 16, bf, 64), (bf, 16, "e4m3", 64),
                              (f16, 16, f16, 64), (f16, 4, "e4m3", 64),
                              (f32, 16, f32, 64), (f32, 2, "e4m3", 64),
                              (bf, 4, bf, 80), (bf, 4, "e4m3", 80),
                              (bf, 4, bf, 96), (bf, 4, "e4m3", 96),
                              (bf, 4, bf, 100), (f32, 4, "e4m3", 100),
                              (bf, 4, bf, 256), (bf, 4, "e4m3", 256),
                              (bf, 8, bf, 512), (bf, 8, "e4m3", 512),
                              (f32, 4, bf, 64), (bf, 4, f32, 64)):
        fp8 = pool == "e4m3"
        b, kv, page, m, num_pages = 4, 4, 128, 8, 40
        q, kp, vp, bt, sl = _paged_inputs(torch, gen, b, kv, g, d, page, m,
                                          num_pages, [0, 129, 640, 1024])
        q = q.to(dtype)
        ks = vs = None
        if fp8:
            kp, ks = _fp8_pool(torch, gen, kv, num_pages, page, d)
            vp, vs = _fp8_pool(torch, gen, kv, num_pages, page, d)
        else:
            kp, vp = kp.to(pool), vp.to(pool)
        got = fa.paged_decode_attention(q, kp, vp, bt, sl, k_scales=ks,
                                        v_scales=vs)
        ref = fa.paged_attention_reference(q, kp, vp, bt, sl, k_scales=ks,
                                           v_scales=vs)
        torch.cuda.synchronize()
        pname = "e4m3" if fp8 else str(pool)[6:]
        name = f"paged {str(dtype)[6:]} over {pname} d{d} group {g}"
        # p and the accumulators are fp32 in both: the output rounding
        err = (_fp32_err(got, ref, name, FP32_FWD_TOL)
               if dtype == torch.float32 else bf16_err(got, ref, 1e-3, name))
        check(got[0].abs().max().item() == 0.0, f"{name}: dead slot")
        out.append(dict(dtype=str(dtype)[6:], pool=pname, d=d, group=g,
                        max_abs_err=err))
    return out


def check_lm_head_ce_repairs(torch):
    """The LM-head CE forward and backward at other hidden sizes (64: the
    tests' tiny GPT; 100, 1536, 1600, 2048), fp16, and fp32 (the FFMA
    route at h 64, 100, 1024, 1536, 2048 and a ragged 1000 x 1003 x 1601),
    at the GPT's vocabulary, held at the CE limits of PERF.md §2, the fp32
    route's backward bitwise on a rerun."""
    from apex_tpu_torch.ops import lm_head_ce as ce
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = []
    for dtype, h, n, V in ((torch.bfloat16, 64, 1024, 32768),
                           (torch.bfloat16, 100, 1024, 32768),
                           (torch.bfloat16, 1536, 1024, 32768),
                           (torch.bfloat16, 1600, 1024, 32768),
                           (torch.bfloat16, 2048, 1024, 32768),
                           (torch.float16, 1024, 1024, 32768),
                           (torch.float32, 64, 1024, 32768),
                           (torch.float32, 100, 1024, 32768),
                           (torch.float32, 1024, 1024, 32768),
                           (torch.float32, 1536, 1024, 32768),
                           (torch.float32, 2048, 1024, 32768),
                           (torch.float32, 1601, 1000, 1003)):
        x = torch.randn(n, h, generator=gen, device="cuda").to(dtype)
        e = (0.02 * torch.randn(V, h, generator=gen, device="cuda")).to(
            dtype)
        tgt = torch.randint(0, V, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        dl = torch.full((n,), 1.0 / n, device="cuda")
        name = f"lm_head_ce {str(dtype)[6:]} h{h}"
        got = ce.lm_head_ce_fwd(x, e, tgt, True)
        ref = ce.lm_head_ce_fwd_reference(x, e, tgt, True)
        torch.cuda.synchronize()
        fwd = 0.0
        for sname, a, r in zip(("m", "l", "pred", "ssum"), got, ref):
            err = (a - r).abs().max().item()
            check(err <= 1e-4 * (r.abs().max().item() + 1.0),
                  f"{name} fwd {sname} max err {err}")
            fwd = max(fwd, err)
        dx, de = ce.lm_head_ce_bwd(x, e, tgt, ref[0], ref[1], dl, 0.1)
        rx, re = ce.lm_head_ce_bwd_reference(x, e, tgt, ref[0], ref[1], dl,
                                             0.1)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            bwd = max(_fp32_err(dx, rx, f"{name} dx", FP32_GRAD_TOL),
                      _fp32_err(de, re, f"{name} dE", FP32_GRAD_TOL))
            dx2, de2 = ce.lm_head_ce_bwd(x, e, tgt, ref[0], ref[1], dl, 0.1)
            check(torch.equal(dx, dx2) and torch.equal(de, de2),
                  f"{name}: two runs of the backward differ")
        else:
            bwd = max(grad_err(dx, rx, f"{name} dx"),
                      grad_err(de, re, f"{name} dE"))
        hp = ce.f32_hidden(h) if dtype == torch.float32 \
            else ce.wgmma_hidden(h)
        out.append(dict(dtype=str(dtype)[6:], h=h, n=n, V=V, padded_h=hp,
                        fwd_err=fwd, bwd_err=bwd))
    return out


def check_fp8_repairs(torch):
    """The fp8 dequant-matmul at K = N = 1000 (zero-padded to 1008) in the
    decode and the prefill regime."""
    from apex_tpu_torch.ops import fp8_matmul as mm
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = []
    for m in (8, 512):
        K = N = 1000
        x = torch.randn(m, K, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
        q, scale = mm.quantize_weight(w)
        y = mm.fp8_dequant_matmul(x, q, scale)
        ref = mm.fp8_dequant_matmul_reference(x, q, scale)
        torch.cuda.synchronize()
        check(y.shape == (m, N), f"fp8 K=N=1000: shape {tuple(y.shape)}")
        out.append(dict(m=m, K=K, N=N, max_abs_err=bf16_err(
            y, ref, 1e-3, f"fp8_matmul m{m} K{K} N{N}")))
    return out


def check_repairs(torch):
    return dict(flash=check_flash_repairs(torch),
                paged_decode=check_paged_repairs(torch),
                lm_head_ce=check_lm_head_ce_repairs(torch),
                fp8_matmul=check_fp8_repairs(torch))


# ---------------------------------------------------------------------------
# B15, the fused bottleneck, and B14, the per-op probe: kernel phase
# ---------------------------------------------------------------------------

# the fused bottleneck against its plain version, both bf16 with the same
# rounding points: two bf16 ulps plus a floor of 2^-5 — h1 and h2 are
# rounded to bf16 in both, and one h2 value rounded the other way (an fp32
# sum in another order) moves an output by |w3| times its ulp, summed over
# the flips of a pixel
BOTTLENECK_FLOOR = 2.0 ** -5
BOTTLENECK_LIB_TOL = 0.15          # the proto's own limit against XLA


def _bottleneck_registers(build):
    """``ptxas -v``'s registers and spill bytes of ``bottleneck_kernel``;
    fails on a spill."""
    regs = {}
    for line in build.library_path("bottleneck").with_suffix(".log") \
            .read_text().splitlines():
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            regs["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs["registers"] = int(m.group(1))
    check(regs.get("spill_bytes") == 0,
          f"bottleneck_kernel: ptxas spills {regs.get('spill_bytes')} bytes")
    return regs


def check_bottleneck(torch, timer):
    """B15 at N 32 against its plain version and the cuDNN composition;
    bitwise on a rerun; n 3 against the plain version; each image of an n 5
    batch bitwise the same image alone; one device launch a call
    (profiler); no spill."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.scripts import bottleneck_proto as bp
    p = bp.make_params(device="cuda")
    x = bp.make_input(bp.N, device="cuda")
    wts = bp.cudnn_weights(p)
    y = bp.fused_block(x, p)
    ref = bp.plain_block(x, p)
    lib = bp.cudnn_block(x, p, wts)
    torch.cuda.synchronize()
    err = bf16_err(y, ref, BOTTLENECK_FLOOR, "bottleneck vs plain")
    lib_err = (y.float() - lib.float()).abs().max().item()
    check(lib_err < BOTTLENECK_LIB_TOL, f"bottleneck vs the cuDNN "
          f"composition: {lib_err} >= {BOTTLENECK_LIB_TOL}")
    check(bool(torch.isfinite(y.float()).all()), "bottleneck: non-finite")
    check(torch.equal(y, bp.fused_block(x, p)),
          "bottleneck: a rerun is not bitwise the first call")
    del ref, lib
    x3 = bp.make_input(3, device="cuda")
    err3 = bf16_err(bp.fused_block(x3, p), bp.plain_block(x3, p),
                    BOTTLENECK_FLOOR, "bottleneck n 3 vs plain")
    x5 = bp.make_input(5, device="cuda")
    y5 = bp.fused_block(x5, p)
    for i in range(5):
        check(torch.equal(y5[i:i + 1],
                          bp.fused_block(x5[i:i + 1].contiguous(), p)),
              f"bottleneck: image {i} of n 5 differs alone")
    launches = device_launches(torch, bp.fused_block, (x, p),
                               ("bottleneck_kernel",))
    check(launches == {"bottleneck_kernel": 1, "other": 0},
          f"bottleneck: device launches {launches}")
    ms = timer(lambda: bp.fused_block(x, p))
    plain_ms = timer(lambda: bp.plain_block(x, p), iters=10)
    lib_ms = timer(lambda: bp.cudnn_block(x, p, wts))
    px = bp.N * bp.H * bp.W
    flops = 2.0 * px * (bp.C * bp.S + 9 * bp.S * bp.S + bp.S * bp.C)
    nbytes = 2 * px * bp.C * 2 + sum(t.numel() * 2 for t in p.values())
    t_bound, by = bound(flops, nbytes)
    return dict(name="bottleneck", route="cuda",
                source="apex_tpu_torch/csrc/bottleneck.cu",
                replaces="scripts/bottleneck_proto.py:89",
                shape=f"x [{bp.N}, {bp.H}, {bp.W}, {bp.C}] NHWC bf16, "
                      f"squeeze {bp.S}, folded batch norms",
                max_abs_err=err,
                tolerance=f"2 bf16 ulp + {BOTTLENECK_FLOOR} vs plain; < "
                          f"{BOTTLENECK_LIB_TOL} vs the cuDNN composition",
                cudnn_composition_max_abs_err=lib_err,
                checked="bitwise on a rerun; n 3 vs plain (max err "
                        f"{err3:.3g}); each image of n 5 bitwise alone",
                device_launches_per_call=launches,
                plan=dict(vars(bp.bottleneck_plan(bp.N))),
                registers=_bottleneck_registers(_build),
                ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                library_ms=lib_ms,
                library="three channels_last bf16 F.conv2d with the folded "
                        "batch norms, ReLUs and residual as bf16 "
                        "elementwise ops")


def check_vpu_probe(torch, timer):
    """Each op's one launch against the plain loop on the same [64, 512,
    512] input: mul, max, where, iota_cmp_where bitwise; exp, exp2 within
    2 fp32 ulps (CUDA's expf/exp2f against torch's; read 0). The record's
    times are the six launches' sums, its bound the larger of their bytes
    and their operations summed; ``by_op`` has each op's."""
    from apex_tpu_torch.scripts import vpu_probe as vp
    x = torch.from_numpy(np.random.RandomState(0).randn(
        64, vp.BQ, vp.BK).astype(np.float32)).cuda()
    by_op = {}
    for op in vp.OPS:
        got = vp.vpu_probe_kernel(x, op)
        ref = vp.vpu_probe_reference(x, op)
        torch.cuda.synchronize()
        ulps = (got.view(torch.int32).long()
                - ref.view(torch.int32).long()).abs().max().item()
        check(ulps <= (2 if op in ("exp", "exp2") else 0),
              f"vpu_probe {op}: {ulps} ulps from the plain loop")
        b = vp.bounds(op)
        by_op[op] = dict(max_ulps=ulps,
                         max_abs_err=(got - ref).abs().max().item(),
                         ms=timer(lambda: vp.vpu_probe_kernel(x, op)),
                         plain_ms=timer(lambda: vp.vpu_probe_reference(x, op),
                                        iters=5),
                         bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                         bytes_ms=b["bytes_ms"], ops_ms=b["ops_ms"],
                         issue=b["issue"], rate_per_s=b["rate_per_s"])
        del got, ref
    total = {k: sum(r[k] for r in by_op.values())
             for k in ("ms", "plain_ms", "bytes_ms", "ops_ms")}
    # the six launches' bytes at the HBM rate against their operations at
    # their units' rates (fp32 lanes, or the SFUs for exp and exp2)
    t_bound = max(total["bytes_ms"], total["ops_ms"])
    by = "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations"
    return dict(name="vpu_probe", route="cuda",
                source="apex_tpu_torch/csrc/vpu_probe.cu",
                replaces="scripts/vpu_probe.py:18",
                shape="x [64, 512, 512] fp32, 64 applications; ms, plain_ms "
                      "and bound_ms cover one launch of each of the six ops",
                max_abs_err=max(r["max_abs_err"] for r in by_op.values()),
                tolerance="bitwise (mul, max, where, iota_cmp_where); 2 fp32 "
                          "ulp (exp, exp2)",
                ms=total["ms"], plain_ms=total["plain_ms"],
                bound_ms=t_bound, bound_by=by,
                library_ms=None,
                library="no single PyTorch call applies an op 64 times",
                sm_clock_hz=vp.sm_clock_hz(), by_op=by_op)


# ---------------------------------------------------------------------------
# the new paths: B14's probe, B15 at the proto's shape, SpatialBottleneck at
# world 1, the O0 GPT step
# ---------------------------------------------------------------------------

def run_probe_path(torch):
    """The probe script's run: each of the six ops chained 16 times over
    [64, 512, 512] and summed, timed as the script times it."""
    from apex_tpu_torch.scripts import vpu_probe as vp
    reset_counters()
    res = {op: vp.probe(op) for op in vp.OPS}
    launches = read_counters()
    # probe: one warm-up and five timed windows of scan_len launches
    check(launches["vpu_probe"] == len(vp.OPS) * 6 * 16,
          f"vpu probe path: {launches['vpu_probe']} launches")
    return dict(by_op=res, launches=launches)


def run_bottleneck_path(torch):
    """The proto's run at N = 32: one checked block, then the script's
    timed() of the kernel and of the cuDNN composition."""
    from apex_tpu_torch.scripts import bottleneck_proto as bp
    p = bp.make_params(device="cuda")
    x = bp.make_input(bp.N, device="cuda")
    wts = bp.cudnn_weights(p)
    reset_counters()
    y = bp.fused_block(x, p)
    lib = bp.cudnn_block(x, p, wts)
    torch.cuda.synchronize()
    err = (y.float() - lib.float()).abs().max().item()
    check(err < BOTTLENECK_LIB_TOL, f"bottleneck path: {err} from cuDNN")
    t_fused = bp.timed(bp.fused_block, x, p)
    t_lib = bp.timed(lambda a, b: bp.cudnn_block(a, b, wts), x, p)
    launches = read_counters()
    check(launches["bottleneck"] == 1 + 1 + 5 * 64,
          f"bottleneck path: {launches['bottleneck']} launches")
    return dict(n=bp.N, max_abs_err_vs_cudnn=err, fused_ms=t_fused,
                cudnn_ms=t_lib, speedup=t_lib / t_fused, launches=launches)


SPATIAL_N, SPATIAL_C, SPATIAL_F, SPATIAL_HW, SPATIAL_STEPS = 32, 256, 64, 56, 4
# SpatialBottleneck against models.resnet.Bottleneck with the same weights.
# In fp32 (TF32 off) the two differ only in their batch norms' fp32 sums
# (SyncBatchNorm's own against cuDNN's): the forward within 1e-4 of the
# largest value and in relative norm. A pre-activation that lands within
# those last bits of a ReLU's zero switches the ReLU's mask, and with it
# that element's whole gradient; such flips, a fraction f of the elements,
# put ~sqrt(f) into the gradients' relative norm (read 5.8e-4 for dx at
# 25.7 M elements): the fp32 gradients are held within 2e-3 in relative
# norm with at most 1e-4 of their elements beyond 2^-6 of themselves plus
# 1e-3 of the largest value. In the O2 set-up (bf16 convs, fp32 norms) the
# two batch norms round their bf16 outputs and gradients at other points,
# which flips more roundings and masks: the forward is held within 1 % in
# relative norm with at most 0.1 % of elements beyond two bf16 ulps + 2 %
# of the largest value; the gradients within 10 % in relative norm — this
# block's bf16 gradients are 4-8 % from its fp32 gradients (measured on
# the CPU, N 4 at 14 x 14), so two bf16 implementations agree no closer.
SPATIAL_FP32_TOL = 1e-4
SPATIAL_FP32_GRAD_TOL = 2e-3
SPATIAL_FP32_FAR = 1e-4
TWIN_NORM_TOL = 1e-2
TWIN_FAR_FRAC = 1e-3
TWIN_GRAD_NORM_TOL = 0.1


def _close_twin(got, ref, what, norm_tol, far_frac=None, floor_frac=0.0,
                elem_rel=2.0 ** -6):
    """Relative-norm agreement within ``norm_tol``; with ``far_frac``, at
    most that fraction of elements beyond ``elem_rel`` of themselves
    (2^-6: two bf16 ulps) plus ``floor_frac`` of the largest value."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    rel = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    check(rel <= norm_tol, f"{what}: relative norm error {rel} > {norm_tol}")
    far = 0.0
    if far_frac is not None:
        tol = ref.abs() * elem_rel + floor_frac * ref.abs().max()
        far = (diff > tol).float().mean().item()
        check(far <= far_frac, f"{what}: {far} of elements beyond {elem_rel} "
              f"of themselves + {floor_frac} of the largest value")
    return dict(max_abs_err=diff.max().item(), rel_norm=rel, frac_far=far)


def _spatial_loss(m, x, t):
    return ((m(x).float() - t) ** 2).mean()


def _spatial_twins(torch, dtype, x, t):
    """SpatialBottleneck and models.resnet.Bottleneck with the same random
    conv weights (seed 15), computing in ``dtype``: forward and backward
    of the loss on (x, t), then their readings against each other."""
    from apex_tpu_torch.contrib.bottleneck import (Bottleneck,
                                                   SpatialBottleneck)
    gen = torch.Generator(device="cuda").manual_seed(15)
    sp = SpatialBottleneck(SPATIAL_C, SPATIAL_F, dtype=dtype, device="cuda")
    ref = Bottleneck(SPATIAL_C, SPATIAL_F, dtype=dtype, device="cuda")
    pairs = (("conv1", sp.conv1, ref.Conv_0), ("conv2", sp.conv2, ref.Conv_1),
             ("conv3", sp.conv3, ref.Conv_2))
    with torch.no_grad():
        for _, w, r in pairs:
            w.copy_(torch.randn(w.shape, generator=gen, device="cuda")
                    * (2.0 / w[0].numel()) ** 0.5)
            r.copy_(w)
    xs, xr = (x.to(dtype).clone().requires_grad_() for _ in range(2))
    ys, yr = sp(xs), ref(xr)
    ((ys.float() - t) ** 2).mean().backward()
    ((yr.float() - t) ** 2).mean().backward()
    torch.cuda.synchronize()
    tag = f"spatial {str(dtype)[6:]}"
    if dtype == torch.float32:
        def grad_check_(g, r, what):
            return _close_twin(g, r, what, SPATIAL_FP32_GRAD_TOL,
                               SPATIAL_FP32_FAR, floor_frac=1e-3)
        fwd = _close_twin(ys, yr, f"{tag} forward", SPATIAL_FP32_TOL, 0.0,
                          floor_frac=SPATIAL_FP32_TOL, elem_rel=0.0)
    else:
        def grad_check_(g, r, what):
            return _close_twin(g, r, what, TWIN_GRAD_NORM_TOL)
        fwd = _close_twin(ys, yr, f"{tag} forward", TWIN_NORM_TOL,
                          TWIN_FAR_FRAC, floor_frac=0.02)
    out = {"y": fwd, "x": grad_check_(xs.grad, xr.grad, f"{tag} dx")}
    for name, w, r in pairs:
        out[name] = grad_check_(w.grad, r.grad, f"{tag} d{name}")
    for pm in sp.parameters():
        pm.grad = None
    return sp, out


def run_spatial_path(torch):
    """SpatialBottleneck at world 1 and ResNet-50's conv2_x width (256 ->
    64 -> 256, 56 x 56, N 32): forward and backward against the port's
    models.resnet.Bottleneck with the same weights (the same function at
    world 1) in fp32 and in the O2 set-up (bf16 convs, fp32 norms), then
    O2 FusedSGD steps."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedSGD
    gen = torch.Generator(device="cuda").manual_seed(16)
    shape = (SPATIAL_N, SPATIAL_C, SPATIAL_HW, SPATIAL_HW)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.randn(shape, generator=gen, device="cuda")
    reset_counters()
    _, fp32 = _spatial_twins(torch, torch.float32, x, t)
    sp, bf16 = _spatial_twins(torch, torch.bfloat16, x, t)
    amp_model, opt = amp.initialize(sp, FusedSGD(lr=0.1, momentum=0.9),
                                    opt_level="O2", verbosity=0)
    amp_model.cast_params()
    check(sp.n1.weight.dtype == torch.float32
          and sp.conv1.dtype == torch.bfloat16, "spatial: O2 cast")
    state = opt.init(sp.parameters())
    step = amp.make_train_step(_spatial_loss, opt)
    sstate = opt._scaler.state
    losses, times = [], []
    for _ in range(SPATIAL_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(sp, state, sstate, x, t)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = read_counters()
    check(all(np.isfinite(losses)), f"spatial: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"spatial: loss did not fall {losses}")
    return dict(n=SPATIAL_N, c=SPATIAL_C, filters=SPATIAL_F,
                hw=SPATIAL_HW, against_bottleneck_fp32=fp32,
                against_bottleneck_o2=bf16, losses=losses,
                step_ms_all=times, step_ms_median=float(np.median(times[1:])),
                launches=launches)


O0_LAYERS, O0_B, O0_S, O0_STEPS = 2, 8, 1024, 3
# every flash forward and backward on the fp32 FFMA route
# (csrc/flash_fwd_f32.cuh, csrc/flash_bwd_f32.cuh), none on frag.cuh's
O0_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP}, "flash_fwd_f32": O0_LAYERS,
               "flash_bwd_f32": O0_LAYERS,
               "layer_norm_fwd": 2 * O0_LAYERS + 1,
               "layer_norm_bwd": 2 * O0_LAYERS + 1, "lm_head_ce_fwd_f32": 1,
               "lm_head_ce_bwd_f32": 1}
# train-o0-dropout-gpt2-b8s1024: the same step with Megatron's dropout,
# every flash forward and single pass on the FFMA route's dropout variants
O0_DROP_PER_STEP = {**O0_PER_STEP, "flash_fwd_f32": 0, "flash_bwd_f32": 0,
                    "flash_fwd_f32_dropout": O0_LAYERS,
                    "flash_bwd_f32_dropout": O0_LAYERS}
# the O0 step against GPT.loss(reference=True), both fp32 on the same
# parameters: the kernels round nothing below fp32 (p, ds and the CE
# gradient tile stay fp32), so only summation order and __expf differ
O0_LOSS_TOL = 1e-5
O0_GRAD_TOL = 1e-4


def run_o0_path(torch, dropout=False, b=O0_B, s=O0_S, steps=O0_STEPS,
                per_step=None):
    """An O0 (fp32) GPT training step through the kernels: 2 layers at
    full width (h1024, 16 heads, V32768), ``b`` x ``s`` (b8 s1024),
    FusedAdam through amp.make_train_step; first the loss and every
    gradient against the plain versions differentiated by autograd (the
    plain twin's peak memory recorded). With ``dropout``
    (train-o0-dropout-gpt2-b8s1024, and at b2 s4096 through the split):
    Megatron's attention and hidden dropout 0.1 (:func:`dropout_config`)
    in training mode, the check's two sides from a host generator in the
    same state (the same attention seeds and hidden masks), the steps from
    one host generator. Then a warm-up and ``steps`` counted steps, each
    kernel's launches a step as ``per_step`` has them; finite losses, and
    falling where the run has more than two steps."""
    import dataclasses
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import GPT
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = dataclasses.replace(gpt_config(max_seq_len=max(s, 1024)),
                              num_layers=O0_LAYERS, dtype=torch.float32)
    if dropout:
        cfg = dropout_config(cfg)
    if per_step is None:
        per_step = O0_DROP_PER_STEP if dropout else O0_PER_STEP
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    ids, labels = train_batch(torch, cfg, b, s)
    params = list(model.named_parameters())

    what = f"O0{' dropout' if dropout else ''} b{b} s{s}"

    def loss_of(reference):
        kw = dict(deterministic=False, generator=torch.Generator()
                  .manual_seed(DROP_GEN_SEED + 5)) if dropout else {}
        return model.loss(ids, labels, reference=reference, **kw)

    loss = loss_of(False)
    grads = torch.autograd.grad(loss, [p for _, p in params])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref_loss = loss_of(True)
    ref = torch.autograd.grad(ref_loss, [p for _, p in params])
    plain_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    loss, ref_loss = loss.detach(), ref_loss.detach()
    dloss = abs(float(loss) - float(ref_loss))
    check(dloss <= O0_LOSS_TOL * abs(float(ref_loss)),
          f"{what} loss kernels {float(loss)} vs plain {float(ref_loss)}")
    worst = []
    for (name, _), g, r in zip(params, grads, ref):
        rel = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
        worst.append((rel, name))
        check(rel <= O0_GRAD_TOL, f"{what} grad {name}: relative norm {rel}")
    worst.sort(reverse=True)
    del grads, ref
    amp_model, opt = amp.initialize(model, FusedAdam(lr=LR), opt_level="O0",
                                    verbosity=0)
    amp_model.cast_params()
    state = opt.init(model.parameters())
    gen = torch.Generator().manual_seed(DROP_GEN_SEED)
    kw = dict(deterministic=False, generator=gen) if dropout else {}
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l, **kw), opt)
    sstate = opt._scaler.state
    _, state, sstate, _ = step(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    reset_counters()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, state, sstate, l_ = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(l_))
    launches = read_counters()
    check(all(np.isfinite(losses))
          and (steps <= 2 or losses[-1] < losses[0]),
          f"{what} losses {losses}")
    for k, per in per_step.items():
        check(launches[k] == per * steps,
              f"{what} {k}: {launches[k]} launches, expected "
              f"{per * steps}")
    box = [state, sstate]

    def one():
        _, box[0], box[1], _ = step(model, box[0], box[1], ids, labels)

    # one more step under torch.profiler: device time by kernel class
    trace_one = _profile(torch, one, 1)
    return dict(layers=O0_LAYERS, batch=b, seq=s, dtype="float32",
                attention_dropout=cfg.attention_dropout,
                hidden_dropout=cfg.hidden_dropout, trace=trace_one,
                loss_kernels=float(loss), loss_plain=float(ref_loss),
                loss_abs_diff=dloss, worst_grad_rel_norm=worst[:5],
                median_grad_rel_norm=float(np.median([w for w, _ in worst])),
                plain_twin_peak_mem_gb=plain_peak_gb,
                losses=losses, step_ms_all=times,
                step_ms_median=float(np.median(times)),
                tokens_per_s=b * s / (np.median(times) / 1e3),
                launches=launches)


O0_LONG_S, O0_LONG_B, O0_LONG_STEPS = 4096, 2, 2
# fp32 past the gate: the split, dk/dv and dq on the FFMA route
O0_LONG_PER_STEP = {**O0_PER_STEP, "flash_bwd_f32": 0,
                    "flash_bwd_f32_dkdv": O0_LAYERS,
                    "flash_bwd_f32_dq": O0_LAYERS}


def run_o0_dropout_path(torch):
    return run_o0_path(torch, dropout=True)


# train-o0-dropout-gpt2-b2s4096: the O0 long path with Megatron's dropout,
# every split's dk/dv and dq on the FFMA split's dropout variants
O0_LONG_DROP_PER_STEP = {**O0_LONG_PER_STEP, "flash_fwd_f32": 0,
                         "flash_fwd_f32_dropout": O0_LAYERS,
                         "flash_bwd_f32_dkdv": 0, "flash_bwd_f32_dq": 0,
                         "flash_bwd_f32_dkdv_dropout": O0_LAYERS,
                         "flash_bwd_f32_dq_dropout": O0_LAYERS}


def run_o0_long_dropout_path(torch):
    """train-o0-dropout-gpt2-b2s4096: the fp32 twin of
    train-dropout-gpt12-h1024-b2s4096, the grad check at the full shape."""
    from apex_tpu_torch.ops import flash_attention as fa
    check(fa.uses_split_backward(O0_LONG_S, O0_LONG_S, 64, 4, 4, True,
                                 dropout=True),
          f"the gate at s{O0_LONG_S} fp32 with dropout: not the split")
    return run_o0_path(torch, dropout=True, b=O0_LONG_B, s=O0_LONG_S,
                       steps=O0_LONG_STEPS, per_step=O0_LONG_DROP_PER_STEP)


# the O0 twins of the bias MHA paths (fairseq trains in fp32 without
# --fp16) at dropout 0: every flash launch on the FFMA route's bias
# variants, the LayerNorm pair of norm_add (the only main paths on them)
O0_MHA16_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP},
                     "flash_fwd_f32_bias": MHA16_LAYERS,
                     "flash_bwd_f32_dkdv_bias": MHA16_LAYERS,
                     "flash_bwd_f32_dq_bias": MHA16_LAYERS,
                     "layer_norm_fwd": MHA16_LAYERS,
                     "layer_norm_bwd": MHA16_LAYERS}
O0_MHA6_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP},
                    "flash_fwd_f32_bias": MHA6_LAYERS,
                    "flash_bwd_f32_bias": MHA6_LAYERS,
                    "layer_norm_fwd": MHA6_LAYERS,
                    "layer_norm_bwd": MHA6_LAYERS}
# the same two at fairseq's attention_dropout 0.1 (transformer_lm_wiki103,
# transformer_wmt_en_de_big): every flash launch on the FFMA route's
# variants with both (the gate splits fp32 with both from s400 at d 128 and
# keeps s128 at d 64 on the single pass)
O0_MHA16_DROP_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP},
                          "flash_fwd_f32_bias_dropout": MHA16_LAYERS,
                          "flash_bwd_f32_dkdv_bias_dropout": MHA16_LAYERS,
                          "flash_bwd_f32_dq_bias_dropout": MHA16_LAYERS,
                          "layer_norm_fwd": MHA16_LAYERS,
                          "layer_norm_bwd": MHA16_LAYERS}
O0_MHA6_DROP_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP},
                         "flash_fwd_f32_bias_dropout": MHA6_LAYERS,
                         "flash_bwd_f32_bias_dropout": MHA6_LAYERS,
                         "layer_norm_fwd": MHA6_LAYERS,
                         "layer_norm_bwd": MHA6_LAYERS}


def _o0_mha_grad_check(torch, what, s, b, heads, lens, per_layer,
                       kw=MHA_BIAS_KW):
    """A 2-layer full-width fp32 stack of the path's configuration (module
    options ``kw``) through the kernels against ``reference=True``, a host
    generator in the same state on both sides (the attention seeds and the
    residual dropout's masks under dropout): loss :data:`O0_LOSS_TOL`
    (absolute: the MSE is above 1, so stricter than relative), every
    gradient :data:`O0_GRAD_TOL` in relative norm; the FFMA variants'
    launches (``per_layer`` of each a layer) asserted."""
    stack = mha_stack(torch, MHA_GRAD_LAYERS, kw, heads)
    batch = mha_batch(torch, s, b, True, lens, torch.float32)

    def loss_of(reference):
        gen = torch.Generator().manual_seed(DROP_GEN_SEED + 5)
        return mha_loss(stack, *batch, generator=gen, reference=reference)

    reset_counters()
    out = _twin_grads(torch, what, dict(stack.named_parameters()), loss_of,
                      O0_LOSS_TOL, O0_GRAD_TOL)
    launches = read_counters()
    for k, per in per_layer.items():
        check(launches[k] == per * MHA_GRAD_LAYERS,
              f"{what} {k}: {launches[k]} launches, expected "
              f"{per * MHA_GRAD_LAYERS}")
    out["shape"] = (f"{MHA_GRAD_LAYERS} layers, s{s} b{b} h{heads}, fp32, "
                    f"dropout {kw['dropout']}")
    del stack, batch
    torch.cuda.empty_cache()
    return out


def run_o0_mha16_path(torch):
    """train-o0-mha16-e1024h8-b1s3072-bias: train-mha16's configuration at
    O0 (fp32), through the FFMA route's forward and split bias variants
    (the gate splits every biased fp32 backward at s3072 d128); then its
    2-layer grad check."""
    stats = run_mha_path(torch, MHA_BIAS_KW, MHA16_S, MHA16_B,
                         O0_MHA16_PER_STEP, "train-o0-mha16-s3072-bias", True,
                         layers=MHA16_LAYERS, heads=MHA16_HEADS, lr=MHA16_LR,
                         opt_level="O0")
    per_layer = {k: v // MHA16_LAYERS for k, v in O0_MHA16_PER_STEP.items()
                 if k.startswith("flash")}
    stats["grad_check"] = _o0_mha_grad_check(
        torch, "O0 mha grad check s3072 h8", MHA16_S, MHA16_B, MHA16_HEADS,
        None, per_layer)
    return stats


def run_o0_mha6_path(torch):
    """train-o0-mha6-e1024h16-b28s128-bias: train-mha6's configuration at
    O0 (fp32) without dropout, through the FFMA route's forward and single
    pass bias variants (the gate keeps s128 on the single pass); then its
    2-layer grad check."""
    from apex_tpu_torch.ops import flash_attention as fa
    check(not fa.uses_split_backward(MHA6_S, MHA6_S, MHA_E // MHA_HEADS, 4,
                                     4, bias=True),
          f"the gate at s{MHA6_S} fp32 with a bias: not the single pass")
    stats = run_mha_path(torch, MHA_BIAS_KW, MHA6_S, MHA6_B, O0_MHA6_PER_STEP,
                         "train-o0-mha6-s128-bias", True, mha6_lengths(),
                         layers=MHA6_LAYERS, opt_level="O0")
    per_layer = {k: v // MHA6_LAYERS for k, v in O0_MHA6_PER_STEP.items()
                 if k.startswith("flash")}
    stats["grad_check"] = _o0_mha_grad_check(
        torch, "O0 mha grad check s128 h16 b28", MHA6_S, MHA6_B, MHA_HEADS,
        mha6_lengths(), per_layer)
    return stats


def run_o0_mha16_dropout_path(torch):
    """train-o0-mha16-e1024h8-b1s3072-bias-dropout: train-mha16-bias-
    dropout's configuration at O0 (fp32), attention dropout 0.1 from the
    host generator, through the FFMA route's forward and split variants
    with both; then its 2-layer grad check."""
    from apex_tpu_torch.ops import flash_attention as fa
    check(fa.uses_split_backward(MHA16_S, MHA16_S, MHA_E // MHA16_HEADS, 4,
                                 4, bias=True, dropout=True),
          f"the gate at s{MHA16_S} fp32 with both: not the split")
    stats = run_mha_path(torch, MHA_BIAS_DROP_KW, MHA16_S, MHA16_B,
                         O0_MHA16_DROP_PER_STEP,
                         "train-o0-mha16-s3072-bias-dropout", True,
                         layers=MHA16_LAYERS, heads=MHA16_HEADS, lr=MHA16_LR,
                         opt_level="O0")
    per_layer = {k: v // MHA16_LAYERS
                 for k, v in O0_MHA16_DROP_PER_STEP.items()
                 if k.startswith("flash")}
    stats["grad_check"] = _o0_mha_grad_check(
        torch, "O0 mha grad check s3072 h8 dropout", MHA16_S, MHA16_B,
        MHA16_HEADS, None, per_layer, MHA_BIAS_DROP_KW)
    return stats


def run_o0_mha6_dropout_path(torch):
    """train-o0-mha6-e1024h16-b28s128-bias-dropout: train-mha6's
    configuration at O0 (fp32), attention dropout 0.1 from the host
    generator, through the FFMA route's forward and single pass variants
    with both (the gate keeps s128 on the single pass); then its 2-layer
    grad check."""
    from apex_tpu_torch.ops import flash_attention as fa
    check(not fa.uses_split_backward(MHA6_S, MHA6_S, MHA_E // MHA_HEADS, 4,
                                     4, bias=True, dropout=True),
          f"the gate at s{MHA6_S} fp32 with both: not the single pass")
    stats = run_mha_path(torch, MHA_BIAS_DROP_KW, MHA6_S, MHA6_B,
                         O0_MHA6_DROP_PER_STEP,
                         "train-o0-mha6-s128-bias-dropout", True,
                         mha6_lengths(), layers=MHA6_LAYERS, opt_level="O0")
    per_layer = {k: v // MHA6_LAYERS
                 for k, v in O0_MHA6_DROP_PER_STEP.items()
                 if k.startswith("flash")}
    stats["grad_check"] = _o0_mha_grad_check(
        torch, "O0 mha grad check s128 h16 b28 dropout", MHA6_S, MHA6_B,
        MHA_HEADS, mha6_lengths(), per_layer, MHA_BIAS_DROP_KW)
    return stats


def run_o0_long_path(torch):
    """The O0 GPT (2 layers at full width, fp32) at b2 s4096, past the
    flash backward's gate: a warm-up, then 2 counted ``FusedAdam`` steps
    through ``amp.make_train_step``, every forward and every split's dk/dv
    and dq on the FFMA route (fp32 takes no wgmma), and one step under
    ``torch.profiler``."""
    import dataclasses
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import GPT
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = dataclasses.replace(gpt_config(max_seq_len=O0_LONG_S),
                              num_layers=O0_LAYERS, dtype=torch.float32)
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    ids, labels = train_batch(torch, cfg, O0_LONG_B, O0_LONG_S)
    amp_model, opt = amp.initialize(model, FusedAdam(lr=LR), opt_level="O0",
                                    verbosity=0)
    amp_model.cast_params()
    state = opt.init(model.parameters())
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    sstate = opt._scaler.state
    _, state, sstate, _ = step(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    reset_counters()
    losses, times = [], []
    for _ in range(O0_LONG_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, l_ = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(l_))
    launches = read_counters()
    check(all(np.isfinite(losses)), f"O0 s{O0_LONG_S} losses {losses}")
    for k, per in O0_LONG_PER_STEP.items():
        check(launches[k] == per * O0_LONG_STEPS,
              f"O0 s{O0_LONG_S} {k}: {launches[k]} launches, expected "
              f"{per * O0_LONG_STEPS}")
    box = [state, sstate]

    def one():
        _, box[0], box[1], _ = step(model, box[0], box[1], ids, labels)

    # one more step under torch.profiler: device time by kernel class
    return dict(layers=O0_LAYERS, batch=O0_LONG_B, seq=O0_LONG_S,
                dtype="float32", trace=_profile(torch, one, 1),
                losses=losses, step_ms_all=times,
                step_ms_median=float(np.median(times)), launches=launches)


# ---------------------------------------------------------------------------
# ZeRO-3 O2 training of the same GPT (world 1: one card), and tier 2 with
# DistributedFusedLAMB
# ---------------------------------------------------------------------------

ZERO_WD = 0.01
ZERO_PER_STEP = {**TRAIN_PER_STEP, "multi_tensor_update": 1}
DFLAMB_STEPS, DFLAMB_LR = 3, 1e-3
DFLAMB_PER_STEP = {**TRAIN_PER_STEP, "multi_tensor_update_lamb": 1}


def zero3_setup(torch, cfg):
    """The JAX flow (``amp/frontend.py:156-190``, ``zero/step.py``):
    amp.initialize(model, ZeroOptimizer(adam, shard_params=True), O2,
    zero=True) -> shard the fp32 params -> opt.init -> cast_params ->
    zero.make_train_step over GPT.loss. Random weights from seed 0."""
    from apex_tpu_torch import amp, zero
    from apex_tpu_torch.models.gpt import GPT
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    zm, opt = amp.initialize(
        model, zero.ZeroOptimizer(lr=LR, kind="adam", shard_params=True,
                                  weight_decay=ZERO_WD),
        opt_level="O2", loss_scale="dynamic", verbosity=0, zero=True)
    shards32 = zm.shard()
    state = opt.init(shards32, zm.spec)
    shards = zm.cast_params(shards32)
    del shards32
    check({x.dtype for x in shards.values()} == {torch.bfloat16},
          "ZeRO-3 O2: resident shards are not all bf16")
    step = zero.make_train_step(lambda m, i, l: m.loss(i, l), optimizer=opt)
    return model, zm, opt, shards, state, step


def dense_twin(torch, cfg, ids, labels):
    """The dense FusedAdam O2 step of the train path from the same fp32
    init (its masters taken before the cast, as ZeroOptimizer takes them)
    on the same batch: yields the state after each step."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import GPT
    from apex_tpu_torch.optimizers import FusedAdam
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    amp_model, opt = amp.initialize(model, FusedAdam(lr=LR,
                                                     weight_decay=ZERO_WD),
                                    opt_level="O2", loss_scale="dynamic",
                                    verbosity=0)
    state = opt.init(model.parameters())
    amp_model.cast_params()
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    sstate = opt._scaler.state
    while True:
        _, state, sstate, _ = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        yield model, opt, state, sstate


def zero3_phases(torch, zm, opt, shards, state, sstate, ids, labels,
                 reps=3):
    """Device time of each phase of the ZeRO-3 step by CUDA events, the
    functions ``zero.make_train_step`` calls one by one in its order:
    materialize + forward + backward, unscale, the flag, the optimizer
    (one B13 launch plus the cast into the bf16 shards), the scaler."""
    from apex_tpu_torch.amp import scaler as scaler_mod
    names = ("forward_backward", "unscale", "inf_flag", "optimizer",
             "scaler_update")
    ms = {k: [] for k in names}
    floats = list(zm.spec.names)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda.synchronize()
        ev[0].record()
        leaves = {k: x.detach().requires_grad_() for k, x in shards.items()}
        loss = zm.call(zm.materialize(leaves), lambda m, i, l: m.loss(i, l),
                       ids, labels)
        grads = torch.autograd.grad(scaler_mod.scale_value(loss, sstate),
                                    [leaves[k] for k in floats])
        ev[1].record()
        g32, found_inf = scaler_mod.unscale(grads, sstate)
        del grads, leaves
        ev[2].record()
        found_inf = found_inf.to(torch.int32) > 0
        ev[3].record()
        shards, state = opt.apply(state, shards, g32, skip=found_inf,
                                  spec=zm.spec)
        ev[4].record()
        sstate = opt._scaler.update_state(sstate, found_inf)
        ev[5].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            ms[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: float(np.median(v)) for k, v in ms.items()}, shards, state, \
        sstate


# ZeRO-3 masters, m and v against the dense FusedAdam twin's: both run the
# same kernels on the same batch from the same fp32 masters (bitwise on the
# CPU, tests/test_torch_zero.py), so on the card they may differ only where
# a gradient is summed in another order in the two steps and a bf16
# rounding flips. Adam moves a master by ~lr a step whatever
# its gradient's size, so a flipped near-zero gradient can put two masters
# up to 2 * lr apart a step (the first step moves each by lr * g / (|g| +
# eps), at most lr: read 5.99e-4 against 6e-4 on the H100), plus the
# masters' own roundings, ZERO_TWIN_ULPS (an fp32 ulp of values up to 8).
# After one step the moments are 0.1 g and 0.001 g^2: they differ as the
# gradients do; after nine steps every gradient differs a little (the
# masters already do), read at 1.7-2.6 % (m) and 1.5-2.2 % (v) in
# relative norm on the H100 (PERF.md)
ZERO_TWIN_FAR_FRAC = 0.01
ZERO_TWIN_ULPS = 1e-6
ZERO_TWIN_SLOT_REL_1, ZERO_TWIN_SLOT_REL = 1e-2, 5e-2


def _zero3_twin_check(torch, st, dstate, steps):
    """``st``: ``(master, m, v)`` flat buffers of the ZeRO-3 state after
    ``steps`` steps, ``dstate`` the twin's after as many."""
    g = dstate.groups[0]
    out = {}
    for name, a, r in (("master", st[0], g.master),
                       ("m", st[1], g.slots["exp_avg"]),
                       ("v", st[2], g.slots["exp_avg_sq"])):
        a = a.to(r.device)
        d = (a - r).abs()
        out[name] = dict(bitwise=bool(torch.equal(a, r)),
                         max_abs_diff=d.max().item(),
                         rel_norm=(d.norm() / r.norm().clamp_min(1e-30))
                         .item(),
                         frac_differing=(d > 0).float().mean().item())
        if name == "master":
            out[name]["frac_over_half_lr"] = (d > LR / 2).float().mean()\
                .item()
        del d
    log(f"train-zero3 vs dense FusedAdam twin after {steps} steps: "
        + json.dumps(out))
    check(out["master"]["max_abs_diff"] <= 2 * LR * steps + ZERO_TWIN_ULPS,
          f"ZeRO-3 masters beyond 2 * lr * steps of the dense twin's: {out}")
    check(out["master"]["frac_over_half_lr"] <= ZERO_TWIN_FAR_FRAC,
          f"ZeRO-3 masters: too many far from the dense twin's: {out}")
    for k in ("m", "v"):
        limit = ZERO_TWIN_SLOT_REL_1 if steps == 1 else ZERO_TWIN_SLOT_REL
        check(out[k]["rel_norm"] <= limit,
              f"ZeRO-3 {k}: relative norm {out[k]['rel_norm']} from the "
              f"dense twin's after {steps} steps")
    return out


def run_zero3_path(torch, cfg):
    model, zm, opt, shards, state, step = zero3_setup(torch, cfg)
    ids, labels = train_batch(torch, cfg)
    sstate = opt._scaler.state
    shards, state, sstate, _ = step(shards, state, sstate, ids, labels)
    torch.cuda.synchronize()
    # kept on the host, out of the timed steps' peak device memory
    first = (state.master.flat.cpu(), state.m.flat.cpu(),
             state.v.flat.cpu())
    scale0 = float(sstate.loss_scale)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counters()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        shards, state, sstate, loss = step(shards, state, sstate, ids,
                                           labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite ZeRO-3 loss: {losses}")
    check(losses[-1] < losses[0], f"ZeRO-3 loss did not fall: {losses}")
    check(float(sstate.loss_scale) == scale0 == 2.0 ** 16,
          "ZeRO-3: the loss scale moved during the timed steps")
    check(int(state.step) == TRAIN_STEPS + 1, "ZeRO-3 step counter")
    for k, per in ZERO_PER_STEP.items():
        check(launches[k] == per * TRAIN_STEPS,
              f"train-zero3 {k}: {launches[k]} launches, expected "
              f"{per * TRAIN_STEPS}")
    ms = [1e3 * t for t in times]
    stats = dict(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S, world=1,
                 leaves=len(zm.spec.names),
                 flat_elements=int(state.master.flat.numel()),
                 losses=losses, step_ms_median=float(np.median(ms)),
                 step_ms_p90=float(np.percentile(ms, 90)), step_ms_all=ms,
                 tokens_per_s=TRAIN_B * TRAIN_S / (np.median(ms) / 1e3),
                 peak_mem_gb=peak, launches=launches)
    # the dense twin from the same init: after the warm-up step, then after
    # the same 1 + 8 steps
    twin = dense_twin(torch, cfg, ids, labels)
    dmodel, dopt, dstate, dss = next(twin)
    stats["twin_after_1_step"] = _zero3_twin_check(torch, first, dstate, 1)
    del first
    for _ in range(TRAIN_STEPS):
        dmodel, dopt, dstate, dss = next(twin)
    del twin
    stats["twin"] = _zero3_twin_check(
        torch, (state.master.flat, state.m.flat, state.v.flat), dstate,
        TRAIN_STEPS + 1)
    box = [shards, state, sstate]

    def one():
        box[0], box[1], box[2], _ = step(box[0], box[1], box[2], ids,
                                         labels)

    trace_z = _profile(torch, one, 2)
    phases, shards, state, sstate = zero3_phases(
        torch, zm, opt, box[0], box[1], box[2], ids, labels)
    dphases, _, _ = step_phases(torch, cfg, dmodel, dopt, dstate, dss)
    stats["phases_ms"] = phases
    stats["dense_fused_adam_phases_ms"] = dphases
    del dmodel, dopt, dstate, dss
    torch.cuda.empty_cache()
    stats["overflow"] = zero3_overflow_check(torch, cfg, opt, shards, state,
                                             sstate, ids, labels)
    return stats, trace_z


def zero3_overflow_check(torch, cfg, opt, shards, state, sstate, ids,
                         labels):
    """A step whose loss overflows: resident shards, masters, m, v and the
    step bitwise unchanged (the kernel writes nothing under the flag), the
    scale halved."""
    from apex_tpu_torch import zero
    big = zero.make_train_step(lambda m, i, l: m.loss(i, l) * 1e38,
                               optimizer=opt)
    before = ({k: v.clone() for k, v in shards.items()},
              state.master.flat.clone(), state.m.flat.clone(),
              state.v.flat.clone(), int(state.step))
    scale0 = float(sstate.loss_scale)
    shards2, state2, sstate2, loss = big(shards, state, sstate, ids, labels)
    torch.cuda.synchronize()
    check(all(torch.equal(shards2[k], v) for k, v in before[0].items()),
          "ZeRO-3 overflow: a resident shard changed")
    check(torch.equal(state2.master.flat, before[1]),
          "ZeRO-3 overflow: master changed")
    check(torch.equal(state2.m.flat, before[2]), "ZeRO-3 overflow: m changed")
    check(torch.equal(state2.v.flat, before[3]), "ZeRO-3 overflow: v changed")
    check(int(state2.step) == before[4], "ZeRO-3 overflow: step moved")
    check(bool(sstate2.overflow), "ZeRO-3 overflow: not detected")
    check(float(sstate2.loss_scale) == scale0 / 2,
          "ZeRO-3 overflow: scale not halved")
    return dict(loss=float(loss), scale_before=scale0,
                scale_after=float(sstate2.loss_scale), step=int(state2.step))


# tier-2 LAMB on the card against its plain twin on the CPU, one step from
# the same state and gradient: the global grad norm and the per-leaf norms
# are fp32 sums in other orders on the two devices, and torch's CPU sqrt
# is not always correctly rounded, so every buffer is held within 1e-5 of
# its largest value
DFLAMB_TWIN_REL = 1e-5


def run_dflamb_path(torch, cfg):
    """Tier 2: ``DistributedFusedLAMB(lr=1e-3, weight_decay=0.01,
    max_grad_norm=1.0)`` through ``amp.initialize`` at O2 and
    ``amp.make_train_step`` on the same GPT; a warm-up, 3 counted steps,
    then one more step on the card (its optimizer phase timed by CUDA
    events) against the CPU twin."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp import scaler as scaler_mod
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.models.gpt import GPT
    hyper = dict(lr=DFLAMB_LR, weight_decay=0.01, max_grad_norm=1.0)
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    amp_model, opt = amp.initialize(model, DistributedFusedLAMB(**hyper),
                                    opt_level="O2", loss_scale="dynamic",
                                    verbosity=0)
    amp_model.cast_params()
    state = opt.init(model)
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    ids, labels = train_batch(torch, cfg)
    sstate = opt._scaler.state
    _, state, sstate, _ = step(model, state, sstate, ids, labels)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    losses, times = [], []
    for _ in range(DFLAMB_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite LAMB loss: {losses}")
    for k, per in DFLAMB_PER_STEP.items():
        check(launches[k] == per * DFLAMB_STEPS,
              f"train-dflamb {k}: {launches[k]} launches, expected "
              f"{per * DFLAMB_STEPS}")
    # one more step's gradient, applied on the card and by the CPU twin
    params = opt.param_groups[0]["params"]
    loss = model.loss(ids, labels)
    grads = torch.autograd.grad(scaler_mod.scale_value(loss, sstate),
                                params)
    g32, found_inf = scaler_mod.unscale(list(grads), sstate)
    del grads
    twin = DistributedFusedLAMB(**hyper)
    cpu_params = [p.detach().cpu() for p in params]
    twin.init(cpu_params)
    cpu_state = type(state)(*(t.cpu() for t in state))
    cpu_state = twin.apply_flat(cpu_state, g32.cpu(), skip=found_inf.cpu())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    state = opt.apply_flat(state, g32, skip=found_inf)
    ev[1].record()
    torch.cuda.synchronize()
    optimizer_ms = ev[0].elapsed_time(ev[1])
    errs = {}
    for name, a, r in (("master", state.master_shard, cpu_state.master_shard),
                       ("m", state.m_shard, cpu_state.m_shard),
                       ("v", state.v_shard, cpu_state.v_shard)):
        a = a.cpu()
        errs[name] = (a - r).abs().max().item() / max(r.abs().max().item(),
                                                      1e-30)
        check(errs[name] <= DFLAMB_TWIN_REL,
              f"tier-2 LAMB {name} vs the CPU twin: {errs[name]} of max")
    check(int(state.step) == int(cpu_state.step) == DFLAMB_STEPS + 2,
          "tier-2 LAMB step counter")
    ms = [1e3 * t for t in times]
    return dict(steps=DFLAMB_STEPS, batch=TRAIN_B, seq=TRAIN_S, losses=losses,
                step_ms_all=ms, step_ms_median=float(np.median(ms)),
                optimizer_ms=optimizer_ms, twin_rel_err_of_max=errs,
                launches=launches)


_PORT_KERNELS = ("flash_fwd_kernel", "flash_bwd_kernel", "flash_dkdv_kernel",
                 "flash_dq_kernel", "flash_bwd_f32_kernel",
                 "flash_dkdv_f32_kernel", "flash_f32_prologue_kernel",
                 "flash_fwd_f32_kernel", "flash_dq_f32_kernel",
                 "flash_fwd_f32_dropout_kernel",
                 "flash_bwd_f32_dropout_kernel",
                 "flash_dkdv_f32_dropout_kernel",
                 "flash_dq_f32_dropout_kernel", "flash_fwd_f32_bias_kernel",
                 "flash_bwd_f32_bias_kernel", "flash_dkdv_f32_bias_kernel",
                 "flash_dq_f32_bias_kernel",
                 "flash_fwd_f32_bias_dropout_kernel",
                 "flash_bwd_f32_bias_dropout_kernel",
                 "flash_dkdv_f32_bias_dropout_kernel",
                 "flash_dq_f32_bias_dropout_kernel",
                 "flash_fwd_sm90", "flash_bwd_fused_sm90",
                 "flash_dkdv_sm90", "flash_dq_sm90",
                 "paged_decode_kernel",
                 "_ln_fwd_body", "ln_bwd_warp_rows", "ln_bwd_block_rows",
                 "_ce_fwd_body",
                 "_ce_bwd_body", "ce32_fwd_kernel", "ce32_grad_kernel",
                 "ce32_product_kernel", "ce32_transpose_kernel", "FwdEpi",
                 "GradEpi", "DxEpi", "DeEpi",
                 "fp8_mm_decode_kernel", "fp8_mm_prefill_kernel",
                 "mtu_kernel")


def _kernel_class(name: str) -> str:
    """The port's own kernels by name; library GEMMs (cuBLAS's nvjet and
    CUTLASS/xmma kernels); memory copies; everything else (PyTorch's
    elementwise, reduction, index and copy kernels)."""
    for k in _PORT_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "conv")):
        return "library conv"
    if "batch_norm" in low or "batchnorm" in low or "bn_fw" in low \
            or "bn_bw" in low:
        return "library batch norm"
    if any(t in low for t in ("nvjet", "gemm", "xmma", "cutlass")):
        return "library GEMM"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "memcpy/memset"
    return "other PyTorch kernels"


def _profile(torch, fn, reps):
    """torch.profiler over ``reps`` calls of ``fn`` (after one unprofiled),
    by kernel class, from the first session that recorded them all
    (:func:`_whole_sessions`)."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()

    kern, wall_us = next(_whole_sessions(torch, calls), (None, None))
    check(kern is not None, f"profiler: no session of {len(LEADS)} "
          "recorded the whole of the traced calls")
    dev_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    by_class = {}
    for e in kern:
        by_class.setdefault(_kernel_class(e.key), [0.0, 0])
        by_class[_kernel_class(e.key)][0] += e.self_device_time_total
        by_class[_kernel_class(e.key)][1] += e.count
    return dict(
        wall_ms_per_call=wall_us / reps / 1e3,
        device_ms_per_call=dev_us / reps / 1e3,
        device_busy_share=(dev_us / wall_us) if dev_us else None,
        kernel_launches_per_call=sum(e.count for e in kern) / reps,
        device_ms_and_launches_by_class_per_call={
            k: (us / reps / 1e3, n / reps) for k, (us, n) in
            sorted(by_class.items(), key=lambda kv: -kv[1][0])},
        top_device_ms_per_call=[
            (e.key[:60], e.self_device_time_total / reps / 1e3)
            for e in top])


def trace_train(torch, cfg, model, state, sstate, step, b=TRAIN_B,
                s=TRAIN_S):
    """torch.profiler over 2 train steps at batch ``b`` and sequence ``s``
    (after one unprofiled); returns the trace and the state after them."""
    ids, labels = train_batch(torch, cfg, b, s)
    box = [state, sstate]

    def one():
        _, box[0], box[1], _ = step(model, box[0], box[1], ids, labels)

    return _profile(torch, one, 2), box[0], box[1]


def trace(torch, cfg, params, path="serve"):
    """torch.profiler over 4 steady decode steps at batch 8 (under
    speculation a step is one draft-and-verify round for each of the 8
    sequences) and over two prefills of the engine of ``path``: device time
    by kernel and the device-busy share of the wall time (``None`` when the
    profiler records no device time)."""
    from apex_tpu_torch.serve import model as model_mod
    eng = make_engine(cfg, params, **SERVE_PATHS[path])
    rng = np.random.RandomState(1)
    new = 64 if eng.spec_k else 16      # rounds take up to k + 1 tokens
    for _ in range(eng.max_batch):
        eng.add_request(rng.randint(0, cfg.vocab_size, size=256).tolist(),
                        new)
    eng.step()                          # 8 prefills + the first decode
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=512)).cuda()
    # pages of its own for the extra prefill (400 live tokens)
    bt = torch.tensor(eng.sched.allocator.alloc(4), dtype=torch.int32,
                      device="cuda")

    def prefill():
        with torch.no_grad():
            model_mod.prefill_forward(cfg, eng.ccfg, eng.params, eng.state,
                                      bt, 400, ids)

    return {f"{path} decode_step_b8": _profile(torch, eng.step, 4),
            f"{path} prefill_512": _profile(torch, prefill, 2)}


def hgmma_counts(build):
    """``HGMMA`` instructions in the SASS of each wgmma library
    (``cuobjdump -sass``): the LM-head CE's, the flash forward's and
    backward's bf16/fp16 kernels, the fp8 matmul's prefill regime and the
    fused bottleneck run on the tensor cores' warpgroup products or the
    check fails."""
    out = {}
    for name in build.targets(["lm_head_ce_sm90", "flash_fwd_sm90",
                               "flash_bwd_sm90", "fp8_matmul",
                               "bottleneck"]):
        sass = subprocess.run(
            [os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
             "-sass", str(build.library_path(name))], capture_output=True,
            text=True, timeout=300, check=True).stdout
        out[name] = sum("HGMMA" in line for line in sass.splitlines())
        check(out[name] > 0, f"{name}: no HGMMA in its SASS")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from apex_tpu_torch.models.gpt import GPT
    from apex_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    sources = ["flash_fwd", "flash_fwd_sm90", "paged_decode", "flash_bwd",
               "flash_bwd_sm90",
               "lm_head_ce", "lm_head_ce_sm90", "fp8_matmul",
               "layer_norm_bwd", "multi_tensor_update", "bottleneck",
               "vpu_probe"]
    sources = _build.targets(sources)       # the dtype-split sources
    _build.build_all(sources)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    # every library loaded before the first profiler session: a library
    # first loaded into a process after many sessions has lost every device
    # record of the process's later sessions (observed on an H100)
    for name in sources:
        _build.load(name)
    for name in sources:
        text = _build.library_path(name).with_suffix(".log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "setmaxnreg" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log("wgmma in the LM-head CE, flash, fp8 matmul and bottleneck "
        "libraries: "
        + json.dumps(hgmma_counts(_build)))

    log("e4m3 cast, card against CPU: " + json.dumps(check_e4m3_cast(torch)))
    timer = Timer(torch)
    kernels = [*check_flash(torch, timer), *check_flash_fwd_f32(torch, timer),
               check_paged(torch, timer),
               check_paged_fp8(torch, timer), *check_fp8_matmul(torch, timer),
               check_layer_norm(torch, timer),
               check_flash_bwd(torch, timer),
               *check_flash_dropout(torch, timer),
               *check_flash_bias(torch, timer),
               *check_flash_f32(torch, timer, split=False),
               *check_flash_f32_dropout(torch, timer),
               check_layer_norm_bwd(torch, timer),
               *check_lm_head_ce(torch, timer),
               *check_lm_head_ce_f32(torch, timer),
               *check_flash_split(torch, timer),
               *check_flash_split_dropout(torch, timer),
               *check_flash_split_bias(torch, timer),
               *check_flash_bias_dropout(torch, timer),
               *check_flash_f32(torch, timer, split=True),
               *check_flash_f32_split_dropout(torch, timer),
               *check_flash_f32_bias(torch, timer),
               *check_flash_f32_bias_dropout(torch, timer),
               *check_xentropy(torch, timer),
               check_multi_tensor_update(torch, timer),
               check_vpu_probe(torch, timer), check_bottleneck(torch, timer)]
    for kr in kernels:
        log(f"kernel {kr['name']}: err {kr['max_abs_err']:.3g} "
            f"ms {kr['ms']:.4f} plain {kr['plain_ms']:.4f} "
            f"bound {kr['bound_ms']:.4f} ({kr['bound_by']}) "
            f"library {kr['library_ms']}")
        for extra in ("device_launches_per_call", "split_ms", "tflops",
                      "shuffle_kernel_ms", "checked",
                      "single_pass_ms", "b8_s1024", "registers",
                      "as_called_ms", "ms_by_block_rows", "long_shape",
                      "delta_fold_max_abs_err", "by_shape",
                      "train_shape", "lamb_ms", "by_op", "d128_shape",
                      "alone_ms", "split_as_called_ms", "no_dropout_ms",
                      "mask_check", "pair_max_abs_err", "no_bias_ms",
                      "positions", "live_pairs", "bias_only_ms",
                      "dropout_only_ms", "bitwise", "fill_rows",
                      "d64_shape", "single_pass_shape",
                      "cudnn_composition_max_abs_err", "plan"):
            if extra in kr:
                log(f"  {kr['name']} {extra}: {json.dumps(kr[extra])}")
    del timer
    log("repaired shapes and dtypes (ROADMAP §C): "
        + json.dumps(check_repairs(torch)))
    torch.cuda.empty_cache()

    cfg = gpt_config()
    t0 = time.perf_counter()
    params = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    log(f"params: {time.perf_counter() - t0:.1f} s")
    serve_stats = {}

    eng, ids, _, stats = run_serve_path(torch, cfg, params, "serve")
    serve_stats["serve"] = stats
    log(f"serve path ({card}): " + json.dumps(stats))
    tf = teacher_forced(torch, cfg, params, eng, ids)
    log("teacher-forced: " + json.dumps(tf) + f" (tolerance {TF_TOL}, "
        f"near-tie margin {TF_TIE})")
    check(tf["max_abs_diff"] <= TF_TOL,
          f"teacher-forced logits differ by {tf['max_abs_diff']}")
    check(tf["worst_flip_gap"] <= TF_TIE,
          f"argmax flip with plain gap {tf['worst_flip_gap']}")
    del eng

    eng, ids, _, stats = run_serve_path(torch, cfg, params, "serve-fp8")
    stats["pool_bytes_bf16_engine"] = serve_stats["serve"]["pool_bytes"]
    serve_stats["serve-fp8"] = stats
    log(f"serve-fp8 path ({card}): " + json.dumps(stats))
    tf8 = teacher_forced(torch, cfg, eng.params, eng, ids)
    tol8 = TF_FP8_FRAC * max(tf8["max_abs_logit"], 1.0)
    log("serve-fp8 teacher-forced, plain forward over the same e4m3 "
        f"weights: {json.dumps(tf8)} (tolerance {TF_FP8_FRAC} x max|logit| "
        f"= {tol8})")
    check(tf8["max_abs_diff"] <= tol8,
          f"serve-fp8 teacher-forced logits differ by {tf8['max_abs_diff']}")
    del eng

    spec, ids, out, stats = run_serve_path(torch, cfg, params,
                                           "serve-spec-fp8w")
    stats["pool_bytes_bf16_engine"] = serve_stats["serve"]["pool_bytes"]
    serve_stats["serve-spec-fp8w"] = stats
    log(f"serve-spec-fp8w path ({card}): " + json.dumps(stats))
    ident = spec_identity(torch, cfg, params, spec, ids, out)
    log("serve-spec-fp8w against a plain fp8-weights engine: "
        + json.dumps(ident))
    check(ident["first_token_divergence"] is None,
          f"speculative tokens differ from plain decode: {ident}")
    check(ident["logits_rows_compared"] > 0 and
          ident["logits_rows_bitwise_equal"] == ident["logits_rows_compared"],
          f"speculative logits rows differ from plain decode: {ident}")
    del spec
    torch.cuda.empty_cache()

    serve_trace = {**trace(torch, cfg, params, "serve"),
                   **trace(torch, cfg, params, "serve-fp8"),
                   **trace(torch, cfg, params, "serve-spec-fp8w")}
    log(f"serve prefill of one 512-token prompt, device against wall time "
        f"(trace, {card}): "
        + json.dumps({path: {k: serve_trace[f"{path} prefill_512"][k]
                             for k in ("device_ms_per_call",
                                       "wall_ms_per_call",
                                       "kernel_launches_per_call")}
                      for path in SERVE_PATHS}))
    log(f"serve decode step, device against wall time (trace, {card}): "
        + json.dumps({path: {k: serve_trace[f"{path} decode_step_b8"][k]
                             for k in ("device_ms_per_call",
                                       "wall_ms_per_call",
                                       "device_busy_share",
                                       "kernel_launches_per_call")}
                      for path in SERVE_PATHS}))
    del params
    torch.cuda.empty_cache()

    # the train path's GPT carries Megatron's dropout: its deterministic
    # steps are bitwise those of the config without
    # (tests/test_torch_gpt_dropout.py), and the dropout steps run on the
    # same model and optimizer state
    model, opt, state, sstate, step, tstats = run_train_path(
        torch, dropout_config(cfg))
    log(f"train path ({card}): " + json.dumps(tstats))
    train_trace, state, sstate = trace_train(torch, cfg, model, state,
                                             sstate, step)
    phases, state, sstate = step_phases(torch, cfg, model, opt, state,
                                        sstate)
    log(f"train step phases, device ms ({card}): " + json.dumps(phases))
    log("overflow: " + json.dumps(overflow_check(torch, cfg, model, opt,
                                                 state, sstate)))
    drop_stats, state, sstate, drop_step = run_dropout_path(
        torch, model, opt, state, sstate)
    drop_stats["without_dropout"] = {
        k: tstats[k] for k in ("step_ms_median", "step_ms_p90",
                               "tokens_per_s")}
    log(f"train-dropout path ({card}): " + json.dumps(drop_stats))
    drop_trace, state, sstate = trace_train(torch, cfg, model, state, sstate,
                                            drop_step)
    log(f"train step with and without dropout, device ms and launches by "
        f"kernel class (trace, {card}): " + json.dumps({
            name: {k: tr[k] for k in (
                "device_ms_per_call", "wall_ms_per_call",
                "device_ms_and_launches_by_class_per_call")}
            for name, tr in (("train_step", train_trace),
                             ("train_step_dropout", drop_trace))}))
    del model, opt, state, sstate, step, drop_step
    torch.cuda.empty_cache()
    det, drop = grad_check(torch, dropout_config(cfg), DROP_GEN_SEED + 1)
    log("grad check (kernels vs plain, tolerances: loss "
        f"{GRAD_LOSS_TOL}, relative norm {GRAD_NORM_TOL}): "
        + json.dumps(det))
    log("dropout grad check (kernels vs plain, the same seeds and hidden "
        f"masks; tolerances: loss {GRAD_LOSS_TOL}, relative norm "
        f"{GRAD_NORM_TOL}): " + json.dumps(drop))
    torch.cuda.empty_cache()

    long_stats, long_trace, (model, opt, state, sstate) = \
        run_long_seq_path(torch)
    log(f"train-gpt-s{LONG_S} path ({card}): " + json.dumps(long_stats))
    ldrop_stats, state, sstate, drop_step = run_dropout_path(
        torch, model, opt, state, sstate, LONG_B, LONG_S, LONG_DROP_PER_STEP,
        f"train-dropout-s{LONG_S}")
    ldrop_stats["without_dropout"] = {
        k: long_stats[k] for k in ("step_ms_median", "step_ms_p90",
                                   "tokens_per_s")}
    log(f"train-dropout-s{LONG_S} path ({card}): " + json.dumps(ldrop_stats))
    ldrop_trace, state, sstate = trace_train(
        torch, model.cfg, model, state, sstate, drop_step, LONG_B, LONG_S)
    log(f"train step s{LONG_S} with and without dropout, device ms and "
        f"launches by kernel class (trace, {card}): " + json.dumps({
            name: {k: tr[k] for k in (
                "device_ms_per_call", "wall_ms_per_call",
                "device_ms_and_launches_by_class_per_call")}
            for name, tr in ((f"train_step_s{LONG_S}", long_trace),
                             (f"train_step_dropout_s{LONG_S}",
                              ldrop_trace))}))
    del model, opt, state, sstate, drop_step
    torch.cuda.empty_cache()
    ldet, ldrop = grad_check(
        torch, dataclasses.replace(dropout_config(gpt_config(LONG_S)),
                                   num_layers=LONG_GRAD_LAYERS),
        DROP_GEN_SEED + 2, LONG_B, LONG_S)
    log(f"s{LONG_S} grad check, {LONG_GRAD_LAYERS} layers at full width "
        f"(kernels vs plain; tolerances: loss {GRAD_LOSS_TOL}, relative "
        f"norm {GRAD_NORM_TOL}): " + json.dumps(ldet))
    log(f"s{LONG_S} dropout grad check, {LONG_GRAD_LAYERS} layers at full "
        f"width (kernels vs plain, the same seeds and hidden masks; "
        f"tolerances: loss {GRAD_LOSS_TOL}, relative norm "
        f"{GRAD_NORM_TOL}): " + json.dumps(ldrop))
    torch.cuda.empty_cache()

    model, amp_model, opt, state, rn_stats, rn_trace = run_rn50_path(torch)
    log(f"train-rn50 path ({card}): " + json.dumps(rn_stats))
    log("train-rn50 overflow: " + json.dumps(rn50_overflow_check(
        torch, model, amp_model, opt, state)))
    log("train-rn50 grad check (kernels vs plain twin, tolerances: loss "
        f"{RN_LOSS_TOL}, relative norm {RN_GRAD_NORM_TOL}, median "
        f"{RN_GRAD_MEDIAN_TOL}): "
        + json.dumps(rn50_grad_check(torch, model, amp_model)))
    del model, amp_model, opt, state
    torch.cuda.empty_cache()
    zero_stats, zero_trace = run_zero3_path(torch, cfg)
    log(f"train-zero3 path ({card}): " + json.dumps(zero_stats))
    torch.cuda.empty_cache()
    lamb_stats = run_dflamb_path(torch, cfg)
    log(f"train-dflamb path ({card}): " + json.dumps(lamb_stats))
    torch.cuda.empty_cache()
    new_paths = {}
    for path, run in (("vpu-probe", run_probe_path),
                      ("bottleneck-b32", run_bottleneck_path),
                      ("spatial-bottleneck-b32", run_spatial_path),
                      ("train-o0-gpt2", run_o0_path),
                      (f"train-o0-gpt2-s{O0_LONG_S}", run_o0_long_path),
                      ("train-mha18-e1024-b16s512-bias", run_mha_bias_path),
                      ("train-mha18-e1024-b120s64-dropout",
                       run_mha_dropout_path),
                      ("train-mha16-e1024h8-b1s3072-bias", run_mha16_path),
                      ("train-mha16-e1024h8-b1s3072-bias-dropout",
                       run_mha16_dropout_path),
                      ("train-mha6-e1024h16-b28s128-bias-dropout",
                       run_mha6_path),
                      ("train-o0-dropout-gpt2-b8s1024",
                       run_o0_dropout_path),
                      ("train-o0-dropout-gpt2-b2s4096",
                       run_o0_long_dropout_path),
                      ("train-o0-mha16-e1024h8-b1s3072-bias",
                       run_o0_mha16_path),
                      ("train-o0-mha6-e1024h16-b28s128-bias",
                       run_o0_mha6_path),
                      ("train-o0-mha16-e1024h8-b1s3072-bias-dropout",
                       run_o0_mha16_dropout_path),
                      ("train-o0-mha6-e1024h16-b28s128-bias-dropout",
                       run_o0_mha6_dropout_path)):
        new_paths[path] = run(torch)
        log(f"{path} path ({card}): " + json.dumps(new_paths[path]))
        if "trace" in new_paths[path]:
            tr = new_paths[path]["trace"]
            log(f"{path} step by kernel class, device ms and launches "
                f"({card}): device {tr['device_ms_per_call']:.3f} ms, "
                + json.dumps(tr["device_ms_and_launches_by_class_per_call"]))
        torch.cuda.empty_cache()
    log("multihead attention grad checks, 2 layers at full width and the "
        "encdec module (kernels vs plain, the same host generator; "
        f"tolerances: loss {GRAD_LOSS_TOL}, relative norm {GRAD_NORM_TOL}): "
        + json.dumps(mha_grad_checks(torch)))
    torch.cuda.empty_cache()
    log("trace: " + json.dumps({**serve_trace, "train_step": train_trace,
                                "train_step_dropout": drop_trace,
                                f"train_step_s{LONG_S}": long_trace,
                                f"train_step_dropout_s{LONG_S}": ldrop_trace,
                                "train_step_rn50": rn_trace,
                                "train_step_zero3": zero_trace}))

    for kr in kernels:
        by_path = {path: st["launches"][kr["name"]]
                   for path, st in serve_stats.items()}
        by_path["train"] = tstats["launches"][kr["name"]]
        by_path["train-dropout"] = drop_stats["launches"][kr["name"]]
        by_path[f"train-gpt-s{LONG_S}"] = long_stats["launches"][kr["name"]]
        by_path[f"train-dropout-s{LONG_S}"] = \
            ldrop_stats["launches"][kr["name"]]
        by_path["train-rn50"] = rn_stats["launches"][kr["name"]]
        by_path["train-zero3"] = zero_stats["launches"][kr["name"]]
        by_path["train-dflamb"] = lamb_stats["launches"][kr["name"]]
        for path, st in new_paths.items():
            by_path[path] = st["launches"][kr["name"]]
        if kr["name"] == "multi_tensor_update":     # its LAMB mode too
            by_path["train-dflamb"] += lamb_stats["launches"][
                "multi_tensor_update_lamb"]
        kr["launches"] = sum(by_path.values())
        kr["launches_by_path"] = by_path
        check(kr["launches"] > 0, f"{kr['name']} never launched on a main "
              "path")

    log("profiler sessions: " + json.dumps(SESSIONS))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
