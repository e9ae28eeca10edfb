"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

For every Benchpress program of ``repro_torch.testing.programs`` (and the
quickstart's velocity-update block) at ``CHIP_SIZES`` — every array 128 MiB
of float64 — the script:

1. runs the program through the lazy runtime with ``backend="triton"`` and
   with ``backend="torch"`` (the floor), twice each in one runtime, and
   times the second (warm) run of each;
2. requires the two backends to agree: bitwise for programs built only
   from correctly rounded ops, else within ``rtol=atol=1e-9`` (the
   reference's own program tolerance);
3. requires at least one fused-block kernel launch, no block declined
   with the ``error`` slug, and no ``prng.uniform`` call on the triton
   path (B1 draws in-kernel); prints how many input buffers blocks
   overwrote in place (``donated_buffers``);
4. holds every distinct claimed block's kernel against its plain torch
   version on the block's own CUDA inputs — bitwise on the exact
   programs, else the same tolerance — called directly and as the
   executor called it (with its ``reuse`` grant, on copies);
5. times the program's largest block (most elements x ops): the kernel
   (its launches captured once in a CUDA graph with the arguments bound
   beforehand, so no host work is timed), the whole wrapper call as the
   executor made it (``call_ms``: output buffers, copies and launches, as
   one CUDA graph) and its plain version, each by CUDA events around
   back-to-back calls, median of 10, against its bound — the larger of
   the bytes it must move over the H100's 3.35e12 B/s and its operations
   over the non-FMA rate of their type;
6. times every distinct block's kernel and call the same way and prints
   what the program's launches lose to their bounds: the sums over its
   blocks of launches x (kernel ms - bound ms) and launches x (call ms -
   bound ms).  The LM lane's B1 and B2 blocks get the same sums, and a
   ``B1 LOSS`` line adds them up.

The ``PRNG`` lines hold B1's in-kernel draw bitwise against
``prng.uniform_at`` (odd lengths, 2-D, float32, float16) and time a
2**24-value float64 draw both ways.

Then the LM serving lane (``run_lm``): ``LazyTransformer`` at Qwen1.5-4B's
published widths (d_model 2560, 20 heads of 128, d_ff 6912, vocab 151936;
``qkv_bias`` off and float32, as the lazy lane admits, and ``LM_LAYERS`` of
its 40 layers), random weights from a seeded ``torch.Generator`` on the
card.  It prefills a batch of 4 prompts of 512 tokens into 1024-deep KV
caches, decodes 8 greedy tokens and runs one forward pass over 2 x 128
tokens, with ``backend="lm"`` (the main path: row-replay kernel B2 behind
the claimants, fused-block kernel B1, torch floor for matmuls and the
gather), with ``backend="torch"`` and with the direct model, all on the
lm run's tokens.  It requires logits and KV caches to agree within
``LM_RTOL`` of their largest magnitude, every flush to claim at least
2L+1 rmsnorm and 2L softmax blocks with no ``error`` decline, both kernels
to launch, and every distinct kernel of the run to match its plain
version; it times the largest B2 block and the largest rmsnorm block
(against ``torch.nn.functional.rms_norm``), warm prefill and decode per
token on all three paths, and one decode-step KV-cache window write
(the floor's functional write, and B1's block in place and with a copy).
Float32 matmuls run in full float32 (TF32 off).

Then the standalone model kernels (``run_model_kernels``): each public op
of ``repro_torch.kernels.*.ops`` on the card at the full widths of a model
config the repo holds — flash attention (B3, CUDA) for a Qwen1.5-4B
prefill and a Gemma2-9B local layer, fused add+RMSNorm (B4, Triton) at
Qwen1.5-4B's and Gemma2-9B's widths, the Mamba scan (B5, CUDA) of a
Jamba-v0.1 layer and the RWKV6 scan (B6, CUDA) of an RWKV6-3B layer —
with inputs from a seeded ``torch.Generator`` on the card.  The ops run
once with every launch count at 0 (the phase's main path); then each case
is held against its plain version on the same inputs, element by element
(``MODEL_TOL``, ``BF16_RTOL``), run again for a bitwise-equal result, and
timed (the kernel as a CUDA graph of its launch, the plain version and,
where one PyTorch call computes the same function, that call) beside its
bound.  The Gemma2-9B attention case also holds two planted faults — the
window 32 keys short and one key short — to the same check, and fails
unless the check rejects both; the Jamba-v0.1 scan case two more — the
state reset every 64 steps, A's state columns rolled by one.  B5's bound
counts its exponentials split at best between the SFU
(``SFU_OPS_PER_S``) and the FMA pipe (``EXP2_FMA_OPS`` each); its line
prints beside it the bounds with all of them on the SFU and with each as
one float32 operation.  B3's bound counts a float32 product on the
faster float32-accurate route, three TF32 tensor-core passes
(``TC_TF32_MACS_PER_S``), and a bfloat16 product at the bf16 tensor-core
rate.

Then the decode-attention kernel (``run_decode_attention``, the
``DECODE`` lines): ``torch.ops.repro_torch.decode_attention`` at the
served shapes of the benchmark's cells (``DECODE_CASES``: OLMoE-1B-7B
chat, 32 rows over 1280-deep caches of 16 / 16 heads; its rag cell, 8 rows
over 3600; Jamba-v0.1 chat, 32 rows over 1280 of 32 / 8 heads; bf16, hd
128, the token at the mean position of the cell's decode steps), each held
against its plain version (``MODEL_TOL``, ``BF16_RTOL``), run again for a
bitwise-equal result and timed (a CUDA graph of the call, the plain
version, and the one library call that computes it,
``F.scaled_dot_product_attention`` over the valid keys, timed only)
beside its bound, the valid keys' and values' bytes read once at 3.35
TB/s.  This is the yardstick of later work on that kernel.  Every served
path below counts the kernel's launches too (one an attention layer in a
decode graph's warm-up and one in its capture, none at replays) and
holds the calls of its decode graph's warm-up against the plain version;
all of them join the ``kernels`` line.

The model-kernel phase also runs the chunked RWKV6 kernel (B7, CUDA) on
the RWKV6-3B layer's inputs of B6's case, so the two are timed on the same
work; B7's bound counts the route it takes, its four products on the FP64
tensor cores (``TC_F64_MACS_PER_S``).

Then the RWKV6-3B serving path (``run_rwkv``): ``configs/rwkv6_3b.py`` at
its published widths and all 32 layers (d_model 2560, 40 heads of 64,
d_ff 8960, vocab 65536; bfloat16 compute, float32 parameters), random
weights from a seeded ``torch.Generator`` on the card with the norm gains
drawn around 1 and each layer's decay logits ``w0`` set to RWKV-LM's
RWKV-v6 ``time_decay`` initialisation (-6 to -1 across the channels).  It
serves 4 requests of ragged lengths (drawn as the launcher draws them,
left-padded to 512 tokens) in one batch through
``launch.serve.serve_requests`` — the weights cast once to bf16, the
prefill replayed as one CUDA graph, then 15 decode steps replayed as
another (B6 writing each layer's state in place into the graph's static
cache) — with every launch count at 0 just before.  It requires one
capture of 32 B7 launches replayed once and one capture of 32 B6
launches replayed 15 times (each after one eager warm-up run), and the
same tokens from the same requests served eagerly (``graph=False``); it
holds 4 graph steps' logits and caches bitwise to eager steps, and three
graph prefills of two batches through one capture bitwise to eager
prefills, and prints the graph pool's memory.  It holds the first and the
last layer's B7 and B6 calls of the warm-up runs against their plain
versions on the recorded inputs (outputs as above, final states in
float32 at ``MODEL_TOL``), reruns a B7 call for a bitwise-equal result,
requires prefill(P) followed by ``RWKV_EXTEND`` decode tokens to give the
last-position logits of prefill(P + those tokens) within ``RWKV_RTOL`` of
their largest magnitude, every logit finite, and times the warm prefill
(eager and as a replay, in turns), the decode step (graph replays, and
eager), one layer against its B7 call, and B7's and B6's calls (32
launches in a graph, as a prefill or a step makes them) against their
bounds.

Then the attention model families (``run_families``, the ``FAMILY``
lines).  Its main path: ``configs/gemma2_9b.py`` at all 42 layers and its
published widths (d_model 3584, 16 query heads and 8 kv heads of 256,
d_ff 14336, vocab 256000 tied, sliding window 4096 on the even layers,
softcaps 50 and 30, GeGLU, bf16 compute), random weights from a seeded
``torch.Generator`` on the card, cast once for serving and the float32
tree dropped.  It serves 2 requests of 4097-8192 tokens left-padded to
8192 and 16 greedy tokens through ``serve_requests`` — the prefill one
CUDA graph, the decode steps replays of another — with B3's and the
decode-attention kernel's counts at 0 just before.  It requires 42 B3
launches a prefill pass (21 local layers with window and softcap, 21
global with softcap; 84 at the wrapper, the warm-up and the capture) and
none in the decode graph, 84 decode-attention calls at the wrapper (the
decode graph's warm-up and capture; the first and last local layers,
rings past their window with softcap at hd 256, and global layers held
against the plain version), the tokens of
eager serving, a prefill replay and ``FAMILY_EXTEND`` decode replays
bitwise to eager ones, the first and last local and global layers'
recorded B3 calls within ``MODEL_TOL`` / ``BF16_RTOL`` of the plain
version, and prefill(8192) then ``FAMILY_EXTEND`` decode tokens within
``FAMILY_RTOL`` of prefill(8196)'s last logits, all finite: at 42 layers
in bf16 and at 2 (one local, one global) in float32, where the ring's
roll and slot arithmetic meet B3's float32.  It times the warm prefill
(eager and replayed, in turns), the decode step, and one local and one
global B3 call against their bounds (``_attention_work`` counts the
window's pairs only) and beside the one PyTorch call that computes the
same function (``_b3_library``: ``torch.compile(flex_attention)`` with a
tanh ``score_mod`` and a causal / window ``block_mask`` where there is a
softcap, else ``F.scaled_dot_product_attention(..., enable_gqa=True)``;
timed only, never on the path).  Then ``FAMILY_OTHERS`` — Qwen3-4B (qk-norm, GQA
4), StarCoder2-3B (GQA 12, gelu), LLaVA-NeXT-Mistral-7B (2880 patch
embeddings before the prompt), Whisper-tiny (4 + 4 layers, 1500 frames,
cross-attention with ``sq != sk`` also in every decode step) and
Qwen1.5-4B (QKV bias, bf16) as published, at 2 layers (Whisper whole):
2 requests of 512 and 412 tokens, 4 decode steps, each B3 call of the
first prefill pass and each decode-attention call of the decode graph's
warm-up held against the plain version, both kernels' counts, graph
replays bitwise to eager, prefill and decode times, and each distinct B3
shape's call timed as Gemma's are.  B3's and the decode-attention
kernel's launches join the ``kernels`` line.

Then the MoE and Mamba families (``run_moe``, the ``MOE`` lines), each
config of ``MOE_CASES`` at its published widths, bf16 compute, random
weights from a seeded ``torch.Generator`` on the card cast once for
serving, dropped before the next config: Jamba-v0.1
(``configs/jamba_v01_52b.py``) as one 8-layer period of its pattern — 7
Mamba layers (d_inner 8192, d_state 16) and one attention layer (32 / 8
heads of 128) at unit position 4, MoE (16 experts of 14336, top 2) on the
odd layers — 2 requests padded to 4096 tokens, 16 tokens; OLMoE-1B-7B
(``configs/olmoe_1b_7b.py``, 64 experts of 1024, top 8, float32 weights
cast once) at all 16 layers, 2 x 4096, 16 tokens; Qwen3-MoE-235B-A22B at
2 of its 94 layers (64 / 4 heads: a GQA group of 16; 128 experts of 1536,
top 8), 2 x 2048, 4 tokens.  Each is served through ``serve_requests``
with B3's, B5's and the decode-attention kernel's counts at 0 just
before: one prefill capture replayed once and one decode capture
replayed every step, B3 once an attention layer a prefill pass (none in
decode), the decode-attention kernel once an attention layer a decode
step (each call of the decode graph's warm-up held against the plain
version), B5 once a Mamba layer a prefill
pass and a decode step, the decode capture's B5 calls writing the ssm
state into the static cache (``out_state`` is ``state``).  It requires
the tokens of eager serving, a prefill replay and up to ``FAMILY_EXTEND``
decode replays bitwise to eager ones with every logit finite, every B3
call of a prefill pass within ``MODEL_TOL`` / ``BF16_RTOL`` of the plain
version, the first and last Mamba layer's B5 call of a prefill and the
first of a decode step (y and the final state) within ``MODEL_TOL``
(the plain scan takes about half a second a Jamba layer, so the other
calls are not held), and for Jamba the state hand-off: prefill(508) and 4
decode tokens against prefill(512) within ``FAMILY_RTOL``, on a copy of
the config with the capacity factor raised to n_experts / top_k so no
token drops.  It prints the share of token-expert pairs dropped at
capacity in a prefill (a diagnostic), warm prefill ms (eager and
replayed, in turns) and decode ms a step, each config's first B3 call
timed beside its library call and B5's prefill-layer and decode-layer
calls against their bounds (the state's bytes read and written
included).  B3's, B5's and the decode-attention kernel's launches join
the ``kernels`` line.

Then training (``run_train``, the ``TRAIN`` lines).  Its main path:
Qwen3-4B (``configs/qwen3_4b.py``) at its published widths and all 36
layers (d_model 2560, 32 / 8 heads of 128, d_ff 9728, vocab 151936, 4.41 B
parameters), float32 parameters, bf16 compute, int8 moments and remat
(the config's defaults), random weights from a seeded
``torch.Generator`` on the card with the norm gains drawn around 1,
batches of 4 x 2048 tokens from ``data.SyntheticLM(seed=0)`` in
``TRAIN_MICRO`` microbatches, ``TRAIN_STEPS`` steps of
``launch.steps.make_train_step`` (a warm-up, then the timed ones, the
card synchronized around each) at peak lr ``TRAIN_LR`` after a 1-step
warm-up, B3's count at 0 before each step.  It requires 288 B3 launches a
step (a forward and a remat recompute per layer and microbatch), every
loss finite and the last two averaging below the first, and prints step
ms (median and spread), tokens/s, 6·N·tokens over the step time as a
share of the card's dense bf16 rate, the peak memory, and one more step
under ``torch.profiler``: wall against device busy, the idle share, and
the device time split into B3, GEMMs, the plain attention backward and
the optimizer (the device spans of the step's ``record_function``
ranges) and the rest, with the top device operations.  The first
microbatch's first and last layer's B3 calls, forward and recompute, are
held against the plain version, and the first is timed beside its bound
and SDPA.  Then at 2 layers, full width, through the same step: every B3
call of a step held against the plain version; one step with B3 against
the same step with the plain version (the checker patches
``flash_attention.ops``' forward for that run only), from a common first
step, in float32 moments: the loss, every parameter and every moment
held to ``TRAIN_LOSS_RTOL``, ``TRAIN_PARAM_LR``, ``TRAIN_PARAM_SHARE``
and ``TRAIN_MOMENT_RTOL`` (the same with int8 moments printed); the loss
curves of ``TRAIN_SWEEP`` (peak lr, moments); and checkpoint/restart
through ``launch/train.py``'s path: ``FaultTolerantLoop`` with a
``CheckpointManager`` in a temporary directory under ``build/``, a save
every 2 steps and a step that raises once at step 3, the restored state
bitwise to the saved one and the replayed losses within
``TRAIN_REPLAY_RTOL`` of a run straight through.  Last, the AdamW tape
(``optim/fused.record_adamw_tape``) at ``TRAIN_TAPE_N`` float64 elements
under ``backend="triton"``: the update one block claimed by B1 with no
decline, bitwise to the torch floor, its blocks held bitwise against
their plain versions and the update block timed against its bound.  B3's
launches and the tape's B1 launches join the ``kernels`` line.

Then cross-flush loop fusion (``run_loop``, the ``LOOP`` lines):
heat_equation, sor, game_of_life and shallow_water at 4096² and
lattice_boltzmann at 256³ (``CHIP_SIZES`` widths), ``LOOP_ITERS``
iterations each, per-flush and loop-fused (the default threshold 3 and
unroll 32: per-flush warm-up, two full drains of 32 replays of one
captured CUDA graph of an iteration, a tail drain), cold then warm in one
runtime each.  It prints wall and flush ms per iteration of both modes,
the deferred share and drains, the captures, replays and state copies,
B1's launches by its wrappers, and a third loop-fused run's device busy
time under ``torch.profiler``; it requires the final arrays of the two
modes bitwise equal, a capture and more than one replay, and no block on
the floor.  Then a random-bearing ``IterativeProgram`` (``LOOP_RANDOM``)
loop-fused against per-flush bitwise (the draws read their key words from
the body's device key table, so a frozen salt would show), every
loop-form B1 call of its body held bitwise against its plain key-table
form on the recorded inputs, and the largest drawing block's loop form
timed against the per-flush form and the plain version.

It then measures the per-block launch cost the ``gpu`` cost model uses
(``LAUNCH_COST``) and runs the calibration phases (``run_a7``).
``CALIBRATE``: ``tuning.calibrate`` on the card at its default sizes (32
KiB to 32 MiB an array), both backends, seeds 0-3, 3 flushes each, the
profile saved to ``build/calibration_profile.json`` and installed again
from the file, which must give the same fit; it prints the samples, the
fitted launch price per backend in us and byte slope per backend as a
multiple of 1/3.35e12 s/B, the residual, the ``gpu`` model's constant and
this run's ``LAUNCH_COST``. ``CALIBRATED <program>``: every program at
``CHIP_SIZES`` under ``cost_model="gpu"`` and ``"calibrated"`` (the fit
installed), triton backend, loop fusion off, cold then warm in one runtime
each: the blocks a run, how many lowering decisions of the gpu runs'
executed blocks differ when recomputed under both models, the blocks on
triton and on the floor, warm and cold walls, and agreement (bitwise on
the exact programs, else ``TOL``). ``ILP <program>``: the same programs
with ``partition_backend="ilp"`` and ``time_budget_s`` = ``ILP_BUDGET_S``
under ``gpu``: the solver's statuses, objectives against greedy's (never
greater), gap, nodes and wall, blocks and walls against the greedy runs,
and agreement with them as above. ``EXPLAIN``: ``tools/explain_torch.py
--json`` on the card, requiring a rejected merge with a priced saving, the
flush's plan resident in the merge cache and every work block's replayed
winner to be the backend the executor ran. B1's launches in these phases
are counted from 0 in each and join the ``kernels`` line.

Then B1's contracting form (``run_fma``, the ``FMA`` lines): every program
at ``CHIP_SIZES`` under ``cost_model="gpu_fma"``, triton backend, loop
fusion off, where every B1 kernel must be the contracting form (one
``tl.fma`` a multiply→add pair).  (a) The result is held against the
PROGRAM phase's floor result: within the pairs' allowance, the sum over
the run's launches of each contracting kernel's ``u · max(|a·b| + 2·|a·b
+ c|)`` over its pairs on its first call's inputs (``FMA_UNIT``: 2⁻⁵³
float64, 2⁻²⁴ float32; absolute, as a contraction under cancellation may
change every relative digit), and for the programs outside ``EXACT``
within ``TOL`` plus that allowance; an exact program past it is held by
``TOL`` and named (amplified).  Each contracting kernel is held the same
way against its plain version on its first call's inputs.  (b) Each
program's contracted pairs — the model's ``_fma_pairs`` over its distinct
claimed blocks, the generator's analysis, the kernels' plans and the
``tl.fma`` calls in their sources — must be equal.  (c) Every distinct
block with a pair is timed in both forms (``kernel_ms``: bitwise,
contracting, contracting, bitwise) and the per-pair saving printed, its
median (clamped at 0) the ``gpu_fma`` model's ``FMA_BONUS_S``.  (d) The
programs whose flush tapes ``gpu_fma`` at that bonus partitions otherwise
than ``gpu`` are counted.  B1's launches on the phase's main path join the
``kernels`` line.

The MODEL phase ends with B3's repeat check (``b3_repeat``, ROADMAP C21):
its Qwen1.5-4B case and the case's bf16 split-P form ``B3_REPEATS`` times
each on the same inputs, every output bitwise to the first and within the
phase's allowance of the plain version.

Then the serving layer (``run_serve``, the ``SERVE`` lines):
``repro_torch.core.serve.Server`` on the card, 4 tenants x 8 requests
back to back from one thread each (odd requests of one shared structure,
even ones with a tenant literal; data ``floor(16 u)`` from a generator
seeded 8), at 2**24 elements a request array (128 MiB) and at 4096, under
``backend="torch"`` (the floor, so equal structures batch) and
``backend="triton"`` (B1: every request solo).  Per (backend, size): a
serial batching-off server gives the reference values; a concurrent
warm-up pass, a timed pass (``SERVE_WINDOW_S``, ``SERVE_MAX_BATCH``) and a
profiled repeat of it must each equal them bitwise; a plan-store warm
start (a cold server writes, a fresh one over the same directory hits and
plans no partition); at 2**24 also ``check_serve``'s seeded requests with
``random`` (a 0.25 s window, a barrier a round).  It requires a batch at
each size under torch, and under triton no batch and B1 launches in the
timed pass.  Each line prints QPS and p50/p99 submit latency of the timed
pass, its batched share and B1 launches, a request's host-to-device and
device-to-host copy ms, the profiled pass's device busy time and idle
share, and the warm start's writes, hits and partition spans.  B1's
launches over the phase join the ``kernels`` line.

Then the mesh (``run_mesh``, the ``MESH`` lines; ``core/dist`` and the
``shard_map`` backend).  (a) A world of one over NCCL in this process
(``dist.host_mesh()``): black_scholes, game_of_life and heat_equation at
``CHIP_SIZES`` and ``tests/test_dist_fusion.py``'s window, aligned and
reduction programs at ``MESH_SIZE`` float64 elements with ``dist.shard``
applied, under ``backend="triton"`` and ``cost_model="comm"``, in a
runtime with the mesh and one without, each cold once and then
``MESH_REPS`` warm runs each in turns (the medians compared), B1's
launches counted in the mesh runs: each bitwise to the run without a
mesh, with B1 launches (over
one rank every base is replicated, so ``shard_map`` declines every block
and B1 runs them); then a plan store shared by a mesh runtime, a
mesh-less one and a second mesh runtime: the mesh-less runtime must miss
the mesh's plans (the topology is in the key) and the second mesh runtime
hit them.  The process group is destroyed before (b).  (b) ``MESH_RANKS``
ranks spawned on the one card over gloo (``testing.mesh.spawn``; gloo
stages each collective through host memory, so these walls are not the
fabric's): the three programs at ``MESH_SIZE`` under ``greedy`` and
``singleton`` on the mesh and without one, each bitwise to the
single-device run on every rank, ``shard_map_blocks`` above 0 and fused
collectives and fabric bytes below unfused on the window program, then
``check_dist`` on ``MESH_SEEDS`` at ``MESH_SEED_SIZE`` elements (the torch
floor).  Each run's line prints its warm wall, blocks per backend,
``shard_map`` blocks, collectives and interconnect bytes; (a)'s B1
launches join the ``kernels`` line.  (c) The model on the mesh
(``launch/mesh.py``, ``launch/steps.py``'s ``make_train_step(cfg, mesh)``
and ``make_serve_steps``; every parameter and moment a DTensor, kernels
B3, B5, B6 and B7 on each rank's local shards through
``models.layers.sharded_call``).  (c1) A world of one over NCCL
(``make_host_mesh()``, (1, 1)): Qwen3-4B at full width and 36 layers
from TRAIN's weights, batch and lr, ``MESH_TRAIN_STEPS`` steps: the
first loss bitwise to TRAIN's first, the second within
``TRAIN_REPLAY_RTOL`` of TRAIN's second, B3 launched 288 times a step
and its first call held against its plain version; then Qwen3-4B at 36
layers and Jamba-v0.1 and RWKV6-3B at 2 layers served through
``make_serve_steps`` (``MESH_SERVE``), every logit within
``FAMILY_RTOL`` of the mesh-less model's on the same tokens, B3, B5, B6
and B7 counted and a first call of each held against its plain version.
(c2) ``MESH_RANKS`` ranks on the one card at ``MESH_GRID``
(``testing.mesh.spawn`` with ``pg_backend="hoststaged"``: every
collective copies to host memory and runs gloo's, so its walls are not a
fabric's): Qwen3-4B at full width and ``MESH_C2_LAYERS`` layers, a
warm-up and a timed train step (``testing.mesh.model_suite``), every
rank's loss within ``TRAIN_LOSS_RTOL`` of the one-rank run at the same
depth and B3 launched layers x microbatches x 2 times a step, the serve
steps within ``FAMILY_RTOL``; ``pipeline_apply`` of ``MESH_PIPE`` over
(4, 1) against the stages composed in order; ``reshard_params`` through
a checkpoint from (4, 1) to (2, 2), bitwise.  Each rank prints its step
ms, peak memory and its collectives by kind (``CommDebugMode``) and
bytes (the staged group's own count).  Part (c)'s launches join the
``kernels`` line.

Then the multi-pod dry run (``run_dryrun``, the ``DRYRUN`` lines;
``launch/dryrun.py``).  Its traces of fake CUDA tensors run in
subprocesses (this process holds NCCL's group), ``DRYRUN_WORKERS`` at a
time at a lower priority, started when the script starts and collected
here; each must leave the card's ``memory_allocated`` at 0.  (a) The
cells of ``DRYRUN_CELLS`` through the CLI over the fake group of 256 or
512 ranks at published widths and full depth: per cell its arguments
and peak temporaries in GiB against the card's memory, FLOPs, dot FLOPs,
kernel calls, collectives by kind and the trace's seconds.  (b) TRAIN's
cell (Qwen3-4B, 36 layers, ``TRAIN_BATCH`` x ``TRAIN_SEQ``,
``TRAIN_MICRO`` microbatches, int8 moments) traced on a fake (1, 1) mesh
against MESH (c1)'s real first step: the argument bytes must equal the
parameters', moments' and batch's, ``flops_per_device`` must equal
``FlopCounterMode`` over that step, and the trace's temporaries must be
within ``DRYRUN_TEMP_RTOL`` of (c1)'s ``max_memory_allocated`` less its
parameters and moments.  (c) MESH (c2)'s train cell traced over a fake
(2, 2) group: its counts of the reference's collective kinds must equal
(c2)'s ``CommDebugMode`` counts of its first step; its result bytes are
printed beside (c2)'s staged input bytes.

Last it prints a ``kernels`` JSON line (B1-B7; B3's entry is its
largest-bound case, since the FAMILY phase a served Gemma2-9B layer, and
B5's since the MOE phase a served Jamba-v0.1 prefill layer with its
state), the card's name and power limit, and ``{"ok": true, "device": {...}}``. Any failure raises (exit code 1). The
Triton kernels are generated and compiled under ``build/`` as the run
needs them; the CUDA kernels are compiled into ``build/cuda/`` at their
first launch, one ``nvcc`` per source at once, then linked.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate (data sheet)
#: the FMA phase: the unit roundoff of a contracted pair's dtype
FMA_UNIT = {"float64": 2.0 ** -53, "float32": 2.0 ** -24}
#: peak non-tensor-core operation rates of an H100 SXM by type.  The data
#: sheet's FP64 34 and FP32 67 TFLOP/s count an FMA as two operations; the
#: kernels launch with FMA contraction off, so one operation issues per
#: lane and cycle: half those rates.  Other types take the float32 rate,
#: the issue limit of 4 warp schedulers x 32 lanes an SM a clock (132 SMs,
#: 1.98 GHz).  32-bit integer work (the in-kernel threefry) included: the
#: Hopper white paper's 64 INT32 lanes an SM would give 16.7e12/s, but
#: monte_carlo_pi's two in-kernel draws ran 76 uint32 operations an
#: element at 18.7e12/s on the card, above that, so only the issue limit
#: is a floor there
PEAK_OPS_PER_S = {"float64": 17e12, "float32": 33.5e12}
TOL = dict(rtol=1e-9, atol=1e-9)
#: programs whose every op is correctly rounded and whose reductions (if
#: any) sum exact integers: the fused kernel must match the floor bit for bit
EXACT = {"game_of_life", "heat_equation", "sor", "water_ice", "shallow_water",
         "gauss_elimination", "lu_factorization", "stencil_27pt",
         "lattice_boltzmann", "monte_carlo_pi"}
#: the LM lane's run: depth cut from 40 (host planning grows faster than
#: linearly with the tape), widths as published
LM_LAYERS = 8
LM_BATCH, LM_PROMPT, LM_MAX_SEQ, LM_STEPS = 4, 512, 1024, 8
LM_FORWARD = (2, 128)
#: lm vs floor vs direct model: logits and caches within this fraction of
#: their largest magnitude.  float32 row sums over 512-6912 terms run in
#: other orders on the three paths, compounded over the layers; measured
#: at most 4.0e-6 on an H100, so this is about 10x that
LM_RTOL = 5e-5
F32_EPS = float(np.finfo(np.float32).eps)
#: the model kernels' bound counts an FMA as one operation, like the rates
#: above: float32 work on the CUDA cores at PEAK_OPS_PER_S["float32"], and
#: bfloat16 products on the tensor cores at the data sheet's 989e12
#: FLOP/s, 494.5e12 multiply-adds per second
TC_BF16_MACS_PER_S = 989e12 / 2
#: TF32 products on the tensor cores: the data sheet's dense 494.5e12
#: FLOP/s, 247.25e12 multiply-adds per second.  One TF32 product keeps 10
#: mantissa bits; three of them (3xTF32: hi·hi + hi·lo + lo·hi of each
#: operand split into TF32 hi + lo) compute a float32 product to float32
#: accuracy, so a float32 product's least time is the smaller of its FMAs
#: on the CUDA cores and three TF32 passes on the tensor cores
TC_TF32_MACS_PER_S = 494.5e12 / 2
#: float64 products on the tensor cores (DMMA): the data sheet's 67e12
#: FLOP/s, 33.5e12 multiply-adds per second
TC_F64_MACS_PER_S = 67e12 / 2
#: special-function results (MUFU: ex2, rcp, rsqrt, ...): 16 a clock an SM
#: on Hopper (CUDA C++ Programming Guide, arithmetic instruction
#: throughput, compute capability 9.0), 132 SMs at the 1.98 GHz of the
#: rates above
SFU_OPS_PER_S = 132 * 16 * 1.98e9
#: float32 operations of an exponential taken on the FMA pipe in place of
#: the SFU, to float32 accuracy: a Cody-Waite reduction (round, subtract)
#: and a degree-5 minimax polynomial by Horner's rule (5 FMAs); the
#: exponent's insertion runs on the integer pipe
EXP2_FMA_OPS = 7
#: kernel vs plain version on the card, per element |err| <= rtol·|plain| +
#: atol.  atol is the reference's own float32 tolerance (tests/
#: test_kernels.py): attention and norm 2e-5, scans 3e-4 (sums in other
#: orders); rtol is 0 for float32 outputs.  bfloat16 outputs: both sides
#: compute in float32 and round once, so beyond the float32 difference they
#: differ by at most one bf16 ulp, 2^-7 of the value: rtol BF16_RTOL
MODEL_TOL = {"flash_attention": 2e-5, "rmsnorm": 2e-5, "mamba_scan": 3e-4,
             "rwkv6_scan": 3e-4, "rwkv6_chunked": 3e-4,
             "decode_attention": 2e-5}
BF16_RTOL = 2.0 ** -7
#: the RWKV6-3B serving run: 4 requests in one batch, prompts left-padded
#: to 512 tokens, 16 greedy tokens (a prefill and 15 decode steps)
RWKV_BATCH, RWKV_PROMPT, RWKV_NEW_TOKENS = 4, 512, 16
#: decode tokens after prefill(P), held against prefill(P + those tokens)
RWKV_EXTEND = 4
#: ... within these fractions of the largest logit magnitude, about 10x
#: the measured on an H100 (0.067 and 0.063 in bfloat16, 4.8e-4 in
#: float32).  In the published bfloat16 the two runs differ by bf16
#: products of other shapes (4 rows a decode step against 2064 a prefill)
#: rounding at other places, compounded over 32 random layers: a loose
#: check.  The same weights computing in float32 take most of that noise
#: away and hold B6's state, carried token by token, against B7's chunks
#: 130x tighter
RWKV_RTOL = {"bfloat16": 0.7, "float32": 5e-3}
#: the FAMILY phase: Gemma2-9B at all 42 layers and its published widths,
#: 2 requests of 4097-8192 tokens left-padded to 8192 (past the 4096
#: window: every local layer's ring is rolled and its window mask bites),
#: 16 greedy tokens
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW_TOKENS = 2, 8192, 16
#: decode tokens after prefill(P), held against prefill(P + those tokens)
FAMILY_EXTEND = 4
#: ... within these fractions of the largest logit magnitude: the RWKV
#: phase's bounds (``RWKV_RTOL``), for the same reasons.  In bfloat16 at
#: 42 layers the two runs round bf16 products of other shapes at other
#: places; in float32 (2 layers at the same widths, one local and one
#: global) B3's 3xTF32 prefill meets the decode's float32 einsum over the
#: ring
FAMILY_RTOL = {"bfloat16": 0.7, "float32": 5e-3}
#: the other attention configs as published, at 2 layers (Whisper-tiny
#: whole, 4 + 4): 2 requests of 512 and 412 tokens (LLaVA's 2880 patches
#: before them, Whisper's 1500 frames beside them), 4 decode steps
FAMILY_OTHERS = ("qwen3-4b", "starcoder2-3b", "llava-next-mistral-7b",
                 "whisper-tiny", "qwen1.5-4b")
FAMILY_OTHER_BATCH, FAMILY_OTHER_PROMPT, FAMILY_OTHER_STEPS = 2, 512, 4
#: the MOE phase: (arch, layers, requests, prompt tokens a request after
#: padding, new tokens), widths as published.  Jamba-v0.1 (52 B
#: parameters, 104 GB in bf16, more than the card holds) as one 8-layer
#: period of its pattern: 7 Mamba layers and one attention layer, 4 MoE
#: layers and 4 dense MLPs, 13.3 B parameters; OLMoE-1B-7B at all 16
#: layers (None); Qwen3-MoE-235B-A22B at 2 of its 94
MOE_CASES = (("jamba-v0.1-52b", 8, 2, 4096, 16),
             ("olmoe-1b-7b", None, 2, 4096, 16),
             ("qwen3-moe-235b-a22b", 2, 2, 2048, 4))
#: the TRAIN phase: Qwen3-4B (configs/qwen3_4b.py) at its published widths
#: and all 36 layers, float32 parameters, bf16 compute, int8 moments and
#: remat (the config's defaults), batch 4 x 2048 tokens in 4 microbatches
#: of 1 x 2048, TRAIN_STEPS steps (a warm-up, then the timed ones) at peak
#: lr TRAIN_LR after a 1-step warm-up (step 0 has lr 0), cosine over
#: TRAIN_TOTAL steps
TRAIN_ARCH = "qwen3-4b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 4, 2048, 4
TRAIN_STEPS = 6
TRAIN_LR = 3e-5
TRAIN_TOTAL = 1000
#: the 2-layer loss curves printed beside it: (peak lr, moments)
TRAIN_SWEEP = ((TRAIN_LR, "int8"), (TRAIN_LR, "f32"), (3e-4, "int8"),
               (3e-4, "f32"))
#: the held runs: the same config at 2 layers (full width) through the
#: same make_train_step; the checkpoint/restart run: steps, save every,
#: the step that raises once
TRAIN_HOLD_LAYERS = 2
TRAIN_RESTART = (5, 2, 3)
#: the AdamW tape at the size of one MLP weight (d_model x d_ff)
TRAIN_TAPE_N = 2560 * 9728
#: B3 step vs plain step, the second step from a common first, with
#: float32 moments: the loss's relative difference; the parameters'
#: largest difference in units of lr (that step's Adam update, (0.9 m1 +
#: 0.1 g) / 0.19 over the root of (0.95 v1 + 0.05 g^2) / 0.0975, is at most
#: about 3 in those units, so two of them differ by at most about 6) and
#: the share of weights off by more than TRAIN_PARAM_SHARE_AT lr; each
#: moment leaf's largest difference over its largest value (the second
#: step's gradient enters m and v by 0.1 and 0.05 of it).  With int8
#: moments the same step is printed, not held: a code at a rounding edge,
#: or a row whose second-moment code is zero (the update then divides by
#: eps), moves its weight by many lr (on an H100 80GB HBM3 at 700 W:
#: 133 lr apart for losses 3.6e-6 apart)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_LR = 8.0
TRAIN_PARAM_SHARE_AT, TRAIN_PARAM_SHARE = 0.01, 0.02
TRAIN_MOMENT_RTOL = 0.05
#: the replay's losses against the straight run's, relative: the same
#: arithmetic on the same data, bitwise on an H100 80GB HBM3, but
#: PyTorch does not promise a deterministic backward on the card (an
#: atomic add's order can flip a bf16 accumulator's rounding and an Adam
#: sign), so a tolerance
TRAIN_REPLAY_RTOL = 1e-4
#: Jamba's state hand-off: prefill(MOE_HANDOFF - MOE_EXTEND tokens) then
#: MOE_EXTEND decode tokens against prefill(MOE_HANDOFF), within
#: FAMILY_RTOL, on a copy of the config whose capacity factor is
#: n_experts / top_k: a group's dropped tokens depend on the group, so at
#: the published 1.25 the two runs would drop different tokens
MOE_HANDOFF, MOE_EXTEND = 512, 4
#: the LOOP phase: the iterative programs at their CHIP_SIZES widths, each
#: run for 3 x the default unroll of 32 iterations, so with the default
#: threshold of 3 a loop-fused run has its per-flush warm-up, two full
#: drains and a tail drain
LOOP_PROGRAMS = ("heat_equation", "sor", "game_of_life", "shallow_water",
                 "lattice_boltzmann")
LOOP_ITERS = 96
#: the random-bearing IterativeProgram held loop-fused against per-flush
#: on the card: (seed, steps, size).  Seed 0's step draws three times and
#: carries a stencil in place and a reduction fed back; 40 steps give a
#: full drain of 32 and a tail of 5
LOOP_RANDOM = (0, 40, 2 ** 20)
ROOT = Path(__file__).resolve().parent
#: the CALIBRATE phase's profile (``build/`` is not committed)
CALIBRATION_PROFILE = ROOT / "build" / "calibration_profile.json"
#: the ILP phase: the solver's wall-clock cap a flush
ILP_BUDGET_S = 1.0
#: the SERVE phase's load (after the reference's serving benchmark): 4
#: tenants x 8 requests back to back, odd requests of one shared
#: structure, even ones with a tenant literal; 2**24 elements a request
#: array (128 MiB, CHIP_SIZES) and the reference's own 4096
SERVE_TENANTS, SERVE_REQUESTS = 4, 8
SERVE_SIZES = (2 ** 24, 4096)
#: the MESH phase: its programs' size, the benchmark programs part (a) runs
#: at ``CHIP_SIZES``, part (a)'s warm runs a side, the ranks of part (b)
#: and its ``check_dist`` seeds
MESH_SIZE = 2 ** 24
MESH_PROGRAMS = ("black_scholes", "game_of_life", "heat_equation")
MESH_REPS = 5
MESH_RANKS = 4
MESH_SEEDS = tuple(range(8))
MESH_SEED_SIZE = 2 ** 20
#: the MESH phase's part (c), the model on the mesh.  (c1) a world of one:
#: Qwen3-4B trained as TRAIN trains it (its weights, batch and lr) for
#: MESH_TRAIN_STEPS steps, then served (batch, prompt tokens, decode
#: steps) at all 36 layers, and MESH_SERVED served at 2 layers the same
#: way.  (c2) MESH_RANKS ranks on the one card at MESH_GRID over ("data",
#: "model"), their collectives staged through the host: Qwen3-4B at full
#: width and MESH_C2_LAYERS layers trained on batch x seq tokens in one
#: microbatch (a warm-up step, then a timed one) and served (batch, prompt,
#: decode steps); the pipeline of MESH_PIPE (d, microbatches, rows a
#: microbatch; weights N(0, 1/d), a gain of about 1 a stage) over (4, 1)
#: ("pod", "data"); the elastic re-shard of
#: MESH_ELASTIC_LAYERS layers' groups through a checkpoint
MESH_TRAIN_STEPS = 2
MESH_SERVE = (2, 512, 8)
MESH_SERVED = ("jamba-v0.1-52b", "rwkv6-3b")
MESH_GRID = (2, 2)
MESH_C2_LAYERS = 2
MESH_C2_TRAIN = (4, 256)
MESH_C2_SERVE = (2, 256, 4)
MESH_PIPE = (2560, 8, 16)
MESH_ELASTIC = ((4, 1), (2, 2))
MESH_ELASTIC_LAYERS = 1

#: the DRYRUN phase (``launch/dryrun.py``): part (a)'s production cells,
#: (arch, shape, mesh), the last one skipped by ``cell_enabled``
DRYRUN_CELLS = (("qwen3-4b", "train_4k", "single"),
                ("qwen3-4b", "prefill_32k", "single"),
                ("qwen3-4b", "decode_32k", "single"),
                ("qwen3-4b", "train_4k", "multi"),
                ("rwkv6-3b", "long_500k", "single"),
                ("qwen3-4b", "long_500k", "single"))
#: dry-run subprocesses at a time, beside the earlier phases
DRYRUN_WORKERS = 3
#: part (b): the trace's temporaries against the card's, relative
DRYRUN_TEMP_RTOL = 0.25
SERVE_WINDOW_S, SERVE_MAX_BATCH = 0.002, 4


def cuda_ms(fn, reps: int = 10, burst: int = 5) -> float:
    """Device time of one call of ``fn``: CUDA events around ``burst``
    back-to-back calls, divided by ``burst``; the median of ``reps`` such
    samples, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / burst)
    return statistics.median(times)


def kernel_ms(kernel, store, salts, device) -> float:
    """Device time of one launch of a block's kernel and its combine
    passes: arguments bound (and output buffers made) first, the launches
    captured in a CUDA graph, and the graph replayed under
    :func:`cuda_ms`."""
    run, _ = kernel.prepare(store, salts, device)
    return graph_ms(run)


def call_ms(kernel, bufs_and_salts, kw=None) -> float:
    """Device time of the whole wrapper call ``kernel(*bufs, salts, **kw)``
    as the executor made it (``kw`` holds the ``reuse`` grant it passed):
    everything the call launches, captured as one CUDA graph and replayed
    under :func:`cuda_ms`.  A call granted reuse overwrites its inputs on
    every replay; the recorder's copies are only timed after that."""
    return graph_ms(lambda: kernel(*bufs_and_salts, **(kw or {})))


def graph_ms(fn, calls: int = 1) -> float:
    """Device time of ``fn`` with no host work timed: ``calls`` calls of it
    captured in a CUDA graph, the graph replayed under :func:`cuda_ms`,
    over ``calls`` (for kernels short enough that a Python call would
    show; a graph replay costs about 0.011 ms of its own on an H100, so a
    kernel of a few microseconds is timed over many calls)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay) / calls


def max_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    both_nan = np.isnan(got) & np.isnan(want)
    d = np.where(both_nan, 0.0, np.abs(got - want))
    return float(d.max()) if d.size else 0.0


def check_close(got, want, what: str, exact: bool) -> float:
    got, want = np.asarray(got), np.asarray(want)
    err = max_err(got, want)
    if exact:
        if not np.array_equal(got, want, equal_nan=True):
            raise AssertionError(f"{what}: not bitwise equal (max err {err})")
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    return err


class BlockRecorder:
    """Remembers, per distinct block signature, the generated kernel (of
    class ``kernel_cls``), clones of the inputs of its first call (the
    executor may let a call overwrite an input buffer, so the recorder
    keeps its own copies), the keywords of that call (the executor's
    ``reuse`` grant) and its number of calls, one launch each."""

    def __init__(self, kernel_cls):
        self.kernel_cls = kernel_cls
        self.calls = {}
        self.counts = {}      # calls (launches) per kernel
        self._orig = kernel_cls.__call__

    def __enter__(self):
        calls, counts, orig = self.calls, self.counts, self._orig

        def spy(kernel, *bufs_and_salts, **kw):
            if id(kernel) not in calls:
                *bufs, salts = bufs_and_salts
                calls[id(kernel)] = (kernel, (*(b.clone() for b in bufs),
                                              salts), dict(kw))
            counts[id(kernel)] = counts.get(id(kernel), 0) + 1
            return orig(kernel, *bufs_and_salts, **kw)

        self.kernel_cls.__call__ = spy
        return self

    def __exit__(self, *exc):
        self.kernel_cls.__call__ = self._orig


def run_program(name: str, args, fn, codegen, lazy) -> dict:
    from repro_torch.core import prng
    out, warm_s, stats, draws = {}, {}, {}, {}
    for backend in ("triton", "torch"):
        prng.CALLS["uniform"] = 0
        with lazy.fresh_runtime(backend=backend, loop_fusion=False) as rt:
            runs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = np.asarray(fn(*args))
                torch.cuda.synchronize()
                runs.append((res, time.perf_counter() - t0))
            out[backend] = [r for r, _ in runs]
            warm_s[backend] = runs[1][1]
            stats[backend] = rt.executor.stats.snapshot()
        draws[backend] = prng.CALLS["uniform"]
    if draws["triton"]:
        raise AssertionError(f"{name}: the triton path called prng.uniform "
                             f"{draws['triton']} times")
    exact = name in EXACT
    err = 0.0
    for k in range(2):
        err = max(err, check_close(out["triton"][k], out["torch"][k],
                                   f"{name} run {k}: triton vs torch", exact))
        if not np.all(np.isfinite(out["triton"][k])):
            raise AssertionError(f"{name}: non-finite result")
    st = stats["triton"]
    if "error" in st["triton_fallbacks"]:
        raise AssertionError(f"{name}: a block was declined with 'error'")
    return {"stats": st, "warm_s": warm_s, "err": err, "exact": exact,
            "draws": draws, "floor": out["torch"][0]}


def block_bound(kernel, module) -> dict:
    """A block's bound: the larger of its bytes over the memory rate and
    its operations over the rate of their type."""
    nbytes = module.block_bytes(kernel.plan)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max((n_ops / PEAK_OPS_PER_S.get(dt, PEAK_OPS_PER_S["float32"])
                  for dt, n_ops in module.block_ops(kernel.plan).items()),
                 default=0.0) * 1e3
    return {"bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _block_inputs(kernel, bufs_and_salts):
    """``kernel.prepare``'s arguments: the input store, the salts (B2,
    which draws nothing, ignores them) and the device."""
    *bufs, salts = bufs_and_salts
    store = dict(zip(kernel.plan.inputs, bufs))
    dev = bufs[0].device if bufs else torch.device("cuda")
    return store, salts, dev


def time_block(kernel, bufs_and_salts, kw, module) -> dict:
    """Kernel (CUDA graph), whole-call (CUDA graph) and plain-version
    device time of one block on its recorded inputs, with its bound
    (:func:`block_bound`)."""
    ms = kernel_ms(kernel, *_block_inputs(kernel, bufs_and_salts))
    plain_ms = cuda_ms(lambda: kernel.plain(*bufs_and_salts))
    return {"ms": ms, "call_ms": call_ms(kernel, bufs_and_salts, kw),
            "plain_ms": plain_ms, "domain": kernel.plan.domain,
            **block_bound(kernel, module)}


def block_loss(calls: dict, counts: dict, module) -> dict:
    """What a run's blocks lose to their bounds: every distinct block's
    kernel and whole wrapper call timed on its recorded inputs (as
    :func:`time_block` does), and the sums over blocks of launches x
    (kernel ms - bound ms) and launches x (call ms - bound ms)."""
    t0 = time.perf_counter()
    loss = call_loss = 0.0
    for key, (kernel, bufs_and_salts, kw) in calls.items():
        bound = block_bound(kernel, module)["bound_ms"]
        ms = kernel_ms(kernel, *_block_inputs(kernel, bufs_and_salts))
        loss += counts[key] * (ms - bound)
        call_loss += counts[key] * (call_ms(kernel, bufs_and_salts, kw)
                                    - bound)
    return {"loss_ms": loss, "call_loss_ms": call_loss,
            "launches": sum(counts.values()), "timed_blocks": len(calls),
            "timing_s": time.perf_counter() - t0}


def block_size(kernel, module):
    return (kernel.plan.N * len(kernel.plan.nodes),
            module.block_bytes(kernel.plan))


def hold_blocks(name: str, calls: dict, module, limit=None,
                exact=False) -> dict:
    """Kernel vs plain on every distinct claimed block, the kernel called
    directly (no input it may overwrite) and as the executor called it
    (with its ``reuse`` grant, on copies of the inputs); times the largest.
    ``limit(plan, want)`` is the allowed max abs error of one output
    (``TOL``, or bitwise when ``exact``, when None)."""
    worst = 0.0
    largest = None
    for kernel, bufs_and_salts, kw in calls.values():
        *bufs, salts = bufs_and_salts
        want = kernel.plain(*bufs_and_salts)
        for got in (kernel(*bufs_and_salts),
                    kernel(*(b.clone() for b in bufs), salts, **kw)):
            for g, w in zip(got, want):
                g, w = g.cpu().numpy(), w.cpu().numpy()
                what = f"{name}: kernel vs plain on block {kernel.plan.domain}"
                if limit is None:
                    err = check_close(g, w, what, exact=exact)
                else:
                    err = max_err(g, w)
                    if not err <= limit(kernel.plan, w):
                        raise AssertionError(f"{what}: max err {err}")
                worst = max(worst, err)
        size = block_size(kernel, module)
        if largest is None or size > largest[0]:
            largest = (size, kernel, bufs_and_salts, kw)
    _, kernel, bufs_and_salts, kw = largest
    return {"max_abs_err": worst, "n_blocks": len(calls),
            **time_block(kernel, bufs_and_salts, kw, module)}


#: in-kernel draws held bitwise against ``prng.uniform_at``: (shape,
#: dtype, seed, salt) — the 2**24 float64 block the ``PRNG`` line times,
#: an odd length, a 2-D domain with ragged rows and columns, float32 at
#: 2**24 - 1, float16; seeds past 2**32 and salts near 2**31
RANDOM_CASES = (((2 ** 24,), np.float64, 0, 7),
                ((1_000_003,), np.float64, 2 ** 40 + 3, 2 ** 31 - 2),
                ((1023, 1537), np.float64, 5, 17),
                ((2 ** 24 - 1,), np.float32, 0, 9),
                ((4099, 3), np.float16, 123456789, 1))


def prng_checks(codegen) -> dict:
    """In-kernel ``random`` against ``prng.uniform_at`` (the steps the
    kernel takes, as torch ops) on :data:`RANDOM_CASES`, bit for bit; then
    a 2**24-value float64 draw two ways: ``prng.uniform`` (the plain draw)
    and one B1 call of a block that only draws, each its launches in a
    CUDA graph (:func:`graph_ms`)."""
    from repro_torch.core import prng
    from repro_torch.core.ir import BaseArray, Op, View
    dev = torch.device("cuda")
    ints = {np.float64: torch.int64, np.float32: torch.int32,
            np.float16: torch.int16}
    kernels = []
    for shape, dt, seed, salt in RANDOM_CASES:
        n = int(np.prod(shape))
        r = BaseArray(n, dt)
        ops = [Op("random", View.contiguous(r, shape), (),
                  new_bases=frozenset({r}))]
        fn, _, _ = codegen.build_block_kernel(ops, seed=seed, device=dev)
        got, = fn((salt,))
        want = prng.uniform_at(seed, salt, torch.arange(n, device=dev), dt)
        if not torch.equal(got.view(ints[dt]), want.view(ints[dt])):
            raise AssertionError(f"in-kernel random {shape} {np.dtype(dt)} "
                                 f"differs from prng.uniform_at")
        kernels.append(fn)
    print("PRNG in-kernel draw vs prng.uniform_at: bitwise on "
          + ", ".join(f"{shape} {np.dtype(dt).name} seed {seed} salt {salt}"
                      for shape, dt, seed, salt in RANDOM_CASES), flush=True)
    fn, (shape, dt, seed, salt) = kernels[0], RANDOM_CASES[0]
    out = {"plain_ms": graph_ms(lambda: prng.uniform(seed, salt, shape, dt,
                                                     dev)),
           "call_ms": call_ms(fn, ((salt,),)),
           "ms": kernel_ms(fn, *_block_inputs(fn, ((salt,),))),
           **block_bound(fn, codegen)}
    print(f"PRNG 2**24 float64 values: prng.uniform (plain) "
          f"ms={out['plain_ms']:.4f} | one B1 call of a block that only "
          f"draws: call_ms={out['call_ms']:.4f} kernel_ms={out['ms']:.4f} "
          f"bytes={out['bytes']} bound_ms={out['bound_ms']:.4f} "
          f"({out['bound_by']})", flush=True)
    return out


def launch_cost_s(lazy, codegen) -> float:
    """Host time of one warm fused-block wrapper call on a tiny block
    (launch plus wrapper bookkeeping) — the ``gpu`` model's ``launch_s``."""
    from repro_torch.core.ir import BaseArray, Op, View
    n = 1024
    a, o = BaseArray(n, np.float64), BaseArray(n, np.float64)
    ops = [Op("mul", View.contiguous(o, (n,)), (View.contiguous(a, (n,)),
                                                2.0),
              new_bases=frozenset({o}))]
    fn, _, _ = codegen.build_block_kernel(ops, device=torch.device("cuda"))
    buf = torch.ones(n, dtype=torch.float64, device="cuda")
    for _ in range(10):
        fn(buf, ())
    torch.cuda.synchronize()
    reps = 500
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(buf, ())
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _rel_err(got, want) -> float:
    """Max abs difference over the largest magnitude of ``want`` (at least
    1): the measure ``LM_RTOL`` bounds."""
    got = torch.as_tensor(got, device="cuda")
    want = torch.as_tensor(want, device="cuda")
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all() or not got.abs().max() > 0:
        raise AssertionError("non-finite or all-zero values")
    scale = max(1.0, float(want.abs().max()))
    return float((got.double() - want.double()).abs().max()) / scale


def _sum_limit(plan, want) -> float:
    """Kernel vs plain on the card: a row sum in another order is off by at
    most (row length) x eps x its magnitude; everything else is bitwise."""
    return plan.C * F32_EPS * max(1.0, float(np.abs(want).max()))


def _rms_norm_ms(kernel, bufs_and_salts) -> float:
    """One ``F.rms_norm`` over the rmsnorm block's dense input with its
    row operand as the weight — the library call for the same output."""
    import torch.nn.functional as F
    *bufs, _ = bufs_and_salts
    store = dict(zip(kernel.plan.inputs, bufs))
    by_kind = {o.kind: store[o.base_uid] for o in kernel.plan.operands
               if o.source == "buffer"}
    d = kernel.plan.C
    x = by_kind["dense"].reshape(kernel.plan.domain)
    w = by_kind["row"].reshape(d)
    return cuda_ms(lambda: F.rms_norm(x, (d,), weight=w, eps=1e-6))


def _kv_write_ms(cfg) -> float:
    """Device time of one decode-step window write into one layer's KV
    cache buffer (the executor's functional write clones the whole base)."""
    from repro_torch.core.executor import _write
    from repro_torch.core.ir import BaseArray, View
    b, t, h, hd = LM_BATCH, LM_MAX_SEQ, cfg.n_kv_heads, cfg.hd
    base = BaseArray(b * t * h * hd, np.float32)
    view = View(base, LM_PROMPT * h * hd, (b, 1, h, hd),
                (t * h * hd, h * hd, hd, 1))
    buf = torch.zeros(base.size, device="cuda")
    val = torch.ones((b, 1, h, hd), device="cuda")
    return cuda_ms(lambda: _write(buf, view, val))


def _kv_block(calls) -> dict:
    """The LM lane's KV-cache write: of the recorded B1 blocks that the
    executor let store into an input base in place, the one with the
    largest such base, its call timed with that grant and without it (one
    copy of the base), and its kernel alone."""
    found = []
    for kernel, bufs_and_salts, kw in calls.values():
        p = kernel.plan
        for u in p.in_place:
            if p.inputs.index(u) in kw.get("reuse", ()):
                found.append((p.base_meta[u][0], kernel, bufs_and_salts, kw))
    if not found:
        raise AssertionError("LM: no B1 block wrote a base in place")
    size, kernel, bufs_and_salts, kw = max(found, key=lambda t: t[0])
    return {"domain": kernel.plan.domain, "base_elems": size,
            "ms": kernel_ms(kernel, *_block_inputs(kernel, bufs_and_salts)),
            "copy_ms": call_ms(kernel, bufs_and_salts),
            "reuse_ms": call_ms(kernel, bufs_and_salts, kw)}


def run_lm(lazy, codegen, rowblock) -> dict:
    """The LM serving lane at Qwen1.5-4B widths (see the module doc)."""
    from repro_torch.configs import qwen15_4b
    from repro_torch.models import transformer as T
    from repro_torch.models.lazy_transformer import LazyTransformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    cfg = qwen15_4b.CONFIG.scaled(qkv_bias=False, dtype="float32",
                                  n_layers=LM_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen, "cuda")
    # the reference's init leaves every norm gain at 0, and qwen scales by
    # the plain gain (no 1+g), which would zero every activation: draw the
    # gains around 1 so the run computes real values
    for norm in (params["groups"]["l0"]["norm1"],
                 params["groups"]["l0"]["norm2"], params["final_norm"]):
        norm["g"] = 1.0 + 0.1 * torch.randn(norm["g"].shape, generator=gen,
                                            device="cuda")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                          dtype=np.int32)
    fwd_tokens = rng.integers(0, cfg.vocab_size, LM_FORWARD, dtype=np.int32)
    print(f"LM config {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}x{cfg.hd} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} qkv_bias={cfg.qkv_bias} dtype={cfg.dtype} "
          f"batch={LM_BATCH} prompt={LM_PROMPT} max_seq={LM_MAX_SEQ} "
          f"decode_steps={LM_STEPS} forward={LM_FORWARD}", flush=True)

    def serve(model):
        """prefill (cold), the decode steps, forward, then a warm prefill;
        ``model`` is (prefill, decode, forward, caches).  The first run
        (lm) picks the greedy tokens; the others decode the same ones."""
        prefill, decode, forward, caches = model
        out = {"decode": [], "decode_s": []}
        out["prefill"], out["prefill_cold_s"] = _timed(prefill)
        for i in range(LM_STEPS):
            if len(tokens) <= i:
                last = out["decode"][-1] if out["decode"] else out["prefill"]
                tokens.append(np.asarray(last).argmax(-1).astype(np.int32))
            got, dt = _timed(lambda: decode(tokens[i]))
            out["decode"].append(got)
            out["decode_s"].append(dt)
        out["forward"], out["forward_s"] = _timed(forward)
        out["caches"] = caches()
        _, out["prefill_warm_s"] = _timed(prefill)
        return out

    tokens: list = []

    def lazy_model(lt):
        def caches():
            return [tuple(lt.rt.buffers[a.view.base.uid].view(a.shape)
                          for a in kv) for kv in lt.caches]
        return (lambda: lt.prefill(prompt, LM_MAX_SEQ), lt.decode,
                lambda: lt.forward(fwd_tokens), caches)

    # -- the main path: backend="lm", counts zeroed just before it --------
    lt = LazyTransformer(params, cfg)
    with BlockRecorder(codegen.FusedBlockKernel) as rec_b1, \
            BlockRecorder(rowblock.RowBlockKernel) as rec_b2:
        codegen.LAUNCHES["fused_block"] = 0
        rowblock.LAUNCHES["rowblock"] = 0
        h0 = len(lt.rt.history)
        res = {"lm": serve(lazy_model(lt))}
        launches = {"fused_block": codegen.LAUNCHES["fused_block"],
                    "rowblock": rowblock.LAUNCHES["rowblock"]}
        flushes = list(lt.rt.history)[h0:]
    donated = sum(e["exec"]["donated_buffers"] for e in flushes)
    if launches["rowblock"] == 0 or launches["fused_block"] == 0:
        raise AssertionError(f"LM: a kernel never launched: {launches}")
    L = cfg.n_layers
    for k, entry in enumerate(flushes):
        ex = entry["exec"]
        claims = ex["backend_blocks"]
        if claims.get("rmsnorm", 0) < 2 * L + 1 \
                or claims.get("flash_attention", 0) < 2 * L:
            raise AssertionError(f"LM flush {k}: claims {claims}")
        for backend, reasons in ex["backend_fallbacks"].items():
            if "error" in reasons:
                raise AssertionError(f"LM flush {k}: {backend} 'error' decline")
    print(f"LM main path (backend=lm): {len(flushes)} flushes, claims per "
          f"flush {[e['exec']['backend_blocks'] for e in flushes][-1]} "
          f"(last), declines {flushes[-1]['exec']['backend_fallbacks']}, "
          f"launches {launches}", flush=True)

    # -- the floor and the direct model on the same tokens -----------------
    res["torch"] = serve(lazy_model(LazyTransformer(params, cfg,
                                                    backend="torch")))
    state = {}

    def d_prefill():
        logits, state["c"] = T.serve_prefill(params, prompt, cfg, LM_MAX_SEQ)
        return logits.cpu().numpy()

    def d_decode(tok):
        logits, state["c"] = T.serve_decode(params, state["c"], tok, cfg)
        return logits.cpu().numpy()

    def d_caches():
        c = state["c"]["l0"]
        return [(c["k"][i], c["v"][i]) for i in range(L)]

    # the direct model's decode steps run the decode-attention kernel
    # eagerly, one call an attention layer a step; the first step's held
    from repro_torch.kernels.decode_attention import kernel as da_k
    with OpRecorder(da_k, "decode_attention", range(L)) as rec_d:
        da_k.LAUNCHES["decode_attention"] = 0
        res["direct"] = serve((d_prefill, d_decode,
                               lambda: T.forward(params, fwd_tokens, cfg)[0]
                               .cpu().numpy(), d_caches))
        torch.cuda.synchronize()
        decode_launches = da_k.LAUNCHES["decode_attention"]
    if decode_launches != L * LM_STEPS:
        raise AssertionError(f"LM direct model: {decode_launches} "
                             f"decode-attention launches, want "
                             f"{L * LM_STEPS}")
    decode_held = _decode_held(f"LM direct model, {decode_launches} "
                               f"decode-attention launches, the first "
                               f"step's", rec_d)
    del rec_d

    # -- agreement ----------------------------------------------------------
    agree = {}
    for other in ("torch", "direct"):
        a, b = res["lm"], res[other]
        errs = {"prefill": _rel_err(a["prefill"], b["prefill"]),
                "decode": max(_rel_err(x, y) for x, y in
                              zip(a["decode"], b["decode"])),
                "forward": _rel_err(a["forward"], b["forward"]),
                "caches": max(_rel_err(x, y) for kv, kv2 in
                              zip(a["caches"], b["caches"])
                              for x, y in zip(kv, kv2))}
        agree[other] = errs
        print(f"LM agreement lm vs {other} (max abs err / max magnitude): "
              f"{errs}", flush=True)
        if max(errs.values()) > LM_RTOL:
            raise AssertionError(f"LM: lm vs {other} beyond {LM_RTOL}: {errs}")

    # -- every distinct kernel against its plain version -------------------
    b1 = hold_blocks("LM B1", rec_b1.calls, codegen, limit=_sum_limit)
    b2 = hold_blocks("LM B2", rec_b2.calls, rowblock, limit=_sum_limit)
    loss = {"B1": block_loss(rec_b1.calls, rec_b1.counts, codegen),
            "B2": block_loss(rec_b2.calls, rec_b2.counts, rowblock)}
    for name, n in (("B1", launches["fused_block"]),
                    ("B2", launches["rowblock"])):
        if loss[name]["launches"] != n:
            raise AssertionError(f"LM {name}: {loss[name]['launches']} "
                                 f"recorded calls for {n} launches")
    norms = [(block_size(k, rowblock), k, bs, kw)
             for k, bs, kw in rec_b2.calls.values()
             if any(n.opcode == "rsqrt" for n in k.plan.nodes)]
    _, nk, nbs, nkw = max(norms, key=lambda t: t[0])
    norm = time_block(nk, nbs, nkw, rowblock)
    norm["library_ms"] = _rms_norm_ms(nk, nbs)
    kv_ms = _kv_write_ms(cfg)
    kv = _kv_block(rec_b1.calls)
    for name, blk in (("B1", b1), ("B2", b2)):
        print(f"LM {name}: {blk['n_blocks']} distinct blocks, kernel vs plain "
              f"max abs err {blk['max_abs_err']:.3g}; largest block "
              f"{blk['domain']}: kernel_ms={blk['ms']:.4f} "
              f"call_ms={blk['call_ms']:.4f} "
              f"plain_ms={blk['plain_ms']:.4f} bytes={blk['bytes']} "
              f"bound_ms={blk['bound_ms']:.4f} ({blk['bound_by']}); every "
              f"block: launches x (kernel_ms - bound_ms) = "
              f"{loss[name]['loss_ms']:.4f} ms, launches x (call_ms - "
              f"bound_ms) = {loss[name]['call_loss_ms']:.4f} ms",
              flush=True)
    print("LM B2 largest block library_ms=null: no single PyTorch call "
          "computes a masked row max or a shifted-exp row sum alone",
          flush=True)
    print(f"LM B2 rmsnorm block {norm['domain']}: kernel_ms={norm['ms']:.4f} "
          f"plain_ms={norm['plain_ms']:.4f} bytes={norm['bytes']} "
          f"bound_ms={norm['bound_ms']:.4f} ({norm['bound_by']}) "
          f"F.rms_norm_ms={norm['library_ms']:.4f}", flush=True)
    for name in ("lm", "torch", "direct"):
        r = res[name]
        print(f"LM timing {name}: prefill_ms cold={r['prefill_cold_s'] * 1e3:.1f}"
              f" warm={r['prefill_warm_s'] * 1e3:.1f} decode_ms_per_token "
              f"(steps 2-{LM_STEPS})="
              f"{statistics.mean(r['decode_s'][1:]) * 1e3:.1f} first_decode_ms="
              f"{r['decode_s'][0] * 1e3:.1f} forward_ms={r['forward_s'] * 1e3:.1f}",
              flush=True)
    print(f"LM KV window write: {kv_ms:.4f} ms per layer cache "
          f"({LM_BATCH}x{LM_MAX_SEQ}x{cfg.n_kv_heads}x{cfg.hd} f32), "
          f"x{2 * L} per decode step = {kv_ms * 2 * L:.3f} ms (the floor's "
          f"functional write); the B1 block that stores into a base of "
          f"{kv['base_elems']} elements in place, domain {kv['domain']}: "
          f"call_ms in place={kv['reuse_ms']:.4f} with a copy="
          f"{kv['copy_ms']:.4f} kernel_ms={kv['ms']:.4f}; LM lane "
          f"donated_buffers={donated} "
          f"({time.perf_counter() - t_start:.1f}s for the LM phase)",
          flush=True)
    return {"launches": launches, "b1": b1, "b2": b2, "norm": norm,
            "agree": agree, "loss": loss,
            "decode": {"launches": decode_launches,
                       "max_abs_err": max(decode_held)}}


def _attention_work(q, k, causal, window, softcap):
    """Bytes (q, k, v read once, o written once) and operations of one
    attention call: B3's count (``flash_attention.kernel.attention_ops``),
    its multiply-adds typed by the route that takes them (bfloat16 on the
    tensor cores; float32 on the faster route that keeps float32
    accuracy, three TF32 tensor-core passes or the CUDA cores' FMAs,
    ``TC_TF32_MACS_PER_S``) and the softmax's elementwise work in
    float32."""
    from repro_torch.kernels.flash_attention.kernel import attention_ops
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    ops = attention_ops(tuple(q.shape), tuple(k.shape), causal, window,
                        softcap)
    macs, elem = ops["macs"], ops["float32"]
    if q.dtype == torch.bfloat16:
        return nbytes, {"tensor_bf16": macs, "float32": elem}
    if 3 * macs / TC_TF32_MACS_PER_S < macs / PEAK_OPS_PER_S["float32"]:
        return nbytes, {"tensor_3xtf32": 3 * macs, "float32": elem}
    return nbytes, {"float32": macs + elem}


def _bound(nbytes, ops):
    """``(ms, "bytes" or "operations")``: the larger of ``nbytes`` over the
    memory rate and each type of ``ops`` over its rate.  ``"exp2"`` counts
    exponentials that may run on the SFU or, at :data:`EXP2_FMA_OPS`
    float32 operations each, on the FMA pipe beside the ``"float32"``
    ones: split at the share that has both pipes end at once."""
    rates = {"tensor_bf16": TC_BF16_MACS_PER_S,
             "tensor_3xtf32": TC_TF32_MACS_PER_S,
             "tensor_f64": TC_F64_MACS_PER_S, "sfu": SFU_OPS_PER_S,
             **PEAK_OPS_PER_S}
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops = dict(ops)
    exps = ops.pop("exp2", 0)
    times = [n / rates[t] for t, n in ops.items()]
    if exps:
        times.append((ops.get("float32", 0) + EXP2_FMA_OPS * exps)
                     / (rates["float32"] + EXP2_FMA_OPS * SFU_OPS_PER_S))
    ops_ms = max(times) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


def _model_cases(gen):
    """The cases of the model-kernel phase: op, inputs, work and library
    yardstick, at the widths of the repo's configs."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mamba_scan.kernel import mamba_ops
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.rmsnorm.ref import reference_add_rmsnorm
    from repro_torch.kernels.rwkv6_scan import ops as rw
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_ops
    from repro_torch.kernels.rwkv6_scan.kernel_chunked import chunked_ops
    from repro_torch.kernels.rwkv6_scan.ref import (reference_rwkv6,
                                                    reference_rwkv6_chunked)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    cases = []
    # B3 — configs/qwen15_4b.py: 20 heads of 128, MHA; a 4 x 512 prefill
    q, k, v = (randn(4, 20, 512, 128) for _ in range(3))
    cases.append(dict(
        kernel="flash_attention", label="Qwen1.5-4B prefill B4 H20 S512 D128 "
        "causal f32", args=(q, k, v, True, None, None),
        run=lambda a: fa.attention(*a), plain=lambda a: reference_attention(
            *a[:3], causal=True), work=_attention_work(q, k, True, None, None),
        library=("F.scaled_dot_product_attention(is_causal=True)",
                 lambda a: F.scaled_dot_product_attention(*a[:3],
                                                          is_causal=True))))
    # B3 — src/repro/configs/gemma2_9b.py: 16 q heads, 8 kv heads of 256,
    # local layers window 4096, attention softcap 50; one 8192-token row
    q = randn(1, 16, 8192, 256, dtype=torch.bfloat16)
    k, v = (randn(1, 8, 8192, 256, dtype=torch.bfloat16) for _ in range(2))
    cases.append(dict(
        kernel="flash_attention", label="Gemma2-9B local layer B1 Hq16 Hkv8 "
        "S8192 D256 window 4096 softcap 50 causal bf16",
        args=(q, k, v, True, 4096, 50.0), run=lambda a: fa.attention(*a),
        plain=lambda a: reference_attention(*a[:3], causal=True, window=4096,
                                            softcap=50.0),
        work=_attention_work(q, k, True, 4096, 50.0),
        library=("none: scaled_dot_product_attention has no softcap", None),
        # what a kernel whose window bound is off by 32 keys (two of the
        # kernel's key tiles at D 256) or by one key would return: the
        # check must reject both
        faults={f"window {w}": lambda a, w=w: reference_attention(
            *a[:3], causal=True, window=w, softcap=50.0)
            for w in (4096 - 32, 4096 - 1)}))
    # B4 — Qwen1.5-4B d_model 2560 over 4 x 512 tokens; Gemma2-9B d_model
    # 3584 (1 + g scale) over 8192 tokens
    for label, shape, plus_one, dtype in (
            ("Qwen1.5-4B 4x512 rows x 2560 f32", (4, 512, 2560), False,
             torch.float32),
            ("Gemma2-9B 8192 rows x 3584 plus_one bf16", (8192, 3584), True,
             torch.bfloat16)):
        x, r = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
        g = randn(shape[-1], dtype=dtype, scale=0.1)
        n, d = x.numel() // shape[-1], shape[-1]
        g_eff = (g.float() + 1.0).to(dtype) if plus_one else g
        cases.append(dict(
            kernel="rmsnorm", label=label, args=(x, r, g, 1e-6, plus_one),
            run=lambda a: rn.add_rmsnorm(*a),
            plain=lambda a: reference_add_rmsnorm(*a[:3], eps=a[3],
                                                  plus_one=a[4]),
            work=(4 * x.numel() * x.element_size() + g.numel()
                  * g.element_size(), {"float32": 5 * n * d + 3 * n + d}),
            library=("none; two calls, x + r then F.rms_norm", None),
            two_calls=lambda a, d=d, g_eff=g_eff: F.rms_norm(
                a[0] + a[1], (d,), weight=g_eff, eps=1e-6)))
    # B5 — src/repro/configs/jamba_v01_52b.py: d_model 4096, expand 2 ->
    # d_inner 8192, d_state 16; batch 2 x 4096 tokens (mamba_ops).  Beside
    # the bound, two that count the exponentials otherwise: all on the
    # SFU, and each as one float32 operation
    bsz, t, di, ds = 2, 4096, 8192, 16
    ins = (randn(bsz, t, di), F.softplus(randn(bsz, t, di)) * 0.1,
           randn(bsz, t, ds), randn(bsz, t, ds),
           -F.softplus(randn(di, ds)) - 0.2, randn(di))
    nbytes = (3 * bsz * t * di + 2 * bsz * t * ds + di * ds + di) * 4

    def reset_every(a, steps=64):
        return torch.cat([reference_mamba(*(z[:, i:i + steps] for z in a[:4]),
                                          *a[4:6])
                          for i in range(0, a[0].shape[1], steps)], dim=1)

    cases.append(dict(
        kernel="mamba_scan", label="Jamba-v0.1 B2 T4096 d_inner 8192 "
        "d_state 16 f32", args=(*ins, 64), run=lambda a: ms.mamba(*a),
        plain=lambda a: reference_mamba(*a[:6]),
        work=(nbytes, mamba_ops(bsz, t, di, ds)),
        other_bounds={
            "exps on the SFU alone": (nbytes, {
                "float32": bsz * t * di * (4 * ds + 2),
                "sfu": bsz * t * di * ds}),
            "exps as float32": (nbytes, {
                "float32": bsz * t * di * (5 * ds + 2)})},
        library=("none: no PyTorch call computes a selective scan", None),
        plain_reps=3,
        # what a kernel that dropped the state every 64 steps, or paired
        # each state with its neighbour's decay, would return
        faults={"state reset every 64 steps": reset_every,
                "A's state columns rolled by one": lambda a: reference_mamba(
                    *a[:4], a[4].roll(1, dims=1), a[5])}))
    # B6 — src/repro/configs/rwkv6_3b.py: 40 heads of 64; batch 8 x 2048.
    # Per step and row: sum_i r_i S_ij, k_i v_j and w_i S_ij + k_i v_j,
    # 3 N^2; the bonus (sum_i r_i u_i k_i) v_j, 3 N
    bh, t, n = 8 * 40, 2048, 64
    ins = (randn(bh, t, n), randn(bh, t, n, scale=0.3), randn(bh, t, n),
           torch.sigmoid(randn(bh, t, n)) * 0.5 + 0.45, randn(n, scale=0.1))
    cases.append(dict(
        kernel="rwkv6_scan", label="RWKV6-3B BH 8x40 T2048 N64 f32",
        args=(*ins, 64), run=lambda a: rw.rwkv6(*a),
        plain=lambda a: reference_rwkv6(*a[:5]),
        work=((5 * bh * t * n + n) * 4,
              rwkv6_ops(bh, t, n)),
        library=("none: no PyTorch call computes the RWKV6 recurrence", None),
        plain_reps=3))
    # B7 on B6's inputs: the same function, in chunks of 32 tokens; the
    # bound counts the route B7 takes (chunked_ops)
    cases.append(dict(
        kernel="rwkv6_chunked", label="RWKV6-3B BH 8x40 T2048 N64 f32, "
        "B6's inputs", args=(*ins, 32), run=lambda a: rw.rwkv6_chunked(*a),
        plain=lambda a: reference_rwkv6_chunked(*a[:5]),
        work=((5 * bh * t * n + n) * 4,
              chunked_ops(bh, t, n)),
        library=("none: no PyTorch call computes the RWKV6 recurrence", None),
        plain_reps=3))
    return cases


def _hold(got, want, rtol, atol):
    """``got`` against ``want`` (tensors or tuples of them), element by
    element: returns the max abs error and the largest share of its
    allowance ``rtol·|want| + atol`` any element takes (at most 1 passes)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = share = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{tuple(g.shape)} {g.dtype} != "
                                 f"{tuple(w.shape)} {w.dtype}")
        if not torch.isfinite(g).all():
            raise AssertionError("non-finite kernel output")
        w = w.double()
        d = (g.double() - w).abs()
        err = max(err, float(d.max()))
        share = max(share, float((d / (rtol * w.abs() + atol)).max()))
    return err, share


#: runs of B3's Qwen1.5-4B case and of its bf16 split-P form in the MODEL
#: phase's repeat check (ROADMAP C21): about 1 ms a run with its check
B3_REPEATS = 200


def b3_repeat(runs: int = B3_REPEATS, small: bool = False) -> dict:
    """B3's Qwen1.5-4B case (B 4, Hq 20, S 512, D 128, causal, float32)
    and its bf16 split-P form (the same q, k, v cast to bfloat16), each run
    ``runs`` times on the same inputs: every output must equal the first
    bitwise and stay within the MODEL phase's allowance of the plain
    version.  The inputs are drawn as ``_model_cases`` draws that case's
    (the first three draws of a card generator seeded 0), and the kernel
    and the plain version read the same tensors.  ``small`` takes B 1, Hq
    2, S 128 (for ``compute-sanitizer``).  Raises on any difference."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import reference_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (1, 2, 128, 128) if small else (4, 20, 512, 128)
    qkv = [torch.randn(shape, generator=gen, device="cuda") for _ in range(3)]
    t0 = time.perf_counter()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        a = tuple(x.to(dtype) for x in qkv)
        plain = reference_attention(*a, causal=True)
        plain_rerun = torch.equal(plain, reference_attention(*a, causal=True))
        rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
        atol = MODEL_TOL["flash_attention"]
        first = fa.attention(*a, True, None, None)
        differ, outside, worst = [], [], 0.0
        for i in range(runs):
            got = first if i == 0 else fa.attention(*a, True, None, None)
            if i and not torch.equal(got, first):
                differ.append(i)
            share = _hold(got, plain, rtol, atol)[1]
            worst = max(worst, share)
            if not share <= 1.0:
                outside.append((i, share))
        name = str(dtype).removeprefix("torch.")
        out[name] = {"runs": runs, "differ": differ, "outside": outside,
                     "worst_share": worst, "plain_rerun_bitwise": plain_rerun}
        print(f"B3 REPEAT {'x'.join(map(str, shape))} causal {name}: "
              f"{runs} runs, bitwise-different from the first "
              f"{len(differ)} {differ[:10]}, outside the allowance "
              f"{len(outside)} {outside[:10]}, worst allowance share "
              f"{worst:.4g}, plain rerun bitwise {plain_rerun}", flush=True)
        if differ or outside:
            raise AssertionError(f"B3 repeat ({name}): {len(differ)} runs "
                                 f"differ, {len(outside)} outside the "
                                 f"allowance")
    print(f"B3 REPEAT: {time.perf_counter() - t0:.1f}s", flush=True)
    return out


def run_model_kernels() -> dict:
    """The standalone model kernels B3-B7 through their public ops at model
    widths (see the module doc).  Returns per-kernel results."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.mamba_scan import kernel as ms_k
    from repro_torch.kernels.rmsnorm import kernel as rn_k
    from repro_torch.kernels.rwkv6_scan import kernel as rw_k
    from repro_torch.kernels.rwkv6_scan import kernel_chunked as rc_k
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    counters = {"flash_attention": fa_k.LAUNCHES, "rmsnorm": rn_k.LAUNCHES,
                "mamba_scan": ms_k.LAUNCHES, "rwkv6_scan": rw_k.LAUNCHES,
                "rwkv6_chunked": rc_k.LAUNCHES}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = _model_cases(gen)
    t0 = time.perf_counter()
    lib = cuda_build.library()
    print(f"MODEL CUDA build: {time.perf_counter() - t0:.1f}s "
          f"({len(cuda_build.sources())} sources, one nvcc each at once, "
          f"then a link) -> {lib._name}", flush=True)
    print(cuda_build.ptxas_report(), flush=True)

    # -- the main path: every op once, counts zeroed just before it --------
    for c in counters.values():
        for key in c:
            c[key] = 0
    outs = [case["run"](case["args"]) for case in cases]
    torch.cuda.synchronize()
    launches = {name: c[name] for name, c in counters.items()}
    print(f"MODEL main path: launches {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name}: the kernel never launched")

    # -- each case: plain version, determinism, times -------------------
    results = {}
    for case, out in zip(cases, outs):
        name, a = case["kernel"], case["args"]
        first = out if isinstance(out, tuple) else (out,)
        rtol = BF16_RTOL if first[0].dtype == torch.bfloat16 else 0.0
        atol = MODEL_TOL[name]
        plain = case["plain"](a)
        err, share = _hold(out, plain, rtol, atol)
        if not share <= 1.0:
            raise AssertionError(f"{case['label']}: kernel vs plain max abs "
                                 f"err {err}, {share:.3g}x its allowance "
                                 f"{rtol:.3g}|plain| + {atol}")
        faults = {}
        for what, fault in case.get("faults", {}).items():
            faults[what] = _hold(fault(a), plain, rtol, atol)[1]
            if not faults[what] > 1.0:
                raise AssertionError(f"{case['label']}: the check passes a "
                                     f"planted fault ({what}: "
                                     f"{faults[what]:.3g}x the allowance)")
        del plain
        again = case["run"](a)
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"{case['label']}: two runs differ")
        ms = graph_ms(lambda: case["run"](a))
        reps = case.get("plain_reps", 10)
        plain_ms = cuda_ms(lambda: case["plain"](a), reps=reps,
                           burst=1 if reps < 10 else 5)
        nbytes, ops = case["work"]
        bound_ms, bound_by = _bound(nbytes, ops)
        others = {what: _bound(*work) for what, work
                  in case.get("other_bounds", {}).items()}
        lib_name, lib_fn = case["library"]
        library_ms = cuda_ms(lambda: lib_fn(a)) if lib_fn else None
        two_ms = cuda_ms(lambda: case["two_calls"](a)) \
            if "two_calls" in case else None
        torch.cuda.empty_cache()
        row = {"label": case["label"], "max_abs_err": err, "share": share,
               "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library": lib_name, "library_ms": library_ms,
               "two_calls_ms": two_ms, "faults": faults}
        results.setdefault(name, []).append(row)
        print(f"MODEL {name} [{case['label']}]: max_abs_err={err:.3g} "
              f"allowance_share={share:.3g} (|err| <= {rtol:.3g}|plain| + "
              f"{atol})" + "".join(f" fault[{w}]_share={s:.3g}"
                                   for w, s in faults.items())
              + f" bitwise_rerun=True kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bytes={nbytes} ops={ops} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) kernel/bound="
              f"{ms / bound_ms:.2f}"
              + "".join(f" bound_ms[{what}]={b:.4f} ({by}) kernel/bound"
                        f"[{what}]={ms / b:.2f}"
                        for what, (b, by) in others.items())
              + f" library={lib_name}"
              + (f" library_ms={library_ms:.4f}" if library_ms else "")
              + (f" two_calls_ms={two_ms:.4f}" if two_ms else ""),
              flush=True)
    b3_repeat()
    print(f"MODEL phase: {time.perf_counter() - t_start:.1f}s", flush=True)
    return {"launches": launches, "cases": results}


#: the decode-attention phase's cases: (cell, rows, cache depth, query
#: heads, KV heads, head dim, write index) at the benchmark cells' served
#: shapes, the index at the mean of the cell's decode steps (chat: prompts
#: padded to 1024, steps at 1024-1278; rag: 3584, steps at 3584-3598)
DECODE_CASES = (
    ("olmoe-1b-7b.chat", 32, 1280, 16, 16, 128, 1151),
    ("olmoe-1b-7b.rag", 8, 3600, 16, 16, 128, 3591),
    ("jamba-v0.1-52b.chat", 32, 1280, 32, 8, 128, 1151),
)


def _decode_hold(args, kw, out):
    """A recorded decode-attention call (``decode_attention.kernel.
    decode_attention``'s ``q, k, v, idx`` and its ``ring``, ``window`` and
    ``softcap``) against its plain version on the same inputs: ``(err,
    share)``."""
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention
    q, k, v, idx = args
    plain = reference_decode_attention(q, k, v, idx.reshape(()), **kw)
    rtol = BF16_RTOL if out.dtype == torch.bfloat16 else 0.0
    return _hold(out, plain, rtol, MODEL_TOL["decode_attention"])


def _decode_label(args, kw) -> str:
    q, k, _, _ = args
    return (f"B{q.shape[0]} T{k.shape[1]} H{q.shape[2]}/{k.shape[2]} "
            f"hd{q.shape[3]} ring={kw.get('ring', False)} window="
            f"{kw.get('window')} softcap={kw.get('softcap')} "
            f"{str(q.dtype).removeprefix('torch.')}")


def _decode_held(what, rec) -> list:
    """Every call ``rec`` (an :class:`OpRecorder` of the decode-attention
    wrapper) kept, held against its plain version; raises past its
    allowance.  Prints the worst and the distinct shapes; returns the
    errors."""
    errs, shapes = [], []
    worst = (0.0, 0.0)
    for i in sorted(rec.calls):
        args, kw, out = rec.calls[i]
        err, share = _decode_hold(args, kw, out)
        label = _decode_label(args, kw)
        if not share <= 1.0:
            raise AssertionError(f"{what} decode-attention call {i} "
                                 f"[{label}]: {share:.3g}x its allowance")
        errs.append(err)
        worst = max(worst, (err, share), key=lambda t: t[1])
        if label not in shapes:
            shapes.append(label)
    print(f"{what}: {len(errs)} decode-attention calls held against "
          f"plain, worst max_abs_err={worst[0]:.3g} "
          f"allowance_share={worst[1]:.3g} (|err| <= {BF16_RTOL:.3g}|plain| "
          f"+ {MODEL_TOL['decode_attention']} in bf16, "
          f"{MODEL_TOL['decode_attention']} in float32); shapes {shapes}",
          flush=True)
    return errs


def _decode_library(q, k, v, at: int, out):
    """The one PyTorch call that computes a decode-attention call over a
    linear cache, timed as a yardstick only (the port never calls it):
    ``F.scaled_dot_product_attention`` over the keys and values up to
    ``at``, with ``enable_gqa`` where the heads are grouped.  Returns
    ``(ms of a CUDA graph of the call, max abs difference from the
    kernel's ``out``)`` or ``(None, why it did not run)``."""
    import torch.nn.functional as F
    gqa = q.shape[2] != k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x[:, :at + 1].transpose(1, 2) for x in (k, v))

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=gqa)
    try:
        got = call().transpose(1, 2)
    except Exception as e:      # a yardstick only: say why it did not run
        return None, f"{type(e).__name__}: " + (
            str(e).strip().splitlines() or [""])[0][:200]
    diff = float((got.double() - out.double()).abs().max())
    del got
    return graph_ms(call), diff


def run_decode_attention() -> dict:
    """The decode-attention kernel at ``DECODE_CASES``, bf16 caches drawn
    on the card: held against its plain version, rerun bitwise, timed as a
    CUDA graph of the call beside its bound (the valid keys and values
    read once, q read and the output written once, at
    ``HBM_BYTES_PER_S``), the plain version's time and the library's
    (:func:`_decode_library`).  Returns the rows and the launches."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, launches = [], 0
    for cell, b, t, h, hkv, hd, at in DECODE_CASES:
        q = torch.randn((b, 1, h, hd), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        k, v = (torch.randn((b, t, hkv, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        idx = torch.tensor(at, dtype=torch.int32, device="cuda")

        def call():
            return da.decode_attention(q, k, v, idx)

        before = da.LAUNCHES["decode_attention"]
        got = call()
        again = call()
        torch.cuda.synchronize()
        launches += da.LAUNCHES["decode_attention"] - before
        if not torch.equal(got, again):
            raise AssertionError(f"DECODE {cell}: two runs differ")
        plain = reference_decode_attention(q, k, v, idx)
        err, share = _hold(got, plain, BF16_RTOL,
                           MODEL_TOL["decode_attention"])
        if not share <= 1.0:
            raise AssertionError(f"DECODE {cell}: kernel vs plain max abs "
                                 f"err {err}, {share:.3g}x its allowance")
        del plain, again
        ms = graph_ms(call)
        library_ms, library_diff = _decode_library(q, k, v, at, got)
        plain_ms = cuda_ms(lambda: reference_decode_attention(q, k, v, idx),
                           reps=5, burst=1)
        nbytes = da.decode_bytes(tuple(q.shape), tuple(k.shape),
                                 q.element_size(), at, ring=False,
                                 window=None)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        splits = da.split_count(b, hkv, h // hkv, t, hd, q.element_size(),
                                da._sm_count(q.device))
        row = {"cell": cell, "shape": (b, t, h, hkv, hd), "idx": at,
               "splits": splits, "max_abs_err": err, "share": share,
               "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
               "bound_ms": bound_ms, "bound_by": "bytes",
               "library_ms": library_ms, "library_diff": library_diff}
        rows.append(row)
        lib = (f"library_ms={library_ms:.4f} (F.scaled_dot_product_attention"
               f" over keys 0-{at}, max abs diff from the kernel "
               f"{library_diff:.3g})" if library_ms is not None
               else f"library_ms=null (did not run: {library_diff})")
        print(f"DECODE {cell} [B {b} T {t} H {h}/{hkv} hd {hd} bf16, idx "
              f"{at}, {splits} splits]: max_abs_err={err:.3g} "
              f"allowance_share={share:.3g} bitwise_rerun=True "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bytes={nbytes} "
              f"bound_ms={bound_ms:.4f} (bytes) kernel/bound="
              f"{ms / bound_ms:.2f} ({100 * bound_ms / ms:.1f}% of the "
              f"bound's rate) {lib}", flush=True)
        del q, k, v, got
        torch.cuda.empty_cache()
    print(f"DECODE phase: {launches} launches, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return {"rows": rows, "launches": launches}


class OpRecorder:
    """While active, wraps ``module.name``: counts its calls, keeps each
    call's positional arguments that are not tensors (``scalars``) and
    whether it wrote its final state over its initial one (``in_place``:
    an ``out_state`` keyword that is the ``state`` keyword's storage), and
    clones of the arguments (taken before the call) and the result of the
    calls numbered in ``keep`` (a CUDA graph's static buffers, which a
    call may read or return, are overwritten by later replays)."""

    def __init__(self, module, name: str, keep):
        self.module, self.name, self.keep = module, name, set(keep)
        self.orig = getattr(module, name)
        self.n = 0
        self.calls = {}
        self.scalars = []
        self.in_place = []

    def __enter__(self):
        def spy(*args, **kw):
            ins = (_clone(args), _clone(kw)) if self.n in self.keep else None
            out = self.orig(*args, **kw)
            self.scalars.append(tuple(a for a in args
                                      if not isinstance(a, torch.Tensor)))
            dst, src = kw.get("out_state"), kw.get("state")
            self.in_place.append(dst is not None and src is not None
                                 and dst.data_ptr() == src.data_ptr())
            if ins is not None:
                self.calls[self.n] = (*ins, _clone(out))
            self.n += 1
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(z) for z in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def rwkv_time_decay(n_layers: int, d: int) -> torch.Tensor:
    """Each layer's ``w0`` as RWKV-LM's RWKV-v6 ``time_decay``
    initialisation sets it: channel ``c`` of layer ``l`` at ``-6 + 5·(c /
    (d-1))^(0.7 + 1.3·l/(n_layers-1))``, so the decay ``exp(-exp(w0))``
    spans 0.9975 to 0.69."""
    c = torch.arange(d, dtype=torch.float64, device="cuda") / (d - 1)
    ratio = torch.arange(n_layers, dtype=torch.float64,
                         device="cuda")[:, None] / (n_layers - 1)
    return (-6.0 + 5.0 * c[None] ** (0.7 + 1.3 * ratio)).to(torch.float32)


def _rwkv_work(args, kw, chunked: bool = False) -> tuple:
    """Bytes (r, k, v, w, u and the states read once, o and the final state
    written once) and operations of one recorded RWKV6 op call: B6's
    float32 3 N² + 3 N per step and row, or B7's route
    (``kernel_chunked.chunked_ops``)."""
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_ops
    from repro_torch.kernels.rwkv6_scan.kernel_chunked import chunked_ops
    r, k, v, w, u = args
    bh, t, n = r.shape
    state = kw.get("state")
    nbytes = sum(z.numel() * z.element_size() for z in (r, k, v, w, u))
    nbytes += r.numel() * r.element_size()             # o, in r's dtype
    nbytes += 4 * bh * n * n * ((state is not None) + bool(
        kw.get("return_state")))
    if chunked:
        return nbytes, chunked_ops(bh, t, n, kw.get("chunk", 32))
    return nbytes, rwkv6_ops(bh, t, n)


def run_rwkv() -> dict:
    """The RWKV6-3B serving path at full width and depth (see the module
    doc).  Returns the kernels' launches and the held and timed calls."""
    from repro_torch.configs import rwkv6_3b
    from repro_torch.kernels.rwkv6_scan import kernel as rw_k
    from repro_torch.kernels.rwkv6_scan import kernel_chunked as rc_k
    from repro_torch.kernels.rwkv6_scan import ops as rw_ops
    from repro_torch.kernels.rwkv6_scan.ref import (reference_rwkv6,
                                                    reference_rwkv6_chunked)
    from repro_torch.launch.serve import draw_prompts, serve_requests
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    cfg = rwkv6_3b.CONFIG
    L = cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen, "cuda")
    # the reference's zero norm gains (plain g, no 1+g for RWKV6) would
    # zero every activation: draw them around 1; the decay logits follow
    # RWKV-LM's initialisation instead of the reference's flat -6
    layers = params["groups"]["l0"]
    for norm in (layers["norm1"], layers["norm2"], params["final_norm"]):
        norm["g"] = 1.0 + 0.1 * torch.randn(norm["g"].shape, generator=gen,
                                            device="cuda")
    layers["mixer"]["w0"] = rwkv_time_decay(L, cfg.d_model)
    n_params = sum(z.numel() for z in _leaves(params))
    prompts = draw_prompts(0, RWKV_BATCH, RWKV_PROMPT, cfg.vocab_size)
    heads = cfg.d_model // cfg.rwkv.head_dim
    print(f"RWKV config {cfg.name} layers={L} d_model={cfg.d_model} "
          f"heads={heads}x{cfg.rwkv.head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} dtype={cfg.dtype} "
          f"param_dtype={cfg.param_dtype} params={n_params} requests="
          f"{RWKV_BATCH} prompt_lengths={[len(p) for p in prompts]} "
          f"max_prompt={RWKV_PROMPT} new_tokens={RWKV_NEW_TOKENS} "
          f"w0 in [{float(layers['mixer']['w0'].min()):.3f}, "
          f"{float(layers['mixer']['w0'].max()):.3f}]", flush=True)

    # -- the main path: serve_requests, counts zeroed just before it -------
    # the prefill and the decode step are each one CUDA graph, captured at
    # their first call after one eager warm-up run, and replayed: the
    # prefill once (B7 once a layer), the decode step at every step (B6
    # writing each state in place into the graph's static cache).  The
    # recorded calls are the warm-ups': eager runs of what the graphs replay
    with OpRecorder(rw_ops, "rwkv6_chunked", {0, L - 1}) as rec7, \
            OpRecorder(rw_ops, "rwkv6", {0, L - 1}) as rec6:
        rc_k.LAUNCHES["rwkv6_chunked"] = 0
        rw_k.LAUNCHES["rwkv6_scan"] = 0
        tokens, times = serve_requests(cfg, params, prompts,
                                       batch=RWKV_BATCH,
                                       max_prompt=RWKV_PROMPT,
                                       new_tokens=RWKV_NEW_TOKENS)
        torch.cuda.synchronize()
        counted = {"rwkv6_chunked": rc_k.LAUNCHES["rwkv6_chunked"],
                   "rwkv6_scan": rw_k.LAUNCHES["rwkv6_scan"]}
    steps = RWKV_NEW_TOKENS - 1
    pre, step = times[0]["prefill"], times[0]["step"]
    # the wrappers run, per capture, for two eager runs (the warm-up and
    # the capture itself); a replay launches the captured kernels again
    # without their wrappers
    per_prefill = counted["rwkv6_chunked"] // (2 * max(pre.captures, 1))
    per_step = counted["rwkv6_scan"] // (2 * max(step.captures, 1))
    print(f"RWKV main path (serve_requests): prefill and decode steps as "
          f"CUDA graph replays: prefill graph={pre.graph} captures="
          f"{pre.captures} replays={pre.replays}; decode graph={step.graph} "
          f"captures={step.captures} replays={step.replays}; counted at the "
          f"wrappers {counted} (the warm-up runs and the captures, so B7 "
          f"{per_prefill} a prefill replay, B6 {per_step} a decode replay); "
          f"op calls B7 {rec7.n} B6 {rec6.n}", flush=True)
    if not (pre.graph and pre.captures == 1 and pre.replays == 1
            and step.graph and step.captures == 1 and step.replays == steps
            and counted == {"rwkv6_chunked": 2 * L, "rwkv6_scan": 2 * L}):
        raise AssertionError(f"RWKV: want one capture of {L} B7 launches "
                             f"replayed once and one of {L} B6 launches "
                             f"replayed {steps} times, got {counted} at the "
                             f"wrappers, {pre.captures} and {step.captures} "
                             f"captures, {pre.replays} and {step.replays} "
                             f"replays")
    launches = {"rwkv6_chunked": per_prefill * (1 + pre.replays),
                "rwkv6_scan": per_step * (1 + step.replays)}
    gen_tokens = np.stack(tokens)
    if gen_tokens.shape != (RWKV_BATCH, RWKV_NEW_TOKENS) \
            or not ((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all():
        raise AssertionError(f"RWKV: generated {gen_tokens}")
    eager_tokens, eager_times = serve_requests(
        cfg, params, prompts, batch=RWKV_BATCH, max_prompt=RWKV_PROMPT,
        new_tokens=RWKV_NEW_TOKENS, graph=False)
    same_tokens = np.array_equal(np.stack(eager_tokens), gen_tokens)
    graph_vs_eager = _graph_vs_eager(cfg, params, prompts)
    prefill = _prefill_graph_vs_eager(cfg, params, prompts)
    print(f"RWKV graph vs eager: serve_requests tokens equal={same_tokens}; "
          f"{RWKV_EXTEND} steps through DecodeStep, logits and caches "
          f"bitwise equal={graph_vs_eager}; PrefillStep, 3 prefills of 2 "
          f"batches through {prefill['captures']} capture and "
          f"{prefill['replays']} replays, logits, tokens and caches bitwise "
          f"equal to the eager prefill={prefill['same']}; graph pool: "
          f"max_memory_allocated +{prefill['peak_mb']:.1f} MB over the "
          f"capturing call, memory_allocated +{prefill['held_mb']:.1f} MB "
          f"and memory_reserved +{prefill['reserved_mb']:.1f} MB after it",
          flush=True)
    if not (same_tokens and graph_vs_eager and prefill["same"]
            and prefill["captures"] == 1 and prefill["replays"] == 3):
        raise AssertionError("RWKV: a graph's replays differ from eager "
                             "serving")

    # -- the recorded calls against their plain versions -------------------
    held = {}
    for name, rec, plain in (("rwkv6_chunked", rec7, reference_rwkv6_chunked),
                             ("rwkv6_scan", rec6, reference_rwkv6)):
        for i, (args, kw, out) in sorted(rec.calls.items()):
            o, st = out
            po, pst = plain(*args, state=kw["state"], return_state=True)
            err_o, share_o = _hold(o, po, BF16_RTOL if o.dtype ==
                                   torch.bfloat16 else 0.0, MODEL_TOL[name])
            err_s, share_s = _hold(st, pst, 0.0, MODEL_TOL[name])
            what = f"RWKV {name} layer {i % L}"
            if not max(share_o, share_s) <= 1.0:
                raise AssertionError(f"{what}: kernel vs plain o err {err_o} "
                                     f"({share_o:.3g}x), state err {err_s} "
                                     f"({share_s:.3g}x its allowance)")
            held[(name, i % L)] = (err_o, share_o, err_s, share_s)
            print(f"{what}: r/k/v {args[0].dtype} {tuple(args[0].shape)}, "
                  f"w {args[3].dtype}, u {tuple(args[4].shape)}, state in "
                  f"{kw['state'] is not None}: o max_abs_err={err_o:.3g} "
                  f"allowance_share={share_o:.3g} (|err| <= "
                  f"{BF16_RTOL:.3g}|plain| + {MODEL_TOL[name]}); final state "
                  f"max_abs_err={err_s:.3g} allowance_share={share_s:.3g} "
                  f"(|err| <= {MODEL_TOL[name]}); |state| max "
                  f"{float(pst.abs().max()):.4g}", flush=True)
    args7, kw7, out7 = rec7.calls[0]
    again = rw_ops.rwkv6_chunked(*args7, **kw7)
    if not all(torch.equal(x, y) for x, y in zip(out7, again)):
        raise AssertionError("RWKV: two runs of a B7 call differ")
    del again

    # -- prefill(P) + decode tokens against prefill(P + tokens) ------------
    toks = _pad_batch(prompts, RWKV_PROMPT)
    longer_toks = np.concatenate([toks, gen_tokens[:, :RWKV_EXTEND]], 1)
    max_seq = RWKV_PROMPT + RWKV_NEW_TOKENS
    sp = T.serving_params(params, cfg)     # as serve_requests serves
    (logits, _), warm_s = _timed(
        lambda: T.serve_prefill(sp, toks, cfg, max_seq))
    if not np.array_equal(logits[:, -1].argmax(-1).cpu().numpy(),
                          gen_tokens[:, 0]):
        raise AssertionError("RWKV: a rerun of the prefill picks other "
                             "tokens")
    extend_err = {}
    for dtype, bound in RWKV_RTOL.items():
        c = cfg.scaled(dtype=dtype)
        logits, cache = T.serve_prefill(params, toks, c, max_seq)
        finite = [bool(torch.isfinite(logits).all())]
        for i in range(RWKV_EXTEND):
            logits, cache = T.serve_decode(params, cache,
                                           gen_tokens[:, i:i + 1], c)
            finite.append(bool(torch.isfinite(logits).all()))
        longer, _ = T.serve_prefill(params, longer_toks, c, max_seq)
        finite.append(bool(torch.isfinite(longer).all()))
        if not all(finite):
            raise AssertionError(f"RWKV {dtype}: non-finite logits {finite}")
        err = extend_err[dtype] = _rel_err(logits, longer)
        print(f"RWKV {dtype}: prefill({RWKV_PROMPT}) + {RWKV_EXTEND} decode "
              f"tokens vs prefill({RWKV_PROMPT + RWKV_EXTEND}) (ragged last "
              f"chunk): last-position logits max abs err / max magnitude = "
              f"{err:.4g} (bound {bound}); max |logit| "
              f"{float(longer.abs().max()):.4g}; every logit finite",
              flush=True)
        if not err <= bound:
            raise AssertionError(f"RWKV {dtype}: decode after prefill off by "
                                 f"{err} > {bound}")
        del cache, logits, longer

    # -- times ---------------------------------------------------------------
    decode_ms = statistics.mean(times[0]["decode_s"][1:]) * 1e3
    eager_decode_ms = statistics.mean(eager_times[0]["decode_s"][1:]) * 1e3
    x = T._embed(sp, T._tokens(sp, toks), cfg)
    lp = T._index(sp["groups"]["l0"], 0)
    state0 = T._index(T.init_cache(cfg, RWKV_BATCH, max_seq,
                                   dtype=cfg.compute_dtype,
                                   device="cuda")["l0"], 0)
    layer_ms = cuda_ms(lambda: T._apply_layer(lp, x, cfg, "rwkv", "mlp",
                                              positions=None, cache=state0))
    timed = {}
    for name, rec, fn, plain in (
            ("rwkv6_chunked", rec7, rc_k.rwkv6_chunked,
             reference_rwkv6_chunked),
            ("rwkv6_scan", rec6, rw_k.rwkv6_scan, reference_rwkv6)):
        args, kw, _ = rec.calls[0]
        nbytes, ops = _rwkv_work(args, kw, chunked=name == "rwkv6_chunked")
        bound_ms, bound_by = _bound(nbytes, ops)
        timed[name] = {
            "ms": graph_ms(lambda: fn(*args, **kw), calls=L),
            "plain_ms": cuda_ms(lambda: plain(*args, **kw), reps=3, burst=1),
            "bytes": nbytes, "ops": ops, "bound_ms": bound_ms,
            "bound_by": bound_by}
    share = timed["rwkv6_chunked"]["ms"] / layer_ms
    # the warm prefill, eager against a replay of the captured one, in
    # turns (eager, replay, replay, eager, eager, replay), host clock to a
    # synchronize, the tokens' copy to the card included in both
    pstep = prefill["step"]
    warm = {"eager": [warm_s * 1e3], "replay": []}
    for kind in ("replay", "replay", "eager", "eager", "replay"):
        run = (lambda: pstep(toks, max_seq)) if kind == "replay" else \
            (lambda: T.serve_prefill(sp, toks, cfg, max_seq))
        warm[kind].append(_timed(run)[1] * 1e3)
    warm_eager_ms = statistics.median(warm["eager"])
    warm_replay_ms = statistics.median(warm["replay"])
    for name, tm in timed.items():
        print(f"RWKV {name} layer-0 call: kernel_ms={tm['ms']:.4f} "
              f"plain_ms={tm['plain_ms']:.4f} bytes={tm['bytes']} "
              f"ops={tm['ops']} bound_ms={tm['bound_ms']:.4f} "
              f"({tm['bound_by']}) kernel/bound="
              f"{tm['ms'] / tm['bound_ms']:.2f} library=none", flush=True)
    print(f"RWKV timing: prefill_ms cold (warm-up, capture, replay)="
          f"{times[0]['prefill_s'] * 1e3:.1f} warm eager="
          f"{[round(x, 2) for x in warm['eager']]} (median "
          f"{warm_eager_ms:.2f}) warm replay="
          f"{[round(x, 2) for x in warm['replay']]} (median "
          f"{warm_replay_ms:.2f}, {warm_replay_ms / warm_eager_ms:.3f} of "
          f"eager) decode_ms_per_step (steps 2-{steps}, "
          f"graph replays)={decode_ms:.3f} eager_decode_ms_per_step="
          f"{eager_decode_ms:.3f} first_decode_ms (warm-up, capture, "
          f"replay)={times[0]['decode_s'][0] * 1e3:.2f} layer_ms (prefill, "
          f"one layer)={layer_ms:.4f} b7_ms={timed['rwkv6_chunked']['ms']:.4f}"
          f" b7_share_of_layer={share:.4f} "
          f"({time.perf_counter() - t_start:.1f}s for the RWKV phase)",
          flush=True)
    return {"launches": launches, "held": held, "extend_err": extend_err,
            "timed": timed, "layer_ms": layer_ms,
            "warm_eager_ms": warm_eager_ms, "warm_replay_ms": warm_replay_ms,
            "decode_ms": decode_ms, "eager_decode_ms": eager_decode_ms}


def _graph_vs_eager(cfg, params, prompts) -> bool:
    """The first batch prefilled once, then ``RWKV_EXTEND`` steps through a
    graph :class:`DecodeStep` and an eager one from the same cache: logits,
    tokens and caches bitwise equal at every step."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    sp = T.serving_params(params, cfg)
    toks = _pad_batch(prompts, RWKV_PROMPT)
    logits, gc = T.serve_prefill(sp, toks, cfg, RWKV_PROMPT + RWKV_EXTEND)
    ec = gc
    gt = et = serve._greedy(logits)
    graph, eager = serve.DecodeStep(sp, cfg), serve.DecodeStep(
        sp, cfg, graph=False)
    same = True
    for _ in range(RWKV_EXTEND):
        gl, gt, gc = graph(gc, gt)
        el, et, ec = eager(ec, et)
        same &= torch.equal(gl, el) and torch.equal(gt, et) and all(
            torch.equal(a, b) for a, b in zip(serve._leaves(gc),
                                              serve._leaves(ec)))
    return bool(same)


def _prefill_graph_vs_eager(cfg, params, prompts) -> dict:
    """Two batches through one :class:`PrefillStep` capture (the first
    again after the second), each replay's logits, token and caches held
    bitwise to the eager prefill of the same tokens; and the graph pool's
    memory: the rise of ``max_memory_allocated`` over the call that
    captures (the warm-up's eager run peaks as high, and its memory is
    freed before the capture), what stays allocated and reserved after
    it."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    sp = T.serving_params(params, cfg)
    a = _pad_batch(prompts, RWKV_PROMPT)
    b = _pad_batch(serve.draw_prompts(1, RWKV_BATCH, RWKV_PROMPT,
                                      cfg.vocab_size), RWKV_PROMPT)
    max_seq = RWKV_PROMPT + RWKV_NEW_TOKENS
    step = serve.PrefillStep(sp, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base, reserved = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    first = step(a, max_seq)
    torch.cuda.synchronize()
    mb = 2.0 ** 20
    out = {"peak_mb": (torch.cuda.max_memory_allocated() - base) / mb,
           "held_mb": (torch.cuda.memory_allocated() - base) / mb,
           "reserved_mb": (torch.cuda.memory_reserved() - reserved) / mb}
    same = True
    for i, toks in enumerate((a, b, a)):
        logits, tok, caches = first if i == 0 else step(toks, max_seq)
        want_l, want_c = T.serve_prefill(sp, toks, cfg, max_seq)
        same &= torch.equal(logits, want_l) and torch.equal(
            tok, serve._greedy(want_l)) and all(
            torch.equal(x, y) for x, y in zip(serve._leaves(caches),
                                              serve._leaves(want_c)))
    out.update(same=bool(same), captures=step.captures,
               replays=step.replays, step=step, tokens=a)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _draw_gains(tree, gen, plus_one: bool) -> None:
    """The reference's zero-initialised leaves drawn in place: norm gains
    ``g`` around 1 for a plain-``g`` config (its zeros would zero every
    activation; ``1 + g`` configs keep them), QKV biases and qk-norm gains
    (always ``1 + g``) around 0."""
    for key, v in tree.items():
        if isinstance(v, dict):
            _draw_gains(v, gen, plus_one)
        elif key in ("bq", "bk", "bv", "q_norm", "k_norm") or (
                key == "g" and not plus_one):
            base = 1.0 if key == "g" else 0.0
            v.copy_(base + 0.1 * torch.randn(v.shape, generator=gen,
                                             device=v.device))


def _family_weights(cfg, seed: int):
    """Random weights for ``cfg`` drawn on the card from a generator seeded
    ``seed`` (``_draw_gains``), cast once for serving: the float32 copies
    of the cast leaves are dropped (Gemma2-9B's 9.24 B parameters are 37
    GB in float32, 18.5 GB in bf16)."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, gen, "cuda")
    _draw_gains(params, gen, cfg.norm_plus_one)
    n_params = sum(z.numel() for z in _leaves(params))
    sp = T.serving_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    return sp, n_params


def _family_inputs(cfg, batch: int, seed: int) -> dict:
    """Seeded frames (an encoder-decoder) or patch embeddings (a VLM), one
    entry a request, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                   generator=gen, device="cuda")
    if cfg.family == "vlm":
        kw["patch_embeds"] = torch.randn((batch, cfg.n_patches, cfg.d_model),
                                         generator=gen, device="cuda")
    return kw


def _b3_hold(args, out):
    """A recorded B3 call (``flash_attention.ops.attention``'s positional
    ``q, k, v, causal, window, softcap, scale``) against its plain version
    on the same inputs, a batch row at a time: ``(err, share)``."""
    from repro_torch.kernels.flash_attention.ref import reference_attention
    q, k, v, causal, window, softcap, scale = args
    rtol = BF16_RTOL if q.dtype == torch.bfloat16 else 0.0
    err = share = 0.0
    for i in range(q.shape[0]):
        plain = reference_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                    causal=causal, window=window,
                                    softcap=softcap, scale=scale)
        e, s = _hold(out[i:i + 1], plain, rtol, MODEL_TOL["flash_attention"])
        err, share = max(err, e), max(share, s)
        del plain
    return err, share


def _b3_label(args) -> str:
    q, k, _, causal, window, softcap, _ = args
    return (f"B{q.shape[0]} Hq{q.shape[1]} Hkv{k.shape[1]} Sq{q.shape[2]} "
            f"Sk{k.shape[2]} D{q.shape[3]} causal={causal} window={window} "
            f"softcap={softcap} {str(q.dtype).removeprefix('torch.')}")


def _b3_library(args, out):
    """The one PyTorch call that computes a recorded B3 call's function,
    timed as a yardstick only (it never runs on the path):
    ``F.scaled_dot_product_attention(..., enable_gqa=True)`` where there is
    no softcap and no window, else ``torch.compile(flex_attention)`` with a
    tanh ``score_mod`` and a causal / window ``block_mask``.  Returns
    ``(call, ms, max abs difference from B3's output ``out``)``, or
    ``(call, None, why it did not run)``; ``ms`` is a CUDA graph of the call
    under :func:`cuda_ms` (SDPA) or events around 5 calls (flex, whose
    calls take milliseconds here)."""
    import torch.nn.functional as F
    q, k, v, causal, window, softcap, scale = args
    gqa = q.shape[1] != k.shape[1]
    if softcap is None and window is None and (not causal
                                               or q.shape[2] == k.shape[2]):
        name = (f"F.scaled_dot_product_attention(is_causal={causal}, "
                f"enable_gqa={gqa})")

        def call():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale, enable_gqa=gqa)
        timer = graph_ms
    else:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        name = (f"torch.compile(flex_attention)(score_mod=tanh softcap "
                f"{softcap}, block_mask causal={causal} window={window}, "
                f"enable_gqa={gqa})")

        def mask_mod(b, h, qi, ki):
            keep = ki <= qi if causal else ki >= 0
            return keep & (ki > qi - window) if window is not None else keep

        def score_mod(score, b, h, qi, ki):
            return softcap * torch.tanh(score / softcap)

        # inductor's cache under build/, its kernels compiled in this
        # process (no worker pool left behind)
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                              str(ROOT / "build" / "inductor_cache"))
        import torch._inductor.config as inductor_config
        inductor_config.compile_threads = 1
        flex = torch.compile(flex_attention, dynamic=False)
        mask = []

        def call():
            if not mask:
                mask.append(create_block_mask(mask_mod, None, None,
                                              q.shape[2], k.shape[2],
                                              device=q.device))
            return flex(q, k, v, block_mask=mask[0], scale=scale,
                        enable_gqa=gqa, score_mod=None if softcap is None
                        else score_mod)
        timer = cuda_ms
    try:
        got = call()
    except Exception as e:      # a yardstick only: say why it did not run
        return name, None, f"{type(e).__name__}: " + (
            str(e).strip().splitlines() or [""])[0][:200]
    diff = float((got.double() - out.double()).abs().max())
    del got
    return name, timer(call), diff


def _b3_timing(label, args, out, err) -> dict:
    """One recorded B3 call (``out`` its output) timed: the kernel as a CUDA
    graph, its plain version a batch row at a time, the bound
    (:func:`_attention_work`) and the library call (:func:`_b3_library`).
    A ``kernels`` line row."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ref import reference_attention
    q, k, v, causal, window, softcap, scale = args
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    nbytes, ops = _attention_work(q, k, causal, window, softcap)
    bound_ms, bound_by = _bound(nbytes, ops)
    ms = graph_ms(lambda: fa_k.flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: [reference_attention(
        q[j:j + 1], k[j:j + 1], v[j:j + 1], **kw)
        for j in range(q.shape[0])], reps=3, burst=1)
    library, library_ms, library_diff = _b3_library(args, out)
    return {"label": f"{label} {_b3_label(args)}", "shape": _b3_label(args),
            "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
            "bound_ms": bound_ms, "bound_by": bound_by, "library": library,
            "library_ms": library_ms, "library_diff": library_diff}


def _print_b3_timing(what, row) -> None:
    lib = (f"library_ms={row['library_ms']:.4f} (max abs diff from B3 "
           f"{row['library_diff']:.3g})" if row["library_ms"] is not None
           else f"library_ms=null (did not run: {row['library_diff']})")
    print(f"{what} [{row['shape']}]: kernel_ms={row['ms']:.4f} plain_ms="
          f"{row['plain_ms']:.4f} (a batch row at a time) bytes="
          f"{row['bytes']} ops={row['ops']} bound_ms={row['bound_ms']:.4f} "
          f"({row['bound_by']}) kernel/bound={row['ms'] / row['bound_ms']:.2f}"
          f" library={row['library']} {lib}", flush=True)


def _serve_main_path(cfg, sp, prompts, max_prompt, new_tokens, kw, keep,
                     keep_decode):
    """``serve_requests`` in one batch with B3's and the decode-attention
    kernel's counts at 0 just before and read just after; B3's op calls
    recorded (clones of those in ``keep``), and the decode-attention
    wrapper's (clones of those in ``keep_decode``).  Returns ``(tokens,
    times, launches counted by kernel, B3's recorder, the decode
    recorder)``."""
    from repro_torch.kernels.decode_attention import kernel as da_k
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import serve_requests
    with OpRecorder(fa_ops, "attention", keep) as rec, \
            OpRecorder(da_k, "decode_attention", keep_decode) as rec_d:
        fa_k.LAUNCHES["flash_attention"] = 0
        da_k.LAUNCHES["decode_attention"] = 0
        tokens, times = serve_requests(cfg, sp, prompts, batch=len(prompts),
                                       max_prompt=max_prompt,
                                       new_tokens=new_tokens, **kw)
        torch.cuda.synchronize()
        counted = {"flash_attention": fa_k.LAUNCHES["flash_attention"],
                   "decode_attention": da_k.LAUNCHES["decode_attention"]}
    return tokens, times, counted, rec, rec_d


def _family_graph_vs_eager(cfg, sp, toks, max_seq, steps, pre, step, kw):
    """The served steps against eager ones on the same batch: a replay of
    the served :class:`PrefillStep` bitwise to ``serve_prefill`` (logits,
    token, caches), then ``steps`` decode steps through the served graph
    :class:`DecodeStep` and an eager one from the eager prefill's caches,
    logits, tokens and caches bitwise at every step.  Returns ``(bitwise,
    every logit finite)``."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    enc_out = None if "frames" not in kw else T.encode(sp, kw["frames"], cfg)
    pe = kw.get("patch_embeds")
    logits, tok, caches = pre(toks, max_seq, enc_out=enc_out,
                              patch_embeds=pe)
    want_l, want_c = T.serve_prefill(sp, toks, cfg, max_seq,
                                     enc_out=enc_out, patch_embeds=pe)
    same = torch.equal(logits, want_l) and torch.equal(
        tok, serve._greedy(want_l)) and all(
        torch.equal(a, b) for a, b in zip(serve._leaves(caches),
                                          serve._leaves(want_c)))
    finite = bool(torch.isfinite(logits).all())
    del logits, caches
    eager = serve.DecodeStep(sp, cfg, graph=False)
    gt = et = serve._greedy(want_l)
    gc = ec = want_c
    for _ in range(steps):
        gl, gt, gc = step(gc, gt, enc_out=enc_out)
        el, et, ec = eager(ec, et, enc_out=enc_out)
        same &= torch.equal(gl, el) and torch.equal(gt, et) and all(
            torch.equal(a, b) for a, b in zip(serve._leaves(gc),
                                              serve._leaves(ec)))
        finite &= bool(torch.isfinite(gl).all())
    return bool(same), finite


def _extend_err(cfg, sp, toks, extra, max_seq) -> tuple:
    """prefill(P) then the ``extra`` tokens decoded one by one, against
    prefill(P + extra): the last-position logits' ``_rel_err``, the
    largest logit magnitude, and whether every logit was finite."""
    from repro_torch.models import transformer as T
    logits, cache = T.serve_prefill(sp, toks, cfg, max_seq)
    finite = bool(torch.isfinite(logits).all())
    for i in range(extra.shape[1]):
        logits, cache = T.serve_decode(sp, cache, extra[:, i:i + 1], cfg)
        finite &= bool(torch.isfinite(logits).all())
    del cache
    longer, _ = T.serve_prefill(sp, np.concatenate([toks, extra], 1), cfg,
                                max_seq)
    finite &= bool(torch.isfinite(longer).all())
    return _rel_err(logits, longer), float(longer.abs().max()), finite


def _check_served(name, cfg, pre, step, counted, want, new_tokens,
                  gen_tokens):
    """One prefill capture replayed once, one decode capture replayed at
    every later step, the launches ``counted`` at the wrappers as
    ``want`` (kernel -> count), and every generated token a token."""
    steps = new_tokens - 1
    if not (pre.graph and pre.captures == 1 and pre.replays == 1
            and step.graph and step.captures == 1
            and step.replays == steps and counted == want):
        raise AssertionError(f"FAMILY {name}: want one prefill capture "
                             f"replayed once, one decode capture replayed "
                             f"{steps} times and launches at the wrappers "
                             f"{want}, got {pre.captures}/{pre.replays}, "
                             f"{step.captures}/{step.replays} and {counted}")
    if gen_tokens.shape[1] != new_tokens or not (
            (gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all():
        raise AssertionError(f"FAMILY {name}: generated {gen_tokens}")


def _run_gemma(held: dict, rows: list) -> dict:
    """Gemma2-9B at all 42 layers (the phase's main path, see the module
    doc).  Appends its held B3 and decode-attention calls' errors and its
    timed B3 cases; returns B3's and the decode-attention kernel's
    launches on the card on the main path."""
    from repro_torch.configs import gemma2_9b
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    cfg = gemma2_9b.CONFIG
    L, w = cfg.n_layers, cfg.sliding_window
    sp, n_params = _family_weights(cfg, 0)
    rng = np.random.default_rng(0)
    lengths = rng.integers(w + 1, FAMILY_PROMPT + 1, FAMILY_BATCH)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    print(f"FAMILY config {cfg.name} layers={L} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} window={w} softcaps="
          f"{cfg.attn_softcap}/{cfg.final_softcap} act={cfg.act} "
          f"tied={cfg.tie_embeddings} dtype={cfg.dtype} params={n_params} "
          f"requests={FAMILY_BATCH} prompt_lengths={lengths.tolist()} "
          f"max_prompt={FAMILY_PROMPT} new_tokens={FAMILY_NEW_TOKENS} "
          f"(weights {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated)",
          flush=True)

    # -- the main path: serve_requests, the counts at 0 just before -------
    # the decode wrapper runs in the decode graph's warm-up (calls 0 to
    # L - 1) and its capture; the warm-up's first and last local (ring,
    # softcap, hd 256) and global layers are held
    tokens, times, counted, rec, rec_d = _serve_main_path(
        cfg, sp, prompts, FAMILY_PROMPT, FAMILY_NEW_TOKENS, {},
        keep={0, 1, L - 2, L - 1}, keep_decode={0, 1, L - 2, L - 1})
    pre, step = times[0]["prefill"], times[0]["step"]
    gen_tokens = np.stack(tokens)
    _check_served(cfg.name, cfg, pre, step, counted,
                  {"flash_attention": 2 * L, "decode_attention": 2 * L},
                  FAMILY_NEW_TOKENS, gen_tokens)
    # one prefill pass's calls: local layers (even) windowed, all capped
    calls = rec.scalars[:L]
    kinds = [(c[1], c[2]) for c in calls]
    want_kinds = [(w if i % 2 == 0 else None, cfg.attn_softcap)
                  for i in range(L)]
    if kinds != want_kinds or any(rec.scalars[i:i + L] != calls
                                  for i in range(L, len(rec.scalars), L)):
        raise AssertionError(f"FAMILY gemma2-9b: B3 calls (window, softcap) "
                             f"{kinds} (want {want_kinds})")
    launches = {"flash_attention": L * (1 + pre.replays),
                "decode_attention": L * (1 + step.replays)}
    print(f"FAMILY gemma2-9b main path (serve_requests): prefill graph "
          f"captures={pre.captures} replays={pre.replays}, decode graph "
          f"captures={step.captures} replays={step.replays}; counted at "
          f"the wrappers {counted} (each graph's warm-up run and capture: "
          f"B3 {L} a prefill pass, {sum(k[0] is not None for k in kinds)}"
          f" local with window {w} and softcap {cfg.attn_softcap}, "
          f"{sum(k[0] is None for k in kinds)} global with softcap, none a "
          f"decode step; the decode-attention kernel {L} a decode step); "
          f"launches on the card {launches}", flush=True)

    # -- graph vs eager ----------------------------------------------------
    eager_tokens, eager_times = serve_requests(
        cfg, sp, prompts, batch=FAMILY_BATCH, max_prompt=FAMILY_PROMPT,
        new_tokens=FAMILY_NEW_TOKENS, graph=False)
    same_tokens = np.array_equal(np.stack(eager_tokens), gen_tokens)
    toks = _pad_batch(prompts, FAMILY_PROMPT)
    max_seq = FAMILY_PROMPT + FAMILY_NEW_TOKENS
    same, finite = _family_graph_vs_eager(cfg, sp, toks, max_seq,
                                          FAMILY_EXTEND, pre, step, {})
    print(f"FAMILY gemma2-9b graph vs eager: serve_requests tokens equal="
          f"{same_tokens}; a prefill replay and {FAMILY_EXTEND} decode "
          f"replays bitwise to eager (logits, tokens, caches)={same}, "
          f"every logit finite={finite}", flush=True)
    if not (same_tokens and same and finite):
        raise AssertionError("FAMILY gemma2-9b: graph replays differ from "
                             "eager serving")

    # -- the recorded B3 calls against the plain version --------------------
    errs = {}
    for i in sorted(rec.calls):
        args, _, out = rec.calls[i]
        err, share = errs[i] = _b3_hold(args, out)
        what = f"FAMILY gemma2-9b layer {i} B3 [{_b3_label(args)}]"
        print(f"{what}: max_abs_err={err:.3g} allowance_share={share:.3g} "
              f"(|err| <= {BF16_RTOL:.3g}|plain| + "
              f"{MODEL_TOL['flash_attention']})", flush=True)
        if not share <= 1.0:
            raise AssertionError(f"{what}: {share:.3g}x its allowance")
        held["flash_attention"].append(err)
    held["decode_attention"] += _decode_held("FAMILY gemma2-9b", rec_d)

    # -- prefill(P) + decode tokens vs prefill(P + tokens) -----------------
    extra = gen_tokens[:, :FAMILY_EXTEND]
    ext = {"bfloat16": _extend_err(cfg, sp, toks, extra,
                                   FAMILY_PROMPT + FAMILY_EXTEND)}

    # -- times ---------------------------------------------------------------
    warm = {"eager": [], "replay": []}
    for kind in ("eager", "replay", "replay", "eager", "eager", "replay"):
        run = (lambda: pre(toks, max_seq)) if kind == "replay" else \
            (lambda: T.serve_prefill(sp, toks, cfg, max_seq))
        warm[kind].append(_timed(run)[1] * 1e3)
    decode_ms = statistics.mean(times[0]["decode_s"][1:]) * 1e3
    eager_decode_ms = statistics.mean(eager_times[0]["decode_s"][1:]) * 1e3
    cold_ms = times[0]["prefill_s"] * 1e3
    for i in (0, 1):
        args, _, out = rec.calls[i]
        layer = "local" if args[4] is not None else "global"
        rows.append(_b3_timing(f"Gemma2-9B served {layer} layer", args, out,
                               errs[i][0]))
        _print_b3_timing(f"FAMILY gemma2-9b B3 {layer} layer call", rows[-1])
    del pre, step, times, eager_times, rec, rec_d, sp
    torch.cuda.empty_cache()

    # the same widths in float32 at 2 layers (one local, one global): the
    # ring's roll and slot arithmetic without bf16's noise
    c32 = cfg.scaled(n_layers=2, dtype="float32")
    sp32, _ = _family_weights(c32, 1)
    ext["float32"] = _extend_err(c32, sp32, toks, extra,
                                 FAMILY_PROMPT + FAMILY_EXTEND)
    del sp32
    torch.cuda.empty_cache()
    for dtype, (err, top, finite) in ext.items():
        depth = L if dtype == "bfloat16" else 2
        print(f"FAMILY gemma2-9b {dtype} {depth} layers: prefill("
              f"{FAMILY_PROMPT}) + {FAMILY_EXTEND} decode tokens vs prefill("
              f"{FAMILY_PROMPT + FAMILY_EXTEND}): last-position logits max "
              f"abs err / max magnitude = {err:.4g} (bound "
              f"{FAMILY_RTOL[dtype]}); max |logit| {top:.4g}; every logit "
              f"finite={finite}", flush=True)
        if not (finite and err <= FAMILY_RTOL[dtype]):
            raise AssertionError(f"FAMILY gemma2-9b {dtype}: decode after "
                                 f"prefill off by {err}, finite {finite}")
    print(f"FAMILY gemma2-9b timing: prefill_ms cold (warm-up, capture, "
          f"replay)={cold_ms:.1f} warm eager="
          f"{[round(x, 2) for x in warm['eager']]} (median "
          f"{statistics.median(warm['eager']):.2f}) warm replay="
          f"{[round(x, 2) for x in warm['replay']]} (median "
          f"{statistics.median(warm['replay']):.2f}) decode_ms_per_step "
          f"(steps 2-{FAMILY_NEW_TOKENS - 1}, graph replays)={decode_ms:.3f} "
          f"eager_decode_ms_per_step={eager_decode_ms:.3f} "
          f"({time.perf_counter() - t0:.1f}s for Gemma2-9B)", flush=True)
    return launches


def _run_other_family(name: str, held: dict, rows: list) -> dict:
    """One of the other attention configs as published, at 2 layers
    (Whisper-tiny whole): ``FAMILY_OTHER_BATCH`` requests of
    ``FAMILY_OTHER_PROMPT`` tokens (LLaVA's 2880 patches before them),
    ``FAMILY_OTHER_STEPS`` decode steps; B3's launches, every recorded call
    held against the plain version, graph vs eager.  Returns B3's and the
    decode-attention kernel's launches on the card and the prefill and
    decode times."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    cfg = get_config(name)
    if cfg.n_encoder_layers == 0:
        cfg = cfg.scaled(n_layers=2)
    sp, n_params = _family_weights(cfg, 2)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (FAMILY_OTHER_PROMPT, FAMILY_OTHER_PROMPT - 100)]
    kw = _family_inputs(cfg, FAMILY_OTHER_BATCH, 3)
    new_tokens = FAMILY_OTHER_STEPS + 1
    L, enc = cfg.n_layers, cfg.n_encoder_layers
    cross = L if enc else 0
    # the encoder's calls (eager, once a batch), then one prefill pass's
    # and the decode step's cross-attention, each run twice at the wrapper
    # (the warm-up and the capture)
    want = enc + 2 * (L + cross) + 2 * cross
    keep = list(range(enc + L + cross))
    if cross:                  # and the first decode step's first one
        keep.append(enc + 2 * (L + cross))
    # the decode step's self-attention through the decode-attention
    # kernel, L calls in the warm-up (all held) and L in the capture
    tokens, times, counted, rec, rec_d = _serve_main_path(
        cfg, sp, prompts, FAMILY_OTHER_PROMPT, new_tokens, kw, keep,
        range(L))
    pre, step = times[0]["prefill"], times[0]["step"]
    gen_tokens = np.stack(tokens)
    want = {"flash_attention": want, "decode_attention": 2 * L}
    _check_served(name, cfg, pre, step, counted, want, new_tokens,
                  gen_tokens)
    launches = {"flash_attention": enc + (L + cross) * (1 + pre.replays)
                + cross * (1 + step.replays),
                "decode_attention": L * (1 + step.replays)}
    toks = _pad_batch(prompts, FAMILY_OTHER_PROMPT)
    max_seq = FAMILY_OTHER_PROMPT + new_tokens + (
        cfg.n_patches if cfg.family == "vlm" else 0)
    same, finite = _family_graph_vs_eager(cfg, sp, toks, max_seq,
                                          FAMILY_OTHER_STEPS, pre, step, kw)
    if not (same and finite):
        raise AssertionError(f"FAMILY {name}: graph replays differ from "
                             f"eager serving")
    shapes, errs, worst = {}, {}, (0.0, 0.0)
    for i in sorted(rec.calls):
        args, _, out = rec.calls[i]
        err, share = errs[i] = _b3_hold(args, out)
        if not share <= 1.0:
            raise AssertionError(f"FAMILY {name} B3 call {i} "
                                 f"[{_b3_label(args)}]: {share:.3g}x its "
                                 f"allowance")
        shapes.setdefault(_b3_label(args), i)
        worst = max(worst, (err, share), key=lambda t: t[1])
        held["flash_attention"].append(err)
    held["decode_attention"] += _decode_held(f"FAMILY {name}", rec_d)
    cold_ms = times[0]["prefill_s"] * 1e3
    enc_out = None if "frames" not in kw else T.encode(sp, kw["frames"], cfg)
    prefill_ms = statistics.median(_timed(lambda: pre(
        toks, max_seq, enc_out=enc_out, patch_embeds=kw.get("patch_embeds"))
    )[1] * 1e3 for _ in range(3))
    decode_ms = statistics.mean(times[0]["decode_s"][1:]) * 1e3
    print(f"FAMILY {name} layers={L}{f'+{enc} encoder' if enc else ''} "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x"
          f"{cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab_size} act={cfg.act} "
          f"qkv_bias={cfg.qkv_bias} qk_norm={cfg.qk_norm} dtype={cfg.dtype} "
          f"params={n_params} batch={FAMILY_OTHER_BATCH}x"
          f"{FAMILY_OTHER_PROMPT}{f' + {cfg.n_patches} patches' if cfg.n_patches else ''}"
          f"{f' + {cfg.encoder_seq} frames' if enc else ''}: counted at the "
          f"wrappers {counted} (want {want}), launches on the card "
          f"{launches}; prefill and {FAMILY_OTHER_STEPS} decode graph "
          f"replays bitwise to eager={same} (every logit finite="
          f"{finite}); {len(rec.calls)} B3 calls held "
          f"against plain, worst max_abs_err={worst[0]:.3g} "
          f"allowance_share={worst[1]:.3g}, shapes {list(shapes)}; "
          f"prefill_ms cold (warm-up, capture, replay)={cold_ms:.1f} warm "
          f"replay (median of 3; the encoder outside)={prefill_ms:.3f} "
          f"decode_ms_per_step (steps 2-{FAMILY_OTHER_STEPS}, graph "
          f"replays)={decode_ms:.3f} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    # each distinct B3 shape's first call timed beside its library call
    for i in shapes.values():
        args, _, out = rec.calls[i]
        rows.append(_b3_timing(f"{name} served", args, out, errs[i][0]))
        _print_b3_timing(f"FAMILY {name} B3 call", rows[-1])
    return {"launches": launches, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms}


def _pad_batch(prompts, width: int):
    """Prompts left-padded to ``width``, as ``serve_requests`` pads them."""
    toks = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        toks[i, width - len(p):] = p
    return toks


def run_families() -> dict:
    """The attention model families (see the module doc): Gemma2-9B served
    at all 42 layers, then the other attention configs at 2 layers.
    Returns B3's and the decode-attention kernel's launches, the held
    calls' largest errors and B3's timed cases' rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    held = {"flash_attention": [], "decode_attention": []}
    rows = []
    launches = _run_gemma(held, rows)
    torch.cuda.empty_cache()
    others = {}
    for name in FAMILY_OTHERS:
        others[name] = _run_other_family(name, held, rows)
        for k, n in others[name]["launches"].items():
            launches[k] += n
        torch.cuda.empty_cache()
    print(f"FAMILY phase: launches {launches}, calls held "
          f"{ {k: len(v) for k, v in held.items()} }, max_abs_err "
          f"{ {k: float(f'{max(v):.3g}') for k, v in held.items()} }, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return {"launches": launches, "rows": rows, "others": others,
            "max_abs_err": {k: max(v) for k, v in held.items()}}


class MoeDrops:
    """While active, wraps the direct model's ``moe``: for its first ``n``
    calls (one prefill pass) the share of token-expert pairs its router
    sends past an expert's capacity (``layers.moe_route``), a diagnostic
    beside the published capacity factor."""

    def __init__(self, n: int):
        from repro_torch.models import transformer as T
        self.T, self.n, self.orig = T, n, T.moe
        self.shares = []

    def __enter__(self):
        from repro_torch.models.layers import MOE_GROUP_TOKENS, moe_route

        def spy(p, x, cfg, **kw):
            if len(self.shares) < self.n:
                s_g = min(x.shape[1], MOE_GROUP_TOKENS)
                r = moe_route(p, x.reshape(-1, s_g, x.shape[-1]), cfg)
                self.shares.append(float(1 - r["keep"].sum()
                                         / r["chosen"].sum()))
            return self.orig(p, x, cfg, **kw)

        self.T.moe = spy
        return self

    def __exit__(self, *exc):
        self.T.moe = self.orig


def _b5_hold(args, kw, out):
    """A recorded B5 call (``mamba_scan.ops.mamba``'s six tensors and its
    ``state`` keyword) against ``reference_mamba`` on the same inputs: y
    (one bf16 ulp beside ``MODEL_TOL`` for a bf16 y) and the final state,
    float32.  Returns ``(err, share)``, the larger of the two."""
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    y, h = out
    py, ph = reference_mamba(*args[:6], state=kw.get("state"),
                             return_state=True)
    rtol = BF16_RTOL if y.dtype == torch.bfloat16 else 0.0
    ey, sy = _hold(y, py, rtol, MODEL_TOL["mamba_scan"])
    eh, sh = _hold(h, ph, 0.0, MODEL_TOL["mamba_scan"])
    return max(ey, eh), max(sy, sh)


def _b5_timing(label, args, kw, err) -> dict:
    """A recorded B5 call timed with its state in and out: the kernel as a
    CUDA graph (32 calls in one graph for a decode token, whose launch is
    a few microseconds), the plain version, and the bound — the bytes of
    x, dt, B, C, A, D and y and of the float32 state read and written
    (``mamba_scan.kernel.mamba_ops`` for the operations).  A ``kernels``
    line row."""
    from repro_torch.kernels.mamba_scan import kernel as ms_k
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    x, dt, b, c, a, d = args[:6]
    state = kw.get("state")
    bsz, t, di = x.shape
    ds = b.shape[-1]
    nbytes = (3 * bsz * t * di + 2 * bsz * t * ds + di * ds + di) \
        * x.element_size() + 2 * bsz * di * ds * 4
    ops = ms_k.mamba_ops(bsz, t, di, ds)
    bound_ms, bound_by = _bound(nbytes, ops)

    def run():
        return ms_k.mamba_scan(x, dt, b, c, a, d, state=state,
                               return_state=True)
    ms = graph_ms(run, calls=32 if t == 1 else 1)
    plain_ms = cuda_ms(lambda: reference_mamba(x, dt, b, c, a, d,
                                               state=state,
                                               return_state=True),
                       reps=3 if t > 1 else 10, burst=1 if t > 1 else 5)
    return {"label": f"{label} B{bsz} T{t} d_inner {di} d_state {ds} "
                     f"{str(x.dtype).removeprefix('torch.')}, state in and "
                     f"out", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library": "none: no PyTorch call computes a selective scan",
            "library_ms": None}


def _moe_config(name, layers):
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return cfg if layers is None else cfg.scaled(n_layers=layers)


def _run_moe_config(case, seed: int, rows: dict, held: dict) -> dict:
    """One config of ``MOE_CASES`` served on the card (see the module doc).
    Appends its timed B3 and B5 calls to ``rows`` and its held errors to
    ``held``; returns its launches on the card and times."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import transformer as T
    name, layers, batch, prompt, new_tokens = case
    t0 = time.perf_counter()
    cfg = _moe_config(name, layers)
    sp, n_params = _family_weights(cfg, seed)
    pattern = cfg.layer_pattern()
    n_attn = sum(m.startswith("attn") for m, _ in pattern)
    n_mamba = sum(m == "mamba" for m, _ in pattern)
    n_moe = sum(f == "moe" for _, f in pattern)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(prompt // 2 + 1, prompt + 1, batch)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    m = cfg.moe
    print(f"MOE config {cfg.name} layers={cfg.n_layers} (attention "
          f"{n_attn}, mamba {n_mamba}; moe {n_moe}, dense "
          f"{cfg.n_layers - n_moe}) d_model={cfg.d_model} heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} experts={m.n_experts} "
          f"top_k={m.top_k} d_expert={m.d_expert} capacity_factor="
          f"{m.capacity_factor} d_ff={cfg.d_ff} vocab={cfg.vocab_size}"
          + (f" mamba d_inner={cfg.mamba.expand * cfg.d_model} d_state="
             f"{cfg.mamba.d_state} d_conv={cfg.mamba.d_conv}"
             if n_mamba else "")
          + f" dtype={cfg.dtype} param_dtype={cfg.param_dtype} params="
          f"{n_params} requests={batch} prompt_lengths={lengths.tolist()} "
          f"max_prompt={prompt} new_tokens={new_tokens} (weights "
          f"{time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated)",
          flush=True)

    # -- the main path: serve_requests, B3's, B5's and DA's counts at 0 ---
    # the wrappers run in the prefill's warm-up and capture (calls 0 to
    # 2n - 1 of n a pass) and the decode step's (2n to 4n - 1); B5's held
    # calls are the first and last Mamba layer of the prefill's warm-up and
    # the first of the decode step's, B3's every call of the warm-up; the
    # decode-attention kernel (DA) runs in the decode step's warm-up (calls
    # 0 to n - 1, all held) and capture
    from repro_torch.kernels.decode_attention import kernel as da_k
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.mamba_scan import kernel as ms_k
    keep5 = {0, n_mamba - 1, 2 * n_mamba} if n_mamba else set()
    with OpRecorder(fa_ops, "attention", range(n_attn)) as r3, \
            OpRecorder(ms_ops, "mamba", keep5) as r5, \
            OpRecorder(da_k, "decode_attention", range(n_attn)) as rd, \
            MoeDrops(n_moe) as dr:
        fa_k.LAUNCHES["flash_attention"] = 0
        ms_k.LAUNCHES["mamba_scan"] = 0
        da_k.LAUNCHES["decode_attention"] = 0
        tokens, times = serve_requests(cfg, sp, prompts, batch=batch,
                                       max_prompt=prompt,
                                       new_tokens=new_tokens)
        torch.cuda.synchronize()
        counted = {"flash_attention": fa_k.LAUNCHES["flash_attention"],
                   "mamba_scan": ms_k.LAUNCHES["mamba_scan"],
                   "decode_attention": da_k.LAUNCHES["decode_attention"]}
    pre, step = times[0]["prefill"], times[0]["step"]
    gen_tokens = np.stack(tokens)
    want = {"flash_attention": 2 * n_attn, "mamba_scan": 4 * n_mamba,
            "decode_attention": 2 * n_attn}
    _check_served(name, cfg, pre, step, counted, want, new_tokens,
                  gen_tokens)
    in_place = [i for i, w in enumerate(r5.in_place) if w]
    if in_place != list(range(3 * n_mamba, 4 * n_mamba)):
        raise AssertionError(f"MOE {name}: B5 calls writing the state in "
                             f"place {in_place}, want the decode capture's "
                             f"{3 * n_mamba} to {4 * n_mamba - 1}")
    launches = {"flash_attention": n_attn * (1 + pre.replays),
                "mamba_scan": n_mamba * (1 + pre.replays)
                + n_mamba * (1 + step.replays),
                "decode_attention": n_attn * (1 + step.replays)}
    print(f"MOE {name} main path (serve_requests): prefill graph captures="
          f"{pre.captures} replays={pre.replays}, decode graph captures="
          f"{step.captures} replays={step.replays}; a prefill pass runs B3 "
          f"{n_attn} and B5 {n_mamba} times, a decode step B3 0, B5 "
          f"{n_mamba} and the decode-attention kernel {n_attn} times "
          f"(counted at the wrappers {counted}: each "
          f"step's warm-up and capture); B5 writing the ssm state in place "
          f"in the decode graph: {len(in_place)} of the capture's "
          f"{n_mamba} calls (out_state is the static cache's state); "
          f"launches on the card {launches}; token-expert pairs dropped at "
          f"capacity in the prefill, by MoE layer "
          f"{[round(x, 4) for x in dr.shares]} (a diagnostic)", flush=True)

    # -- graph vs eager ----------------------------------------------------
    eager_tokens, _ = serve_requests(cfg, sp, prompts, batch=batch,
                                     max_prompt=prompt,
                                     new_tokens=new_tokens, graph=False)
    same_tokens = np.array_equal(np.stack(eager_tokens), gen_tokens)
    toks = _pad_batch(prompts, prompt)
    max_seq = prompt + new_tokens
    steps = min(FAMILY_EXTEND, new_tokens - 1)
    same, finite = _family_graph_vs_eager(cfg, sp, toks, max_seq, steps,
                                          pre, step, {})
    print(f"MOE {name} graph vs eager: serve_requests tokens equal="
          f"{same_tokens}; a prefill replay and {steps} decode replays "
          f"bitwise to eager (logits, tokens, caches)={same}; every logit "
          f"finite={finite}", flush=True)
    if not (same_tokens and same and finite):
        raise AssertionError(f"MOE {name}: graph replays differ from eager "
                             f"serving, or a logit is not finite")

    # -- the recorded calls against their plain versions -------------------
    errs3, errs5 = {}, {}
    for i in sorted(r3.calls):
        args, _, out = r3.calls[i]
        errs3[i] = _b3_hold(args, out)
        if not errs3[i][1] <= 1.0:
            raise AssertionError(f"MOE {name} B3 call {i} "
                                 f"[{_b3_label(args)}]: {errs3[i][1]:.3g}x "
                                 f"its allowance")
    for i in sorted(r5.calls):
        args, kw, out = r5.calls[i]
        errs5[i] = _b5_hold(args, kw, out)
        what = "decode" if i >= 2 * n_mamba else "prefill"
        print(f"MOE {name} B5 call {i} ({what}, Mamba layer "
              f"{i % n_mamba} of {n_mamba}) [x {tuple(args[0].shape)} "
              f"{str(args[0].dtype).removeprefix('torch.')}, state in and "
              f"out]: y and final state max_abs_err={errs5[i][0]:.3g} "
              f"allowance_share={errs5[i][1]:.3g} (|err| <= "
              f"{MODEL_TOL['mamba_scan']})", flush=True)
        if not errs5[i][1] <= 1.0:
            raise AssertionError(f"MOE {name} B5 call {i}: "
                                 f"{errs5[i][1]:.3g}x its allowance")
    if errs3:
        worst = max(errs3.values(), key=lambda e: e[1])
        print(f"MOE {name}: {len(errs3)} B3 calls (one prefill pass) held "
              f"against plain, worst max_abs_err={worst[0]:.3g} "
              f"allowance_share={worst[1]:.3g} (|err| <= "
              f"{BF16_RTOL:.3g}|plain| + {MODEL_TOL['flash_attention']})",
              flush=True)
    held["flash_attention"] += [e for e, _ in errs3.values()]
    held["mamba_scan"] += [e for e, _ in errs5.values()]
    held["decode_attention"] += _decode_held(f"MOE {name}", rd)

    # -- the state hand-off (Mamba configs) --------------------------------
    if n_mamba:
        ch = cfg.scaled(moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
        head = toks[:, -(MOE_HANDOFF - MOE_EXTEND):]
        err, top, fin = _extend_err(ch, sp, head,
                                    gen_tokens[:, :MOE_EXTEND], MOE_HANDOFF)
        print(f"MOE {name} state hand-off, capacity_factor "
              f"{ch.moe.capacity_factor} (nothing dropped): prefill("
              f"{MOE_HANDOFF - MOE_EXTEND}) + {MOE_EXTEND} decode tokens vs "
              f"prefill({MOE_HANDOFF}): last-position logits max abs err / "
              f"max magnitude = {err:.4g} (bound {FAMILY_RTOL[cfg.dtype]}); "
              f"max |logit| {top:.4g}; every logit finite={fin}", flush=True)
        if not (fin and err <= FAMILY_RTOL[cfg.dtype]):
            raise AssertionError(f"MOE {name}: decode after prefill off by "
                                 f"{err}, finite {fin}")

    # -- times ---------------------------------------------------------------
    warm = {"eager": [], "replay": []}
    for kind in ("eager", "replay", "replay", "eager"):
        run = (lambda: pre(toks, max_seq)) if kind == "replay" else \
            (lambda: T.serve_prefill(sp, toks, cfg, max_seq))
        warm[kind].append(_timed(run)[1] * 1e3)
    decode_ms = statistics.mean(times[0]["decode_s"][1:]) * 1e3
    prof = _profile_steps(pre, step, toks, max_seq)
    print(f"MOE {name} timing: prefill_ms cold (warm-up, capture, replay)="
          f"{times[0]['prefill_s'] * 1e3:.1f} warm eager="
          f"{[round(x, 2) for x in warm['eager']]} warm replay="
          f"{[round(x, 2) for x in warm['replay']]} decode_ms_per_step "
          f"(steps 2-{new_tokens - 1}, graph replays)={decode_ms:.3f} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    for what, (wall, busy, top) in prof.items():
        print(f"MOE {name} profile of a {what} (torch.profiler, graph "
              f"replays): wall {wall:.3f} ms, device busy {busy:.3f} ms, "
              f"idle share {1 - busy / wall:.3f}; top device ops: {top}",
              flush=True)
    if r3.calls:
        args, _, out = r3.calls[0]
        rows["flash_attention"].append(_b3_timing(f"{name} served", args,
                                                  out, errs3[0][0]))
        _print_b3_timing(f"MOE {name} B3 call", rows["flash_attention"][-1])
    for i, what in ((0, "prefill"), (2 * n_mamba, "decode")):
        if i not in r5.calls:
            continue
        args, kw, _ = r5.calls[i]
        row = _b5_timing(f"{name} served {what} layer", args, kw,
                         errs5[i][0])
        rows["mamba_scan"].append(row)
        print(f"MOE {name} B5 {what} layer call [{row['label']}]: "
              f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"bytes={row['bytes']} ops={row['ops']} bound_ms="
              f"{row['bound_ms']:.4f} ({row['bound_by']}) kernel/bound="
              f"{row['ms'] / row['bound_ms']:.2f} library=none", flush=True)
    return {"launches": launches, "prefill_ms": warm, "decode_ms": decode_ms}


def _profile_steps(pre, step, toks, max_seq) -> dict:
    """A prefill replay, and two decode replays from its caches (after one
    step that copies them into the decode graph's static caches), each
    under ``torch.profiler``: ``{what: (wall ms, device busy ms, the top
    device operations by time, each summed over the run)}``; wall and busy
    per step, the top operations over the run's steps (named in
    ``what``)."""
    from torch.profiler import ProfilerActivity, profile as tp
    _, tok, caches = pre(toks, max_seq)
    _, tok, caches = step(caches, tok)
    runs = {"prefill": (1, lambda: pre(toks, max_seq)),
            "decode step (top ops over 2 steps)":
                (2, lambda: [step(caches, tok) for _ in range(2)])}
    out = {}
    for what, (n, fn) in runs.items():
        torch.cuda.synchronize()
        with tp(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                acc_events=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = _device_kernels(prof)
        out[what] = (wall / n, _busy_ms(events) / n,
                     _top_device_ops(events, 4))
    return out


def run_moe() -> dict:
    """The MoE and Mamba families (see the module doc): Jamba-v0.1 at one
    8-layer period, OLMoE-1B-7B whole and Qwen3-MoE-235B-A22B at 2 layers,
    each served through the prefill and decode graphs, its weights dropped
    before the next.  Returns B3's and B5's launches on the card, the
    timed calls' rows and the held calls' largest errors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = {"flash_attention": [], "mamba_scan": []}
    held = {"flash_attention": [], "mamba_scan": [], "decode_attention": []}
    launches = {"flash_attention": 0, "mamba_scan": 0, "decode_attention": 0}
    for seed, case in enumerate(MOE_CASES):
        res = _run_moe_config(case, 10 + seed, rows, held)
        for k, n in res["launches"].items():
            launches[k] += n
        del res
        gc.collect()
        torch.cuda.empty_cache()
    print(f"MOE phase: launches {launches}, B3 calls held "
          f"{len(held['flash_attention'])} (max_abs_err "
          f"{max(held['flash_attention']):.3g}), B5 calls held "
          f"{len(held['mamba_scan'])} (max_abs_err "
          f"{max(held['mamba_scan']):.3g}), decode-attention calls held "
          f"{len(held['decode_attention'])} (max_abs_err "
          f"{max(held['decode_attention']):.3g}), peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB allocated, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return {"launches": launches, "rows": rows,
            "max_abs_err": {k: max(v) for k, v in held.items()}}


def _device_kernels(prof):
    """The device kernels of a profile, without the device-side spans of
    ``record_function`` ranges (user annotations)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and not _is_annotation(e)]


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) \
        or e.name in TRAIN_RANGES or e.name == "train_step.forward_backward"


def _busy_ms(kernels) -> float:
    """The device's busy time: the union of the kernels' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _loop_program(lazy, fn, args, loop_fusion: bool, profile=False) -> dict:
    """Two runs of ``fn(*args)`` (cold, then warm) in one triton runtime,
    each timed to the drain of its last iteration (an empty flush) and a
    synchronize; the result read back after the clock.  With ``profile``
    a third run goes under ``torch.profiler`` for the device's busy time.
    Returns each run's result, wall and flush seconds, history and stats
    deltas and B1's launches."""
    from repro_torch.kernels.fused_block import codegen
    out = []
    with lazy.fresh_runtime(backend="triton", loop_fusion=loop_fusion) as rt:
        for k in range(3 if profile else 2):
            prof = None
            if k == 2:
                from torch.profiler import ProfilerActivity, profile as tp
                prof = tp(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
                prof.__enter__()
            n_hist = len(rt.history)
            before = rt.executor.stats.snapshot()
            codegen.LAUNCHES["fused_block"] = 0
            f0 = rt.flush_wall_s
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args)
            lazy.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            flush = rt.flush_wall_s - f0
            launches = codegen.LAUNCHES["fused_block"]
            busy = None
            if prof is not None:
                prof.__exit__(None, None, None)
                busy = _busy_ms(_device_kernels(prof))
            hist = list(rt.history)[n_hist:]
            st = rt.executor.stats.snapshot()
            delta = {key: st[key] - before[key] for key in (
                "loop_flushes", "loop_iterations", "loop_captures",
                "loop_replays", "loop_state_copies", "triton_blocks",
                "triton_fallback_blocks", "donated_buffers")}
            out.append({"result": np.asarray(res), "wall_s": wall,
                        "flush_s": flush, "busy_ms": busy,
                        "launches": launches, "stats": delta,
                        "deferred": sum(1 for h in hist
                                        if h.get("loop_deferred")),
                        "drains": [h["n_iterations"] for h in hist
                                   if h.get("loop_drain")]})
            del res
    return out


def _key_table_copy(keys):
    from repro_torch.core import prng
    return prng.KeyTable(keys.table.clone(), keys.ctr.clone(), keys.off)


class LoopFormRecorder:
    """Records the first call of each fused-block kernel that ran its loop
    form (``salts`` a ``prng.KeyTable``): the kernel, clones of its inputs
    and of the key table and counter as they stood, and its keywords.  A
    loop body's first call is its eager warm-up, so the capture after it
    records nothing."""

    def __init__(self, kernel_cls):
        self.kernel_cls = kernel_cls
        self.calls = {}
        self._orig = kernel_cls.__call__

    def __enter__(self):
        from repro_torch.core import prng
        calls, orig = self.calls, self._orig

        def spy(kernel, *bufs_and_salts, **kw):
            *bufs, salts = bufs_and_salts
            if isinstance(salts, prng.KeyTable) and id(kernel) not in calls:
                calls[id(kernel)] = (kernel, [b.clone() for b in bufs],
                                     _key_table_copy(salts), dict(kw))
            return orig(kernel, *bufs_and_salts, **kw)

        self.kernel_cls.__call__ = spy
        return self

    def __exit__(self, *exc):
        self.kernel_cls.__call__ = self._orig


def _loop_form_checks(lazy, codegen) -> dict:
    """The random-bearing ``IterativeProgram`` (``LOOP_RANDOM``) loop-fused
    against per-flush on the card, bitwise; then every loop-form B1 call of
    its body (three draw) held bitwise against its plain key-table form on
    the recorded inputs, and the largest drawing block's loop form timed
    against its per-flush form (key words as launch arguments) and its
    plain version."""
    from repro_torch.testing.tapegen import IterativeProgram
    seed, steps, size = LOOP_RANDOM
    prog = IterativeProgram(seed, steps=steps, size=size)
    ref = prog.run(backend="triton", loop_fusion=False)
    with LoopFormRecorder(codegen.FusedBlockKernel) as rec:
        with lazy.fresh_runtime(backend="triton") as rt:
            codegen.LAUNCHES["fused_block"] = 0
            got = prog.run_current()
            launches = codegen.LAUNCHES["fused_block"]
            st = rt.executor.stats.snapshot()
    for i, (r, g) in enumerate(zip(ref, got)):
        check_close(g, r, f"LOOP random program output {i}: loop-fused vs "
                    "per-flush", exact=True)
    if st["loop_replays"] <= 1 or st["loop_captures"] < 1:
        raise AssertionError(f"LOOP random program: {st['loop_captures']} "
                             f"captures, {st['loop_replays']} replays")
    drawing = [c for c in rec.calls.values() if c[0].plan.rand_shapes]
    if not drawing:
        raise AssertionError("LOOP: no loop-form call of a drawing block")
    for kernel, bufs, keys, kw in rec.calls.values():
        want = kernel.plain(*bufs, keys)
        for args in ((bufs, {}), ([b.clone() for b in bufs], kw)):
            got_k = kernel(*args[0], keys, **args[1])
            for g, w in zip(got_k, want):
                check_close(g.cpu().numpy(), w.cpu().numpy(),
                            f"LOOP B1 loop form vs plain on block "
                            f"{kernel.plan.domain}", exact=True)
    kernel, bufs, keys, _ = max(drawing, key=lambda c: c[0].plan.N)
    store = dict(zip(kernel.plan.inputs, bufs))
    salts = tuple(range(1, len(kernel.plan.rand_shapes) + 1))
    timing = {"loop_ms": kernel_ms(kernel, store, keys, bufs[0].device),
              "arg_ms": kernel_ms(kernel, store, salts, bufs[0].device),
              "plain_ms": cuda_ms(lambda: kernel.plain(*bufs, keys)),
              "domain": kernel.plan.domain,
              "draws": len(kernel.plan.rand_shapes),
              **block_bound(kernel, codegen)}
    return {"stats": st, "blocks": len(rec.calls), "drawing": len(drawing),
            "timing": timing, "launches": launches}


def run_loop(lazy, codegen) -> dict:
    """The LOOP phase: cross-flush loop fusion on the card (module
    docstring).  Returns B1's launches on its main path (the loop-fused
    runs) and the loop-form check's error (0: bitwise)."""
    from repro_torch.testing.programs import BENCHMARKS, CHIP_SIZES
    t_start = time.perf_counter()
    launches = 0
    for name in LOOP_PROGRAMS:
        args = (LOOP_ITERS,) + tuple(CHIP_SIZES[name][1:])
        flush = _loop_program(lazy, BENCHMARKS[name], args, False)
        torch.cuda.empty_cache()
        fused = _loop_program(lazy, BENCHMARKS[name], args, True,
                              profile=True)
        torch.cuda.empty_cache()
        for k in range(2):
            check_close(fused[k]["result"], flush[k]["result"],
                        f"LOOP {name} run {k}: loop-fused vs per-flush",
                        exact=True)
        st = fused[0]["stats"]
        if st["loop_captures"] < 1 or fused[1]["stats"]["loop_replays"] <= 1:
            raise AssertionError(f"LOOP {name}: captures {st} / "
                                 f"{fused[1]['stats']}")
        if fused[1]["stats"]["triton_fallback_blocks"]:
            raise AssertionError(f"LOOP {name}: a block fell to the floor")
        launches += sum(run["launches"] for run in fused)
        w, p = fused[1], fused[2]
        print(f"LOOP {name} args={args}: warm wall_ms/iter per-flush="
              f"{flush[1]['wall_s'] / LOOP_ITERS * 1e3:.4f} loop-fused="
              f"{w['wall_s'] / LOOP_ITERS * 1e3:.4f}; flush_ms/iter "
              f"per-flush={flush[1]['flush_s'] / LOOP_ITERS * 1e3:.4f} "
              f"loop-fused={w['flush_s'] / LOOP_ITERS * 1e3:.4f}; cold "
              f"wall_ms/iter per-flush="
              f"{flush[0]['wall_s'] / LOOP_ITERS * 1e3:.4f} loop-fused="
              f"{fused[0]['wall_s'] / LOOP_ITERS * 1e3:.4f}; deferred "
              f"{w['deferred']}/{LOOP_ITERS} drains={w['drains']}; captures "
              f"cold={fused[0]['stats']['loop_captures']} warm="
              f"{w['stats']['loop_captures']}, replays warm="
              f"{w['stats']['loop_replays']}, loop_state_copies cold="
              f"{fused[0]['stats']['loop_state_copies']} warm="
              f"{w['stats']['loop_state_copies']}; B1 launches by the "
              f"wrappers warm per-flush={flush[1]['launches']} "
              f"loop-fused={w['launches']}; profiled loop-fused run: wall "
              f"{p['wall_s'] * 1e3:.3f} ms, device busy {p['busy_ms']:.3f} "
              f"ms, idle {1 - p['busy_ms'] / (p['wall_s'] * 1e3):.3f}; "
              f"bitwise=True", flush=True)
        del flush, fused
    form = _loop_form_checks(lazy, codegen)
    launches += form["launches"]
    t = form["timing"]
    print(f"LOOP random IterativeProgram{LOOP_RANDOM}: loop-fused vs "
          f"per-flush bitwise; captures={form['stats']['loop_captures']} "
          f"replays={form['stats']['loop_replays']}; B1 loop form vs plain "
          f"bitwise on {form['blocks']} blocks ({form['drawing']} draw); "
          f"largest drawing block {t['domain']} ({t['draws']} draws): "
          f"loop form kernel_ms={t['loop_ms']:.4f}, key words as launch "
          f"arguments {t['arg_ms']:.4f}, plain_ms={t['plain_ms']:.4f}, "
          f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})", flush=True)
    print(f"LOOP phase: {time.perf_counter() - t_start:.1f}s", flush=True)
    return {"launches": launches, "max_abs_err": 0.0}


def run_calibrate(codegen, launch_s: float) -> dict:
    """The CALIBRATE phase: ``tuning.calibrate`` on the card at its default
    sizes (module docstring), the profile saved under ``build/`` and
    installed again from the file in this process; ``launch_s`` is this
    run's ``LAUNCH_COST`` reading.  Returns the installed fit and B1's
    launches."""
    from repro_torch.core import cost, tuning
    from repro_torch.core.tuning.calibrate import CARD_SIZES
    t_start = time.perf_counter()
    CALIBRATION_PROFILE.parent.mkdir(parents=True, exist_ok=True)
    tuning.clear_fit()
    codegen.LAUNCHES["fused_block"] = 0
    fit = tuning.calibrate(seeds=range(4), repeats=3,
                           device=torch.device("cuda"),
                           save=str(CALIBRATION_PROFILE))
    launches = codegen.LAUNCHES["fused_block"]
    if launches == 0:
        raise AssertionError("CALIBRATE: no fused-block kernel launched")
    if set(fit.launch_s) != {"torch", "triton"}:
        raise AssertionError(f"CALIBRATE: fitted backends {fit.launch_s}")
    loaded = tuning.load_and_install(str(CALIBRATION_PROFILE))
    for key in ("launch_s", "hbm_slope_s", "hbm_s_per_byte",
                "fabric_s_per_byte", "n_samples", "n_keys", "residual_s"):
        if getattr(loaded, key) != getattr(fit, key):
            raise AssertionError(f"CALIBRATE: the saved profile refits "
                                 f"{key} to {getattr(loaded, key)}, not "
                                 f"{getattr(fit, key)}")
    slope = {b: (f"{fit.hbm_slope_s[b] * cost.HBM_BW:.3f}"
                 if b in fit.hbm_slope_s else "unidentified")
             for b in ("torch", "triton")}
    # beside the fit, what its samples say directly: per backend the median
    # best wall of the keys that move at most 1 MiB (launch-bound) and the
    # median wall per byte of those that move at least 32 MiB
    keys = tuning.Profile.load(str(CALIBRATION_PROFILE)).grouped()
    direct = {}
    for b in ("torch", "triton"):
        small = [k.wall_s for (kb, _), k in keys.items()
                 if kb == b and k.hbm_bytes <= 2 ** 20]
        large = [k.wall_s / k.hbm_bytes * cost.HBM_BW
                 for (kb, _), k in keys.items()
                 if kb == b and k.hbm_bytes >= 2 ** 25]
        direct[b] = (f"{statistics.median(small) * 1e6:.2f} us over "
                     f"{len(small)} keys <= 1 MiB, "
                     + (f"{statistics.median(large):.3f} x over "
                        f"{len(large)} keys >= 32 MiB" if large
                        else "no key >= 32 MiB"))
    print(f"CALIBRATE tuning.calibrate(seeds=range(4), repeats=3, "
          f"sizes={CARD_SIZES}) on the card: n_samples={fit.n_samples} "
          f"n_keys={fit.n_keys}; launch_us torch="
          f"{fit.launch_s['torch'] * 1e6:.2f} triton="
          f"{fit.launch_s['triton'] * 1e6:.2f}; byte slope x (1/3.35e12 "
          f"s/B) torch={slope['torch']} triton={slope['triton']}; "
          f"hbm_s_per_byte x 3.35e12 = {fit.hbm_s_per_byte * cost.HBM_BW:.3f}"
          f"; residual_us={fit.residual_s * 1e6:.2f}; the samples "
          f"directly: torch {direct['torch']}; triton {direct['triton']}"
          f"; gpu model launch_us="
          f"{cost.KERNEL_LAUNCH_S * 1e6:.2f} (constant), LAUNCH_COST this "
          f"run {launch_s * 1e6:.2f} us; B1 launches {launches}; "
          f"load_and_install({CALIBRATION_PROFILE.relative_to(ROOT)}): the "
          f"same fit, epoch {loaded.epoch} "
          f"({time.perf_counter() - t_start:.1f}s)", flush=True)
    return {"fit": loaded, "launches": launches}


def _program_runs(lazy, fn, args, **runtime_kw) -> dict:
    """Two runs of ``fn(*args)`` (cold, then warm) in one triton runtime
    with loop fusion off (per-flush decisions), each timed from a
    synchronize to a synchronize.  Returns each run's result, wall and
    stats delta, every executed work block ``(ops, plan)`` of both runs,
    the history and the lowering context and stack."""
    from repro_torch.core.executor import stats_delta
    blocks, runs = [], []
    with lazy.fresh_runtime(backend="triton", loop_fusion=False,
                            **runtime_kw) as rt:
        ex = rt.executor
        orig = ex.run_schedule

        def spy(schedule, buffers):
            for plan in schedule.blocks:
                if plan.has_work:
                    blocks.append(([schedule.tape[i]
                                    for i in plan.op_indices], plan))
            return orig(schedule, buffers)

        ex.run_schedule = spy
        for _ in range(2):
            before = ex.snapshot_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = np.asarray(fn(*args))
            torch.cuda.synchronize()
            runs.append({"result": res, "wall_s": time.perf_counter() - t0,
                         "stats": stats_delta(before, ex.stats)})
        out = {"runs": runs, "blocks": blocks, "history": list(rt.history),
               "ctx": ex.lowering_context(), "stack": ex.backends}
    return out


def _agree(name, got, want, what) -> float:
    """``got``'s runs against ``want``'s: bitwise on the exact programs,
    else ``TOL``; every value finite."""
    err = 0.0
    for k in range(2):
        a, b = got["runs"][k]["result"], want["runs"][k]["result"]
        err = max(err, check_close(a, b, f"{what} {name} run {k}",
                                   name in EXACT))
        if not np.all(np.isfinite(a)):
            raise AssertionError(f"{what} {name}: non-finite result")
    return err


def _split(run) -> str:
    bb = run["stats"]["backend_blocks"]
    return f"{bb.get('triton', 0)}/{bb.get('torch', 0)}"


def run_calibrated_and_ilp(lazy, codegen, programs) -> dict:
    """The CALIBRATED and ILP phases (module docstring): every program at
    ``CHIP_SIZES`` under ``gpu`` (greedy), ``calibrated`` (the installed
    fit) and ``gpu`` with the ILP partitioner.  Returns B1's launches in
    each phase."""
    from repro_torch.core.backends import select_lowering
    from repro_torch.core.cost import make_cost_model
    from repro_torch.testing.programs import CHIP_SIZES
    launches = {"CALIBRATED": 0, "ILP": 0}
    t_phase = {"CALIBRATED": 0.0, "ILP": 0.0}
    gpu_m, cal_m = make_cost_model("gpu"), make_cost_model("calibrated")
    if cal_m.fit is None:
        raise AssertionError("CALIBRATED: no fit installed")
    for name, fn in programs.items():
        args = CHIP_SIZES[name]
        t0 = time.perf_counter()
        codegen.LAUNCHES["fused_block"] = 0
        g = _program_runs(lazy, fn, args, cost_model="gpu")
        c = _program_runs(lazy, fn, args, cost_model="calibrated")
        launches["CALIBRATED"] += codegen.LAUNCHES["fused_block"]
        err = _agree(name, c, g, "CALIBRATED calibrated vs gpu")
        differ = sum(
            1 for ops, plan in g["blocks"]
            if select_lowering(ops, plan, g["stack"], g["ctx"],
                               gpu_m).backend
            != select_lowering(ops, plan, g["stack"], g["ctx"],
                               cal_m).backend)
        gw, cw = g["runs"][1], c["runs"][1]
        t_phase["CALIBRATED"] += time.perf_counter() - t0
        print(f"CALIBRATED {name} args={args}: blocks a run gpu="
              f"{gw['stats']['blocks_run']} calibrated="
              f"{cw['stats']['blocks_run']}; lowering decisions differing "
              f"{differ}/{len(g['blocks'])} (the gpu runs' executed "
              f"blocks, recomputed under both models); triton/torch blocks "
              f"gpu={_split(gw)} calibrated={_split(cw)}; warm_ms gpu="
              f"{gw['wall_s'] * 1e3:.3f} calibrated={cw['wall_s'] * 1e3:.3f}"
              f"; cold_ms gpu={g['runs'][0]['wall_s'] * 1e3:.1f} calibrated="
              f"{c['runs'][0]['wall_s'] * 1e3:.1f}; "
              f"{'bitwise' if name in EXACT else 'max_abs_err'}={err:.3g} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        del c
        t0 = time.perf_counter()
        codegen.LAUNCHES["fused_block"] = 0
        i = _program_runs(lazy, fn, args, cost_model="gpu",
                          partition_backend="ilp",
                          time_budget_s=ILP_BUDGET_S)
        launches["ILP"] += codegen.LAUNCHES["fused_block"]
        err = _agree(name, i, g, "ILP ilp vs greedy")
        solves = [h for h in i["history"] if "ilp_status" in h]
        if not solves:
            raise AssertionError(f"ILP {name}: no flush was solved")
        for h in solves:
            if not h["ilp_objective"] <= h["greedy_cost"]:
                raise AssertionError(f"ILP {name}: objective "
                                     f"{h['ilp_objective']} > greedy "
                                     f"{h['greedy_cost']}")
        iw = i["runs"][1]
        status = {}
        for h in solves:
            status[h["ilp_status"]] = status.get(h["ilp_status"], 0) + 1
        t_phase["ILP"] += time.perf_counter() - t0
        objective = sum(h["ilp_objective"] for h in solves)
        greedy = sum(h["greedy_cost"] for h in solves)
        print(f"ILP {name} args={args}: {len(solves)} solves, status "
              f"{status}; objective sum={objective:.9g}"
              f" greedy_cost sum={greedy:.9g}"
              f" (s, the gpu model); max gap="
              f"{max(h['ilp_gap'] for h in solves):.3g}; nodes="
              f"{sum(h['ilp_nodes'] for h in solves)} edges max="
              f"{max(h['ilp_edges'] for h in solves)}; solver wall_s="
              f"{sum(h['ilp_wall_s'] for h in solves):.3f} (max "
              f"{max(h['ilp_wall_s'] for h in solves):.3f}); blocks a run "
              f"ilp={iw['stats']['blocks_run']} greedy="
              f"{g['runs'][1]['stats']['blocks_run']}; warm_ms ilp="
              f"{iw['wall_s'] * 1e3:.3f} greedy="
              f"{g['runs'][1]['wall_s'] * 1e3:.3f}; cold_ms ilp="
              f"{i['runs'][0]['wall_s'] * 1e3:.1f}; "
              f"{'bitwise' if name in EXACT else 'max_abs_err'}={err:.3g} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        del g, i
        torch.cuda.empty_cache()
    for phase in ("CALIBRATED", "ILP"):
        if launches[phase] == 0:
            raise AssertionError(f"{phase}: no fused-block kernel launched")
        print(f"{phase} phase: B1 launches {launches[phase]}, "
              f"{t_phase[phase]:.1f}s", flush=True)
    return launches


def run_explain(codegen) -> dict:
    """The EXPLAIN phase: ``tools/explain_torch.py --json`` on the card.
    Requires a rejected merge with a priced saving, the merge cache
    resident, and every work block's replayed winner to be the backend the
    executor ran (``history[-1]["exec"]["backend_blocks"]``)."""
    from tools import explain_torch
    t0 = time.perf_counter()
    codegen.LAUNCHES["fused_block"] = 0
    args = explain_torch.parse(["--json"])
    report, executed = explain_torch.run(args)
    launches = codegen.LAUNCHES["fused_block"]
    doc = json.loads(report.to_json())
    if doc["schema"] != "repro_explain_v1":
        raise AssertionError(f"EXPLAIN: schema {doc['schema']}")
    rejected = [m for m in doc["merges"]
                if m["action"] == "rejected" and m["saving"] > 0]
    if not rejected:
        raise AssertionError("EXPLAIN: no rejected merge with a saving")
    winners = {}
    for b in doc["blocks"]:
        if b["backend"] is None:
            continue
        won = [v["backend"] for v in b["verdicts"] if v["winner"]]
        if won != [b["backend"]]:
            raise AssertionError(f"EXPLAIN: block {b['index']} winners "
                                 f"{won}")
        winners[b["backend"]] = winners.get(b["backend"], 0) + 1
    ran = {k: v for k, v in executed.items() if v}
    if winners != ran or not winners.get("triton"):
        raise AssertionError(f"EXPLAIN: winners {winners}, executed {ran}")
    if not doc["cache"]["resident"] or launches == 0:
        raise AssertionError(f"EXPLAIN: cache {doc['cache']}, B1 launches "
                             f"{launches}")
    declines = sorted({v["reason"] for b in doc["blocks"]
                       for v in b["verdicts"] if v["reason"]})
    print(f"EXPLAIN tools/explain_torch.py --json on the card: "
          f"{doc['n_ops']} ops -> {doc['n_blocks']} blocks; merges taken "
          f"{sum(1 for m in doc['merges'] if m['action'] == 'merged')}, "
          f"rejected {len(rejected)} (savings "
          f"{sorted({m['saving'] for m in rejected})}, "
          f"{sorted({m['reason'] for m in rejected})}); winners {winners} = "
          f"executed {ran}; declines {declines}; cache resident; B1 "
          f"launches {launches} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return {"launches": launches}


def run_a7(launch_s=None) -> int:
    """The calibration, calibrated-model, ILP and explain phases (module
    docstring), in that order; returns B1's launches over them.  Runs
    alone: ``PYTHONPATH=src python3 -c "import chip_smoke as c;
    c.run_a7()"`` (``launch_s`` is then measured here)."""
    from repro_torch.core import lazy
    from repro_torch.kernels.fused_block import codegen
    from repro_torch.testing.programs import BENCHMARKS, quickstart
    t0 = time.perf_counter()
    if launch_s is None:
        launch_s = launch_cost_s(lazy, codegen)
    calib = run_calibrate(codegen, launch_s)
    torch.cuda.empty_cache()
    priced = run_calibrated_and_ilp(lazy, codegen,
                                    dict(BENCHMARKS, quickstart=quickstart))
    explained = run_explain(codegen)
    launches = calib["launches"] + sum(priced.values()) + \
        explained["launches"]
    print(f"A7 phases (CALIBRATE, CALIBRATED, ILP, EXPLAIN): B1 launches "
          f"{launches}, {time.perf_counter() - t0:.1f}s", flush=True)
    return launches


def _pair_allowance(kernel, bufs_and_salts) -> float:
    """How far B1's contracting form may move a block's outputs from its
    bitwise form, on the block's own inputs: over its pairs (``plan.fma``)
    ``u · max(|a·b| + 2·|a·b + c|)`` — the product's rounding, which the
    fused form skips, and the add's rounding in each form — with ``u`` the
    pair dtype's unit (``FMA_UNIT``).  Absolute: under cancellation a
    contraction may change every relative digit of ``a·b + c``."""
    total = 0.0
    plan = kernel.plan

    def seen(k, a, b, c):
        nonlocal total
        u = FMA_UNIT[np.dtype(plan.nodes[plan.fma[k][1]].out_dtype).name]
        a, b, c = (torch.as_tensor(z, dtype=torch.float64,
                                   device=kernel.device) for z in (a, b, c))
        prod = a * b
        total += u * float((prod.abs() + 2 * (prod + c).abs()).max())

    kernel.plain(*bufs_and_salts, pairs=seen)
    return total


def _fma_run(lazy, fn, args):
    """One run of ``fn(*args)`` under ``gpu_fma`` with the triton backend
    (loop fusion off): its result, each flush's tape and every claimed
    block ``(signature, ops)``."""
    tapes, blocks = [], []
    with lazy.fresh_runtime(backend="triton", cost_model="gpu_fma",
                            loop_fusion=False) as rt:
        if not rt.lowering_policy().ctx.contract_fma:
            raise AssertionError("FMA: gpu_fma's context does not contract")
        plan, run = rt.scheduler.plan, rt.executor.run_schedule

        def spy_plan(tape, **kw):
            tapes.append(list(tape))
            return plan(tape, **kw)

        def spy_run(schedule, buffers):
            for p in schedule.blocks:
                if p.has_work and p.lowering is not None \
                        and p.lowering.backend == "triton":
                    blocks.append((p.signature, [schedule.tape[i]
                                                 for i in p.op_indices]))
            return run(schedule, buffers)

        rt.scheduler.plan, rt.executor.run_schedule = spy_plan, spy_run
        res = np.asarray(fn(*args))
        torch.cuda.synchronize()
    return res, tapes, blocks


def _has_pair(tape) -> bool:
    """Whether any ``add`` of ``tape`` reads a view a ``mul`` wrote: the
    only tapes ``gpu_fma`` can plan otherwise than ``gpu``."""
    from repro_torch.core.blocks import view_key
    muls = {view_key(op.out) for op in tape if op.opcode == "mul"}
    return any(view_key(v) in muls for op in tape if op.opcode == "add"
               for v in op.in_views())


def run_fma(lazy, codegen, programs, floors=None) -> dict:
    """The FMA phase (module docstring): B1's contracting form under the
    ``gpu_fma`` cost model.  ``floors`` maps a program to its result on
    the torch floor (the PROGRAM phase's first run: a fresh runtime's
    draws, as the phase's own run makes them; run here when None).  Returns
    B1's launches on the phase's main path and the per-pair saving.  Runs
    alone (~90 s on an H100): ``PYTHONPATH=src python3 -c "import
    chip_smoke as c; from repro_torch.core import lazy; from
    repro_torch.kernels.fused_block import codegen; from
    repro_torch.testing.programs import BENCHMARKS, quickstart;
    c.run_fma(lazy, codegen, dict(BENCHMARKS, quickstart=quickstart))"``."""
    from repro_torch.core import cost
    from repro_torch.core.algorithms import partition
    from repro_torch.core.blocks import BlockInfo
    from repro_torch.core.cache import tape_signature
    from repro_torch.testing.programs import CHIP_SIZES
    t_phase = time.perf_counter()
    model = cost.make_cost_model("gpu_fma")
    launches, timed, amplified, tapes_of = 0, [], [], {}
    for name, fn in programs.items():
        args = CHIP_SIZES[name]
        t0 = time.perf_counter()
        with BlockRecorder(codegen.FusedBlockKernel) as rec:
            codegen.LAUNCHES["fused_block"] = 0
            res, tapes, blocks = _fma_run(lazy, fn, args)
            n_launch = codegen.LAUNCHES["fused_block"]
        launches += n_launch
        tapes_of[name] = tapes
        if floors is not None and name in floors:
            floor = floors[name]
        else:
            with lazy.fresh_runtime(backend="torch", loop_fusion=False):
                floor = np.asarray(fn(*args))
        if not np.all(np.isfinite(res)):
            raise AssertionError(f"FMA {name}: non-finite result")
        kernels = [k for k, _, _ in rec.calls.values()]
        if not all(k.contract_fma for k in kernels):
            raise AssertionError(f"FMA {name}: a B1 kernel of the bitwise "
                                 f"form ran under gpu_fma")
        # (b) the contracted pairs: kernels, sources, analysis and model
        distinct = dict(blocks)
        model_pairs = sum(model._fma_pairs(BlockInfo.from_ops(ops))
                          for ops in distinct.values())
        plan_pairs = sum(len(codegen._analyze(ops).fma)
                         for ops in distinct.values())
        kernel_pairs = sum(len(k.plan.fma) for k in kernels)
        source_pairs = sum(codegen.triton_source(k.plan, False, True)[0]
                           .count("tl.fma(") for k in kernels)
        if not model_pairs == plan_pairs == kernel_pairs == source_pairs:
            raise AssertionError(
                f"FMA {name}: pairs model {model_pairs}, analysis "
                f"{plan_pairs}, kernels {kernel_pairs}, sources "
                f"{source_pairs}")
        # (a) each contracting kernel against its plain version, and the
        # result against the floor, within the pairs' allowance
        allowance, block_err = 0.0, 0.0
        for key, (k, bufs_and_salts, _) in rec.calls.items():
            if not k.plan.fma:
                continue
            a_k = _pair_allowance(k, bufs_and_salts)
            allowance += rec.counts[key] * a_k
            got = k(*bufs_and_salts)
            want = k.plain(*bufs_and_salts)
            err = max(max_err(g.cpu().numpy(), w.cpu().numpy())
                      for g, w in zip(got, want))
            block_err = max(block_err, err)
            what = f"FMA {name} block {k.plan.domain}: kernel vs plain"
            if name not in EXACT:
                # reductions and libdevice differ from the plain version
                # in the bitwise form too (the PROGRAM phase's TOL)
                for g, w in zip(got, want):
                    np.testing.assert_allclose(
                        g.cpu().numpy(), w.cpu().numpy(), rtol=TOL["rtol"],
                        atol=TOL["atol"] + a_k, err_msg=what)
            elif err > a_k:
                for g, w in zip(got, want):
                    check_close(g.cpu().numpy(), w.cpu().numpy(),
                                f"{what} past its pair allowance {a_k:.3g}",
                                False)
                amplified.append(f"{name} block {k.plan.domain}")
            timed.append((name, k, bufs_and_salts))
        err = max_err(res, floor)
        if name not in EXACT:
            # the reductions sum in another order than the floor's
            np.testing.assert_allclose(
                res, floor, rtol=TOL["rtol"], atol=TOL["atol"] + allowance,
                err_msg=f"FMA {name}: gpu_fma vs the floor")
            held = "TOL plus the pairs' allowance"
        elif err <= allowance:
            held = "the pairs' allowance"
        else:
            check_close(res, floor, f"FMA {name}: gpu_fma vs the floor past "
                        f"the pairs' allowance {allowance:.3g}", False)
            held = "its own tolerance TOL (amplified)"
            amplified.append(name)
        print(f"FMA {name} args={args}: blocks={len(blocks)} distinct="
              f"{len(distinct)} contracting kernels with pairs="
              f"{sum(1 for k in kernels if k.plan.fma)} pairs (model "
              f"_fma_pairs = analysis = kernels = tl.fma in sources)="
              f"{model_pairs} launches={n_launch}; vs the floor max_abs_err="
              f"{err:.3g} allowance={allowance:.3g} held by {held}; kernels "
              f"vs plain max_abs_err={block_err:.3g} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        del res, floor
        torch.cuda.empty_cache()
    if launches == 0:
        raise AssertionError("FMA: no fused-block kernel launched")
    # (c) both forms of every distinct block with a pair, in one call
    savings = []
    for name, k, bufs_and_salts in timed:
        *bufs, salts = bufs_and_salts
        store = dict(zip(k.plan.inputs, bufs))
        twin = codegen.FusedBlockKernel(k.plan, k.seed, k.device)
        ms = [kernel_ms(kk, store, salts, k.device)
              for kk in (twin, k, k, twin)]
        plain_ms, fma_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        per_pair_s = (plain_ms - fma_ms) / len(k.plan.fma) * 1e-3
        savings.append(per_pair_s)
        bound = block_bound(k, codegen)
        print(f"FMA timing {name} block {k.plan.domain} pairs="
              f"{len(k.plan.fma)}: bitwise kernel_ms={plain_ms:.4f} "
              f"contracting kernel_ms={fma_ms:.4f} (runs "
              f"{', '.join(f'{x:.4f}' for x in ms)}) bound_ms="
              f"{bound['bound_ms']:.4f} ({bound['bound_by']}); saving a "
              f"pair {per_pair_s * 1e6:.4f} us", flush=True)
    if not savings:
        raise AssertionError("FMA: no block with a pair was timed")
    median = statistics.median(savings)
    bonus = max(0.0, median)
    # (d) the programs whose partitions the measured bonus changes
    gpu = cost.make_cost_model("gpu")
    fma = cost.make_cost_model("gpu_fma", fma_bonus_s=bonus)
    differ, t0 = [], time.perf_counter()
    for name, tapes in tapes_of.items():
        seen = set()
        for tape in tapes:
            sig = tape_signature(tape, "greedy", "gpu")
            if sig in seen or not _has_pair(tape):
                continue
            seen.add(sig)
            if partition(tape, cost_model=gpu).op_blocks() != \
                    partition(tape, cost_model=fma).op_blocks():
                differ.append(name)
                break
    print(f"FMA saving a contracted pair over {len(savings)} blocks: median "
          f"{median * 1e6:.4f} us, range [{min(savings) * 1e6:.4f}, "
          f"{max(savings) * 1e6:.4f}] us -> FMA_BONUS_S = {bonus:.6g} s "
          f"(clamped at 0; core/cost.py holds {cost.FMA_BONUS_S:.6g}); "
          f"partitions differing between gpu_fma at that bonus and gpu: "
          f"{len(differ)}/{len(programs)} programs {differ} "
          f"({time.perf_counter() - t0:.1f}s); amplified past the pairs' "
          f"allowance, held by TOL: {amplified}", flush=True)
    print(f"FMA phase: B1 launches {launches}, "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    return {"launches": launches, "bonus_s": bonus}


def _shared_request(lazy, data):
    """The load's coalescable structure: one tape for every tenant."""
    def fn():
        a = lazy.asarray(data)
        b = lazy.floor((a * 2.0 + 3.0) % 1021.0)
        return lazy.maximum(b, a) + b.sum().broadcast_to(a.shape)
    return fn


def _tenant_request(lazy, data, tenant):
    """A structure of the tenant's own (its literal is in the tape)."""
    scale = float(tenant + 2)

    def fn():
        a = lazy.asarray(data)
        return lazy.floor((a * scale) % 1021.0) + a
    return fn


def _serve_load(lazy, size):
    """Each tenant's request functions, its data drawn from one seeded
    generator in (tenant, request) order."""
    rng = np.random.default_rng(8)
    load = []
    for t in range(SERVE_TENANTS):
        fns = []
        for r in range(SERVE_REQUESTS):
            data = np.floor(rng.random(size) * 16.0)
            fns.append(_shared_request(lazy, data) if r % 2
                       else _tenant_request(lazy, data, t))
        load.append(fns)
    return load


def _drive(srv, load, concurrent: bool, barrier: bool = False):
    """Every tenant's requests back to back (one thread a tenant when
    ``concurrent``; a barrier before each round with ``barrier``); returns
    ``({tenant: [results]}, [submit latency s], wall s)`` with the wall
    from the first submit to the last result.  A worker's failure, or a
    thread still running after 600 s, raises."""
    import threading
    n = len(load)
    results = {t: [] for t in range(n)}
    lats, errors = [], []
    lock = threading.Lock()
    gate = threading.Barrier(n) if barrier else None

    def tenant(t):
        try:
            for fn in load[t]:
                if gate is not None:
                    gate.wait(600)
                t0 = time.perf_counter()
                out = srv.submit(t, fn)
                dt = time.perf_counter() - t0
                results[t].append(out)
                with lock:
                    lats.append(dt)
        except BaseException as e:     # noqa: BLE001 — raised below
            errors.append((t, e))
            if gate is not None:
                gate.abort()

    t0 = time.perf_counter()
    if concurrent:
        threads = [threading.Thread(target=tenant, args=(t,), daemon=True)
                   for t in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        if any(th.is_alive() for th in threads):
            raise AssertionError("SERVE: a tenant thread hung")
    else:
        for t in range(n):
            tenant(t)
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"SERVE: tenant {errors[0][0]} failed: "
                             f"{errors[0][1]!r}") from errors[0][1]
    return results, lats, wall


def _same(refs, got, what):
    for t in refs:
        for r, (a, b) in enumerate(zip(refs[t], got[t])):
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                    a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)):
                raise AssertionError(f"SERVE {what}: tenant {t} request {r} "
                                     f"differs from the serial run")


def _copy_ms(data) -> tuple:
    """A request's host-to-device copy (as ``Runtime.adopt`` makes it) and
    its result's device-to-host copy (as the server reads it), each to a
    synchronize, median of 5, in ms."""
    h2d, d2h = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = torch.from_numpy(data.reshape(-1).copy()).to("cuda")
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dev.to("cpu", copy=True).numpy()
        d2h.append(time.perf_counter() - t0)
    return statistics.median(h2d) * 1e3, statistics.median(d2h) * 1e3


def _warm_start(lazy, backend, load) -> dict:
    """A cold batching-off server over a fresh store directory drives the
    load's first two requests of each tenant (every structure of the load)
    serially; a fresh server over the same directory drives them again
    under the tracer.  Returns the cold writes, the warm hits, and the
    warm run's partition spans (0 when every plan came from the store)."""
    import tempfile
    from repro_torch.core.obs import trace
    from repro_torch.core.serve import Server
    load = [fns[:2] for fns in load]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        cold = Server(store=d, batching=False, backend=backend)
        _drive(cold, load, concurrent=False)
        warm = Server(store=d, batching=False, backend=backend)
        tr = trace.enable()
        try:
            _drive(warm, load, concurrent=False)
        finally:
            trace.disable()
        return {"writes": cold.metrics.counter(
                    "cache.plan_store.write").get(),
                "hits": warm.metrics.counter("cache.plan_store.hit").get(),
                "partitions": sum(1 for e in tr.events
                                  if e["name"] == "stage.partition")}


def run_serve(lazy, codegen) -> int:
    """The SERVE phase: the multi-tenant server (``repro_torch.core.serve``)
    on the card under the load above, at each size of ``SERVE_SIZES`` and
    under ``backend="torch"`` (the floor, so structurally equal requests
    batch) and ``backend="triton"`` (B1 on every request: a plan with a
    block off the floor runs solo).  Each pass: a serial batching-off
    server for the reference values, a concurrent warm-up pass, a timed
    concurrent pass (``SERVE_WINDOW_S``, ``SERVE_MAX_BATCH``) and a
    profiled repeat of it for the device's idle share, each result bitwise
    to the serial one; a plan-store warm start; at 2**24 a ``check_serve``
    pass with ``random`` (a 0.25 s window and a barrier a round).  Returns
    B1's launches over the phase (counted from 0 at its start)."""
    from repro_torch.core.serve import Server
    from repro_torch.testing import tapegen
    t_start = time.perf_counter()
    codegen.LAUNCHES["fused_block"] = 0
    tapegen.check_serve(0, device="cuda")     # both phases, small, floor
    n = SERVE_TENANTS * SERVE_REQUESTS
    for size in SERVE_SIZES:
        load = _serve_load(lazy, size)
        h2d_ms, d2h_ms = _copy_ms(np.floor(
            np.random.default_rng(8).random(size) * 16.0))
        for backend in ("torch", "triton"):
            t0 = time.perf_counter()
            ref_srv = Server(batching=False, backend=backend)
            refs, _, _ = _drive(ref_srv, load, concurrent=False)
            srv = Server(window_s=SERVE_WINDOW_S, max_batch=SERVE_MAX_BATCH,
                         backend=backend)
            m = srv.metrics
            warm, _, _ = _drive(srv, load, concurrent=True)
            _same(refs, warm, f"{backend} {size} warm-up pass")
            del warm
            b0 = m.counter("serve.batched_requests").get()
            n0 = m.counter("serve.batches").get()
            l0 = codegen.LAUNCHES["fused_block"]
            out, lats, wall = _drive(srv, load, concurrent=True)
            launches = codegen.LAUNCHES["fused_block"] - l0
            share = (m.counter("serve.batched_requests").get() - b0) / n
            timed_batches = m.counter("serve.batches").get() - n0
            _same(refs, out, f"{backend} {size} timed pass")
            del out
            from torch.profiler import ProfilerActivity, profile as tp
            with tp(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
                prof_out, _, prof_wall = _drive(srv, load, concurrent=True)
                torch.cuda.synchronize()
            events = _device_kernels(prof)
            busy = _busy_ms(events)
            copy_ms = _busy_ms([e for e in events
                                if "memcpy" in e.name.lower()])
            kernel_ms = _busy_ms([e for e in events
                                  if "memcpy" not in e.name.lower()])
            top = _top_device_ops(events)
            _same(refs, prof_out, f"{backend} {size} profiled pass")
            del prof_out, refs
            ws = _warm_start(lazy, backend, load)
            if ws["writes"] < 1 or ws["hits"] < 1 or ws["partitions"]:
                raise AssertionError(f"SERVE {backend} {size}: warm start "
                                     f"{ws}")
            rand = (_serve_random(lazy, backend, size)
                    if size == max(SERVE_SIZES) else None)
            total = m.counter("serve.batches").get() + (
                rand["batches"] if rand else 0)
            if backend == "triton" and (total or launches == 0):
                raise AssertionError(f"SERVE triton {size}: batches {total}, "
                                     f"B1 launches {launches}")
            if backend == "torch" and not total:
                raise AssertionError(f"SERVE torch {size}: no batch")
            lat_ms = np.asarray(lats) * 1e3
            p50, p99 = (float(np.percentile(lat_ms, q)) for q in (50, 99))
            print(f"SERVE backend={backend} size={size} tenants="
                  f"{SERVE_TENANTS} requests={n} window_s={SERVE_WINDOW_S} "
                  f"max_batch={SERVE_MAX_BATCH}: qps={n / wall:.2f} "
                  f"p50_ms={p50:.3f} p99_ms={p99:.3f} p99/p50="
                  f"{p99 / p50:.2f} batched_share={share:.3f} "
                  f"batches={timed_batches} (phase total {total}) "
                  f"B1_launches={launches} h2d_ms_per_request={h2d_ms:.3f} "
                  f"d2h_ms_per_request={d2h_ms:.3f} profiled pass: wall "
                  f"{prof_wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
                  f"(copies {copy_ms:.3f}, kernels {kernel_ms:.3f}), idle "
                  f"{1 - busy / (prof_wall * 1e3):.3f}, top device ops "
                  f"[{top}]; warm start "
                  f"writes={ws['writes']} hits={ws['hits']} "
                  f"partitions={ws['partitions']}; bitwise=True"
                  + (f"; random pass ({SERVE_TENANTS} x 2 requests) "
                     f"bitwise, batches={rand['batches']} batched="
                     f"{rand['batched']}" if rand else "")
                  + f" ({time.perf_counter() - t0:.1f}s)", flush=True)
            torch.cuda.empty_cache()
        del load
    launches = codegen.LAUNCHES["fused_block"]
    print(f"SERVE phase: B1 launches {launches}, "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    return launches


def _top_device_ops(events, n=3) -> str:
    """The ``n`` device operations of a profile with the most time, summed
    by name: ``name xcount ms`` each."""
    by = {}
    for e in events:
        ms, k = by.get(e.name, (0.0, 0))
        by[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                      k + 1)
    rows = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
    return "; ".join(f"{name[:60]} x{k} {ms:.3f} ms"
                     for name, (ms, k) in rows)


def _serve_random(lazy, backend, size) -> dict:
    """``check_serve``'s second phase at ``size`` under ``backend``: its
    seeded requests (``random`` among them) through a batching server,
    concurrently with a barrier a round, bitwise to a batching-off server
    driven serially.  Returns the server's batches and batched requests."""
    from repro_torch.core.serve import Server
    from repro_torch.testing import tapegen
    _, datas, rseeds = tapegen.serve_recipe(0, tenants=SERVE_TENANTS,
                                            requests=2, size=size)
    load = [[tapegen.serve_request(lazy, rs, datas[t], 8) for rs in rseeds]
            for t in range(SERVE_TENANTS)]
    refs, _, _ = _drive(Server(batching=False, backend=backend), load,
                        concurrent=False)
    srv = Server(window_s=0.25, max_batch=SERVE_TENANTS, backend=backend)
    got, _, _ = _drive(srv, load, concurrent=True, barrier=True)
    _same(refs, got, f"{backend} {size} random pass")
    return {"batches": srv.metrics.counter("serve.batches").get(),
            "batched": srv.metrics.counter("serve.batched_requests").get()}


def _train_config(layers=None):
    """``configs/qwen3_4b.py`` as published, or cut to ``layers``."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    return cfg if layers is None else cfg.scaled(n_layers=layers)


def _train_state(cfg, seed: int):
    """Random float32 weights on the card from a generator seeded
    ``seed``, the zero-initialised gains drawn (``_draw_gains``), and zero
    moments of the config's dtype (int8)."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, gen, "cuda")
    _draw_gains(params, gen, cfg.norm_plus_one)
    return params, adamw_init(params, state_dtype=cfg.opt_state_dtype)


def _train_step(cfg, lr=TRAIN_LR, moments=None):
    from repro_torch.launch.steps import make_train_step
    step, _ = make_train_step(cfg, num_microbatches=TRAIN_MICRO,
                              peak_lr=lr, warmup=1, total_steps=TRAIN_TOTAL,
                              opt_state_dtype=moments)
    return step


def _train_sweep(cfg, data) -> dict:
    """The loss curves of ``TRAIN_STEPS`` steps at 2 layers from one
    initialisation, for each (peak lr, moments) of ``TRAIN_SWEEP``: how
    the int8 moments and the lr move the first steps."""
    from repro_torch.optim import adamw_init
    curves = {}
    for lr, moments in TRAIN_SWEEP:
        params, _ = _train_state(cfg, 44)
        opt = adamw_init(params, state_dtype=moments)
        step = _train_step(cfg, lr, moments)
        losses = []
        for s in range(TRAIN_STEPS):
            params, opt, m = step(params, opt, data.batch_at(s))
            losses.append(round(float(m["loss"]), 4))
        curves[lr, moments] = losses
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
    return curves


def _clone_tree(tree):
    """A detached copy of a tree of tensors (dicts, tuples, ``OptState``)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone_tree(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


@contextlib.contextmanager
def _plain_b3():
    """The checker's patch, for one run: ``flash_attention.ops.attention``'s
    forward takes the plain version (``reference_attention``) in place of
    kernel B3; its backward is that plain version's autograd either way."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import reference_attention
    real = ops.flash_attention
    ops.flash_attention = reference_attention
    try:
        yield
    finally:
        ops.flash_attention = real


#: the spans (``launch/steps.py``, ``flash_attention/ops.py``) whose
#: profiler ranges name a kernel's part of the step; kernels outside them
#: by name
TRAIN_RANGES = {"flash_attention.backward": "attention backward (plain)",
                "train_step.adamw": "optimizer",
                "train_step.accumulate": "bf16 accumulate"}
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "gemv", "matmul")


def _kernel_part(name: str) -> str:
    if "flash_fwd" in name:
        return "B3"
    if any(w in name.lower() for w in GEMM_NAMES):
        return "GEMM"
    return "other"


def _train_split(prof, kernels):
    """Device ms and kernels by part of the step: a kernel inside the
    device-side span of a ``TRAIN_RANGES`` range (one stream: the span's
    kernels are the ones its range launched) takes that range's part,
    any other kernel its name's (:func:`_kernel_part`).  Returns ``{part:
    (ms, kernels)}``."""
    import bisect
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end, TRAIN_RANGES[e.name])
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and e.name in TRAIN_RANGES)
    starts = [a for a, _, _ in spans]
    parts = {}
    for k in kernels:
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        if i >= 0 and k.time_range.end <= spans[i][1]:
            part = spans[i][2]
        else:
            part = _kernel_part(k.name)
        ms, n = parts.get(part, (0.0, 0))
        parts[part] = (ms + (k.time_range.end - k.time_range.start) / 1e3,
                       n + 1)
    return parts


def _train_profile(step, params, opt, batch) -> dict:
    """One train step under ``torch.profiler``: wall and device-busy ms,
    the idle share, the split by part and the top device operations."""
    from torch.profiler import ProfilerActivity, profile as tp
    from repro_torch.core.obs import trace
    torch.cuda.synchronize()
    # a tracer puts the step's spans into the profile as its ranges; one
    # a caller installed stays
    owned = trace.active() is None
    if owned:
        trace.enable()
    try:
        with tp(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                acc_events=True) as prof:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        if owned:
            trace.disable()
    events = _device_kernels(prof)
    busy = _busy_ms(events)
    parts = _train_split(prof, events)
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
            "parts": parts, "loss": float(m["loss"]),
            "top": _top_device_ops(events, 8), "params": params, "opt": opt}


def _moment_diff(a, b) -> dict:
    """Two optimizer states' moments: the share of int8 codes that differ
    and the largest code difference, and the largest relative difference
    of the scales and of the float32 moments."""
    from repro_torch.checkpoint.manager import _flatten
    codes = diff = n = 0
    rel = 0.0
    for (path, x), (_, y) in zip(_flatten((a.m, a.v)),
                                 _flatten((b.m, b.v))):
        if x.dtype == torch.int8:
            d = (x.int() - y.int()).abs()
            codes += int((d != 0).sum())
            n += d.numel()
            diff = max(diff, int(d.max()))
        else:
            big = float(y.abs().max()) or 1.0
            rel = max(rel, float((x - y).abs().max()) / big)
    return {"code_share": codes / max(n, 1), "code_max": diff, "rel": rel}


def _b3_vs_plain(cfg, data, moments) -> dict:
    """One train step with B3 against the same step with the plain
    version (:func:`_plain_b3`), both from the state after a common first
    step, with ``moments``: the loss's relative difference, the
    parameters' largest difference and the share off by more than
    ``TRAIN_PARAM_SHARE_AT`` lr, the moments' differences
    (:func:`_moment_diff`) and B3's launches in each."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.optim import adamw_init
    step = _train_step(cfg, TRAIN_LR, moments)
    params, _ = _train_state(cfg, 41)
    opt = adamw_init(params, state_dtype=moments)
    params, opt, _ = step(params, opt, data.batch_at(0))
    pa, oa = _clone_tree(params), _clone_tree(opt)
    batch = data.batch_at(1)
    fa_k.LAUNCHES["flash_attention"] = 0
    pa, oa, ma = step(pa, oa, batch)
    launches = [fa_k.LAUNCHES["flash_attention"]]
    with _plain_b3():
        pb, ob, mb = step(params, opt, batch)
    launches.append(fa_k.LAUNCHES["flash_attention"] - launches[0])
    lr = float(ma["lr"])
    pairs = list(zip(_flatten(pa), _flatten(pb)))
    dp = max(float((x - y).abs().max()) for (_, x), (_, y) in pairs)
    moved = sum(int(((x - y).abs() > TRAIN_PARAM_SHARE_AT * lr).sum())
                for (_, x), (_, y) in pairs) / sum(x.numel()
                                                   for (_, x), _ in pairs)
    out = {"lr": lr, "launches": launches, "dp": dp, "moved": moved,
           "loss": (round(float(ma["loss"]), 6), round(float(mb["loss"]), 6)),
           "loss_rel": abs(float(ma["loss"]) - float(mb["loss"]))
           / float(mb["loss"]), "moments": _moment_diff(oa, ob)}
    del params, opt, pa, oa, pb, ob, pairs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_restart(cfg, step, data) -> dict:
    """Checkpoint and restart through ``launch/train.py``'s path (see the
    module doc): ``TRAIN_RESTART[0]`` steps under ``FaultTolerantLoop``
    with a ``CheckpointManager`` in a temporary directory under
    ``build/`` (removed afterwards), a save every ``TRAIN_RESTART[1]``
    steps and a step function that raises once at step
    ``TRAIN_RESTART[2]``, against the same steps run straight through."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.runtime import FaultTolerantLoop
    n, every, fail = TRAIN_RESTART
    params, opt = _train_state(cfg, 43)
    start = (_clone_tree(params), _clone_tree(opt))
    clean = []
    for s in range(n):
        params, opt, m = step(params, opt, data.batch_at(s))
        clean.append(float(m["loss"]))
    del params, opt
    os.makedirs(ROOT / "build", exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        mgr = CheckpointManager(d, keep=2)
        saved, restored = {}, []
        real_save, real_restore = mgr.save, mgr.restore

        def save(s, tree, blocking=False):
            if s == every and s not in saved:
                saved[s] = _clone_tree(tree)
            return real_save(s, tree, blocking=blocking)

        def restore(s, like):
            out = real_restore(s, like)
            # a copy: the replayed steps update the state in place
            restored.append((out[0], _clone_tree(out[1])))
            return out

        mgr.save, mgr.restore = save, restore
        losses, fired = {}, []

        def step_fn(state, batch):
            s, batch = batch
            if s == fail and not fired:
                fired.append(s)
                raise RuntimeError("injected failure")
            p, o, m = step(*state, batch)
            losses[s] = float(m["loss"])
            return (p, o)

        loop = FaultTolerantLoop(mgr, save_every=every)
        loop.run(start, step_fn, lambda s: (s, data.batch_at(s)), n)
        loop_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(d) for f in fs)
    if loop.restarts != 1 or [s for s, _ in restored] != [every]:
        raise AssertionError(f"TRAIN restart: {loop.restarts} restarts, "
                             f"restored steps {[s for s, _ in restored]}, "
                             f"want 1 and [{every}]")
    bitwise = all(torch.equal(x, y) and x.dtype == y.dtype
                  for (_, x), (_, y) in zip(_flatten(restored[0][1]),
                                            _flatten(saved[every])))
    rel = max(abs(losses[s] - clean[s]) / clean[s] for s in range(n))
    return {"bitwise": bitwise, "loss_rel": rel, "losses": losses,
            "clean": clean, "loop_s": loop_s, "bytes": size,
            "leaves": len(list(_flatten(saved[every])))}


def _adamw_tape(lazy, codegen) -> dict:
    """``optim/fused.record_adamw_tape`` at ``TRAIN_TAPE_N`` under
    ``backend="triton"`` and the torch floor: one block claimed by B1 with
    no decline, bitwise to the floor; each distinct block held bitwise
    against its plain version and the update block timed
    (``hold_blocks``)."""
    from repro_torch.optim.fused import record_adamw_tape
    outs, hist = {}, {}
    kw = dict(lr=TRAIN_LR, c1=0.1, c2=0.05)
    with BlockRecorder(codegen.FusedBlockKernel) as rec:
        codegen.LAUNCHES["fused_block"] = 0
        for backend in ("triton", "torch"):
            with lazy.fresh_runtime(backend=backend,
                                    loop_fusion=False) as rt:
                outs[backend] = [r.numpy() for r in
                                 record_adamw_tape(rt, TRAIN_TAPE_N, **kw)]
                # the update's flush: the one with the most ops (the
                # draws' flush and the outputs' reads are the others)
                hist[backend] = max((h for h in rt.history
                                     if not h.get("cached")),
                                    key=lambda h: h["n_ops"])
                if backend == "triton":
                    stats = rt.executor.stats.snapshot()
                    launches = codegen.LAUNCHES["fused_block"]
    bitwise = all(np.array_equal(a, b) for a, b in zip(outs["triton"],
                                                       outs["torch"]))
    blk = hold_blocks("adamw tape", rec.calls, codegen, exact=True)
    return {"bitwise": bitwise, "n_blocks": hist["triton"]["n_blocks"],
            "n_ops": hist["triton"]["n_ops"], "stats": stats,
            "launches": launches, "blk": blk}


def _train_sweep_print(data) -> None:
    t0 = time.perf_counter()
    curves = _train_sweep(_train_config(TRAIN_HOLD_LAYERS), data)
    print(f"TRAIN loss curves at {TRAIN_HOLD_LAYERS} layers, one "
          f"initialisation, warm-up 1 step: " + "; ".join(
              f"lr {lr:g} {moments} moments {losses}"
              for (lr, moments), losses in curves.items())
          + f" ({time.perf_counter() - t0:.1f}s)", flush=True)


def run_train(lazy, codegen) -> dict:
    """The TRAIN phase (see the module doc).  Returns B3's launches and
    largest held error, its timed training call (a ``kernels`` row) and the
    AdamW tape's B1 launches."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    cfg = _train_config()
    params, opt = _train_state(cfg, 40)
    n_params = sum(p.numel() for _, p in _flatten(params))
    n_attn = cfg.n_layers
    tokens = TRAIN_BATCH * TRAIN_SEQ
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    step = _train_step(cfg)
    print(f"TRAIN config {cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} params={n_params} "
          f"param_dtype={cfg.param_dtype} compute={cfg.dtype} moments="
          f"{cfg.opt_state_dtype} remat={cfg.remat} batch={TRAIN_BATCH}x"
          f"{TRAIN_SEQ} microbatches={TRAIN_MICRO} peak_lr={TRAIN_LR} "
          f"(warm-up 1 step: step 0 has lr 0) data=SyntheticLM(seed=0) "
          f"({time.perf_counter() - t_start:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated)",
          flush=True)

    # -- the main path: make_train_step, B3's count at 0 around each step --
    # the wrapper runs per microbatch n_attn forwards (calls 0 to n - 1)
    # then n_attn recomputes in the backward, last layer first; kept: the
    # first microbatch's first and last layer, forward and recompute
    torch.cuda.reset_peak_memory_stats()
    losses, times, counts = [], [], []
    keep = {0, n_attn - 1, n_attn, 2 * n_attn - 1}
    with OpRecorder(fa_ops, "attention", keep) as rec:
        for s in range(TRAIN_STEPS):
            fa_k.LAUNCHES["flash_attention"] = 0
            batch = data.batch_at(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts.append(fa_k.LAUNCHES["flash_attention"])
            losses.append(float(m["loss"]))
            print(f"TRAIN step {s}{' (warm-up)' if s == 0 else ''}: "
                  f"{times[-1]:.1f} ms loss {losses[-1]:.5f} lr "
                  f"{float(m['lr']):.3g} B3 launches {counts[-1]}",
                  flush=True)
    peak = torch.cuda.max_memory_allocated()
    want = 2 * n_attn * TRAIN_MICRO
    if counts != [want] * TRAIN_STEPS:
        raise AssertionError(f"TRAIN: B3 launches a step {counts}, want "
                             f"{want} (a forward and a recompute per layer "
                             f"and microbatch)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"TRAIN: a loss is not finite: {losses}")
    if not np.mean(losses[-2:]) < losses[0]:
        _train_sweep_print(data)
        raise AssertionError(f"TRAIN: the last two losses {losses[-2:]} do "
                             f"not average below the first {losses[0]}")
    timed = times[1:]
    med = statistics.median(timed)
    flops = 6 * n_params * tokens
    print(f"TRAIN main path: {len(timed)} timed steps after a warm-up, "
          f"step ms median {med:.1f} (min {min(timed):.1f}, max "
          f"{max(timed):.1f}); {tokens / med * 1e3:.0f} tokens/s; 6*N*tokens "
          f"= {flops:.4g} FLOP a step, {flops / med / 1e9:.1f} TFLOP/s = "
          f"{flops / med * 1e3 / (2 * TC_BF16_MACS_PER_S):.4f} of the dense "
          f"bf16 rate; peak {peak / 2 ** 30:.2f} GiB allocated "
          f"(max_memory_allocated); B3 launches a step {want} "
          f"({n_attn} layers x {TRAIN_MICRO} microbatches x 2: forward and "
          f"remat recompute); losses {[round(x, 5) for x in losses]} (last "
          f"two average {np.mean(losses[-2:]):.5f} < first "
          f"{losses[0]:.5f})", flush=True)

    fa_k.LAUNCHES["flash_attention"] = 0
    prof = _train_profile(step, params, opt, data.batch_at(TRAIN_STEPS))
    params, opt = prof.pop("params"), prof.pop("opt")
    counts.append(fa_k.LAUNCHES["flash_attention"])
    if counts[-1] != want:
        raise AssertionError(f"TRAIN: the profiled step launched B3 "
                             f"{counts[-1]} times, want {want}")
    split = "; ".join(f"{part} {ms:.1f} ms ({n} kernels)" for part, (ms, n)
                      in sorted(prof["parts"].items(), key=lambda kv:
                                -kv[1][0]))
    print(f"TRAIN profile (one step under torch.profiler): wall "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms, "
          f"idle share {prof['idle']:.4f}; split by the device spans of "
          f"the step's ranges, else by kernel name: {split}; "
          f"top device ops: {prof['top']}", flush=True)

    # the kept full-depth calls against the plain version; one timed
    held = []
    for i in sorted(rec.calls):
        args, _, out = rec.calls[i]
        err, share = _b3_hold(args, out)
        held.append(err)
        what = "forward" if i < n_attn else "recompute"
        print(f"TRAIN B3 call {i} ({what}, layer "
              f"{i if i < n_attn else 2 * n_attn - 1 - i}) "
              f"[{_b3_label(args)}]: max_abs_err={err:.3g} "
              f"allowance share={share:.3f}", flush=True)
        if not share <= 1.0:
            raise AssertionError(f"TRAIN B3 call {i}: {share:.3g}x its "
                                 "allowance")
    args, _, out = rec.calls[0]
    row = _b3_timing("TRAIN", args, out, max(held))
    _print_b3_timing("TRAIN B3 one training call", row)
    launches = sum(counts)
    del params, opt, rec, args, out
    gc.collect()
    torch.cuda.empty_cache()

    # -- held at 2 layers ---------------------------------------------------
    cfg2 = _train_config(TRAIN_HOLD_LAYERS)
    step2 = _train_step(cfg2)
    params, opt = _train_state(cfg2, 41)
    n2 = 2 * TRAIN_HOLD_LAYERS * TRAIN_MICRO
    with OpRecorder(fa_ops, "attention", range(n2)) as rec:
        params, opt, m0 = step2(params, opt, data.batch_at(0))
    shares = []
    for i in sorted(rec.calls):
        args, _, out = rec.calls[i]
        err, share = _b3_hold(args, out)
        held.append(err)
        shares.append(share)
    del rec
    if len(shares) != n2 or not max(shares) <= 1.0:
        raise AssertionError(f"TRAIN 2 layers: {len(shares)} B3 calls held "
                             f"(want {n2}), largest allowance share "
                             f"{max(shares):.3g}")
    print(f"TRAIN held at {TRAIN_HOLD_LAYERS} layers: every B3 call of a "
          f"step ({n2}: forward and recompute, {TRAIN_MICRO} microbatches) "
          f"against the plain version, max_abs_err {max(held[-n2:]):.3g}, "
          f"largest allowance share {max(shares):.3f}", flush=True)
    del params, opt
    gc.collect()
    d = {moments: _b3_vs_plain(cfg2, data, moments)
         for moments in ("f32", "int8")}
    f, q = d["f32"], d["int8"]
    print(f"TRAIN B3 step vs plain step ({TRAIN_HOLD_LAYERS} layers, the "
          f"second step from a common first, lr {f['lr']:.3g}, float32 "
          f"moments; B3 launches {f['launches']}): loss {f['loss']} rel "
          f"diff {f['loss_rel']:.3g} (tolerance {TRAIN_LOSS_RTOL}); "
          f"parameters max |diff| {f['dp']:.3g} = {f['dp'] / f['lr']:.3g} lr "
          f"(tolerance {TRAIN_PARAM_LR} lr), share off by more than "
          f"{TRAIN_PARAM_SHARE_AT} lr {f['moved']:.3g} (tolerance "
          f"{TRAIN_PARAM_SHARE}); moments' largest difference over their "
          f"leaf's largest {f['moments']['rel']:.3g} (tolerance "
          f"{TRAIN_MOMENT_RTOL}). The same with the config's int8 moments, "
          f"for the record (no tolerance: a code near a rounding edge or "
          f"a row's zero code moves its weight by many lr): loss "
          f"{q['loss']} rel diff {q['loss_rel']:.3g}; parameters max "
          f"|diff| {q['dp'] / q['lr']:.3g} lr, share off by more than "
          f"{TRAIN_PARAM_SHARE_AT} lr {q['moved']:.3g}; int8 codes "
          f"differing {q['moments']['code_share']:.3g}, by at most "
          f"{q['moments']['code_max']}; float32 moments (gains) rel diff "
          f"{q['moments']['rel']:.3g}", flush=True)
    if f["launches"] != [n2, 0] or q["launches"] != [n2, 0]:
        raise AssertionError(f"TRAIN: B3 launched {f['launches']} and "
                             f"{q['launches']} times in the kernel and "
                             f"plain steps, want [{n2}, 0]")
    if not (f["loss_rel"] <= TRAIN_LOSS_RTOL
            and f["dp"] <= TRAIN_PARAM_LR * f["lr"]
            and f["moved"] <= TRAIN_PARAM_SHARE
            and f["moments"]["rel"] <= TRAIN_MOMENT_RTOL):
        raise AssertionError("TRAIN: the B3 step and the plain step differ "
                             "beyond their tolerances")
    del d, f, q
    gc.collect()
    torch.cuda.empty_cache()

    _train_sweep_print(data)
    rs = _train_restart(cfg2, step2, data)
    n, every, fail = TRAIN_RESTART
    print(f"TRAIN checkpoint/restart ({TRAIN_HOLD_LAYERS} layers, "
          f"FaultTolerantLoop over {n} steps, save every {every}, a failure "
          f"injected once at step {fail}): restored step {every} of "
          f"{rs['leaves']} leaves bitwise to the saved state="
          f"{rs['bitwise']}; losses after the replay "
          f"{[round(rs['losses'][s], 6) for s in range(n)]} vs straight "
          f"through {[round(x, 6) for x in rs['clean']]}, largest rel diff "
          f"{rs['loss_rel']:.3g} (tolerance {TRAIN_REPLAY_RTOL}); the loop "
          f"with its saves {rs['loop_s']:.1f}s, {rs['bytes'] / 2 ** 30:.2f} "
          f"GiB on disk at the end", flush=True)
    if not (rs["bitwise"] and rs["loss_rel"] <= TRAIN_REPLAY_RTOL):
        raise AssertionError("TRAIN: the restart differs from the saved "
                             "state or the straight run")
    gc.collect()
    torch.cuda.empty_cache()

    tape = _adamw_tape(lazy, codegen)
    st, blk = tape["stats"], tape["blk"]
    print(f"TRAIN AdamW tape (optim/fused.record_adamw_tape, n="
          f"{TRAIN_TAPE_N} float64, backend=triton): the update's flush "
          f"{tape['n_ops']} ops in {tape['n_blocks']} block(s); triton "
          f"blocks {st['triton_blocks']} declines "
          f"{dict(st['triton_fallbacks'])}; B1 launches {tape['launches']} "
          f"(the draws' blocks and the update's); "
          f"bitwise to the torch floor={tape['bitwise']}; update block "
          f"kernel_ms={blk['ms']:.4f} call_ms={blk['call_ms']:.4f} "
          f"plain_ms={blk['plain_ms']:.4f} bytes={blk['bytes']} bound_ms="
          f"{blk['bound_ms']:.4f} ({blk['bound_by']})", flush=True)
    if not (tape["n_blocks"] == 1 and tape["bitwise"]
            and not st["triton_fallback_blocks"]
            and tape["launches"] == st["triton_blocks"] >= 2):
        raise AssertionError("TRAIN: the AdamW tape is not one B1 block "
                             "bitwise to the floor")
    print(f"TRAIN phase: {time.perf_counter() - t_start:.1f}s", flush=True)
    return {"launches": launches, "row": row, "max_abs_err": max(held),
            "b1_launches": tape["launches"], "losses": losses}


def _mesh_line(label: str, run: dict, extra: str = "") -> None:
    print(f"MESH {label} warm_ms={run['wall_s'] * 1e3:.3f} "
          f"blocks={dict(sorted(run['backend_blocks'].items()))} "
          f"shard_map_blocks={run['shard_map_blocks']} "
          f"collectives={run['collectives']} "
          f"interconnect_bytes={run['interconnect_bytes']:.0f}{extra}",
          flush=True)


def _ms_list(walls) -> str:
    return "/".join(f"{w * 1e3:.3f}" for w in walls)


def _mesh_pair(lazy, codegen, fn, mesh):
    """One program in a runtime with the mesh and in one without, each
    cold once, then ``MESH_REPS`` warm runs each in turns (mesh, none,
    none, mesh, ...).  Returns each side's last result, median warm wall,
    walls and last run's stats, and B1's launches in the mesh runs."""
    from repro_torch.core.executor import stats_delta
    rts = {side: lazy.Runtime(backend="triton", cost_model="comm",
                              loop_fusion=False, **kw)
           for side, kw in (("mesh", {"mesh": mesh}), ("none", {}))}
    walls = {side: [] for side in rts}
    res, b1 = {}, 0
    order = ["mesh", "none"]
    for i in range(MESH_REPS + 1):
        for side in (order if i % 2 == 0 else order[::-1]):
            ex = rts[side].executor
            before = ex.snapshot_stats()
            n0 = codegen.LAUNCHES["fused_block"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with rts[side].activate():
                out = fn()
            torch.cuda.synchronize()
            if i:                         # run 0 is each side's cold run
                walls[side].append(time.perf_counter() - t0)
            if side == "mesh":
                b1 += codegen.LAUNCHES["fused_block"] - n0
            st = stats_delta(before, ex.stats)
            res[side] = {"out": np.asarray(out),
                         "backend_blocks": dict(st["backend_blocks"]),
                         **{k: st.get(k, 0) for k in (
                             "shard_map_blocks", "collectives",
                             "interconnect_bytes")}}
    for side in rts:
        res[side]["walls"] = walls[side]
        res[side]["wall_s"] = statistics.median(walls[side])
    return res["mesh"], res["none"], b1


def _mesh_world_of_one(lazy, codegen) -> int:
    """Part (a): a world of one over NCCL in this process.  Returns B1's
    launches in the mesh runs."""
    import tempfile
    import torch.distributed as tdist
    from repro_torch.core import dist
    from repro_torch.core.dist import host_mesh
    from repro_torch.testing import mesh as tmesh
    from repro_torch.testing.programs import BENCHMARKS, CHIP_SIZES
    if tdist.is_initialized():
        raise AssertionError("MESH: a process group is already up")
    mesh = host_mesh()
    b1 = 0
    try:
        if tdist.get_backend(mesh.get_group()) != "nccl":
            raise AssertionError("MESH: the world of one is not NCCL")
        todo = {k: (lambda f=f: f(lazy, dist, 1, MESH_SIZE))
                for k, f in tmesh.PROGRAMS.items()}
        for k in MESH_PROGRAMS:
            todo[k] = (lambda f=BENCHMARKS[k], a=CHIP_SIZES[k]:
                       f(*a).numpy())
        for name, fn in todo.items():
            got, want, n = _mesh_pair(lazy, codegen, fn, mesh)
            if got["out"].tobytes() != want["out"].tobytes():
                raise AssertionError(f"MESH {name}: the NCCL world of one "
                                     "differs from the run without a mesh")
            if n == 0:
                raise AssertionError(f"MESH {name}: no B1 launch")
            b1 += n
            _mesh_line(f"nccl-1 {name}", got,
                       f" nomesh_warm_ms={want['wall_s'] * 1e3:.3f} "
                       f"ratio={got['wall_s'] / want['wall_s']:.4f} (medians "
                       f"of {MESH_REPS} warm runs each, in turns; mesh "
                       f"{_ms_list(got['walls'])}, none "
                       f"{_ms_list(want['walls'])}) b1_launches={n} "
                       "bitwise=True")
            torch.cuda.empty_cache()
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            counts = []
            for kw in ({"mesh": mesh}, {}, {"mesh": mesh}):
                with lazy.fresh_runtime(backend="triton", cost_model="comm",
                                        plan_store=d, loop_fusion=False,
                                        **kw) as rt:
                    tmesh.window(lazy, dist, 1, MESH_SIZE)
                    reg = rt.executor.metrics
                    counts.append(
                        (reg.counter("cache.plan_store.hit").get(),
                         reg.counter("cache.plan_store.write").get(),
                         rt.executor.topology_key()))
        if not (counts[0][0] == 0 and counts[0][1] > 0 and counts[1][0] == 0
                and counts[1][1] > 0 and counts[2][0] > 0
                and counts[0][2] != counts[1][2]):
            raise AssertionError(f"MESH plan store: {counts}")
        print(f"MESH nccl-1 plans: mesh topology={counts[0][2]} writes "
              f"{counts[0][1]}; mesh-less topology={counts[1][2]} hits "
              f"{counts[1][0]} writes {counts[1][1]}; a second mesh runtime "
              f"hits {counts[2][0]}", flush=True)
    finally:
        tdist.destroy_process_group()
    return b1


def _mesh_hold(rec_b3=None, rec_b5=None, rec_rw=(), rec_da=None) -> dict:
    """The first recorded call of each kernel on the mesh path (each rank's
    local shards) against its plain version: name -> (err, share)."""
    from repro_torch.kernels.rwkv6_scan.ref import (reference_rwkv6,
                                                    reference_rwkv6_chunked)
    held = {}
    if rec_b3 is not None and 0 in rec_b3.calls:
        args, _, out = rec_b3.calls[0]
        held["flash_attention"] = _b3_hold(args, out)
    if rec_b5 is not None and 0 in rec_b5.calls:
        args, kw, out = rec_b5.calls[0]
        held["mamba_scan"] = _b5_hold(args, kw, out)
    if rec_da is not None and rec_da.calls:
        held["decode_attention"] = _decode_hold(*rec_da.calls[min(
            rec_da.calls)])
    for name, rec, plain in rec_rw:
        if 0 not in rec.calls:
            continue
        args, kw, out = rec.calls[0]
        o, st = out
        po, pst = plain(*args, state=kw["state"], return_state=True)
        eo, so = _hold(o, po, BF16_RTOL if o.dtype == torch.bfloat16
                       else 0.0, MODEL_TOL[name])
        es, ss = _hold(st, pst, 0.0, MODEL_TOL[name])
        held[name] = (max(eo, es), max(so, ss))
    for name, (err, share) in held.items():
        if not share <= 1.0:
            raise AssertionError(f"MESH {name} on the mesh: {share:.3g}x "
                                 "its allowance against the plain version")
    return held


def _mesh_serve_pair(cfg, sp, mesh, toks, n_dec):
    """``make_serve_steps`` on ``mesh`` and the mesh-less model's eager
    ``serve_prefill`` / ``serve_decode`` (what ``serve_requests`` replays
    as graphs) on the same tokens: the mesh-less run picks each decode
    token greedily and the mesh run is fed it.  Returns the largest
    difference over the largest magnitude of every step's logits, whether
    all were bitwise, and the mesh path's launches and wall seconds."""
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.launch.steps import make_serve_steps
    from repro_torch.models import transformer as T
    from repro_torch.testing import mesh as tmesh
    max_seq = toks.shape[1] + n_dec
    prefill, decode, specs = make_serve_steps(cfg, mesh, max_seq,
                                              toks.shape[0])
    want, wc = T.serve_prefill(sp, toks, cfg, max_seq)
    wants, tokens = [want], []
    for _ in range(n_dec):
        tokens.append(want[:, -1].argmax(-1)[:, None])
        want, wc = T.serve_decode(sp, wc, tokens[-1], cfg)
        wants.append(want)
    del wc
    dsp = shard_tree(sp, specs["params"], mesh)
    tmesh.zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, gc = prefill(dsp, {"tokens": toks})
    gots = [got.full_tensor()]
    for tok in tokens:
        got, gc = decode(dsp, gc, tok)
        gots.append(got.full_tensor())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tmesh.kernel_launches()
    rel = max(float((g - w).abs().max()) / float(w.abs().max())
              for g, w in zip(gots, wants))
    same = all(torch.equal(g, w) for g, w in zip(gots, wants))
    if not all(torch.isfinite(g).all() for g in gots):
        raise AssertionError(f"MESH {cfg.name}: a served logit is not finite")
    return rel, same, counts, wall


def _mesh_model_world_of_one(train_losses) -> dict:
    """Part (c1): the model on a world of one over NCCL (see the module
    doc).  Returns each kernel's launches and the largest held error."""
    import torch.distributed as tdist
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels.decode_attention import kernel as da_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.rwkv6_scan import ops as rw_ops
    from repro_torch.kernels.rwkv6_scan.ref import (reference_rwkv6,
                                                    reference_rwkv6_chunked)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptState
    from repro_torch.testing import mesh as tmesh
    if tdist.is_initialized():
        raise AssertionError("MESH (c1): a process group is already up")
    t0 = time.perf_counter()
    mesh = make_host_mesh()
    launches = dict.fromkeys(tmesh.kernel_launches(), 0)
    held = {}
    try:
        if tdist.get_backend(mesh.get_group(0)) != "nccl" or \
                tuple(mesh.shape) != (1, 1):
            raise AssertionError(f"MESH (c1): the host mesh is {mesh}")
        cfg = _train_config()
        step, specs = make_train_step(cfg, mesh, num_microbatches=TRAIN_MICRO,
                                      peak_lr=TRAIN_LR, warmup=1,
                                      total_steps=TRAIN_TOTAL)
        params, opt = _train_state(cfg, 40)
        params = shard_tree(params, specs["params"], mesh)
        opt = OptState(opt.step, shard_tree(opt.m, specs["opt"].m, mesh),
                       shard_tree(opt.v, specs["opt"].v, mesh))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
        losses, times, counts = [], [], []
        # what DRYRUN (b) holds its trace to: the first step's arguments
        # and FLOPs (FlopCounterMode over the step: a (1, 1) mesh's global
        # operations are its local ones) and the steps' peak.  The batch
        # in the dtype of the model's input spec, int32 (SyntheticLM's
        # tokens are int64, as the reference's; the model reads either as
        # int64, so the losses do not move)
        def batch_at(s):
            return {k: v.astype(np.int32) for k, v in
                    data.batch_at(s).items()}

        batch = batch_at(0)
        c1 = {"card_arg_bytes": _tree_bytes((params, opt))}
        c1["arg_bytes"] = c1["card_arg_bytes"] + _tree_bytes(batch)
        with OpRecorder(fa_ops, "attention", {0}) as rec:
            for s in range(MESH_TRAIN_STEPS):
                tmesh.zero_launches()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                flop_counter = FlopCounterMode(display=False) if s == 0 \
                    else contextlib.nullcontext()
                with flop_counter:
                    params, opt, m = step(params, opt, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
                counts.append(tmesh.kernel_launches()["flash_attention"])
                losses.append(float(m["loss"]))
                if s == 0:
                    c1["flops"] = flop_counter.get_total_flops()
                batch = batch_at(s + 1)
        c1["peak_bytes"] = torch.cuda.max_memory_allocated()
        # the recorder's clones of B3's first call, which the step itself
        # does not hold
        c1["kept_bytes"] = _tree_bytes(list(rec.calls.values()))
        peak = c1["peak_bytes"] / 2 ** 30
        launches["flash_attention"] += sum(counts)
        held.update(_mesh_hold(rec_b3=rec))
        del params, opt, rec, step
        gc.collect()
        torch.cuda.empty_cache()
        want = 2 * cfg.n_layers * TRAIN_MICRO
        rel = abs(losses[1] - train_losses[1]) / abs(train_losses[1])
        print(f"MESH (c1) nccl-1 train {cfg.name} {cfg.n_layers} layers "
              f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"batch={TRAIN_BATCH}x{TRAIN_SEQ} microbatches={TRAIN_MICRO}: "
              f"step ms {[round(t, 1) for t in times]} (TRAIN's main path "
              f"above without a mesh); losses {losses} against TRAIN's "
              f"{train_losses[:MESH_TRAIN_STEPS]}: first bitwise="
              f"{losses[0] == train_losses[0]}, second rel diff {rel:.3g} "
              f"(tolerance {TRAIN_REPLAY_RTOL}); B3 launches a step {counts} "
              f"(want {want}); B3's first call on the mesh against its plain "
              f"version max_abs_err={held['flash_attention'][0]:.3g} "
              f"allowance share={held['flash_attention'][1]:.3f}; peak "
              f"{peak:.2f} GiB allocated; the first step (timed under "
              f"FlopCounterMode) {c1['flops']:.6g} FLOPs", flush=True)
        if losses[0] != train_losses[0] or not rel <= TRAIN_REPLAY_RTOL \
                or counts != [want] * MESH_TRAIN_STEPS:
            raise AssertionError("MESH (c1): the train step on the mesh "
                                 "differs from TRAIN's")
        batch, prompt, n_dec = MESH_SERVE
        for name, layers in ((TRAIN_ARCH, None),) + tuple(
                (n, 2) for n in MESH_SERVED):
            from repro_torch.configs import get_config
            c = get_config(name)
            c = c if layers is None else c.scaled(n_layers=layers)
            sp, _ = _family_weights(c, 43)
            gen = torch.Generator(device="cuda").manual_seed(44)
            toks = torch.randint(0, c.vocab_size, (batch, prompt),
                                 generator=gen, device="cuda")
            # the decode-attention wrapper's first call on the mesh: after
            # the mesh-less model's, one an attention layer a step
            n_attn = sum(m.startswith("attn") for m, _ in c.layer_pattern())
            recs = [OpRecorder(fa_ops, "attention", {0}),
                    OpRecorder(ms_ops, "mamba", {0}),
                    OpRecorder(rw_ops, "rwkv6_chunked", {0}),
                    OpRecorder(rw_ops, "rwkv6", {0}),
                    OpRecorder(da_k, "decode_attention", {n_attn * n_dec})]
            with contextlib.ExitStack() as stack:
                for r in recs:
                    stack.enter_context(r)
                rel, same, n, wall = _mesh_serve_pair(c, sp, mesh, toks,
                                                      n_dec)
            part = _mesh_hold(recs[0], recs[1], (
                ("rwkv6_chunked", recs[2], reference_rwkv6_chunked),
                ("rwkv6_scan", recs[3], reference_rwkv6)), recs[4])
            for k, v in part.items():
                held[k] = max(held.get(k, (0.0, 0.0)), v)
            for k in launches:
                launches[k] += n[k]
            tol = FAMILY_RTOL[str(c.compute_dtype).removeprefix("torch.")]
            print(f"MESH (c1) nccl-1 serve {c.name} {c.n_layers} layers "
                  f"{batch}x{prompt} + {n_dec} decode steps through "
                  f"make_serve_steps: logits vs the mesh-less model max "
                  f"|diff|/max|logit| {rel:.3g} (tolerance {tol}), bitwise="
                  f"{same}; launches {n}; held {part}; {wall * 1e3:.1f} ms "
                  f"(eager)", flush=True)
            if not rel <= tol:
                raise AssertionError(f"MESH (c1) {c.name}: served logits "
                                     "differ from the mesh-less model's")
            del sp
            gc.collect()
            torch.cuda.empty_cache()
        for k in ("mamba_scan", "rwkv6_scan", "rwkv6_chunked"):
            if launches[k] == 0:
                raise AssertionError(f"MESH (c1): {k} never launched")
    finally:
        tdist.destroy_process_group()
    print(f"MESH (c1) {time.perf_counter() - t0:.1f}s", flush=True)
    return {"launches": launches, "held": held, "c1": c1}


def _mesh_model_ranks() -> dict:
    """Part (c2): the model on ``MESH_RANKS`` host-staged ranks of the one
    card (see the module doc).  Returns each kernel's launches over the
    ranks."""
    import tempfile
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.testing import mesh as tmesh
    t0 = time.perf_counter()
    cfg = _train_config(MESH_C2_LAYERS)
    b, seq = MESH_C2_TRAIN
    data = SyntheticLM(cfg, b, seq, seed=0)
    batches = [data.batch_at(s) for s in range(2)]
    train_kw = dict(num_microbatches=1, peak_lr=TRAIN_LR, warmup=1,
                    total_steps=TRAIN_TOTAL)
    sb, sprompt, sdec = MESH_C2_SERVE
    rng = np.random.default_rng(45)
    serve = {"tokens": rng.integers(0, cfg.vocab_size, (sb, sprompt)),
             "decode": rng.integers(0, cfg.vocab_size, (sb, sdec))}
    # the one-rank run at the same depth, on the same weights
    step, _ = make_train_step(cfg, **train_kw)
    params = tmesh._weights(cfg, 46, "cuda")
    opt = adamw_init(params, state_dtype=cfg.opt_state_dtype)
    want = []
    for batch in batches:
        params, opt, m = step(params, opt, batch)
        want.append(float(m["loss"]))
    del opt
    sp = T.serving_params(tmesh._weights(cfg, 46, "cuda"), cfg)
    del params
    toks = torch.as_tensor(serve["tokens"], device="cuda")
    max_seq = sprompt + sdec
    logits, cache = T.serve_prefill(sp, toks, cfg, max_seq)
    wlog = [logits.float().cpu().numpy()]
    for j in range(sdec):
        logits, cache = T.serve_decode(
            sp, cache, torch.as_tensor(serve["decode"][:, j:j + 1],
                                       device="cuda"), cfg)
        wlog.append(logits.float().cpu().numpy())
    del sp, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    d, m_pipe, rows = MESH_PIPE
    (ROOT / "build").mkdir(exist_ok=True)
    # four ranks share the card: their allocators grow segments in place
    # rather than each holding fragments of its own
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ranks = tmesh.spawn(tmesh.run_suites, MESH_RANKS, device="cuda",
                            pg_backend="hoststaged", jobs=[
            ("model_suite", dict(cfg=cfg, weights=46, shape=MESH_GRID,
                                 batches=batches, train_kw=train_kw,
                                 serve=serve, keep_params=False)),
            ("pipeline_suite", dict(shape=(MESH_RANKS, 1), d=d, m=m_pipe,
                                    rows=rows, scale=d ** -0.5)),
            ("elastic_suite", dict(
                cfg=_train_config(MESH_ELASTIC_LAYERS), weights=47,
                shapes=MESH_ELASTIC, directory=tmp, keys=("groups",),
                keep_leaves=False))])
    launches = dict.fromkeys(tmesh.kernel_launches(), 0)
    tol = FAMILY_RTOL["bfloat16"]
    n_b3 = 2 * MESH_C2_LAYERS
    for r, (res, pipe, el) in enumerate(ranks):
        rel = max(abs(g - w) / abs(w) for g, w in zip(res["losses"], want))
        srel = max(float(np.abs(g - w).max()) / float(np.abs(w).max())
                   for g, w in zip([res["prefill"]] + res["decode"], wlog))
        b3 = [n["flash_attention"] for n in res["launches"]]
        for n in res["launches"] + [res["serve_launches"]]:
            for k in launches:
                launches[k] += n[k]
        comm = "; ".join(
            f"{phase}: {res['comm'][phase]} staged "
            f"{ {k: v for k, v in res['staged'][phase].items() if v[0]} }"
            for phase in res["comm"])
        print(f"MESH (c2) rank {r} of {MESH_RANKS} at {MESH_GRID} (host-"
              f"staged) {cfg.name} {cfg.n_layers} layers {b}x{seq} one "
              f"microbatch: step ms warm-up {res['step_ms'][0]:.1f} timed "
              f"{res['step_ms'][1]:.1f}; losses {res['losses']} vs one "
              f"rank {want} rel diff {rel:.3g} (tolerance {TRAIN_LOSS_RTOL}"
              f"); B3 launches a step {b3} (want {n_b3}); serve {sb}x"
              f"{sprompt} + {sdec} decode steps max |diff|/max|logit| "
              f"{srel:.3g} (tolerance {tol}); peak {res['peak_gib']:.2f} GiB "
              f"allocated; collectives by kind (CommDebugMode) and staged "
              f"[calls, bytes] by phase: {comm}; pipeline {MESH_PIPE} over "
              f"({MESH_RANKS}, 1) max |diff| {pipe['err']:.3g} wall "
              f"{pipe['wall_s'] * 1e3:.1f} ms; elastic {MESH_ELASTIC} "
              f"bitwise={el['bitwise']}", flush=True)
        if not (rel <= TRAIN_LOSS_RTOL and b3 == [n_b3] * len(batches)
                and srel <= tol and pipe["err"] <= 2e-5 and el["bitwise"]):
            raise AssertionError(f"MESH (c2) rank {r}: outside its "
                                 "tolerances")
    print(f"MESH (c2) {time.perf_counter() - t0:.1f}s with the spawn",
          flush=True)
    return {"launches": launches, "comm": ranks[0][0]["comm"],
            "staged": ranks[0][0]["staged"]}


def _train_losses() -> list:
    """TRAIN's main path's first ``MESH_TRAIN_STEPS`` losses (its weights,
    batches and lr, no mesh), for part (c1) when the phase runs alone."""
    from repro_torch.data import SyntheticLM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_config()
    params, opt = _train_state(cfg, 40)
    step = _train_step(cfg)
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    losses = []
    for s in range(MESH_TRAIN_STEPS):
        params, opt, m = step(params, opt, data.batch_at(s))
        losses.append(float(m["loss"]))
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def run_mesh(lazy, codegen, train_losses=None) -> dict:
    """The MESH phase: (a) a world of one over NCCL in this process, every
    program under the mesh bitwise to the same run without one and its
    plans keyed by the topology; (b) ``MESH_RANKS`` ranks spawned on the
    one card over gloo (collectives staged through the host), the window,
    aligned and reduction programs at ``MESH_SIZE`` bitwise to the
    single-device run on each rank, fused collectives and bytes below
    unfused, and ``check_dist`` on ``MESH_SEEDS``; (c) the model on the
    mesh, (c1) a world of one and (c2) ``MESH_RANKS`` host-staged ranks.
    Returns B1's launches in (a)'s mesh runs and B3, B5, B6 and B7's in
    (c), with the largest error of (c)'s held calls.  ``train_losses``:
    TRAIN's first losses, which (c1) must reproduce (run again when the
    phase runs alone)."""
    from repro_torch.testing import mesh as tmesh
    t0 = time.perf_counter()
    b1 = _mesh_world_of_one(lazy, codegen)
    t1 = time.perf_counter()
    res = tmesh.spawn(tmesh.mesh_suite, MESH_RANKS, device="cuda",
                      backend="triton", size=MESH_SIZE, seeds=MESH_SEEDS,
                      seed_size=MESH_SEED_SIZE, keep_outputs=False,
                      warm=True)
    runs = res[0]["runs"]
    for name, modes in runs.items():
        for mode in ("greedy", "singleton", "single"):
            _mesh_line(f"gloo-{MESH_RANKS} {name} {mode}", modes[mode],
                       " (host-staged)" if mode != "single" else "")
    win = runs["window"]
    fused, unfused = win["greedy"], win["singleton"]
    if not (fused["shard_map_blocks"] > 0
            and fused["collectives"] < unfused["collectives"]
            and 0 < fused["interconnect_bytes"]
            < unfused["interconnect_bytes"]):
        raise AssertionError(f"MESH window: fused {fused} unfused {unfused}")
    if any(r["n_seeds"] != len(MESH_SEEDS) for r in res):
        raise AssertionError("MESH: check_dist did not run on every rank")
    t2 = time.perf_counter()
    print(f"MESH gloo-{MESH_RANKS} bitwise to single-device on every rank; "
          f"check_dist seeds {MESH_SEEDS[0]}-{MESH_SEEDS[-1]} at "
          f"{MESH_SEED_SIZE} elements bitwise; phase (a) {t1 - t0:.1f}s, "
          f"(b) {t2 - t1:.1f}s with the spawn", flush=True)
    one = _mesh_model_world_of_one(train_losses or _train_losses())
    torch.cuda.empty_cache()
    ranks = _mesh_model_ranks()
    launches = {k: one["launches"][k] + ranks["launches"][k]
                for k in one["launches"]}
    print(f"MESH (c) launches on the mesh path: {launches}; phase "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return {"b1": b1, "launches": launches, "held": one["held"],
            "c1": one["c1"], "c2": {"comm": ranks["comm"],
                                    "staged": ranks["staged"]}}


def _tree_bytes(tree) -> int:
    """The bytes of the tensors (a DTensor's local shard) and numpy arrays
    in nested dicts, lists and tuples."""
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def dryrun_job(job: dict, out: str) -> None:
    """One DRYRUN trace, in a subprocess that sees no card (see
    :func:`start_dryruns`): ``job["part"]`` is ``"a"`` (a production cell
    through the CLI, ``job["cell"]``), ``"b"`` (TRAIN's cell on a fake
    (1, 1) mesh) or ``"c"`` (MESH (c2)'s train cell over a fake (2, 2)
    group).  Writes the record, the wall and the card's
    ``memory_allocated`` after the trace to ``out`` as JSON."""
    import tempfile
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun as D
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if job["part"] == "a":
        arch, shape, mesh_kind = job["cell"]
        with tempfile.TemporaryDirectory() as tmp:
            D.main(["--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                    "--out", tmp])
            with open(os.path.join(
                    tmp, f"{arch}__{shape}__{mesh_kind}.json")) as f:
                rec = json.load(f)
    else:
        grid = (1, 1) if job["part"] == "b" else MESH_GRID
        if job["part"] == "b":
            cfg, (b, seq), micro = _train_config(), (TRAIN_BATCH,
                                                     TRAIN_SEQ), TRAIN_MICRO
        else:
            cfg, (b, seq), micro = _train_config(MESH_C2_LAYERS), \
                MESH_C2_TRAIN, 1
        with D.fake_group(int(np.prod(grid))):
            mesh = DeviceMesh("cuda", torch.arange(int(np.prod(grid)))
                              .reshape(grid), mesh_dim_names=("data",
                                                              "model"))
            rec = D.run_cell(cfg, ShapeSpec(f"train_{job['part']}", seq, b,
                                            "train"),
                             "x".join(map(str, grid)), out_dir=None,
                             mesh=mesh, device="cuda",
                             train_kw=dict(num_microbatches=micro))
    res = {"rec": rec, "wall_s": time.perf_counter() - t0,
           "memory_allocated": torch.cuda.memory_allocated()}
    with open(out, "w") as f:
        json.dump(res, f)


def start_dryruns():
    """Start the DRYRUN phase's traces (:func:`dryrun_job`), each in a
    subprocess of its own (this process holds NCCL's group) at a lower
    priority,
    ``DRYRUN_WORKERS`` at a time, beside the earlier phases: part (b)'s
    first, then (c)'s and (a)'s cells.  Returns ``(started, {name:
    future})``; each future gives the job's result or raises."""
    import concurrent.futures
    import shutil
    logs = ROOT / "build" / "dryrun"
    logs.mkdir(parents=True, exist_ok=True)
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    nice = [shutil.which("nice"), "-n", "10"] if shutil.which("nice") \
        else []
    jobs = {"b": {"part": "b"}, "c": {"part": "c"}}
    for cell in DRYRUN_CELLS:
        jobs["/".join(cell)] = {"part": "a", "cell": list(cell)}

    def run(name, job):
        out = logs / f"{name.replace('/', '__')}.json"
        out.unlink(missing_ok=True)
        code = ("import json, sys, chip_smoke; chip_smoke.dryrun_job("
                "json.loads(sys.argv[1]), sys.argv[2])")
        proc = subprocess.run(
            nice + [sys.executable, "-c", code, json.dumps(job), str(out)],
            env=env, capture_output=True, text=True, timeout=1000,
            cwd=ROOT)
        (logs / f"{name.replace('/', '__')}.log").write_text(
            proc.stdout + proc.stderr)
        if proc.returncode != 0 or not out.exists():
            raise RuntimeError(f"DRYRUN {name}: exit {proc.returncode}:\n"
                               f"{proc.stderr[-3000:]}")
        return json.loads(out.read_text())

    pool = concurrent.futures.ThreadPoolExecutor(DRYRUN_WORKERS)
    futures = {name: pool.submit(run, name, job)
               for name, job in jobs.items()}
    pool.shutdown(wait=False)
    return time.perf_counter(), futures


def _gib(n) -> str:
    return f"{n / 2 ** 30:.3f}"


def _kinds(rec) -> dict:
    """A record's collectives that moved anything: kind -> [count,
    bytes]."""
    col = rec["collectives"]
    return {k: [col["counts"][k], col[k]] for k in col["counts"]
            if col["counts"][k]}


def run_dryrun(dry, mesh) -> None:
    """The DRYRUN phase (see the module doc): collects the traces started
    by :func:`start_dryruns` and holds (b) against MESH (c1) and (c)
    against MESH (c2)."""
    from repro_torch.launch.dryrun import KINDS, _collective_kind
    t0 = time.perf_counter()
    started, futures = dry
    res = {name: f.result() for name, f in futures.items()}
    waited = time.perf_counter() - t0
    total = torch.cuda.get_device_properties(0).total_memory
    for name, r in res.items():
        if r["memory_allocated"]:
            raise AssertionError(f"DRYRUN {name}: the trace allocated "
                                 f"{r['memory_allocated']} bytes on the card")
    for cell in DRYRUN_CELLS:
        r = res["/".join(cell)]
        rec = r["rec"]
        if "skipped" in rec:
            print(f"DRYRUN (a) {'/'.join(cell)} skipped: {rec['skipped']}",
                  flush=True)
            continue
        mem = rec["memory"]
        fit = mem["argument_size_in_bytes"] + mem["temp_peak_bytes"]
        print(f"DRYRUN (a) {'/'.join(cell)} over {rec['n_devices']} fake "
              f"ranks, fake {rec['device']} tensors: arguments "
              f"{_gib(mem['argument_size_in_bytes'])} GiB + peak "
              f"temporaries {_gib(mem['temp_peak_bytes'])} GiB = "
              f"{_gib(fit)} GiB against the card's {_gib(total)} GiB "
              f"(fits {fit <= total}); flops_per_device "
              f"{rec['flops_per_device']:.6g}, dot "
              f"{rec['dot_flops_per_device']:.6g}, kernels "
              f"{rec['kernel_flops_per_device']:.6g} "
              f"in calls {rec['kernel_calls']}; collectives [count, result "
              f"bytes] {_kinds(rec)}; t_trace_s {rec['t_trace_s']:.1f} "
              f"(job {r['wall_s']:.1f}s; the card's memory_allocated "
              f"after it {r['memory_allocated']})", flush=True)
    # (b) against MESH (c1)'s real first step
    c1, rec = mesh["c1"], res["b"]["rec"]
    mem = rec["memory"]
    real_temp = c1["peak_bytes"] - c1["card_arg_bytes"] - c1["kept_bytes"]
    ratio = mem["temp_peak_bytes"] / real_temp
    print(f"DRYRUN (b) {rec['arch']} {TRAIN_BATCH}x{TRAIN_SEQ} "
          f"microbatches={TRAIN_MICRO} on a fake (1, 1) mesh against MESH "
          f"(c1)'s first step: argument bytes {mem['argument_size_in_bytes']}"
          f" vs {c1['arg_bytes']} (equal "
          f"{mem['argument_size_in_bytes'] == c1['arg_bytes']}); "
          f"flops_per_device {rec['flops_per_device']} vs FlopCounterMode "
          f"{c1['flops']} (equal {rec['flops_per_device'] == c1['flops']});"
          f" temporaries {_gib(mem['temp_peak_bytes'])} GiB vs (c1)'s "
          f"max_memory_allocated less its parameters, moments and the "
          f"recorder's clones {_gib(real_temp)} GiB: ratio {ratio:.4f} "
          f"(within {DRYRUN_TEMP_RTOL}); t_trace_s {rec['t_trace_s']:.1f}",
          flush=True)
    if mem["argument_size_in_bytes"] != c1["arg_bytes"] \
            or rec["flops_per_device"] != c1["flops"] \
            or not abs(ratio - 1) <= DRYRUN_TEMP_RTOL:
        raise AssertionError("DRYRUN (b): the trace differs from MESH (c1)")
    # (c) against MESH (c2)'s first step on rank 0
    rec = res["c"]["rec"]
    want, other = {}, {}
    for name, n in mesh["c2"]["comm"]["train_step_0"].items():
        kind = _collective_kind(name)
        into = want if kind in KINDS else other
        into[kind] = into.get(kind, 0) + n
    got = {k: n for k, n in rec["collectives"]["counts"].items()
           if n and k in KINDS}
    staged = mesh["c2"]["staged"]["train_step_0"]
    print(f"DRYRUN (c) {rec['arch']} {rec['global_batch']}x"
          f"{rec['seq_len']} {_train_config(MESH_C2_LAYERS).n_layers} layers "
          f"over a fake {MESH_GRID} group against MESH (c2) rank 0's first "
          f"step: counts {got} vs CommDebugMode's {want} (equal "
          f"{got == want}; (c2)'s others {other}: its whole batch placed "
          f"in the step); result bytes "
          f"{ {k: rec['collectives'][k] for k in got} } vs (c2)'s staged "
          f"[calls, input bytes] {staged}; t_trace_s "
          f"{rec['t_trace_s']:.1f}", flush=True)
    if got != want:
        raise AssertionError("DRYRUN (c): the collectives differ from MESH "
                             "(c2)'s")
    print(f"DRYRUN phase {time.perf_counter() - t0:.1f}s (waited "
          f"{waited:.1f}s for jobs started {t0 - started:.1f}s before; the "
          f"jobs' walls { {k: round(r['wall_s'], 1) for k, r in res.items()} }"
          ")", flush=True)


def _model_entry(name, route, source, replaces, res) -> dict:
    """The ``kernels`` line entry of a model kernel: its largest-bound case
    (the largest error over its cases)."""
    rows = res["cases"][name]
    top = max(rows, key=lambda r: r["bound_ms"])
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": res["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import lazy
    from repro_torch.kernels.fused_block import codegen
    from repro_torch.testing.programs import BENCHMARKS, CHIP_SIZES, quickstart

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    dry = start_dryruns()
    programs = dict(BENCHMARKS, quickstart=quickstart)
    launches = 0
    worst = 0.0
    overall = None
    b1_loss = []
    floors = {}
    for name, fn in programs.items():
        args = CHIP_SIZES[name]
        t0 = time.perf_counter()
        with BlockRecorder(codegen.FusedBlockKernel) as rec:
            codegen.LAUNCHES["fused_block"] = 0
            res = run_program(name, args, fn, codegen, lazy)
            n_launch = codegen.LAUNCHES["fused_block"]
        if n_launch == 0:
            raise AssertionError(f"{name}: no fused-block kernel launched")
        launches += n_launch
        blk = hold_blocks(name, rec.calls, codegen, exact=res["exact"])
        loss = block_loss(rec.calls, rec.counts, codegen)
        if loss["launches"] != n_launch:
            raise AssertionError(f"{name}: {loss['launches']} recorded calls "
                                 f"for {n_launch} launches")
        b1_loss.append(loss)
        floors[name] = res["floor"]
        worst = max(worst, blk["max_abs_err"])
        if overall is None or blk["bound_ms"] > overall["bound_ms"]:
            overall = blk
        st = res["stats"]
        run = st["triton_blocks"] + st["triton_fallback_blocks"]
        print(f"PROGRAM {name} args={args} blocks={run} "
              f"triton={st['triton_blocks']}/{run} "
              f"declines={dict(st['triton_fallbacks'])} launches={n_launch} "
              f"donated_buffers={st['donated_buffers']} prng.uniform calls "
              f"triton={res['draws']['triton']} "
              f"torch={res['draws']['torch']} "
              f"warm_ms triton={res['warm_s']['triton'] * 1e3:.3f} "
              f"torch={res['warm_s']['torch'] * 1e3:.3f} "
              f"{'bitwise' if res['exact'] else 'max_abs_err'}="
              f"{res['err']:.3g} distinct_blocks={blk['n_blocks']} "
              f"kernel_vs_plain_err={blk['max_abs_err']:.3g} | largest "
              f"block {blk['domain']}: kernel_ms={blk['ms']:.4f} "
              f"call_ms={blk['call_ms']:.4f} "
              f"plain_ms={blk['plain_ms']:.4f} bytes={blk['bytes']} "
              f"bound_ms={blk['bound_ms']:.4f} ({blk['bound_by']}) | "
              f"every block: launches x (kernel_ms - bound_ms) summed = "
              f"{loss['loss_ms']:.4f} ms, launches x (call_ms - bound_ms) "
              f"summed = {loss['call_loss_ms']:.4f} ms over "
              f"{loss['timed_blocks']} blocks "
              f"(timed in {loss['timing_s']:.1f}s) "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        torch.cuda.empty_cache()
    prng_checks(codegen)
    from repro_torch.kernels.fused_block import rowblock
    lm = run_lm(lazy, codegen, rowblock)
    torch.cuda.empty_cache()
    b1_loss.append(lm["loss"]["B1"])
    sums = "; ".join(
        f"launches x ({what} - bound_ms): programs "
        f"{sum(x[key] for x in b1_loss[:-1]):.4f} ms + LM lane "
        f"{b1_loss[-1][key]:.4f} ms = {sum(x[key] for x in b1_loss):.4f} ms"
        for key, what in (("loss_ms", "kernel_ms"),
                          ("call_loss_ms", "call_ms")))
    print(f"B1 LOSS over every distinct block, {sums}; over "
          f"{sum(x['launches'] for x in b1_loss)} launches of "
          f"{sum(x['timed_blocks'] for x in b1_loss)} blocks (timing "
          f"{sum(x['timing_s'] for x in b1_loss):.1f}s); B2 on the LM lane "
          f"{lm['loss']['B2']['loss_ms']:.4f} ms over "
          f"{lm['loss']['B2']['launches']} launches of "
          f"{lm['loss']['B2']['timed_blocks']} blocks", flush=True)
    model = run_model_kernels()
    torch.cuda.empty_cache()
    decode = run_decode_attention()
    model["cases"]["decode_attention"] = decode["rows"]
    model["launches"]["decode_attention"] = (decode["launches"]
                                             + lm["decode"]["launches"])
    for row in decode["rows"]:
        row["max_abs_err"] = max(row["max_abs_err"],
                                 lm["decode"]["max_abs_err"])
    rwkv = run_rwkv()
    torch.cuda.empty_cache()
    for name, n in rwkv["launches"].items():
        model["launches"][name] += n
    for (name, _), (err_o, _, err_s, _) in rwkv["held"].items():
        for row in model["cases"][name]:
            row["max_abs_err"] = max(row["max_abs_err"], err_o, err_s)
    families = run_families()
    torch.cuda.empty_cache()
    model["cases"]["flash_attention"].extend(families["rows"])
    moe = run_moe()
    torch.cuda.empty_cache()
    for name, rows in moe["rows"].items():
        model["cases"][name].extend(rows)
    for res in (families, moe):
        for name, n in res["launches"].items():
            model["launches"][name] += n
        for name, err in res["max_abs_err"].items():
            for row in model["cases"][name]:
                row["max_abs_err"] = max(row["max_abs_err"], err)
    train = run_train(lazy, codegen)
    torch.cuda.empty_cache()
    model["launches"]["flash_attention"] += train["launches"]
    model["cases"]["flash_attention"].append(train["row"])
    for row in model["cases"]["flash_attention"]:
        row["max_abs_err"] = max(row["max_abs_err"], train["max_abs_err"])
    loop = run_loop(lazy, codegen)
    torch.cuda.empty_cache()
    launch_s = launch_cost_s(lazy, codegen)
    print(f"LAUNCH_COST fused_block wrapper call at n=1024: "
          f"{launch_s * 1e6:.2f} us", flush=True)
    a7_launches = run_a7(launch_s)
    torch.cuda.empty_cache()
    fma = run_fma(lazy, codegen, programs, floors)
    del floors
    torch.cuda.empty_cache()
    serve_launches = run_serve(lazy, codegen)
    torch.cuda.empty_cache()
    mesh = run_mesh(lazy, codegen, train["losses"])
    run_dryrun(dry, mesh)
    for name, n in mesh["launches"].items():
        model["launches"][name] += n
    for name, (err, _) in mesh["held"].items():
        for row in model["cases"][name]:
            row["max_abs_err"] = max(row["max_abs_err"], err)
    kernels = {"kernels": [{
        "name": "fused_block",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_block/codegen.py",
        "replaces": "src/repro/kernels/fused_block/codegen.py:475",
        "launches": (launches + lm["launches"]["fused_block"]
                     + loop["launches"] + a7_launches + fma["launches"]
                     + serve_launches
                     + train["b1_launches"] + mesh["b1"]),
        "max_abs_err": max(worst, lm["b1"]["max_abs_err"]),
        "ms": overall["ms"],
        "plain_ms": overall["plain_ms"],
        "bound_ms": overall["bound_ms"],
        "bound_by": overall["bound_by"],
        "library_ms": None,
    }, {
        "name": "rowblock",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_block/rowblock.py",
        "replaces": "src/repro/kernels/fused_block/rowblock.py:242",
        "launches": lm["launches"]["rowblock"],
        "max_abs_err": lm["b2"]["max_abs_err"],
        "ms": lm["norm"]["ms"],
        "plain_ms": lm["norm"]["plain_ms"],
        "bound_ms": lm["norm"]["bound_ms"],
        "bound_by": lm["norm"]["bound_by"],
        "library_ms": lm["norm"]["library_ms"],
    },
        _model_entry("flash_attention", "cuda",
                     "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention/kernel.py:81", model),
        _model_entry("rmsnorm", "triton",
                     "src/repro_torch/kernels/rmsnorm/kernel.py",
                     "src/repro/kernels/rmsnorm/kernel.py:36", model),
        _model_entry("mamba_scan", "cuda",
                     "src/repro_torch/csrc/mamba_scan.cu",
                     "src/repro/kernels/mamba_scan/kernel.py:48", model),
        _model_entry("rwkv6_scan", "cuda",
                     "src/repro_torch/csrc/rwkv6_scan.cu",
                     "src/repro/kernels/rwkv6_scan/kernel.py:52", model),
        _model_entry("rwkv6_chunked", "cuda",
                     "src/repro_torch/csrc/rwkv6_chunked.cu",
                     "src/repro/kernels/rwkv6_scan/kernel_chunked.py:70",
                     model),
        _model_entry("decode_attention", "cuda",
                     "src/repro_torch/csrc/decode_attention.cu", None,
                     model)]}
    print(json.dumps(kernels))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
