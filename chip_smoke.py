"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
then drives the main path — the ISLA admission loop on ``route="device"``
over 1000 blocks x 16 groups x 20000 rows — twice: once with the four
moment aggregates on the four serving keys (the moment-only tick), once
with COUNT DISTINCT on the four keys added (the sketch stack's tick).
For each run it checks that it ran through the kernels (launch counts
reset just before, read just after) and that its answers agree with the port's float64 ``route="host"`` on
the same queries and seed (COUNT DISTINCT exactly: the register planes
are bit-identical).  It keeps a copy of every value pane the loop folded
and every hash pane it merged into the HLL registers, and replays each
fold and each register merge, kernel against plain PyTorch version, on
those very panes and times both; it also holds the fold at the tick's
shape with synthetic 64- and 4096-sample panes, and times every
Pallas-signature wrapper against its plain version.  Each run's cold plan
must make exactly one pilot kernel launch.  The pilot kernel is held
against its plain version and timed at the loop's pilot size and at
10^5, 10^6 and 10^7 samples (beside the card's smallest launch at the
loop's size), with the device pilot's host time and its stages; one
device-route plan at a precision tight enough for a pilot of at least
100,000 samples reports its pilot's size and seconds.

Then the same loop twice more with the torch default dtype float64 (set
for the run, restored after it), so every key's store runs float64 and
each drawing tick folds one tagged stream of every key's samples with
``isla_tagged_fold`` by the stream's (key, block) run table (and, with
COUNT DISTINCT, merges it with ``isla_sketch_tagged``): one launch each a
tagged fold, no dense launch, one pilot launch a run; a profiled re-run
of each loop must show the run kernel once a drawing tick and no sort
kernel.  A host-route run of the same loop under the same anchor (the
host route takes the device pilot too) must hold every key's moment
rows, totals, draw ledger and register plane bit for bit, and the
partials must equal Phase 2 run on the CPU over the card's state (their
gaps to the host solve are counted in ulps; the cells the division
repair moved are counted in every run, fp32 too).  Each tick's tagged
fold is replayed on both paths, the run table and the stable sort, each
against its plain version run on the CPU over the same tensors, bit for
bit, and timed beside its bound (and the same stream folded at fp32);
each merge likewise.

Then the same four loops (moments and distinct, fp32 and float64) on
``route="mesh"``: the cell axis split by block runs over four shards,
all on ``cuda:0``, each shard launching the tick kernels on its own rows.
It checks one launch of each tick kernel a shard a drawing tick and one
pilot launch a run, and each tick's cross-device steps: one sum of the
O(groups) stat rows (and with COUNT DISTINCT one max of the folded
register rows) a drawing tick, nothing of O(cells).  The fp32 answers
must agree with the host route's as the device route's do; a float64 run
is held to a device-route run of the same loop made beside it: every
key's moment rows, totals, draw ledgers, register plane and partials bit
for bit.  Each mesh tick's stage times print beside the device route's.

Then the pipelined tick: the loop's batch under two modes (two mode
groups, two stacks) through ``MultiQueryExecutor.run(pipeline=True)``
with ``chunk_blocks=250`` (four chunks a group, their ticks on the
launch worker thread, the stat rows read back through pinned buffers and
CUDA events), five runs: moments and distinct, fp32 and float64, on the
device route, and distinct float64 on the four-shard mesh.  Each is held
to a serial run of the same seeds made beside it: the same launches
tick by tick, and every answer, draw ledger, moment row, total,
register plane and partial bit for bit (fp32: wherever a second serial
run repeats the first; the gaps are printed).  Each tick's stage
seconds and wall time print beside the serial run's.  One pipelined
top-up tick is profiled with every thread traced: its ``isla:launch``
ranges must lie on the launch worker, some under a main-thread
``isla:draw``, and its trace must hold every ISLA kernel it launched.

Then the float64 dense tick ("isla float64 dense"): ``isla_fold``'s
float64 form on the four keys at (1000, 512) and (1000, 1024), held
within rel 1e-12 of its plain version run on the CPU, two launches bit
for bit, and timed beside the fp32 form on the same panes; then
``DeviceStack.tick(dense=...)`` on float64 stores at the main path's
stack shape (4 keys x 16 groups x 1000 blocks, 34,000 cells, on the
loop's tables), three zone-pruned ticks of 954 samples a drawn block
(the even blocks, the odd ones, the even ones again), moments alone and
with a register plane.  Each drawing tick must make one float64 fold
launch (and one ``isla_sketch``) and no fp32 fold; a
``block_compaction=False`` twin and a four-shard mesh on ``cuda:0``
must give the same bits (state, ledgers, register planes, partials),
and a float64 tagged run of the same samples must lie within rel 1e-12
(ledgers and registers bit for bit).  A profiled re-run of the second
tick must hold the fold's kernel and no sort kernel, and each tick's
fold is replayed against its plain version on the CPU and timed.

Then the telemetry estimator ("isla telemetry"): on seeded gamma(2, 2)
per-token losses of (512, 2048) and (4096, 4096) tokens, ``loss_stats``
(empirical, rate 0.05, with the exact mean), ``isla_mean`` in both
semantics and both modes at rate 0.02, strided and drawn by a CUDA
``torch.Generator``, ``exact_mean`` and ``loss_stats_trimmed_exact``, on
the device route and on four shards on ``cuda:0`` (the tensor cut on dim
0); then ``telemetry_bench.py``'s normal(5.5, 1.5) tensor and
``router_load_stats`` on softmax probabilities over arctic-480b's
experts.  Each call must launch ``isla_fold`` once a shard (an ISLA
call) and no other kernel, upload nothing through ``h2d``, reduce 3, 6
(empirical), then 8 (merged) or 2 (blocks) floats across shards (the
same at both sizes), and agree within rel 1e-5 with the same call under
the plain versions and with the port on the CPU (generator calls: the
plain versions only).  The phase's fold panes are replayed against the
plain fold and timed beside their bound; every call is timed (CUDA
events).  After the LM phase, ``grad_abs_stats`` runs over its olmo-1b
parameter tree, on the device route and on the mesh.

Then it drives the LM serving path: olmo-1b at full width and depth
(16 layers, d_model 2048, 16 heads of 128) in bf16 from a seeded
generator, six seeded prompts of 384-2048 tokens through a
``BatchScheduler`` of four slots, 16 new tokens each.  It checks that
every prefill ran its attention through the hand-written
``flash_attention`` kernel (one launch per layer per prefill; counts
reset just before, read just after), keeps the q, k, v of every one of
those calls and replays the kernel against its plain version on them,
timing the kernel, the plain version and PyTorch's
``scaled_dot_product_attention`` (the library yardstick; the port never
calls it).  It also holds the kernel on GQA, MQA, fp32 and every
head_dim it takes, and a reduced olmo-1b on the card against the CPU.

Then the VLM path: paligemma-3b at full width and depth (18 layers,
d_model 2048, 8 heads of 256 over one KV head) in bf16 from a seeded
generator, served as the reference serves a frontend config: two
prefills through ``serve_prefill`` with 256 seeded patch embeddings
(``synth_frontend_embeds``) before 767 tokens at batch 2 and 1791 at
batch 1 (S = 1023 and 2047), each followed by 8 greedy ``serve_decode``
steps.  It checks one ``flash_attention`` launch per layer of each
prefill, replays each of those calls against the plain version and times
it beside SDPA (``enable_gqa``).  The flash library's SASS
(``cuobjdump``) must show ``wgmma`` (HGMMA) and TMA loads (UTMALDG), and
no ``mma.sync`` (HMMA), in every bf16 instantiation, and its ``-Xptxas
-v`` log no spill.

Then the MoE path ("lm moe"): grok-1-314b (2 layers) and arctic-480b (1
layer) at full width, the depth cut so that one 80 GB card holds each,
one after the other (each model's parameters freed before the next is
built), in bf16 from a seeded generator: six seeded prompts of
384-2048 tokens (every other one on the 256-token routing group, the
rest falling back to one group) through a ``BatchScheduler`` of four
slots, 8 new tokens each.  It checks one ``flash_attention`` launch per
layer of each prefill and no ISLA kernel, that every decode step routes
all four slots, holds ``moe._route`` of the main path's own router
logits on the card against ``_route`` run on the CPU on the same logits
(every prefill and one decode tick: ``dispatch`` identical but for
counted fp32 near-ties, ``combine`` within rel 1e-6), and the card's
``apply_moe`` on a grouped prefill, a fallback one and a decode step
against a per-token gather formulation (within 2e-2 of the output's
scale); it prints each model's parameter count, init seconds and peak
memory, prefill seconds a request, decode tick seconds, tokens/s and,
from one profiled decode tick, its device events and busy share, and
replays every flash call beside SDPA (48 q heads over 8 KV heads, and
56 over 8).  The MoE models are freed before the next phase.

Then the Mamba path ("lm mamba"): mamba2-130m at full width and depth (24
layers, d_model 768, 24 SSD heads of 64, d_state 128, chunk 256) in bf16
from a seeded generator, six seeded prompts through a ``BatchScheduler``
of four slots, 16 new tokens each; every other prompt a multiple of the
chunk of two chunks or more, the rest shorter than a chunk (the
reference's chunk contract).  It checks no ``flash_attention`` and no
ISLA launch, holds every prefill's layer-0 ``ssd_chunked`` against the
O(S^2) ``ssd_reference`` and a closed-form final state on the card on its
own inputs (2e-2 of scale), a 512-token prefill and the next decode tick
against the same weights in fp32 on the CPU (every Mamba call and the LM
head again on the card's own inputs, 2e-2 of scale; the weights in fp32
on the card, end to end, logits, h and conv rows within 1e-4 of scale;
the bf16 run's end-to-end gap printed: bf16 roundings compound over 24
layers, in the reference as here), and prefill(252) + 4 decode steps
against prefill(256) (the reference's own contract, rtol and atol 2e-2,
held in fp32 and printed in bf16); it prints the parameter count, init
seconds, peak memory, prefill seconds a request, decode tick seconds,
tokens/s and one profiled decode tick's device events and busy share
(read only when the trace holds a kernel for every matrix product the
tick's host side made).  Then jamba's
hybrid stack (7 Mamba, 1 attention, MoE on odd positions) at its reduced
config (8 layers, d_model 128) in bf16 and fp32 through the scheduler:
one ``flash_attention`` launch per prefill, no ISLA kernel, the same
SSD checks, the flash calls replayed beside SDPA, and in fp32 a prefill
on the 64-token routing group and one off it, each with its next decode
step, against the CPU within 1e-4 of scale (a router near-tie that takes
another expert is counted).  One full-width period of jamba (8 layers) is
90.29 GB in bf16, more than one card holds.

Then the training path ("lm train"; the earlier models freed first, the
bytes still held printed): olmo-1b at full width and depth (16 layers,
1.177 B parameters) in bf16 with remat, from a seeded generator, takes 8
``train_step``s of AdamW on the port's ``SyntheticStream`` at 4 x 1024
tokens (two CE chunks of 512), each timed; every loss, ``grad_norm`` and
telemetry value must be finite, the steps must launch ``isla_fold``
exactly once each (the default ISLA loss telemetry; counts reset just
before, read just after) and no other kernel (no ``flash_attention``:
training attention is plain torch ops, as the reference's is jnp).  It
prints the loss trajectory, step seconds, tokens/s, peak memory and
``loss_mean_isla`` beside ``loss_mean_exact``, and profiles one more step
(taken again until its trace holds a device event for every matrix
product and the fold's kernel): its device events, busy share and top
kernels.  One step at 1 x 8192 tokens must take ``_blocked_attention`` at
block 1024 in every layer and its recompute, and stay finite.  The same
model cut to one layer, in fp32, takes one step on the card and one on
the CPU from the same weights and batch: metrics within rel 1e-5, the
moments and new params within 1e-5 of each leaf's scale (where the
gradient is near zero Adam's first step is held to 2 lr).  Reduced
olmo-1b in fp32 takes one step over 2 microbatches against one over the
whole batch (the same tolerances).  ``_blocked_attention`` at blocks 1024
and 512 is held against the dense formula in fp32 at (1, 2048, 16, 128),
outputs and q, k, v grads within 1e-5 of scale.  mamba2-130m at full
width and depth takes 4 steps at 4 x 512 in bf16 with remat (one fold a
step).  Reduced jamba and grok-1-314b in fp32 take one step on the card
against the CPU (metrics and the MoE aux losses within 1e-4, the routing
held by ``check_route``, near-ties counted).  Reduced olmo-1b takes the
reference's integration run on the card: 30 steps whose last five losses
average more than 0.2 below the first five, with a checkpoint at step 5
(``train.checkpoint``) restored into the abstract shapes and steps 5-9
replayed to within rtol 1e-5; the median ``|isla - exact|`` is printed.
In the olmo-1b, mamba2-130m and descent runs each step's loss telemetry
is replayed under the plain fold on that step's own per-token losses
(within rel 1e-5), and the first pane of each length the telemetry
folded is replayed by ``check_telemetry_folds``.  The ``kernels`` line's
``isla_fold`` entry includes the phase's launches, and its error, time
and bound those panes'.

Then the training CLI ("lm train cli"): ``python -m
repro_torch.launch.train`` on olmo-1b at full width and depth in a child
process that sees the smoke's card alone (run A: 6 steps at 4 x 1024,
``--telemetry-exact``, checkpoints every 4 steps, so steps 4 and 6 are
committed, 11.77 GB each); then a crash after step 4's commit, mid-write
of step 6 (run A's step 6 moved aside, a partial ``step_00000006.tmp``
left); then run B, the CLI's ``run`` in this process with ``--resume``:
it must print ``[resume] from step 4``, have removed the ``.tmp`` by its
first step, run steps 4 and 5 with one ``isla_fold`` launch each and no
other kernel (counts set to 0 just before, read just after) and commit
step 6.  Its rows (loss and every 0-d metric) and its step-6
checkpoint, leaf by leaf, must equal run A's bit for bit (two
uninterrupted runs of the CLI on the card agree bit for bit:
``tools/train_cli_repeat.py``).  It prints each step's seconds and
tokens/s, the restore, the checkpoint submit (the host copy) and write
seconds, the checkpoint's bytes and the peak memory before run B's first
step and in all.  The checkpoints live under the git-ignored
``_train_cli/``, whose free space must hold three of them, and are
removed when the phase ends.  Its fold launches join the ``kernels``
line's ``isla_fold``.

Then the sharded train step ("lm train mesh"): olmo-1b at full width
and depth (bf16, remat, TP on) takes 3 meshless steps at 4 x 1024, then
the same init and batches through ``launch.train.build_step`` over a
one-rank ``("data", "model")`` nccl mesh (a ``FileStore`` group,
destroyed at the end): one ``isla_fold`` launch a step (counts set to 0
just before, read just after), each step's telemetry replayed under the
plain fold; the sharded rows and final params and moments must equal the
meshless ones bit for bit, or else the reason is printed and a
one-layer fp32 sharded step must hold within ``TRAIN_TOL`` of the
meshless one.  Its step-2 state is saved (``checkpoint.save`` of the
DTensors, under the git-ignored ``_train_mesh/``), restored with
``shardings=`` and stepped again to the same bits.  It prints step
seconds and peak memory beside the meshless ones.  Where four cards are
visible (never on a one-card machine) it also spawns four nccl ranks
(``train_mesh_cards``): a (2, 2) mesh for 3 steps with each rank's peak,
step time and each collective's count and bytes, the meshless steps and
a one-layer fp32 pair beside them, and the elastic drill from (2, 2) to
(1, 2) at step 2.  Its fold launches join the ``kernels`` line's.

Then the dry run ("dryrun"): ``python -m repro_torch.launch.dryrun`` in
three child processes started together (olmo-1b's every shape on the
(16, 16) mesh, its train_4k on (2, 16, 16), mamba2-130m's long_500k on
(16, 16): rank 0 of a fake process group, fake CUDA tensors), each
cell ``ok`` (or the config's own skip) and each child's card bytes 0
over its cells; it prints each cell's FLOPs, bytes and collective bytes
a device, dominant term, bound and trace time.  Then olmo-1b at full
width and depth (bf16, remat) takes one real training step at 4 x 1024
and one real 1966-token prefill, each under ``roofline.op_cost.
CostCounter``, beside the same call traced on fake tensors: FLOPs,
bytes, every op's count and the kernel records must be equal (one
``isla_fold`` record; one ``flash_attention`` record a layer at row 8's
operations); the step's bound is printed beside the "lm train" phase's
warm step.  Then its prefill and two decode steps on a one-rank mesh
must equal the meshless ones bit for bit with equal flash launches
(counts set to 0 before the real calls, read after; they join the
``kernels`` line's).

Every profiled window (the kernel timings, the profiled ticks and
steps) is padded by 20 ms of host time at each end, inside the window
(the card's timestamps part from the host's by up to 0.41 ms, and the
profiler keeps only the device events inside its host-side window),
and opens with 64 one-cycle spins that no
reading counts (a window drops its first device records, up to 14
seen).  The smoke prints how many windows each measurement
took and how many lead spins the windows lost.

Every failure exits nonzero.  The last three lines of standard output
are the card's name and power limit, one JSON object describing every
kernel, and the result object; details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
FOLD_SOURCE = "src/repro_torch/kernels/csrc/isla_kernels.cu"


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


SLEEP_CYCLES_PER_S = 2.0e9    # above the H100's SM clock: sleeps err long


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` warmed calls, CUDA events.
    The card spins (``torch.cuda._sleep``) while the host enqueues the
    timed calls, so a call that takes the card less time than the host
    takes to issue it is timed by the card's work, not the host's."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * reps * host_s, 0.5)
                          * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_TRIES = 3       # windows a measurement takes when events go astray
PROFILE_GAP_S = 0.005   # host pause between the last work and a window
PROFILE_LEAD_S = 1e-4   # a launch worker's mark spin (mark_threads)
# Two ways a window lost device events on the card.  The profiler keeps
# an event only inside its window on the host's clock, and the card's
# timestamps part from the host's: a kernel was stamped up to 0.41 ms
# before its own launch, so a short window
# whose events all shift past an edge keeps none; every window therefore
# pauses PROFILE_PAD_S on the host after it opens and, synchronised,
# before it closes, inside the window.  And a window drops its first
# device records, kernels and copies alike, whatever their time: up to 14
# seen, and 0-11 of the lead spins below in 98 of 104 windows of one smoke
# (chip_smoke.json's profiled_windows); so every window opens with
# PROFILE_LEAD_KERNELS one-cycle spins that the reading of a trace leaves
# out.
PROFILE_PAD_S = 0.02
PROFILE_LEAD_KERNELS = 64
SPIN = "spin_kernel"    # torch.cuda._sleep's kernel: never counted
# One entry a kernel_events measurement: the windows it took and, for
# each window, the events and the lead spins it kept and, when it was not
# whole, its device events by name.
WINDOW_LOG: "list[dict]" = []


def padded_profile(**kw):
    """A ``torch.profiler.profile`` over ``kw`` padded by ``PROFILE_PAD_S``
    of host time at each end, inside the window, the card synchronised
    before the closing pause, and opened by ``PROFILE_LEAD_KERNELS``
    one-cycle spins (``device_events`` leaves them out)."""
    import torch
    from torch.profiler import profile

    class Padded(profile):
        def __enter__(self):
            super().__enter__()
            time.sleep(PROFILE_PAD_S)
            for _ in range(PROFILE_LEAD_KERNELS):
                torch.cuda._sleep(1)
            return self

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            return super().__exit__(*exc)

    return Padded(**kw)


def kernel_events(fn, names, reps: int = 20, warm: int = 3, setup=None):
    """The profiler's device events of the kernels whose names contain one
    of ``names`` over ``reps`` calls of ``fn``, each after ``setup()`` when
    given (untimed unless it runs such a kernel): ``(mean device ms a call
    or None when the trace holds no such event, events a call)``.

    A window can drop device records on the card (``PROFILE_PAD_S``), so
    each is padded and opened by spins that are never counted
    (``padded_profile``), and a window whose events are not a whole
    number a call is taken again, up to ``PROFILE_TRIES`` windows (the
    last one is reported; ``WINDOW_LOG`` gets what each window kept)."""
    events = window_events(fn, names, reps, warm, setup)
    us = [t for _, t in events]
    return (sum(us) / reps * 1e-3 if us else None), len(us) / reps


def window_events(fn, names, reps: int = 20, warm: int = 3, setup=None):
    """``kernel_events``'s window: the ``(name, us)`` of each device event
    whose name contains one of ``names`` over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity

    for _ in range(warm):
        if setup is not None:
            setup()
        fn()
    log = dict(reps=reps, windows=[])
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        time.sleep(PROFILE_GAP_S)
        with padded_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if setup is not None:
                    setup()
                fn()
            torch.cuda.synchronize()
        device = device_events(prof)
        kept = [e for e in device if any(n in e.name for n in names)]
        events = [(e.name, e.time_range.elapsed_us()) for e in kept]
        whole = bool(events) and len(events) % reps == 0
        spins = sum(1 for e in prof.events() if SPIN in e.name)
        counts = {}
        for e in device if not whole else ():
            counts[e.name[:70]] = counts.get(e.name[:70], 0) + 1
        log["windows"].append(dict(events=len(kept), lead_spins=spins,
                                   names=counts))
        if whole:
            break
    log["tries"] = tries
    WINDOW_LOG.append(log)
    return events


def kernel_ms(fn, names, reps: int = 20, warm: int = 3, setup=None):
    """Mean device milliseconds a call of ``fn`` spends in the kernels
    whose names contain one of ``names`` (``kernel_events``)."""
    return kernel_events(fn, names, reps, warm, setup)[0]


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# ---------------------------------------------------------------------------
# Kernel A: the dense fold at the serving tick's shapes.
# ---------------------------------------------------------------------------

# The serving tick's four keys (plain, WHERE, GROUP BY, WHERE + GROUP BY)
# over 16 groups x 1000 blocks: 34,000 cells.
FOLD_KEYS = ((1, False), (1, True), (16, False), (16, True))


def fold_case(device, n_blocks: int, quota: int, seed: int = 0,
              dtype=None):
    """The panes and resident rows one tick folds: value, pad, GROUP BY
    and predicate panes (n_blocks, quota), one bounds row, prior rows;
    values, bounds and rows of ``dtype`` (fp32 by default), the masks
    fp32.  One seed gives the same numbers at either dtype."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_groups = max(g for g, _ in FOLD_KEYS)
    dtype = dtype or torch.float32

    def dev(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device=device).contiguous()

    shape = (n_blocks, quota)
    case = dict(
        values=dev(rng.normal(1.0, 0.25, shape), dtype),
        pad=torch.ones(shape, dtype=torch.float32, device=device),
        gid=dev(rng.integers(0, n_groups, shape), torch.int32),
        valid=dev(rng.random(shape) < 0.5),
        bounds=dev([0.5, 0.875, 1.125, 1.5], dtype),
        n_cells=sum(g * n_blocks for g, _ in FOLD_KEYS))
    case["prior"] = dev(rng.uniform(0, 50, (case["n_cells"], 11)), dtype)
    return case


def fold_tick(fold, case, state) -> None:
    """One tick's fold: a launch per key onto its rows of ``state``."""
    n_b = case["values"].shape[0]
    o = 0
    for g, where in FOLD_KEYS:
        rows = state[o:o + g * n_b]
        fold(case["values"], case["bounds"], rows[:, 0:4], rows[:, 4:8],
             rows[:, 8:11], pad=case["pad"],
             valid=case["valid"] if where else None,
             gid=case["gid"] if g > 1 else None, n_groups=g)
        o += g * n_b


def fold_stack_tick(case, state) -> None:
    """The same tick's fold through ``fold_panes``: one launch folds all
    four keys onto their rows of ``state``."""
    from repro_torch.core import distributed as D

    D.fold_panes(state[:, 0:4], state[:, 4:8], state[:, 8:11],
                 case["values"], case["pad"], (case["gid"],),
                 (case["valid"],), case["bounds"],
                 n_groups_list=tuple(g for g, _ in FOLD_KEYS),
                 gid_slots=tuple(0 if g > 1 else -1 for g, _ in FOLD_KEYS),
                 valid_slots=tuple(0 if w else -1 for _, w in FOLD_KEYS))


def panes_bound_ms(values2d, pad_valid, gid_panes, valid_panes, bounds,
                   n_cells: int, n_keys: int, cell_idx=None
                   ) -> "tuple[float, float]":
    """Least time for one ``fold_panes`` call on this run's data: every
    real (unpadded) sample's value (4 B, 8 at float64), pad, GROUP BY and
    predicate entries (4 B each) read once, the cuts and the cell map read
    once, the addressed resident rows (of the values' type) read and
    written once; against the work of every key on every real sample (4
    compares, 2 muls, 11 adds) at the fp32 or float64 peak.  Returns the
    milliseconds the bytes take and those the operations take."""
    wide = values2d.element_size() if values2d.element_size() == 8 else 4
    n_real = int(pad_valid.count_nonzero())
    n_panes = 1 + len(gid_panes) + len(valid_panes)
    in_bytes = (wide + 4 * n_panes) * n_real + wide * bounds.numel()
    if cell_idx is not None:
        in_bytes += 4 * cell_idx.numel()
    row_bytes = 2 * wide * 11 * n_cells
    t_bytes = (in_bytes + row_bytes) / HBM_BYTES_PER_S * 1e3
    peak = FP64_FLOP_PER_S if wide == 8 else FP32_FLOP_PER_S
    t_ops = 17 * n_real * n_keys / peak * 1e3
    return t_bytes, t_ops


def check_fold(device, n_blocks: int, quota: int) -> dict:
    import torch
    from repro_torch.kernels import isla_moments as K
    from repro_torch.kernels import ref

    case = fold_case(device, n_blocks, quota)
    want = case["prior"].clone()
    fold_tick(ref.isla_fold_ref, case, want)
    err, rel = 0.0, 0.0
    # The tick's fold through the stacked entry (one launch) and through
    # the one-key entry (a launch per key), each twice.
    for tick in (fold_stack_tick, lambda c, st: fold_tick(K.isla_fold, c,
                                                          st)):
        got, again = case["prior"].clone(), case["prior"].clone()
        tick(case, got)
        tick(case, again)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "isla_fold is not deterministic")
        err = max(err, max_abs_err(got, want))
        rel = max(rel, float(((got.double() - want.double()).abs()
                              / want.double().abs().clamp_min(1.0)).max()))
    check(rel <= 1e-5, f"isla_fold disagrees with its plain version at "
                       f"quota {quota}: max rel err {rel:.3g} > 1e-5")
    scratch = case["prior"].clone()
    ms = time_ms(lambda: fold_stack_tick(case, scratch))
    per_key_ms = time_ms(lambda: fold_tick(K.isla_fold, case, scratch))
    plain_ms = time_ms(lambda: fold_tick(ref.isla_fold_ref, case, scratch),
                       reps=5, warm=1)
    t_bytes, t_ops = panes_bound_ms(
        case["values"], case["pad"], (case["gid"],), (case["valid"],),
        case["bounds"], n_cells=case["n_cells"], n_keys=len(FOLD_KEYS))
    bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")
    return dict(quota=quota, n_blocks=n_blocks, cells=case["n_cells"],
                samples=case["values"].numel(), max_abs_err=err,
                max_rel_err=rel, tolerance="rel 1e-5", ms=ms,
                per_key_ms=per_key_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, launches_per_tick=1)


class Recorder:
    """Counts the calls the main path makes to ``<module>.<name>``
    (``module``: ``core.distributed`` when None) and, with ``keep``,
    keeps a copy of the arguments of every one (``fold_panes``: the value
    panes and the resident rows just before the fold; ``sketch_panes``:
    the hash panes and the resident register plane just before the merge),
    by wrapping it while installed.  A callable ``keep`` keeps only what
    it returns for the call's arguments."""

    def __init__(self, name: str, keep=True, module=None):
        self.name = name
        self.keep = keep
        self.module = module
        self.count = 0
        self.calls = []

    def __enter__(self):
        if self.module is None:
            from repro_torch.core import distributed as D
            self.module = D
        self._real = real = getattr(self.module, self.name)

        def clone(x):
            if hasattr(x, "_fields"):  # a NamedTuple (TaggedRuns)
                return type(x)(*(clone(v) for v in x))
            if isinstance(x, (tuple, list)):
                return type(x)(clone(v) for v in x)
            if isinstance(x, dict):
                return {k: clone(v) for k, v in x.items()}
            return x.clone() if hasattr(x, "clone") else x

        def spy(*args, **kw):
            self.count += 1
            if callable(self.keep):
                self.calls.append(self.keep(*args, **kw))
            elif self.keep:
                self.calls.append(dict(args=clone(args), kw=clone(kw)))
            return real(*args, **kw)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._real)
        return False


class PlainVersions:
    """While installed, every kernel wrapper takes its plain PyTorch
    version for card tensors too (``on_gpu`` answers False), so a plain
    replay or a plain time is the same call on the same card tensors.
    Calls made under it launch nothing and count nothing."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import isla_moments as K

        self._mods = (K, FA)
        self._real = K.on_gpu
        for m in self._mods:
            m.on_gpu = lambda t: False
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.on_gpu = self._real
        return False


def check_main_path_folds(calls) -> "list[dict]":
    """Replay each fold of the main path on a copy of its rows: the kernel
    (twice: identical bits) against its plain version on the very panes
    the serving tick folded, then both timed, with the call's bound.  A
    float64 pane's plain version runs on the CPU (timed by the host
    clock) and is held within rel ``DENSE64_TOL``; an fp32 pane's on the
    card, within rel 1e-5."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import isla_moments as K

    out = []
    for c in calls:
        state, panes = c["args"][:3], c["args"][3:]
        kw = c["kw"]
        values2d = panes[0]
        f64 = values2d.dtype == torch.float64
        tol = DENSE64_TOL if f64 else 1e-5

        def fold_into(rows, panes=panes, kw=kw):
            D.fold_panes(*rows, *panes, **kw)

        def run(state=state, fold_into=fold_into):
            rows = [t.clone() for t in state]
            fold_into(rows)
            return torch.cat(rows, dim=1)

        got, again = run(), run()
        if f64:
            host_state, host_panes, host_kw = to_device((state, panes, kw))
            t0 = time.perf_counter()
            want = run(host_state, functools.partial(
                fold_into, panes=host_panes, kw=host_kw))
            plain_ms = (time.perf_counter() - t0) * 1e3
        else:
            with PlainVersions():
                want = run()
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              "isla_fold is not deterministic on the main path's panes")
        got = got.to(want.device)
        rel = float(((got.double() - want.double()).abs()
                     / want.double().abs().clamp_min(1.0)).max())
        check(rel <= tol, f"isla_fold disagrees with its plain version on "
                          f"the main path's {tuple(values2d.shape)} "
                          f"{values2d.dtype} pane: max rel err {rel:.3g} > "
                          f"{tol}")
        scratch = [t.clone() for t in state]
        event_ms = time_ms(lambda: fold_into(scratch))
        dev_ms = kernel_ms(lambda: fold_into(scratch), ("isla_fold",))
        if not f64:
            with PlainVersions():
                plain_ms = time_ms(lambda: fold_into(scratch), reps=5,
                                   warm=1)
        g_list = kw["n_groups_list"]
        n_b = values2d.shape[0]
        active = kw.get("active_cells")
        _, _, stage = K.fold_stage(values2d.shape[1], D.stack_keys(
            n_b, g_list, kw["gid_slots"], kw["valid_slots"]),
            values2d.element_size() if f64 else 4)
        t_bytes, t_ops = panes_bound_ms(
            *panes, n_cells=sum(g * n_b for g in g_list),
            n_keys=len(g_list),
            cell_idx=None if active is None else active[0])
        out.append(dict(pane=list(values2d.shape), keys=len(g_list),
                        groups=list(g_list),
                        real_samples=int(panes[1].count_nonzero()),
                        compacted=active is not None,
                        dynamic_smem_bytes=stage,
                        max_abs_err=max_abs_err(got, want), max_rel_err=rel,
                        tolerance=f"rel {tol}",
                        ms=event_ms if dev_ms is None else dev_ms,
                        kernel_ms=dev_ms, event_ms=event_ms,
                        plain_ms=plain_ms, bytes_ms=t_bytes, ops_ms=t_ops,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations"))
    return out


# ---------------------------------------------------------------------------
# Kernel C: the HLL register merge on the main path's hash panes.
# ---------------------------------------------------------------------------

PLAIN_REPS_LANE_CAP = 10_000_000  # wider panes: one plain replay, not five
SKETCH_OPS_PER_LANE = 30          # mix (3 64-bit muls as 32-bit IMADs,
                                  # shifts, xors), clz, shared max


def sketch_bound_ms(pad_valid, gid_panes, valid_panes, n_keys: int,
                    changed_regs: int) -> "tuple[float, float]":
    """Least time for one ``sketch_panes`` call on this run's data: every
    live lane's 8 bytes of raw bits and its pad, GROUP BY and predicate
    entries read once, and each register the merge raised read and
    written once (1 byte each); against ~30 integer operations per live
    lane and key at the guide's fp32 non-tensor peak (it lists no
    integer rate).  Returns the milliseconds the bytes take and those the
    operations take."""
    n_real = int(pad_valid.count_nonzero())
    in_bytes = n_real * (8 + 4 + 4 * (len(gid_panes) + len(valid_panes)))
    reg_bytes = 2 * changed_regs
    t_bytes = (in_bytes + reg_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = SKETCH_OPS_PER_LANE * n_real * n_keys / FP32_FLOP_PER_S * 1e3
    return t_bytes, t_ops


def check_main_path_sketches(calls) -> "list[dict]":
    """Replay each register merge of the main path on a copy of its
    plane: the kernel (twice: identical bits) against its plain version
    on the very hash panes the serving tick merged — bit for bit — then
    both timed, with the call's bound."""
    import torch
    from repro_torch.core import distributed as D

    out = []
    for c in calls:
        regs0, panes = c["args"][0], c["args"][1:]
        kw = c["kw"]

        def merge(regs):
            D.sketch_panes(regs, *panes, **kw)

        def run():
            regs = regs0.clone()
            merge(regs)
            return regs

        got, again = run(), run()
        with PlainVersions():
            want = run()
        torch.cuda.synchronize()
        bits = panes[0]
        check(torch.equal(got, again),
              "isla_sketch is not deterministic on the main path's panes")
        check(torch.equal(got, want),
              f"isla_sketch disagrees with its plain version on the main "
              f"path's {tuple(bits.shape)} hash pane")
        raised = got != regs0
        touched = int(raised.any(dim=1).sum())
        changed = int(raised.sum())
        scratch = regs0.clone()
        # Each timed merge starts from the plane the tick found (a repeat
        # on the merged plane would time the skip path alone); the events
        # time repeats on the merged plane.
        dev_ms = kernel_ms(lambda: merge(scratch), ("isla_sketch",),
                           setup=lambda: scratch.copy_(regs0))
        event_ms = time_ms(lambda: merge(scratch))
        plain_reps = 1 if bits.numel() > PLAIN_REPS_LANE_CAP else 5
        with PlainVersions():
            plain_ms = time_ms(lambda: merge(scratch), reps=plain_reps,
                               warm=1)
        g_list = kw["n_groups_list"]
        t_bytes, t_ops = sketch_bound_ms(*panes[1:4], n_keys=len(g_list),
                                         changed_regs=changed)
        out.append(dict(pane=list(bits.shape), keys=len(g_list),
                        groups=list(g_list),
                        live_lanes=int(panes[1].count_nonzero()),
                        touched_cells=touched, changed_registers=changed,
                        compacted=kw.get("active_cells") is not None,
                        max_abs_err=max_abs_err(got, want),
                        tolerance="0 (bit-identical)",
                        ms=event_ms if dev_ms is None else dev_ms,
                        kernel_ms=dev_ms, repeat_event_ms=event_ms,
                        plain_ms=plain_ms, plain_reps=plain_reps,
                        bytes_ms=t_bytes, ops_ms=t_ops,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations"))
    return out


# ---------------------------------------------------------------------------
# The Pallas-signature wrappers, each against its plain version.
# ---------------------------------------------------------------------------


def check_wrappers(device, n_cells: int = 1000, lanes: int = 1024,
                   n_groups: int = 16) -> "list[dict]":
    """Every Pallas-signature wrapper at the serving loop's widest pane
    (``n_cells`` blocks x ``lanes`` samples, as (n_cells, lanes/128, 128)
    tiles), each held against its plain version on the same card tensors
    (moments rel 1e-5, registers bit for bit) and both timed, with the
    byte bound of what the call reads and writes."""
    import numpy as np
    import torch
    from repro_torch.core.types import IslaParams
    from repro_torch.kernels import isla_moments as K

    rng = np.random.default_rng(3)
    rows = lanes // 128
    shape = (n_cells, rows, 128)
    raw = np.round(rng.normal(100, 20, shape))
    bits = raw.view(np.uint64)

    def dev(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    x = dev(raw, torch.float32)
    hi = dev((bits >> np.uint64(32)).astype(np.uint32).view(np.int32))
    lo = dev((bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
             .view(np.int32))
    valid = dev((rng.random(shape) < 0.9).astype(np.int32))
    bounds = dev([60.0, 90.0, 110.0, 140.0], torch.float32)
    prior = dev(rng.uniform(0, 50, (n_cells, 2, 4)), torch.float32)
    prior_regs = dev(rng.integers(0, 8, (n_cells, 32, 128)), torch.uint8)
    grouped = dev(np.round(rng.normal(100, 20, (n_groups,) + shape)),
                  torch.float32)
    params = IslaParams(e=0.5)
    n = x.numel()
    mom_rw = 2 * 4 * 8  # a (2, 4) fp32 cell row read and written
    def raised(out):  # registers the merge raised, each read and written
        return 2 * int((out[1] != prior_regs).sum())

    # name: (values shape, call, bytes it must move given its outputs)
    cases = {
        "isla_moments": (
            (n_cells * rows, 128),
            lambda: K.isla_moments(x.reshape(-1, 128), bounds, tm=rows),
            lambda out: 4 * n + mom_rw),
        "isla_moments_grouped": (
            tuple(grouped.shape),
            lambda: K.isla_moments_grouped(grouped, bounds, tm=rows),
            lambda out: 4 * grouped.numel() + mom_rw * n_groups * n_cells),
        "isla_fused": (
            shape,
            lambda: K.isla_fused(x, bounds, prior.clone(), 100.0, params,
                                 tm=rows),
            lambda out: 4 * n + (mom_rw + 4) * n_cells),
        "isla_fused_sketch": (
            shape,
            lambda: K.isla_fused_sketch(x, bounds, prior.clone(),
                                        prior_regs.clone(), hi, lo, valid,
                                        100.0, params, tm=rows),
            lambda out: 16 * n + (mom_rw + 4) * n_cells + raised(out)),
    }
    out = []
    for name, (v_shape, call, need_bytes) in cases.items():
        got = call()
        with PlainVersions():
            want = call()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, rel = 0.0, 0.0
        for g, w in zip(got, want):
            if g.dtype == torch.uint8:
                check(torch.equal(g, w), f"{name} registers disagree with "
                                         f"its plain version")
                continue
            err = max(err, max_abs_err(g, w))
            rel = max(rel, float(((g.double() - w.double()).abs()
                                  / w.double().abs().clamp_min(1.0)).max()))
        check(rel <= 1e-5, f"{name} disagrees with its plain version: max "
                           f"rel err {rel:.3g} > 1e-5")
        ms = time_ms(call)
        with PlainVersions():
            plain_ms = time_ms(call, reps=5, warm=1)
        out.append(dict(name=name, shape=list(v_shape), max_abs_err=err,
                        max_rel_err=rel,
                        tolerance="rel 1e-5; registers bit-identical",
                        ms=ms, plain_ms=plain_ms,
                        bound_ms=need_bytes(got) / HBM_BYTES_PER_S * 1e3,
                        bound_by="bytes"))
    return out


def check_batched(device) -> dict:
    """``isla_moments_batched`` (the Pallas signature on the fold kernel)
    with a tile stride and per-cell cuts, against the fold's plain
    version on the same card tensors."""
    import numpy as np
    import torch
    from repro_torch.kernels import isla_moments as K
    from repro_torch.kernels import ref

    rng = np.random.default_rng(1)
    n, rows, tm, stride = 1000, 64 * 8, 64, 2
    x = torch.as_tensor(rng.normal(100, 20, (n, rows, 128)),
                        dtype=torch.float32, device=device)
    b = torch.as_tensor(np.asarray([60.0, 90.0, 110.0, 140.0])[None]
                        + rng.uniform(-5, 5, (n, 1)), dtype=torch.float32,
                        device=device)
    chunks = (tm * 128, stride * tm * 128, rows // tm // stride)

    def plain():
        out = torch.zeros((n, 2, 4), dtype=torch.float32, device=device)
        ref.isla_fold_ref(x.reshape(n, rows * 128), b, out[:, 0],
                          out[:, 1], chunks=chunks)
        return out

    got = K.isla_moments_batched(x, b, tm=tm, stride=stride)
    want = plain()
    rel = float(((got.double() - want.double()).abs()
                 / want.double().abs().clamp_min(1.0)).max())
    check(rel <= 1e-5, f"isla_moments_batched disagrees with its plain "
                       f"version: max rel err {rel:.3g} > 1e-5")
    ms = time_ms(lambda: K.isla_moments_batched(x, b, tm=tm, stride=stride))
    plain_ms = time_ms(plain, reps=5, warm=1)
    read = 4 * (n * chunks[0] * chunks[2] + b.numel())
    return dict(shape=[n, rows, 128], tm=tm, stride=stride,
                max_abs_err=max_abs_err(got, want), max_rel_err=rel,
                tolerance="rel 1e-5", ms=ms, plain_ms=plain_ms,
                bound_ms=(read + 4 * 8 * n) / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes")


# ---------------------------------------------------------------------------
# Kernel B: pilot statistics.
# ---------------------------------------------------------------------------


PILOT_SIZES = (100_000, 1_000_000, 10_000_000)  # beside the loop's pilot
PILOT_KERNEL = "pilot_moments_kernel"
L2_FLUSH_BYTES = 64 << 20  # read between calls: more than the 50 MB L2


def pilot_host_ms(v_host, reps: int) -> dict:
    """Host milliseconds (median of ``reps``) of ``pilot_stats_device`` as
    a whole, and of its stages run one by one with a sync after each:
    scale (``prescale_pilot``), upload, launch (the kernel finished) and
    readback."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import isla_moments as K

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[len(ts) // 2]

    dev = torch.device("cuda")
    box = {}

    def scale():
        box["v32"], _ = D.prescale_pilot(v_host)

    def upload():
        box["v"] = D.h2d(box["v32"], torch.float32, dev)

    def launch():
        box["m"] = K.pilot_moments(box["v"])

    out = dict(whole=median_ms(
        lambda: D.pilot_stats_device(v_host, device="cuda")))
    for name, fn in (("scale", scale), ("upload", upload),
                     ("launch", launch),
                     ("readback", lambda: box["m"].tolist())):
        out[name] = median_ms(fn)
    return out


def check_pilot(device, loop_n: int) -> "list[dict]":
    """The pilot kernel at the loop's pilot size and at 10^5, 10^6 and 10^7
    samples: ``pilot_moments`` against its float64 plain version (count
    and min exact, mean, M2 and sigma within rel 1e-5; a second run
    bit-identical), ``pilot_stats`` with and without a centre against the
    form derived from the plain moments (``ref.stats_from_moments``); its
    device time from the profiler (as after the upload, and after a read
    of 64 MB has flushed L2) beside the byte bound and the launches a
    call; the plain version's and ``torch.std_mean`` +
    ``torch.min``'s time (no one call computes the function); and the
    device pilot's host time with its stages.  At the loop's size it also
    times the card's smallest launch (a one-element ``fill_``) the same
    way."""
    import numpy as np
    import torch
    from repro_torch.kernels import isla_moments as K
    from repro_torch.kernels import ref

    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    tiny = torch.zeros(1, device=device)
    rows = []
    for n in (loop_n,) + PILOT_SIZES:
        v_host = np.random.default_rng(2).normal(0.8, 0.1, n)
        v = torch.as_tensor(v_host, dtype=torch.float32, device=device)
        got, again = K.pilot_moments(v), K.pilot_moments(v)
        want = ref.pilot_moments_ref(v)
        check(torch.equal(got, again),
              f"pilot_moments n={n}: two runs differ: {got} vs {again}")
        g, w = got.tolist(), want.tolist()
        rel = [abs(g[i] - w[i]) / max(abs(w[i]), 1e-300) for i in (1, 2, 4)]
        check(g[0] == w[0] == n and g[3] == w[3] and max(rel) <= 1e-5,
              f"pilot_moments n={n} disagrees with its plain version: "
              f"{g} vs {w} (rel {rel})")
        err = max(abs(a - b) for a, b in zip(g, w))
        # pilot_stats (the same launch): its (count, sum (x-c), sum
        # (x-c)^2, min) against the form derived from the plain moments,
        # sum (x-c) = n (mean - c) to 4 n ulps of c absolute (c is the
        # run's fp32 mean there, so the sum is ~0 and rests on the fp32
        # mean's last bits).
        center = (v.sum() / n).reshape(1)
        for c in (None, center):
            st = K.pilot_stats(v, center=c).double()
            ws = ref.stats_from_moments(want, c).double()
            floor = 0.0 if c is None else 4 * n * float(
                np.spacing(np.float32(c.item())))
            bad = (st - ws).abs() > 1e-5 * ws.abs() + torch.tensor(
                [0.0, floor, 0.0, 0.0], dtype=torch.float64, device=device)
            check(not bool(bad.any()) and float(st[0]) == n
                  and float(st[3]) == float(ws[3]),
                  f"pilot_stats n={n} disagrees with its plain version: "
                  f"{st} vs {ws}")
            err = max(err, max_abs_err(st, ws))
        hot_ms, per_call = kernel_events(lambda: K.pilot_moments(v),
                                         (PILOT_KERNEL,))
        hot_tries = WINDOW_LOG[-1]["tries"]
        cold_ms, _ = kernel_events(lambda: K.pilot_moments(v),
                                   (PILOT_KERNEL,),
                                   setup=lambda: flush.max())
        cold_tries = WINDOW_LOG[-1]["tries"]
        check(per_call == 1.0, f"pilot_moments n={n}: {per_call} kernel "
                               f"launches a call, not 1")
        bound = 4 * n / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * n / FP32_FLOP_PER_S * 1e3
        row = dict(n=n, max_abs_err=err, max_rel_err=max(rel),
                   tolerance=("rel 1e-5; count and min exact; pilot_stats' "
                              "sum (x-c) also 4 n ulps of c"), ms=hot_ms,
                   cold_ms=cold_ms, launches_per_call=per_call,
                   windows_taken=dict(hot=hot_tries, cold=cold_tries),
                   event_ms=time_ms(lambda: K.pilot_moments(v)),
                   plain_ms=time_ms(lambda: ref.pilot_moments_ref(v)),
                   std_mean_min_ms=time_ms(
                       lambda: (torch.std_mean(v), torch.min(v))),
                   bound_ms=max(bound, t_ops),
                   bound_by="bytes" if bound >= t_ops else "operations",
                   host_ms=pilot_host_ms(v_host, 5 if n >= 10 ** 7 else 20))
        if n == loop_n:
            row["smallest_launch_ms"] = kernel_ms(lambda: tiny.fill_(1.0),
                                                  ("",))
        rows.append(row)
    del flush
    return rows


# ---------------------------------------------------------------------------
# The main path: the admission loop on route="device".
# ---------------------------------------------------------------------------


# The main path's two runs.  A COUNT DISTINCT ask on a key gives its
# store a register plane, and one sketch member makes the whole stacked
# mode-group a sketch stack, so moment-only traffic and traffic with
# COUNT DISTINCT take two different ticks; each run drives one of them.
MAIN_RUNS = (("moments", False), ("distinct", True))


def serve_queries(C, e: float, distinct: bool, mode=None):
    """One tick's batch: the four serving keys (plain, WHERE, GROUP BY,
    WHERE + GROUP BY) under the four moment aggregates, and with
    ``distinct`` COUNT DISTINCT on each of the four keys; ``mode`` is each
    query's Phase 2 mode (None: the run's)."""
    flag = C.Predicate(column="flag", eq=1.0)
    q = functools.partial(C.IslaQuery, e=e, mode=mode)
    qs = [q(agg="AVG"),
          q(agg="SUM", where=flag),
          q(agg="AVG", group_by="region"),
          q(agg="COUNT", group_by="region", where=flag),
          q(agg="VAR")]
    if distinct:
        qs += [q(agg="count_distinct"),
               q(agg="count_distinct", where=flag),
               q(agg="count_distinct", group_by="region"),
               q(agg="count_distinct", group_by="region", where=flag)]
    return qs


def run_serve(device: str, route: str, n_blocks: int, n_groups: int,
              rows: int, ticks, distinct: bool, seed: int = 0,
              profile_at=(), pilot_device: "str | None" = None,
              mesh=None):
    """Drive the admission loop: one batch of ``serve_queries`` per entry
    of ``ticks`` (its precision e), the ticks in ``profile_at`` (their
    indices) under the torch profiler.  ``pilot_device`` gives the executor the device pilot on
    that device whatever its route (a host-route run that shares the
    device route's anchor); ``mesh`` is the executor's cell mesh of
    ``route="mesh"`` (its shards' devices).  Returns the finished tickets,
    the executor and per-tick records (with the host seconds the tick
    spent on its run tables: ``DeviceStack.key_runs`` and
    ``tagged_run_table``, and the tick's cross-device reduces)."""
    import numpy as np
    import repro_torch.core as C
    import repro_torch.core.moment_store as MS
    import repro_torch.core.multiquery as MQ
    from repro_torch.kernels import isla_moments as K
    from repro_torch.launch.serve import (IslaAdmissionLoop,
                                          _synthetic_grouped_blocks)

    samplers = _synthetic_grouped_blocks(n_blocks, n_groups, rows, seed)
    ex = C.MultiQueryExecutor(samplers, [10 ** 7] * n_blocks,
                              params=C.IslaParams(e=ticks[0]),
                              group_domains={"region": n_groups},
                              device=device, mesh=mesh)
    if pilot_device is not None:
        ex._pilot_stats_fn = lambda route: functools.partial(
            MQ.pilot_stats_device, device=pilot_device)
    loop = IslaAdmissionLoop(ex, np.random.default_rng(seed + 1),
                             route=route, incremental=True)
    done, records = [], []
    table_s = [0.0]

    def timed(fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                table_s[0] += time.perf_counter() - t0
        return run

    real_runs, real_table = MS.DeviceStack.key_runs, MS.tagged_run_table
    MS.DeviceStack.key_runs = timed(real_runs)
    MS.tagged_run_table = timed(real_table)
    try:
        with Recorder("fold_panes", keep=False) as folds, \
                Recorder("sketch_panes", keep=False) as merges, \
                Recorder("_segment_carry_sum", keep=False) as tagged:
            serve_ticks(loop, ex, C, K, ticks, distinct, device, profile_at,
                        folds, merges, tagged, table_s, done, records)
    finally:
        MS.DeviceStack.key_runs, MS.tagged_run_table = real_runs, real_table
    return done, ex, records


def serve_ticks(loop, ex, C, K, ticks, distinct, device, profile_at, folds,
                merges, tagged, table_s, done, records) -> None:
    """``run_serve``'s ticks, each recorded (see there)."""
    from repro_torch.core import distributed as D

    for k, e in enumerate(ticks):
        for q in serve_queries(C, e, distinct):
            loop.submit(q)
        f0, p0 = K.isla_fold.launches, K.pilot_stats.launches
        s0 = K.isla_sketch.launches
        tt0, ts0 = K.isla_tagged_fold.launches, \
            K.isla_sketch_tagged.launches
        fc0, sc0, tc0 = folds.count, merges.count, tagged.count
        rt0 = table_s[0]
        prof = profile_tick(device, k in profile_at)
        # the wall clock inside the window: a profiled tick's excludes
        # the window's padding
        with prof, D.collective_footprint() as reduces:
            t0 = time.perf_counter()
            out = loop.tick()
            if device == "cuda":
                import torch
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        records.append(dict(
            e=e, wall_s=wall, answered=len(out),
            device_busy_s=device_seconds(prof),
            kernel_events=device_kernel_counts(prof),
            new_samples=sum({a.answer.pass_id: a.answer.new_samples
                             for a in out}.values()),
            fold_calls=folds.count - fc0,
            sketch_calls=merges.count - sc0,
            tagged_calls=tagged.count - tc0,
            fold_launches=K.isla_fold.launches - f0,
            pilot_launches=K.pilot_stats.launches - p0,
            sketch_launches=K.isla_sketch.launches - s0,
            tagged_launches=K.isla_tagged_fold.launches - tt0,
            tagged_sketch_launches=K.isla_sketch_tagged.launches - ts0,
            run_table_host_s=table_s[0] - rt0,
            collectives=list(reduces),
            stages_s=dict(ex.last_stage_times)))
        done.extend(out)


def profile_tick(device: str, on: bool):
    """A torch.profiler context over one tick (CPU + CUDA activity,
    ``padded_profile``) when ``on`` and on the card, else a no-op
    context."""
    import contextlib

    if not (on and device == "cuda"):
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity
    return padded_profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])


def device_events(prof) -> list:
    """A profiled window's device events (kernels, copies, fills) but the
    spins that open it or mark a thread (``SPIN``); [] when not
    profiled."""
    if not hasattr(prof, "events"):
        return []
    return [e for e in prof.events() if str(e.device_type).endswith("CUDA")
            and SPIN not in e.name]


def device_seconds(prof):
    """Seconds of kernel time on the card inside a profiled tick (the sum
    of the device events' durations), None when not profiled or when the
    trace holds no device event."""
    spans = [e.time_range.elapsed_us() for e in device_events(prof)]
    return sum(spans) * 1e-6 if spans else None


def device_kernel_seconds(prof) -> dict:
    """Seconds of device time by kernel name in a profiled window (empty
    when not profiled or when the trace holds no device event)."""
    out = {}
    for e in device_events(prof):
        out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
    return out


def device_event_count(prof) -> "int | None":
    """How many device events (kernels, copies, fills) a profiled window
    holds, None when not profiled or when the trace holds none."""
    return len(device_events(prof)) or None


ISLA_KERNELS = ("isla_fold_kernel", "isla_fold_combine_kernel",
                "isla_sketch_kernel", "pilot_moments_kernel",
                "isla_tagged_fold_kernel", "isla_tagged_runs_kernel")


def device_kernel_counts(prof) -> "dict | None":
    """How many times each ISLA ``__global__`` kernel ran on the card in a
    profiled window (by the device events' names), and how many sort
    kernels (``sort`` in the name), None when not profiled or when the
    trace holds no device event."""
    names = [e.name for e in device_events(prof)]
    if not names:
        return None
    out = {k: sum(1 for n in names if k in n) for k in ISLA_KERNELS}
    out["sort"] = sum(1 for n in names if "sort" in n.lower())
    return out


def trace_whole(r: dict) -> bool:
    """Whether a profiled tick's trace holds every ISLA kernel that the
    wrappers' launch counts say the tick ran."""
    ev = r["kernel_events"]
    want = {"isla_fold_kernel": r["fold_launches"],
            "pilot_moments_kernel": r["pilot_launches"],
            "isla_sketch_kernel": r["sketch_launches"]
            + r["tagged_sketch_launches"]}
    if not any(want.values()) and not r["tagged_launches"]:
        return True
    return ev is not None and all(ev[k] >= n for k, n in want.items()) \
        and ev["isla_tagged_fold_kernel"] + ev["isla_tagged_runs_kernel"] \
        >= r["tagged_launches"]


def profiled_serve(name: str, n_blocks, n_groups, rows, ticks, distinct,
                   profile_at, forbidden=()) -> "tuple[list, int]":
    """A re-run of the main path's loop (same seed, same draws) with the
    ticks in ``profile_at`` under the profiler.  The profiler can lose a
    window's kernel records on the card (seen once: a traced tick that
    held none of the ISLA kernels it launched), and a trace that lost
    kernels cannot show that one did not run.  So every traced tick must
    be ``trace_whole``; the run is taken again when one is not, up to
    ``PROFILE_TRIES`` runs, and fails after that.  A kernel of
    ``forbidden`` (``device_kernel_counts``' keys) in any trace fails at
    once.  Returns the last run's records and the runs it took."""
    for run in range(1, PROFILE_TRIES + 1):
        _, _, recs = run_serve("cuda", "device", n_blocks, n_groups, rows,
                               ticks, distinct, profile_at=profile_at)
        for k in profile_at:
            ev = recs[k]["kernel_events"] or {}
            check(not any(ev.get(f) for f in forbidden),
                  f"the {name} run's profiled tick {k + 1} ran {ev}")
        if all(trace_whole(recs[k]) for k in profile_at):
            return recs, run
        print(f"the {name} run's profiled re-run {run}: the trace lost "
              f"kernels the launch counts name: "
              + "; ".join(f"tick {k + 1} {recs[k]['kernel_events']}"
                          for k in profile_at))
    check(False, f"the {name} run's profiled ticks lost kernels in "
                 f"{PROFILE_TRIES} runs")


def host_op_seconds(prof, top: int = 12) -> dict:
    """The ``top`` operators by host (self CPU) seconds in a profiled
    window, with their call counts."""
    if not hasattr(prof, "key_averages"):
        return {}
    rows = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)
    return {r.key: [r.self_cpu_time_total * 1e-6, r.count]
            for r in rows[:top]}


def check_answers(dev_done, host_done, distinct: bool) -> dict:
    """Device route vs the port's float64 host route: finite values,
    identical draw ledgers, values rel 2e-3 and groups rel 5e-3 (the
    reference's device-versus-host tolerances); COUNT DISTINCT answers
    equal (the same registers give the same host estimate)."""
    check(len(dev_done) == len(host_done) > 0, "answer counts differ")
    worst, worst_g, n_distinct = 0.0, 0.0, 0
    for d, h in zip(dev_done, host_done):
        a, b = d.answer, h.answer
        check(math.isfinite(a.value), f"non-finite answer {a.value}")
        check(a.new_samples == b.new_samples
              and a.sample_size == b.sample_size,
              f"draw ledgers differ: {a.new_samples}/{a.sample_size} vs "
              f"{b.new_samples}/{b.sample_size}")
        if a.query.agg == "count_distinct":
            check(a.value == b.value and a.error_bound == b.error_bound,
                  f"count_distinct device {a.value} vs host {b.value}")
            check(b.groups is None or [g.value for g in a.groups]
                  == [g.value for g in b.groups],
                  "count_distinct group answers differ")
            n_distinct += 1
            continue
        rel = abs(a.value - b.value) / max(abs(b.value), 1e-12)
        worst = max(worst, rel)
        check(rel <= 2e-3, f"{a.query.agg} device {a.value} vs host "
                           f"{b.value}: rel {rel:.3g} > 2e-3")
        if b.groups is not None:
            for gd, gh in zip(a.groups, b.groups):
                check(gd.n_samples == gh.n_samples,
                      "group sample counts differ")
                if math.isfinite(gh.value):
                    r = abs(gd.value - gh.value) / max(abs(gh.value), 1e-12)
                    worst_g = max(worst_g, r)
                    check(r <= 5e-3, f"group value rel {r:.3g} > 5e-3")
    check(n_distinct > 0 or not distinct,
          "no count_distinct answer was served")
    return dict(answers=len(dev_done), distinct_answers_equal=n_distinct,
                max_rel_value=worst, max_rel_group=worst_g)


def main_path(name: str, distinct: bool, n_blocks=1000, n_groups=16,
              rows=20000, ticks=(0.5, 0.25, 0.25)) -> dict:
    """One run of the main path: the launch counts are set to 0 just
    before the loop and read just after; every kernel of the run's tick
    must have launched (``isla_sketch`` exactly when COUNT DISTINCT is
    asked).  Its answers are then held against the float64 host route,
    and a second, profiled run of the same loop gives the device's busy
    time."""
    import torch
    from repro_torch.kernels import isla_moments as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    with Recorder("fold_panes") as folds, \
            Recorder("sketch_panes") as sketches:
        dev_done, ex, records = run_serve("cuda", "device", n_blocks,
                                          n_groups, rows, ticks, distinct)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"isla_fold": K.isla_fold.launches,
                "pilot_stats": K.pilot_stats.launches,
                "isla_sketch": K.isla_sketch.launches}
    check(K.isla_tagged_fold.launches == K.isla_sketch_tagged.launches == 0,
          f"the {name} run (fp32) launched a tagged kernel")
    for kernel, n in launches.items():
        if kernel == "isla_sketch" and not distinct:
            check(n == 0, f"the {name} run launched isla_sketch: its "
                          f"moment-only tick took the sketch stack")
        else:
            check(n > 0, f"the {name} run never launched {kernel}")
    # One launch folds (merges) every key of a tick: each fold_panes
    # (sketch_panes) call of every tick launches its kernel exactly once.
    for k, r in enumerate(records):
        check(r["fold_launches"] == r["fold_calls"]
              and r["sketch_launches"] == r["sketch_calls"],
              f"the {name} run's tick {k + 1} made {r['fold_calls']} "
              f"fold_panes and {r['sketch_calls']} sketch_panes calls but "
              f"{r['fold_launches']} isla_fold and {r['sketch_launches']} "
              f"isla_sketch launches")
    # One cold plan a run (the anchor stays frozen), one device pilot,
    # one pilot kernel launch.
    check(launches["pilot_stats"] == 1 and records[0]["pilot_launches"] == 1,
          f"the {name} run's cold plan made {records[0]['pilot_launches']} "
          f"pilot_stats launches ({launches['pilot_stats']} in the run), "
          f"not 1")
    pilot_n = int(ex._anchor[0].pilot_size)
    repair = phase2_repair(ex)
    del ex  # the host run below rebuilds the same tables
    host_done, _, _ = run_serve("cpu", "host", n_blocks, n_groups, rows,
                                ticks, distinct)
    agree = check_answers(dev_done, host_done, distinct)
    # The profiler inflates the host stages of the tick it traces, so the
    # device's busy time comes from a second, profiled run of the same
    # loop (same seed, same draws) after the counts were read.
    profiled, traced_runs = profiled_serve(
        name, n_blocks, n_groups, rows, ticks, distinct, (1,),
        forbidden=("isla_fold_combine_kernel",))
    # The profiler's own count of the traced tick's ISLA kernels: one fold
    # kernel per fold_panes call (its combine only when a row is sliced,
    # which the loop's panes never are) and one merge per sketch_panes.
    ev, r = profiled[1]["kernel_events"], profiled[1]
    check(ev["isla_fold_kernel"] == r["fold_calls"]
          and ev["isla_fold_combine_kernel"] == 0
          and ev["isla_sketch_kernel"] == r["sketch_calls"],
          f"the {name} run's profiled tick ran {ev} for "
          f"{r['fold_calls']} fold_panes and {r['sketch_calls']} "
          f"sketch_panes calls")
    return dict(name=name, launches=launches, wall_s=wall, ticks=records,
                profiled_ticks=profiled, traced_runs=traced_runs,
                pilot_size=pilot_n,
                agreement=agree, phase2=repair, fold_calls=folds.calls,
                sketch_calls=sketches.calls,
                shape=dict(blocks=n_blocks, groups=n_groups, rows=rows))


# ---------------------------------------------------------------------------
# The float64 tagged tick: the same loop with the torch default dtype
# float64, so every key's device store runs float64 (scale 1.0) and each
# drawing tick folds its tagged stream with isla_tagged_fold.
# ---------------------------------------------------------------------------

F64_RUNS = (("moments f64", False), ("distinct f64", True))
FP64_FLOP_PER_S = 34e12  # H100 SXM float64 outside the tensor cores
                         # (NVIDIA's data sheet; the guide lists none)


def ulp_gap(got, want) -> "tuple[int, float]":
    """How many float64 values differ and the largest gap in ulps of the
    wanted value."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    if not diff.any():
        return 0, 0.0
    gap = np.abs(got - want)[diff] / np.spacing(np.abs(want[diff]))
    return int(diff.sum()), float(gap.max())


def phase2_gaps(dst) -> dict:
    """A device store's last partials against Phase 2 run on the CPU over
    the card's state (cells that differ, the largest gap in ulps), and
    the cells the division repair moved: Phase 2 on the card again with
    its divisions by constants taken by a host scalar, as torch does it
    (a product with the reciprocal), against the partials."""
    import torch
    from repro_torch.core import distributed as D

    params, mode, geometry = dst._stats_cfg
    card = dst._partials
    cpu, old = [], None
    for dev in ("cpu", card.device):
        inv = torch.full((dst.n_cells,), 1.0 / dst.scale, dtype=dst.dtype,
                         device=dev)
        thr, geo = D._scaled_solve_args(params, geometry, inv)
        args = (dst.mom_s.to(dev), dst.mom_l.to(dev),
                dst._sketch0_dev.to(dev).expand(dst.n_cells), params)
        kw = dict(mode=mode, geometry=geo, thr=thr)
        if dev == "cpu":
            cpu = D.phase2(*args, **kw)
            continue
        real = D._div
        D._div = lambda x, d: x / d
        try:
            old = D.phase2(*args, **kw)
        finally:
            D._div = real
    n, g = ulp_gap(card.cpu().numpy(), cpu.numpy())
    return dict(cells=dst.n_cells, differ_from_cpu=n, max_ulps_from_cpu=g,
                moved_by_repair=int((old != card).sum()))


def phase2_repair(ex) -> dict:
    """``phase2_gaps`` summed over an executor's device stores."""
    out = dict(cells=0, differ_from_cpu=0, max_ulps_from_cpu=0.0,
               moved_by_repair=0)
    for dst in ex._device_stores.values():
        g = phase2_gaps(dst)
        for k in ("cells", "differ_from_cpu", "moved_by_repair"):
            out[k] += g[k]
        out["max_ulps_from_cpu"] = max(out["max_ulps_from_cpu"],
                                       g["max_ulps_from_cpu"])
    return out


def check_f64_state(dev_ex, host_ex) -> dict:
    """Every key's float64 device state against the host route's
    ``MomentStore`` after the same draws under the same anchor: moment
    rows, totals, draw ledger and register plane bit for bit, and the
    partials equal to Phase 2 run on the CPU over the card's state.  The
    device partials' gaps to the host solve of the same state are counted
    (the reference's own formula parts from it; not gated)."""
    import numpy as np
    import torch

    n_keys, p_host, gap_host, cells = 0, 0, 0.0, 0
    for skey, dst in dev_ex._device_stores.items():
        check(dst.dtype == torch.float64 and dst.scale == 1.0,
              f"the float64 run's store {skey} runs {dst.dtype} at scale "
              f"{dst.scale}")
        hs = host_ex._stores[skey]
        got = dst.to_host()
        for f in ("mom_s", "mom_l", "totals", "n_sampled"):
            check(np.array_equal(getattr(got, f), getattr(hs, f)),
                  f"the float64 store {skey} is not bit-identical to the "
                  f"host route's in {f}")
        if hs.has_sketch:
            check(np.array_equal(got.regs, hs.regs),
                  f"the float64 store {skey}'s register plane differs from "
                  f"the host route's")
        params, mode, geometry = dst._stats_cfg
        host = hs.solve(params, mode=mode, geometry=geometry).avg
        n, g = ulp_gap(dst.partials_host(), host)
        p_host, gap_host = p_host + n, max(gap_host, g)
        n_keys += 1
        cells += dst.n_cells
    check(n_keys > 0, "the float64 run kept no device store")
    repair = phase2_repair(dev_ex)
    check(repair["differ_from_cpu"] == 0,
          f"{repair['differ_from_cpu']} float64 partials differ from Phase 2 "
          f"run on the CPU over the card's state (max "
          f"{repair['max_ulps_from_cpu']:g} ulp)")
    return dict(keys=n_keys, cells=cells, state_bit_identical=True,
                partials_differing_from_host_solve=p_host,
                max_ulps_from_host_solve=gap_host, phase2=repair)


def main_path_f64(name: str, distinct: bool, n_blocks=1000, n_groups=16,
                  rows=20000, ticks=(0.5, 0.25, 0.25)) -> dict:
    """One float64 run of the main path, the torch default dtype float64
    for the run and restored after it: the launch counts are set to 0 just
    before the loop and read just after; every drawing tick must make one
    ``isla_tagged_fold`` launch a tagged fold (and, with COUNT DISTINCT,
    one ``isla_sketch_tagged`` launch), no dense launch, one pilot launch
    a run.  A host-route run of the same loop under the same anchor (the
    host route takes the device pilot too) then holds every key's state
    bit for bit and the answers."""
    import torch
    from repro_torch.kernels import isla_moments as K

    was = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with Recorder("_segment_carry_sum") as folds, \
                Recorder("isla_sketch_tagged") as merges:
            dev_done, ex, records = run_serve("cuda", "device", n_blocks,
                                              n_groups, rows, ticks,
                                              distinct)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"isla_tagged_fold": K.isla_tagged_fold.launches,
                    "isla_sketch_tagged": K.isla_sketch_tagged.launches,
                    "pilot_stats": K.pilot_stats.launches,
                    "isla_fold": K.isla_fold.launches,
                    "isla_sketch": K.isla_sketch.launches}
        check(launches["isla_tagged_fold"] > 0
              and launches["isla_fold"] == launches["isla_sketch"] == 0,
              f"the {name} run launched {launches}")
        check((launches["isla_sketch_tagged"] > 0) == distinct,
              f"the {name} run made {launches['isla_sketch_tagged']} "
              f"tagged register merges")
        for k, r in enumerate(records):
            check(r["tagged_launches"] == r["tagged_calls"]
                  and r["tagged_sketch_launches"]
                  == (r["tagged_calls"] if distinct else 0)
                  and r["fold_calls"] == r["sketch_calls"] == 0,
                  f"the {name} run's tick {k + 1} made {r['tagged_calls']} "
                  f"tagged folds with {r['tagged_launches']} isla_tagged_fold "
                  f"and {r['tagged_sketch_launches']} isla_sketch_tagged "
                  f"launches")
        check(launches["pilot_stats"] == 1
              and records[0]["pilot_launches"] == 1,
              f"the {name} run made {launches['pilot_stats']} pilot "
              f"launches, not 1")
        host_done, host_ex, _ = run_serve("cpu", "host", n_blocks, n_groups,
                                          rows, ticks, distinct,
                                          pilot_device="cuda")
        state = check_f64_state(ex, host_ex)
        agree = check_answers(dev_done, host_done, distinct)
        exact = sum(d.answer.value == h.answer.value
                    for d, h in zip(dev_done, host_done))
        del ex, host_ex
        # The profiler's view of both drawing ticks, in a re-run of the
        # same loop: the run kernel once a tagged fold, the sorted path's
        # kernel never, no sort kernel at all.
        profiled, traced_runs = profiled_serve(
            name, n_blocks, n_groups, rows, ticks, distinct, (0, 1),
            forbidden=("isla_tagged_fold_kernel", "sort"))
        for k in (0, 1):
            ev, r = profiled[k]["kernel_events"], profiled[k]
            check(ev is not None and r["tagged_calls"] > 0
                  and ev["isla_tagged_runs_kernel"] == r["tagged_calls"]
                  and ev["isla_tagged_fold_kernel"] == 0 and ev["sort"] == 0,
                  f"the {name} run's profiled tick {k + 1} ran {ev} for "
                  f"{r['tagged_calls']} tagged folds")
    finally:
        torch.set_default_dtype(was)
    return dict(name=name, launches=launches, wall_s=wall, ticks=records,
                profiled_ticks=profiled, traced_runs=traced_runs,
                agreement=dict(agree, answers_equal=exact), state=state,
                tagged_calls=folds.calls, sketch_calls=merges.calls,
                shape=dict(blocks=n_blocks, groups=n_groups, rows=rows))


# ---------------------------------------------------------------------------
# The mesh route: the same loop on route="mesh", its cell axis split by
# block runs over four shards on the one card, each shard launching the
# tick kernels on its own rows.
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_DEVICES = ("cuda:0",) * MESH_SHARDS
# (name, COUNT DISTINCT, float64, the device-route run of the same loop)
MESH_RUNS = (("moments mesh", False, False, "moments"),
             ("distinct mesh", True, False, "distinct"),
             ("moments f64 mesh", False, True, "moments f64"),
             ("distinct f64 mesh", True, True, "distinct f64"))
N_REGS = 4096  # HLL registers a cell: bytes a folded register row


def mesh_tick_launches(distinct: bool, f64: bool, n_shards: int,
                       drawing: bool, first: bool) -> dict:
    """What one tick of a mesh run launches: a drawing tick one launch of
    each of its tick kernels a shard (fp32: a ``fold_panes`` and, with
    COUNT DISTINCT, a ``sketch_panes`` call a shard; float64: a
    ``_segment_carry_sum`` a shard and its tagged merge), a warm tick
    nothing, and the run's cold plan one pilot launch."""
    s = n_shards if drawing else 0
    out = dict(fold_calls=0, fold_launches=0, sketch_calls=0,
               sketch_launches=0, tagged_calls=0, tagged_launches=0,
               tagged_sketch_launches=0, pilot_launches=int(first))
    if f64:
        out.update(tagged_calls=s, tagged_launches=s,
                   tagged_sketch_launches=s if distinct else 0)
    else:
        out.update(fold_calls=s, fold_launches=s,
                   sketch_calls=s if distinct else 0,
                   sketch_launches=s if distinct else 0)
    return out


def check_mesh_ticks(name: str, records, n_shards: int, distinct: bool,
                     f64: bool, n_rows: int) -> None:
    """Each tick of a mesh run against ``mesh_tick_launches``, and its
    cross-device steps: a drawing tick reduces once, the sum of its
    stack's stat rows, 9 columns a row (a sketch stack adds the max of
    its folded register rows, 4096 bytes a row), at most ``n_rows`` rows
    (the loop's keys': nothing of O(cells)); a warm tick reduces nothing
    when its stats are cached, else as a drawing tick."""
    for k, r in enumerate(records):
        drawing = r["new_samples"] > 0
        want = mesh_tick_launches(distinct, f64, n_shards, drawing, k == 0)
        got = {key: r[key] for key in want}
        check(got == want, f"the {name} run's tick {k + 1} launched {got}, "
                           f"not {want}")
        ops = r["collectives"]
        rows = ops[0][1] // 9 if ops and ops[0][0] == "sum" else 0
        reduce = [("sum", 9 * rows)] + ([("max", N_REGS * rows)]
                                        if distinct else [])
        check((0 < rows <= n_rows and ops == reduce)
              or (not drawing and ops == []),
              f"the {name} run's tick {k + 1} reduced {ops}: not one sum of "
              f"at most {n_rows} stat rows"
              + (" and one max of as many register rows" if distinct
                 else ""))


def check_mesh_state(mesh_ex, dev_ex) -> dict:
    """Every key's float64 state on the mesh route against the device
    route's after the same draws: moment rows, totals, both draw ledgers,
    register plane and partials bit for bit."""
    import numpy as np

    n_keys, cells = 0, 0
    check(set(mesh_ex._device_stores) == set(dev_ex._device_stores),
          "the mesh and device runs kept different keys")
    for skey, dst in dev_ex._device_stores.items():
        mst = mesh_ex._device_stores[skey]
        got, want = mst.to_host(), dst.to_host()
        for f in ("mom_s", "mom_l", "totals", "n_sampled"):
            check(np.array_equal(getattr(got, f), getattr(want, f)),
                  f"the mesh store {skey} differs from the device route's "
                  f"in {f}")
        check(np.array_equal(mst._n_sampled_dev.cpu().numpy(),
                             dst._n_sampled_dev.cpu().numpy()),
              f"the mesh store {skey}'s device ledger differs")
        if want.has_sketch:
            check(np.array_equal(got.regs, want.regs),
                  f"the mesh store {skey}'s register plane differs")
        check(np.array_equal(mst.partials_host(), dst.partials_host()),
              f"the mesh store {skey}'s partials differ")
        n_keys += 1
        cells += dst.n_cells
    check(n_keys > 0, "the float64 mesh run kept no device store")
    return dict(keys=n_keys, cells=cells, state_bit_identical=True,
                partials_bit_identical=True)


def main_path_mesh(name: str, distinct: bool, f64: bool, n_blocks=1000,
                   n_groups=16, rows=20000, ticks=(0.5, 0.25, 0.25)
                   ) -> dict:
    """One run of the main path on ``route="mesh"`` over ``MESH_SHARDS``
    shards on the card (the torch default dtype float64 for a float64
    run, restored after it): the launch counts and the reduce's counters
    are read around the loop and every tick is held to
    ``check_mesh_ticks``.  A float64 run is then held to a device-route
    run of the same loop, made here (``check_mesh_state``; its tick
    records are kept beside); an fp32 run's answers to the float64 host
    route, as the device route's are."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core.moment_store import MeshDeviceStack
    from repro_torch.kernels import isla_moments as K

    was = torch.get_default_dtype()
    if f64:
        torch.set_default_dtype(torch.float64)
    try:
        K.reset_launch_counts()
        calls0 = D.mesh_all_reduce.calls
        elems0 = D.mesh_all_reduce.elements
        t0 = time.perf_counter()
        done, ex, records = run_serve("cuda", "mesh", n_blocks, n_groups,
                                      rows, ticks, distinct,
                                      mesh=MESH_DEVICES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(K, k).launches
                    for k in ("isla_fold", "isla_sketch", "isla_tagged_fold",
                              "isla_sketch_tagged", "pilot_stats")}
        reduces = dict(calls=D.mesh_all_reduce.calls - calls0,
                       elements=D.mesh_all_reduce.elements - elems0)
        stacks = list(ex._device_stacks.values())
        check(stacks and all(isinstance(st, MeshDeviceStack)
                             and st.n_shards == MESH_SHARDS
                             for st in stacks),
              f"the {name} run served from {stacks}")
        # The loop's four keys: plain, WHERE, GROUP BY, WHERE + GROUP BY.
        check_mesh_ticks(name, records, MESH_SHARDS, distinct, f64,
                         2 + 2 * n_groups)
        device_ticks, state = None, None
        if f64:
            dev_done, dev_ex, device_ticks = run_serve(
                "cuda", "device", n_blocks, n_groups, rows, ticks, distinct)
            state = check_mesh_state(ex, dev_ex)
            agree = check_answers(done, dev_done, distinct)
            agree["answers_equal"] = sum(
                a.answer.value == b.answer.value
                for a, b in zip(done, dev_done))
            del dev_ex
        else:
            host_done, _, _ = run_serve("cpu", "host", n_blocks, n_groups,
                                        rows, ticks, distinct)
            agree = check_answers(done, host_done, distinct)
        del ex
    finally:
        torch.set_default_dtype(was)
    return dict(name=name, shards=MESH_SHARDS, devices=list(MESH_DEVICES),
                launches=launches, reduces=reduces, wall_s=wall,
                ticks=records, device_ticks=device_ticks, agreement=agree,
                state=state,
                shape=dict(blocks=n_blocks, groups=n_groups, rows=rows))


# ---------------------------------------------------------------------------
# The pipelined tick: the loop's batch under two modes (two mode groups, two
# stacks) through run(pipeline=True) with chunk_blocks=250 (four chunks a
# group), each run held to serial runs made beside it with the same seeds.
# ---------------------------------------------------------------------------

PIPE_MODES = ("calibrated", "faithful_cf")
PIPE_CHUNK_BLOCKS = 250
# (name, COUNT DISTINCT, float64, the mesh's devices or None)
PIPE_RUNS = (("moments pipelined", False, False, None),
             ("distinct pipelined", True, False, None),
             ("moments f64 pipelined", False, True, None),
             ("distinct f64 pipelined", True, True, None),
             ("distinct f64 mesh pipelined", True, True, MESH_DEVICES))
PIPE_PROFILED_TICK = 1  # the top-up tick
ISLA_LAUNCHES = ("isla_fold", "isla_sketch", "isla_tagged_fold",
                 "isla_sketch_tagged", "pilot_stats")
WORKER_MARK = "isla:worker-mark"  # a range the launch worker opens in a
MAIN_MARK = "isla:main-mark"      # profiled window, and the main thread's
STATE_FIELDS = ("mom_s", "mom_l", "totals", "n_sampled", "regs")


def pipeline_queries(C, e: float, distinct: bool):
    """One pipelined tick's batch: ``serve_queries`` under each mode of
    ``PIPE_MODES``, so the run plans two mode groups."""
    return [q for m in PIPE_MODES for q in serve_queries(C, e, distinct, m)]


def answer_key(a) -> str:
    """Every field of an answer, the draw ledger's included, as exact text
    (repr round-trips a float, NaN included)."""
    groups = None if a.groups is None else [
        (g.group, g.value, g.mean, g.error_bound, g.n_samples, g.est_size)
        for g in a.groups]
    return repr((a.value, a.mean, a.error_bound, a.sampling_rate,
                 a.sample_size, a.mode, a.pass_id, a.n_matched,
                 a.est_population, a.new_samples, a.half_width, groups))


def pipe_profile(device: str, on: bool):
    """A profiler over one tick, every thread's ranges included (the
    launch worker's too), when ``on`` (``padded_profile`` on the card);
    else a no-op context."""
    import contextlib

    if not on:
        return contextlib.nullcontext()
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device == "cuda" else [])
    make = padded_profile if device == "cuda" else profile
    return make(activities=acts, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))


def mark_threads(device: str) -> None:
    """Open ``WORKER_MARK`` on the launch worker and ``MAIN_MARK`` here,
    so a profiled window can tell the two threads' ranges apart.  On the
    card each mark is a short device spin (never counted): the first
    kernel inside a window can be left out of its trace
    (``kernel_events``), and here it is a spin, on each thread."""
    import torch
    from torch.profiler import record_function
    from repro_torch.core import distributed as D

    def mark(name):
        with record_function(name):
            if device == "cuda":
                torch.cuda._sleep(int(PROFILE_LEAD_S * SLEEP_CYCLES_PER_S))

    D.launch_pool().submit(mark, WORKER_MARK).result()
    mark(MAIN_MARK)


def stage_ranges(events) -> dict:
    """The pipelined tick's stage ranges in a profiled window, by thread:
    ``(start_us, end_us)`` of each ``isla:launch`` on the launch worker and
    on the main thread, and of each ``isla:draw`` on the main thread.  The
    threads are known by the marks (``mark_threads``).  Only the host's
    ranges are read: on the card the trace also holds each range's
    device-side span, on a stream, not a thread."""
    evs = [e for e in events if e.name.startswith("isla:")
           and str(e.device_type).endswith("CPU")]
    worker = {e.thread for e in evs if e.name == WORKER_MARK}
    main = {e.thread for e in evs if e.name == MAIN_MARK}
    check(len(worker) == 1 and len(main) == 1 and worker != main,
          f"the profiled window does not tell the launch worker "
          f"({worker}) from the main thread ({main})")

    def spans(name, threads):
        return sorted((e.time_range.start, e.time_range.end) for e in evs
                      if e.name == name and e.thread in threads)

    return dict(worker_launch=spans("isla:launch", worker),
                main_launch=spans("isla:launch", main),
                main_draw=spans("isla:draw", main))


def overlap_us(a, b) -> float:
    """Microseconds during which a range of ``a`` and one of ``b`` (lists of
    ``(start, end)``) are both open."""
    return sum(max(0.0, min(e1, e2) - max(s1, s2))
               for s1, e1 in a for s2, e2 in b)


def pipe_serve(device: str, route: str, n_blocks: int, n_groups: int,
               rows: int, ticks, distinct: bool, pipeline: bool,
               seed: int = 0, mesh=None, profile_at=(),
               chunk_blocks: int = PIPE_CHUNK_BLOCKS):
    """Drive ``MultiQueryExecutor.run(incremental=True, chunk_blocks=...,
    pipeline=...)`` one ``pipeline_queries`` batch a tick (its precision
    e from ``ticks``) on ``_synthetic_grouped_blocks`` tables.  Returns
    the answers by tick, the executor and a record a tick: wall and stage
    seconds, new samples, each ISLA kernel's launches, and for a tick of
    ``profile_at`` its ISLA kernel events and its stage ranges by thread
    (``stage_ranges``)."""
    import numpy as np
    import torch
    import repro_torch.core as C
    from repro_torch.kernels import isla_moments as K
    from repro_torch.launch.serve import _synthetic_grouped_blocks

    samplers = _synthetic_grouped_blocks(n_blocks, n_groups, rows, seed)
    ex = C.MultiQueryExecutor(samplers, [10 ** 7] * n_blocks,
                              params=C.IslaParams(e=ticks[0]),
                              group_domains={"region": n_groups},
                              device=device, mesh=mesh)
    rng = np.random.default_rng(seed + 1)
    answers, records = [], []
    for k, e in enumerate(ticks):
        qs = pipeline_queries(C, e, distinct)
        before = {n: getattr(K, n).launches for n in ISLA_LAUNCHES}
        prof = pipe_profile(device, k in profile_at)
        if k in profile_at:
            time.sleep(PROFILE_GAP_S)
        with prof:
            if k in profile_at:
                mark_threads(device)
            t0 = time.perf_counter()
            out = ex.run(qs, rng, route=route, incremental=True,
                         chunk_blocks=chunk_blocks, pipeline=pipeline)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = {n: getattr(K, n).launches - before[n] for n in ISLA_LAUNCHES}
        rec = dict(e=e, wall_s=wall, stages_s=dict(ex.last_stage_times),
                   new_samples=sum({a.pass_id: a.new_samples
                                    for a in out}.values()),
                   launches=got, fold_launches=got["isla_fold"],
                   sketch_launches=got["isla_sketch"],
                   tagged_launches=got["isla_tagged_fold"],
                   tagged_sketch_launches=got["isla_sketch_tagged"],
                   pilot_launches=got["pilot_stats"], kernel_events=None)
        if k in profile_at:
            rec.update(kernel_events=device_kernel_counts(prof),
                       ranges=stage_ranges(prof.events()))
        answers.append(out)
        records.append(rec)
    return answers, ex, records


def store_arrays(stores) -> dict:
    """Every device store's state as host arrays, keyed by (store key,
    field): moment rows, totals, both draw ledgers, register plane and
    partials (``stores``: the stores by key)."""
    out = {}
    for skey, dst in stores.items():
        host = dst.to_host()
        for f in STATE_FIELDS:
            v = getattr(host, f, None)
            if v is not None:
                out[(skey, f)] = v
        out[(skey, "n_sampled_dev")] = dst._n_sampled_dev.cpu().numpy()
        out[(skey, "partials")] = dst.partials_host()
    return out


def check_twin(name: str, piped, serial, serial2=None) -> dict:
    """A pipelined run against its serial twin, each ``(answers by tick,
    store_arrays)``: every answer (value, bound, groups, draw ledger) and
    every state array bit for bit.  With ``serial2``, a second serial run
    of the same seeds (fp32), only what the two serial runs agree on is
    held, and the gaps are counted: answers and arrays where the two
    serial runs part (``serial_gap``) and where the pipelined run parts
    from the first (``pipe_gap``, which must stay inside the first)."""
    import numpy as np

    def keys(run):
        return [answer_key(a) for tick in run[0] for a in tick]

    def same(x, y):
        return x.shape == y.shape and np.array_equal(x, y, equal_nan=True)

    p, s = keys(piped), keys(serial)
    check(len(p) == len(s) > 0, f"the {name} run answered {len(p)} "
                                f"queries, its serial twin {len(s)}")
    check(set(piped[1]) == set(serial[1]),
          f"the {name} run kept other stores than its serial twin")
    s2 = keys(serial2) if serial2 is not None else s
    arrays2 = serial2[1] if serial2 is not None else serial[1]
    gaps = dict(answers=len(p), arrays=len(serial[1]), serial_gap=0,
                pipe_gap=0, serial_gap_arrays=[], pipe_gap_arrays=[])
    for i, (a, b, c) in enumerate(zip(p, s, s2)):
        gaps["serial_gap"] += b != c
        gaps["pipe_gap"] += a != b
        check(a == b or b != c, f"the {name} run's answer {i} differs from "
                                f"its serial twin's, which a second serial "
                                f"run repeats: {a} against {b}")
    for k, want in serial[1].items():
        rep = same(want, arrays2[k])
        if not rep:
            gaps["serial_gap_arrays"].append(str(k))
        if not same(piped[1][k], want):
            gaps["pipe_gap_arrays"].append(str(k))
            check(not rep, f"the {name} run's {k} differs from its serial "
                           f"twin's, which a second serial run repeats")
    return gaps


def pipe_path(name: str, distinct: bool, f64: bool, mesh, n_blocks=1000,
              n_groups=16, rows=20000, ticks=(0.5, 0.25, 0.25),
              device: str = "cuda") -> dict:
    """One pipelined run of the main path (the torch default dtype float64
    for a float64 run, restored after it), on ``route="mesh"`` over
    ``mesh`` or on the device route: the launch counts are set to 0 just
    before it and read just after, and every kernel of its tick must have
    launched.  A serial run of the same seeds is made beside it: its
    launches tick by tick must be the pipelined run's, and its answers
    and state the pipelined run's bit for bit (``check_twin``; fp32 with
    a second serial run beside it).  ``device`` is the card; the CPU
    rehearses the phase at a small size."""
    import torch
    from repro_torch.kernels import isla_moments as K

    route = "device" if mesh is None else "mesh"
    args = (device, route, n_blocks, n_groups, rows, ticks, distinct)
    was = torch.get_default_dtype()
    if f64:
        torch.set_default_dtype(torch.float64)
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        answers, ex, records = pipe_serve(*args, True, mesh=mesh)
        wall = time.perf_counter() - t0
        launches = {n: getattr(K, n).launches for n in ISLA_LAUNCHES}
        tick_kernels = (("isla_tagged_fold", "isla_sketch_tagged") if f64
                        else ("isla_fold", "isla_sketch"))
        other = (("isla_fold", "isla_sketch") if f64
                 else ("isla_tagged_fold", "isla_sketch_tagged"))
        check(device != "cuda" or (
            launches[tick_kernels[0]] > 0 and launches["pilot_stats"] == 1
            and (launches[tick_kernels[1]] > 0) == distinct
            and not any(launches[n] for n in other)),
              f"the {name} run launched {launches}")
        piped = (answers, store_arrays(ex._device_stores))
        del ex
        s_answers, s_ex, s_records = pipe_serve(*args, False, mesh=mesh)
        serial = (s_answers, store_arrays(s_ex._device_stores))
        del s_ex
        for k, (r, q) in enumerate(zip(records, s_records)):
            check(r["launches"] == q["launches"],
                  f"the {name} run's tick {k + 1} launched {r['launches']}, "
                  f"its serial twin's {q['launches']}")
        serial2 = None
        if not f64:
            s2_answers, s2_ex, _ = pipe_serve(*args, False, mesh=mesh)
            serial2 = (s2_answers, store_arrays(s2_ex._device_stores))
            del s2_ex
        twin = check_twin(name, piped, serial, serial2)
    finally:
        torch.set_default_dtype(was)
    return dict(name=name, route=route, shards=len(mesh or ("cuda",)),
                launches=launches, wall_s=wall, ticks=records,
                serial_ticks=s_records, twin=twin,
                chunk_blocks=PIPE_CHUNK_BLOCKS, modes=list(PIPE_MODES),
                shape=dict(blocks=n_blocks, groups=n_groups, rows=rows))


def check_pipe_profile(r: dict, n_chunk_ticks: int) -> dict:
    """A profiled pipelined top-up tick: ``n_chunk_ticks`` ``isla:launch``
    ranges on the launch worker and none on the main thread, at least one
    overlapping a main-thread ``isla:draw`` range, and every ISLA kernel
    the launch counts name inside the window (``trace_whole``)."""
    rg = r["ranges"]
    ov = overlap_us(rg["worker_launch"], rg["main_draw"])
    check(len(rg["worker_launch"]) == n_chunk_ticks
          and not rg["main_launch"] and ov > 0,
          f"the profiled pipelined tick: {len(rg['worker_launch'])} "
          f"isla:launch ranges on the launch worker (want "
          f"{n_chunk_ticks}), {len(rg['main_launch'])} on the main thread, "
          f"{ov:.0f} us of them under a main-thread draw")
    return dict(worker_launches=len(rg["worker_launch"]),
                main_draws=len(rg["main_draw"]), overlap_us=ov,
                launch_us=sum(e - s for s, e in rg["worker_launch"]),
                draw_us=sum(e - s for s, e in rg["main_draw"]))


def profiled_pipe(n_blocks=1000, n_groups=16, rows=20000,
                  ticks=(0.5, 0.25, 0.25)) -> "tuple[dict, int]":
    """The fp32 moments run pipelined again with its top-up tick under the
    profiler (every thread's ranges): held to ``check_pipe_profile`` once
    its trace is whole, taken again up to ``PROFILE_TRIES`` runs when the
    profiler lost kernels.  Returns the tick's record and the runs taken."""
    n_chunk_ticks = len(PIPE_MODES) * -(-n_blocks // PIPE_CHUNK_BLOCKS)
    for run in range(1, PROFILE_TRIES + 1):
        _, _, recs = pipe_serve("cuda", "device", n_blocks, n_groups, rows,
                                ticks, False, True,
                                profile_at=(PIPE_PROFILED_TICK,))
        r = recs[PIPE_PROFILED_TICK]
        if trace_whole(r):
            r["profile"] = check_pipe_profile(r, n_chunk_ticks)
            return r, run
        print(f"the profiled pipelined re-run {run}: the trace lost "
              f"kernels the launch counts name: {r['kernel_events']}")
    check(False, f"the profiled pipelined tick lost kernels in "
                 f"{PROFILE_TRIES} runs")


def tagged_bound_ms(values, seg, bounds, n_cells: int
                    ) -> "tuple[float, float]":
    """Least time for one tagged fold on this stream: every sample's value
    and id read once, the cuts read once, every resident row (11 columns)
    read and written once; against ~17 operations a sample (two
    multiplies, four compares, up to eleven adds) at the float64 (or
    fp32) rate outside the tensor cores."""
    w = values.element_size()
    in_bytes = values.numel() * (w + 4) + bounds.numel() * w
    t_bytes = (in_bytes + 2 * 11 * w * n_cells) / HBM_BYTES_PER_S * 1e3
    rate = FP64_FLOP_PER_S if w == 8 else FP32_FLOP_PER_S
    return t_bytes, 17 * values.numel() / rate * 1e3


def check_main_path_tagged(calls) -> "list[dict]":
    """Replay each tagged fold of the float64 runs on a copy of its rows,
    on both paths: the run table the tick carried (the main path) and the
    stable sort (the path of streams in any order).  On each, the kernel
    twice (identical bits) against its plain version run on the CPU over
    the same tensors, bit for bit; then the call's device time and
    events, its kernel's time, its bound and the ratio, the plain version
    on the card, and (run table) the same stream folded at fp32.  A
    run-table call must hold one run kernel and no sort kernel."""
    import torch
    from repro_torch.kernels import isla_moments as K

    out = []
    for c in calls:
        state, (values, seg, bounds) = c["args"][:3], c["args"][3:]
        runs = c["kw"].get("runs")
        check(runs is not None, "a float64 tick folded with no run table")
        table = bounds.reshape(-1, 4).contiguous()
        n = state[0].shape[0]
        t_bytes, t_ops = tagged_bound_ms(values, seg, table, n)
        bound = max(t_bytes, t_ops)

        def fold(rows, v=values, b=table, r=runs):
            K.isla_tagged_fold(v, seg, b, *rows, runs=r)

        rows = [t.to("cpu", copy=True) for t in state]
        K.isla_tagged_fold(values.cpu(), seg.cpu(), table.cpu(), *rows,
                           runs=runs._replace(table=runs.table.cpu()))
        want = torch.cat(rows, dim=1)
        row = dict(samples=values.numel(), cells=n,
                   per_cell_cuts=table.shape[0] > 1,
                   tolerance="0 (bit-identical)", bytes_ms=t_bytes,
                   ops_ms=t_ops, bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        for path, r, kernel in (("runs", runs, "isla_tagged_runs_kernel"),
                                ("sorted", None, "isla_tagged_fold_kernel")):
            def run():
                rows = [t.clone() for t in state]
                fold(rows, r=r)
                return torch.cat(rows, dim=1)

            got, again = run(), run()
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"isla_tagged_fold ({path}) is "
                                           f"not deterministic on the main "
                                           f"path")
            check(torch.equal(got.cpu(), want),
                  f"isla_tagged_fold ({path}) disagrees with its plain "
                  f"version on the main path's {values.numel()}-sample "
                  f"stream")
            scratch = [t.clone() for t in state]
            call_ms, events = kernel_events(lambda: fold(scratch, r=r),
                                            ("",))
            kern_ms = kernel_ms(lambda: fold(scratch, r=r), (kernel,))
            row[path] = dict(ms=call_ms, kernel_ms=kern_ms,
                             kernels_a_call=events,
                             over_bound=(None if call_ms is None
                                         else call_ms / bound),
                             max_abs_err=max_abs_err(got.cpu(), want))
        check(int(runs.count) == 0, "the main path's run table was found "
                                    "out of place")
        scratch = [t.clone() for t in state]
        names = [n for n, _ in window_events(lambda: fold(scratch), ("",),
                                             reps=5)]
        check(sum("isla_tagged_runs_kernel" in n for n in names) == 5
              and not any("sort" in n.lower() for n in names),
              f"five run-table folds ran {names}")
        rs, sd = row["runs"], row["sorted"]
        with PlainVersions():
            plain_ms = time_ms(lambda: fold(scratch), reps=3, warm=1)
        s32 = [t.float() for t in state]
        v32, b32 = values.float(), table.float()
        f32_ms = kernel_events(lambda: fold(s32, v32, b32), ("",))[0]
        b32_bytes, b32_ops = tagged_bound_ms(v32, seg, b32, n)
        row.update(ms=rs["ms"], kernel_ms=rs["kernel_ms"],
                   max_abs_err=max(rs["max_abs_err"], sd["max_abs_err"]),
                   call_kernels=sorted(set(names)),
                   sort_share=(None if sd["ms"] is None
                               or sd["kernel_ms"] is None
                               else 1.0 - sd["kernel_ms"] / sd["ms"]),
                   plain_ms=plain_ms, fp32_ms=f32_ms,
                   fp32_bound_ms=max(b32_bytes, b32_ops))
        out.append(row)
    return out


def check_main_path_tagged_sketches(calls) -> "list[dict]":
    """Replay each tagged register merge of the float64 distinct run on a
    copy of the plane it found: the kernel twice against its plain version
    run on the CPU over the same tensors, bit for bit, then timed from
    that plane, with the call's bound."""
    import torch
    from repro_torch.kernels import isla_moments as K

    out = []
    for c in calls:
        bits, seg, regs0 = c["args"]

        def run():
            regs = regs0.clone()
            K.isla_sketch_tagged(bits, seg, regs)
            return regs

        got, again = run(), run()
        want = regs0.to("cpu", copy=True)
        K.isla_sketch_tagged(bits.cpu(), seg.cpu(), want)
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              "isla_sketch_tagged is not deterministic on the main path")
        check(torch.equal(got.cpu(), want),
              f"isla_sketch_tagged disagrees with its plain version on the "
              f"main path's {bits.numel()}-lane stream")
        changed = int((got != regs0).sum())
        scratch = regs0.clone()
        dev_ms = kernel_ms(lambda: K.isla_sketch_tagged(bits, seg, scratch),
                           ("isla_sketch",),
                           setup=lambda: scratch.copy_(regs0))
        event_ms = time_ms(lambda: K.isla_sketch_tagged(bits, seg, scratch))
        with PlainVersions():
            plain_ms = time_ms(lambda: K.isla_sketch_tagged(bits, seg,
                                                            scratch),
                               reps=3, warm=1)
        live = int(((seg >= 0) & (seg < regs0.shape[0])).sum())
        t_bytes = (live * 12 + 2 * changed) / HBM_BYTES_PER_S * 1e3
        t_ops = SKETCH_OPS_PER_LANE * live / FP32_FLOP_PER_S * 1e3
        out.append(dict(lanes=bits.numel(), live_lanes=live,
                        changed_registers=changed,
                        max_abs_err=max_abs_err(got.cpu(), want),
                        tolerance="0 (bit-identical)",
                        ms=event_ms if dev_ms is None else dev_ms,
                        kernel_ms=dev_ms, repeat_event_ms=event_ms,
                        plain_ms=plain_ms, bytes_ms=t_bytes, ops_ms=t_ops,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations"))
    return out


TIGHT_E = 0.04  # ~166 pilot samples a block, ~166,000 in all


def tight_plan(n_blocks=1000, n_groups=16, rows=20000, seed=0) -> dict:
    """One device-route ``plan`` (no tick) on the loop's tables at a
    precision e tight enough that the pilot draws at least 100,000
    samples: its pilot size, the device pilot's seconds (host clock around
    ``pilot_stats_device``) and its launches, counted from 0."""
    import numpy as np
    import repro_torch.core as C
    import repro_torch.core.multiquery as MQ
    import torch
    from repro_torch.kernels import isla_moments as K
    from repro_torch.launch.serve import _synthetic_grouped_blocks

    samplers = _synthetic_grouped_blocks(n_blocks, n_groups, rows, seed)
    ex = C.MultiQueryExecutor(samplers, [10 ** 7] * n_blocks,
                              params=C.IslaParams(e=TIGHT_E),
                              group_domains={"region": n_groups},
                              device="cuda")
    real, spent = MQ.pilot_stats_device, []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        spent.append(time.perf_counter() - t0)
        return out

    MQ.pilot_stats_device = timed
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        plan = ex.plan(serve_queries(C, TIGHT_E, False),
                       np.random.default_rng(seed + 1), route="device")
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
    finally:
        MQ.pilot_stats_device = real
    n = int(plan.pilot.pilot_size)
    check(n >= 100_000 and len(spent) == 1 and K.pilot_stats.launches == 1,
          f"the tight plan drew a pilot of {n} samples with "
          f"{len(spent)} device pilots and {K.pilot_stats.launches} "
          f"pilot_stats launches")
    check(math.isfinite(plan.pilot.sketch0) and plan.pilot.sigma > 0,
          f"the tight plan's pilot has sketch0 {plan.pilot.sketch0} and "
          f"sigma {plan.pilot.sigma}")
    return dict(e=TIGHT_E, pilot_size=n, pilot_s=spent[0], plan_s=plan_s,
                pilot_launches=K.pilot_stats.launches,
                sketch0=plan.pilot.sketch0, sigma=plan.pilot.sigma)


# ---------------------------------------------------------------------------
# The float64 dense tick: DeviceStack.tick(dense=...) on float64 stacks at
# the main path's stack shape, folded by isla_fold's float64 form.
# ---------------------------------------------------------------------------

# (name, COUNT DISTINCT)
DENSE64_RUNS = (("moments f64 dense", False), ("distinct f64 dense", True))
DENSE64_RATE = 954      # samples a drawn block: the top-up tick's rate
DENSE64_PROFILED_TICK = 1
DENSE64_TOL = 1e-12     # relative, against the plain fold and the tagged run
DENSE64_SHAPES = ((1000, 512), (1000, 1024))  # row 1's fold_panes calls


def rel_gap(got, want) -> float:
    """The largest ``|got - want| / |want|`` over two float64 arrays (inf
    where ``want`` is 0 and ``got`` is not)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    if not diff.any():
        return 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.max(np.where(diff > 0, diff / np.abs(want), 0.0)))


def to_device(x, device="cpu", dtype=None):
    """``x`` with every tensor in it (tuples, NamedTuples, lists, dicts)
    on ``device``; with ``dtype``, its floating-point tensors of another
    width cast to it (fp32 leaves of a bf16 tree stay fp32 when ``dtype``
    is fp32)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):   # a NamedTuple
        return type(x)(*(to_device(v, device, dtype) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device, dtype) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, device, dtype) for k, v in x.items()}
    if not hasattr(x, "to"):
        return x
    if dtype is not None and x.is_floating_point():
        return x.to(device=device, dtype=dtype)
    return x.to(device)


def check_fold64(device, n_blocks: int, quota: int) -> dict:
    """The float64 fold on the smoke's four keys at one of row 1's
    ``fold_panes`` shapes: against its plain version run on the CPU on
    the same numbers (rel 1e-12), two launches bit for bit, then the
    kernel's device time beside the fp32 fold's on the same panes."""
    import torch

    case = fold_case(device, n_blocks, quota, dtype=torch.float64)
    host = fold_case("cpu", n_blocks, quota, dtype=torch.float64)
    got, again = case["prior"].clone(), case["prior"].clone()
    fold_stack_tick(case, got)
    fold_stack_tick(case, again)
    want = host["prior"].clone()
    t0 = time.perf_counter()
    fold_stack_tick(host, want)
    plain_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    check(torch.equal(got, again), "isla_fold's float64 form is not "
                                   "deterministic")
    rel = float(((got.cpu() - want).abs()
                 / want.abs().clamp_min(1.0)).max())
    check(rel <= DENSE64_TOL,
          f"isla_fold's float64 form disagrees with its plain version at "
          f"{(n_blocks, quota)}: max rel err {rel:.3g} > {DENSE64_TOL}")
    scratch = case["prior"].clone()
    ms = kernel_ms(lambda: fold_stack_tick(case, scratch), ("isla_fold",))
    event_ms = time_ms(lambda: fold_stack_tick(case, scratch))
    c32 = fold_case(device, n_blocks, quota)
    s32 = c32["prior"].clone()
    fp32_ms = kernel_ms(lambda: fold_stack_tick(c32, s32), ("isla_fold",))
    t_bytes, t_ops = panes_bound_ms(
        case["values"], case["pad"], (case["gid"],), (case["valid"],),
        case["bounds"], n_cells=case["n_cells"], n_keys=len(FOLD_KEYS))
    return dict(pane=[n_blocks, quota], cells=case["n_cells"],
                max_abs_err=max_abs_err(got.cpu(), want), max_rel_err=rel,
                tolerance=f"rel {DENSE64_TOL}", ms=ms, event_ms=event_ms,
                fp32_ms=fp32_ms, plain_ms=plain_ms, bytes_ms=t_bytes,
                ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def dense64_stores(C, anchor, n_blocks, distinct, device):
    """The main path's four keys (plain, WHERE ``flag``, GROUP BY
    ``region``, both) as float64 device stores under one anchor."""
    import torch

    b, sketch0, n_groups = anchor
    return [C.DeviceMomentStore.fresh_device(
        n_blocks, b, sketch0, [10 ** 7] * n_blocks, n_groups=g,
        dtype=torch.float64, has_sketch=distinct, device=device)
        for g, _ in dense64_keys(n_groups)]


def dense64_keys(n_groups):
    return tuple((g, where) for g in (1, n_groups) for where in (False,
                                                                 True))


def dense64_draws(n_blocks=1000, n_groups=16, rows=20000, seed=0):
    """The phase's tables (the loop's ``_synthetic_grouped_blocks``), its
    anchor (cuts from a seeded 1000-sample pilot) and three drawing
    ticks: ``DENSE64_RATE`` rows of each active block, the even blocks
    active on the first tick, the odd ones on the second, then the even
    ones again (each mesh shard holds half its blocks active, so every
    shard compacts too).  Each tick is ``(raw values, quotas, region
    codes, flag mask)``, block-major."""
    import numpy as np
    import repro_torch.core as C
    from repro_torch.launch.serve import _synthetic_grouped_blocks

    _, tables = _synthetic_grouped_blocks(n_blocks, n_groups, rows, seed,
                                          with_tables=True)
    rng = np.random.default_rng(seed + 7)
    pilot = np.concatenate([t["value"][rng.integers(0, rows, 1)]
                            for t in tables])
    sketch0, sigma = float(pilot.mean()), float(pilot.std(ddof=1))
    anchor = (C.make_boundaries(sketch0, sigma, C.IslaParams()), sketch0,
              n_groups)
    halves = [np.arange(0, n_blocks, 2), np.arange(1, n_blocks, 2)]
    ticks = []
    for active in (halves[0], halves[1], halves[0]):
        quotas = np.zeros(n_blocks, dtype=np.int64)
        quotas[active] = DENSE64_RATE
        idx = [rng.integers(0, rows, DENSE64_RATE) for _ in active]
        vals = np.concatenate([tables[b]["value"][i]
                               for b, i in zip(active, idx)])
        gids = np.concatenate([tables[b]["region"][i]
                               for b, i in zip(active, idx)]).astype(np.int64)
        flag = np.concatenate([tables[b]["flag"][i]
                               for b, i in zip(active, idx)]) == 1.0
        ticks.append((vals, quotas, gids, flag))
    return anchor, ticks


def dense64_payload(tick, n_groups):
    vals, quotas, gids, flag = tick
    keys = dense64_keys(n_groups)
    return dict(values=vals, quotas=quotas,
                dense=([gids if g > 1 else None for g, _ in keys],
                       [flag if w else None for _, w in keys]))


def tagged64_payload(stack, stores, tick, n_groups, distinct):
    """The same tick as the tagged payload: every key's matched samples
    in its own frame, placed by ``key_seg``, with its run table."""
    import numpy as np
    from repro_torch.core import sketch as SK

    vals, quotas, gids, flag = tick
    bids = np.repeat(np.arange(quotas.size), quotas)
    segs, vs, his, los, runs = [], [], [], [], []
    hi, lo = SK.value_limbs(vals) if distinct else (None, None)
    for k, (st, (g, where)) in enumerate(zip(stores,
                                             dense64_keys(n_groups))):
        mask = flag if where else None
        keep = slice(None) if mask is None else mask
        segs.append(stack.key_seg(k, st, bids, gids if g > 1 else None,
                                  mask))
        vs.append(((vals + st.shift) / st.scale)[keep])
        runs.append(stack.key_runs(quotas, mask))
        if distinct:
            his.append(hi[keep])
            los.append(lo[keep])
    kw = dict(values=np.concatenate(vs), seg=np.concatenate(segs),
              quotas=quotas, runs=np.stack(runs))
    if distinct:
        kw["hash_limbs"] = (np.concatenate(his), np.concatenate(los))
    return kw


def dense64_serve(kind, distinct, anchor, ticks, device="cuda",
                  profile_at=(), compaction=True, keep=False) -> dict:
    """The phase's ticks through one float64 stack on ``device``: ``kind``
    "device" (a ``DeviceStack``), "mesh" (``MESH_SHARDS`` shards, all on
    ``cuda:0`` on the card) or "tagged" (a ``DeviceStack`` fed the tagged
    payload).  The launch counts are read around each tick; ``keep``
    keeps the arguments of every ``fold_panes`` call for the replays."""
    import torch
    import repro_torch.core as C
    from repro_torch.kernels import isla_moments as K
    from repro_torch.launch.mesh import make_cell_mesh

    n_blocks, n_groups = ticks[0][1].size, anchor[2]
    stores = dense64_stores(C, anchor, n_blocks, distinct, device)
    shards = MESH_DEVICES if device == "cuda" else (device,) * MESH_SHARDS
    stack = (C.MeshDeviceStack(stores, make_cell_mesh(devices=list(shards)))
             if kind == "mesh" else C.DeviceStack(stores))
    stack.block_compaction = compaction
    params = C.IslaParams()
    records = []
    with Recorder("fold_panes", keep=keep) as folds:
        for k, tick in enumerate(ticks):
            before = (K.isla_fold.launches_f64, K.isla_fold.launches,
                      K.isla_sketch.launches)
            timings = {}
            prof = profile_tick(device, k in profile_at)
            # The wall clock takes the payload's host build too: the
            # tagged one cuts each key's slice and run table on the host.
            # It runs inside the window: a profiled tick's excludes the
            # window's padding.
            with prof:
                t0 = time.perf_counter()
                kw = (tagged64_payload(stack, stores, tick, n_groups,
                                       distinct) if kind == "tagged"
                      else dense64_payload(tick, n_groups))
                stack.tick(params, timings=timings, **kw)
                if device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            after = (K.isla_fold.launches_f64, K.isla_fold.launches,
                     K.isla_sketch.launches)
            f64, f32, sk = (a - b for a, b in zip(after, before))
            records.append(dict(
                new_samples=int(tick[1].sum()),
                active_blocks=int((tick[1] > 0).sum()), wall_s=wall,
                stages_s=timings, fold_f64_launches=f64,
                fold_launches=f32, sketch_launches=sk,
                device_busy_s=device_seconds(prof),
                kernel_events=device_kernel_counts(prof)))
    compacted = bool(stack._active_cache)
    check(compacted is (compaction and kind != "tagged"),
          f"the {kind} float64 dense run's compaction engaged: {compacted}")
    return dict(kind=kind, ticks=records,
                arrays=store_arrays(dict(enumerate(stores))),
                fold_calls=folds.calls, compacted=compacted)


def dense64_trace_whole(r: dict) -> bool:
    """``trace_whole`` for a float64 dense tick: its trace holds the fold
    launches that the float64 counter names."""
    ev = r["kernel_events"]
    return ev is not None and ev["isla_fold_kernel"] >= r[
        "fold_f64_launches"] and ev["isla_sketch_kernel"] >= r[
            "sketch_launches"]


def dense64_path(name: str, distinct: bool, device="cuda", **shape) -> dict:
    """One run of the float64 dense phase at the main path's stack shape
    (4 keys x 16 groups x 1000 blocks, 34,000 cells): the launch counts are
    set to 0 just before the device run's ticks and read just after;
    every drawing tick must make one float64 ``isla_fold`` launch (and,
    with COUNT DISTINCT, one ``isla_sketch``) and no fp32 fold.  A
    ``block_compaction=False`` twin must give the same bits (state,
    ledgers, register planes, partials), so must the four-shard mesh, and
    a float64 tagged run of the same samples must lie within rel 1e-12
    (moments and partials; ledgers and registers bit for bit).  A
    profiled re-run of the top-up tick must show the fold's kernel, no
    sort kernel and a whole trace.  ``shape`` cuts the tables
    (``dense64_draws``' arguments)."""
    import numpy as np
    from repro_torch.kernels import isla_moments as K

    anchor, ticks = dense64_draws(**shape)
    serve = functools.partial(dense64_serve, distinct=distinct,
                              anchor=anchor, ticks=ticks, device=device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dev = serve("device", keep=True)
    wall = time.perf_counter() - t0
    launches = {"isla_fold_f64": K.isla_fold.launches_f64,
                "isla_fold": K.isla_fold.launches,
                "isla_sketch": K.isla_sketch.launches}
    for k, r in enumerate(dev["ticks"]):
        check(r["fold_f64_launches"] == 1 and r["fold_launches"] == 0
              and r["sketch_launches"] == int(distinct),
              f"the {name} run's tick {k + 1} launched "
              f"{r['fold_f64_launches']} float64 and {r['fold_launches']} "
              f"fp32 folds, {r['sketch_launches']} merges")
    full = serve("device", compaction=False)
    K.reset_launch_counts()
    mesh = serve("mesh")
    mesh_launches = {"isla_fold_f64": K.isla_fold.launches_f64,
                     "isla_fold": K.isla_fold.launches,
                     "isla_sketch": K.isla_sketch.launches}
    for k, r in enumerate(mesh["ticks"]):
        check(r["fold_f64_launches"] == MESH_SHARDS
              and r["fold_launches"] == 0
              and r["sketch_launches"] == MESH_SHARDS * int(distinct),
              f"the {name} mesh run's tick {k + 1} launched "
              f"{r['fold_f64_launches']} float64 and {r['fold_launches']} "
              f"fp32 folds, {r['sketch_launches']} merges")
    tagged = serve("tagged")
    for twin, what in ((full, "block_compaction=False twin"),
                       (mesh, "four-shard mesh run")):
        for key, want in dev["arrays"].items():
            check(np.array_equal(twin["arrays"][key], want),
                  f"the {name} run's {what} differs in {key}")
    gaps = {}
    for key, want in tagged["arrays"].items():
        got = dev["arrays"][key]
        if key[1] in ("mom_s", "mom_l", "totals", "partials"):
            gaps[key[1]] = max(gaps.get(key[1], 0.0), rel_gap(got, want))
        else:
            check(np.array_equal(got, want), f"the {name} run's {key} "
                                             f"differs from the tagged run's")
    check(max(gaps.values()) <= DENSE64_TOL,
          f"the {name} run parts from the float64 tagged run: {gaps}")
    traced = None
    for run in range(1, PROFILE_TRIES + 1):
        rec = serve("device", profile_at=(DENSE64_PROFILED_TICK,))
        traced = rec["ticks"][DENSE64_PROFILED_TICK]
        ev = traced["kernel_events"] or {}
        check(not ev.get("sort") and not ev.get("isla_tagged_fold_kernel")
              and not ev.get("isla_tagged_runs_kernel"),
              f"the {name} run's profiled tick ran {ev}")
        if dense64_trace_whole(traced):
            break
        check(run < PROFILE_TRIES, f"the {name} run's profiled tick lost "
                                   f"kernels in {PROFILE_TRIES} runs: {ev}")
    return dict(name=name, launches=launches, mesh_launches=mesh_launches,
                wall_s=wall, ticks=dev["ticks"], full_ticks=full["ticks"],
                mesh_ticks=mesh["ticks"], tagged_ticks=tagged["ticks"],
                tagged_gaps=gaps, profiled_tick=traced, traced_runs=run,
                fold_calls=dev["fold_calls"], shape=dict(
                    blocks=ticks[0][1].size, groups=anchor[2],
                    cells=sum(g for g, _ in dense64_keys(anchor[2]))
                    * ticks[0][1].size, rate=DENSE64_RATE))


# ---------------------------------------------------------------------------
# The telemetry estimator: distributed.isla_mean / exact_mean and metrics on
# per-token losses, router probabilities and the LM's parameter tree, on the
# device route and on four shards; Phase 1 is one isla_fold a shard.
# ---------------------------------------------------------------------------

# (512, 2048): the 1M-token step of examples/approximate_telemetry.py;
# (4096, 4096): a 16M-token step, the order of the largest published
# pretraining batches.
TELEMETRY_SHAPES = ((512, 2048), (4096, 4096))
TELEMETRY_RATE = 0.02
TELEMETRY_TOL = 1e-5        # relative: the port's fp32 contract
TELEMETRY_SEED = 7          # generators' seeds (shard s: + s)
ACCURACY_SHAPE = (256, 4096)  # telemetry_bench.py's normal(5.5, 1.5) tensor
ROUTER_ARCH = "arctic-480b"
ROUTER_TOKENS = (8, 2048)   # batch x tokens of router logits
OTHER_KERNELS = ("pilot_stats", "isla_sketch", "isla_sketch_tagged",
                 "isla_tagged_fold", "isla_fold_f64", "flash_attention")


def telemetry_calls():
    """``(name, kind, kw)`` of every call the phase makes on a loss
    tensor."""
    calls = [("loss_stats", "loss_stats", {})]
    for sem in ("blocks", "merged"):
        for mode in ("calibrated", "empirical"):
            for sampling in ("strided", "generator"):
                calls.append((f"isla_mean {sem} {mode} {sampling}",
                              "isla_mean",
                              dict(semantics=sem, mode=mode,
                                   generator=sampling == "generator")))
    calls.append(("exact_mean", "exact_mean", {}))
    calls.append(("loss_stats_trimmed_exact", "trimmed", {}))
    return calls


def telemetry_expect(kind: str, kw: dict) -> "tuple[int, list]":
    """A call's ``isla_fold`` launches a shard and the elements of each
    cross-shard sum it makes on a mesh."""
    if kind == "isla_mean":
        return 1, [3] + ([6] if kw["mode"] == "empirical" else []) \
            + [8 if kw["semantics"] == "merged" else 2]
    return {"loss_stats": (1, [3, 6, 2, 2]), "exact_mean": (0, [2]),
            "trimmed": (0, []), "router": (1, [3, 2]),
            "grad": (1, [3, 8])}[kind]


def telemetry_fn(kind: str, kw: dict, x, mesh):
    """A zero-argument call of the phase on ``x`` (a tensor, or with
    ``mesh`` a list with a tensor or tree a shard), returning a dict of
    0-d tensors.  A generator call makes its generators anew each time,
    from the same seeds: every run draws the same indices."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core import metrics as M

    p = M.DEFAULT_PARAMS
    if kind == "isla_mean":
        kw = dict(kw)
        drawn = kw.pop("generator")

        def gens():
            if not drawn:
                return None
            if mesh is None:
                return torch.Generator(device=x.device).manual_seed(
                    TELEMETRY_SEED)
            return [torch.Generator(device=v.device).manual_seed(
                TELEMETRY_SEED + s) for s, v in enumerate(x)]

        return lambda: {"isla_mean": D.isla_mean(
            x, p, mesh=mesh, rate=TELEMETRY_RATE, generator=gens(), **kw)}
    return {"loss_stats": lambda: M.loss_stats(x, mesh=mesh,
                                               include_exact=True),
            "exact_mean": lambda: {"exact_mean": D.exact_mean(x, mesh)},
            "trimmed": lambda: M.loss_stats_trimmed_exact(x),
            "router": lambda: M.router_load_stats(x, mesh=mesh),
            "grad": lambda: M.grad_abs_stats(x, mesh=mesh)}[kind]


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class FoldPanes:
    """Keeps a copy of the first pane of each length that ``isla_mean``
    folds through ``ops.isla_moments`` (with its cuts) while installed and
    ``on``."""

    def __init__(self):
        self.panes, self.on = {}, False

    def __enter__(self):
        from repro_torch.kernels import ops

        self._real = real = ops.isla_moments

        def spy(values, bounds, *a, **kw):
            n = values.numel()
            if self.on and n not in self.panes:
                self.panes[n] = (values.clone(), bounds.clone())
            return real(values, bounds, *a, **kw)

        ops.isla_moments = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.isla_moments = self._real
        return False


def telemetry_call(name: str, kind: str, kw: dict, x, mesh, cpu_x,
                   cpu_mesh, device) -> dict:
    """One call of the phase, checked: the launch counts are set to 0 just
    before it and read just after (``isla_fold`` once a shard for an ISLA
    call, no other kernel), no ``h2d`` call, its cross-shard sums as
    ``telemetry_expect`` says (none without a mesh); each answer a finite
    fp32 0-d tensor on the values' (the mesh's first) device, within rel
    ``TELEMETRY_TOL`` of the same call under ``PlainVersions`` and, unless
    it draws with a generator, of the port on the CPU tensors made from
    the same arrays (``cpu_x``; None: no CPU run)."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K

    fn = telemetry_fn(kind, kw, x, mesh)
    n_shards = 1 if mesh is None else len(mesh.devices)
    K.reset_launch_counts()
    with Recorder("h2d", keep=False) as up, D.collective_footprint() as rec:
        out = fn()
    sync(device)
    launches = dict(isla_fold=K.isla_fold.launches,
                    isla_fold_f64=K.isla_fold.launches_f64,
                    pilot_stats=K.pilot_stats.launches,
                    isla_sketch=K.isla_sketch.launches,
                    isla_sketch_tagged=K.isla_sketch_tagged.launches,
                    isla_tagged_fold=K.isla_tagged_fold.launches,
                    flash_attention=FA.flash_attention.launches)
    per_shard, sums = telemetry_expect(kind, kw)
    where = f"{name} ({'mesh' if mesh else 'device'} route)"
    check(launches["isla_fold"] == per_shard * n_shards
          and not any(launches[k] for k in OTHER_KERNELS),
          f"{where} launched {launches}, not {per_shard} isla_fold a shard")
    check(up.count == 0, f"{where} uploaded through h2d {up.count} times")
    want_rec = [("sum", n) for n in sums] if mesh is not None else []
    check(rec == want_rec, f"{where} reduced {rec}, not {want_rec}")
    with PlainVersions():
        plain = fn()
    cpu = None
    if cpu_x is not None and not kw.get("generator"):
        cpu = telemetry_fn(kind, kw, cpu_x, cpu_mesh)()
    home = mesh.devices[0] if mesh is not None else next(_leaves(x)).device
    values, gaps = {}, {}
    for k, v in out.items():
        check(v.dtype == torch.float32 and v.dim() == 0 and v.device == home
              and bool(torch.isfinite(v)),
              f"{where} gave {k} = {v!r}, not a finite fp32 0-d tensor on "
              f"{home}")
        values[k] = float(v)
        gaps[k] = dict(plain=rel_gap(values[k], float(plain[k])))
        if cpu is not None:
            gaps[k]["cpu"] = rel_gap(values[k], float(cpu[k]))
        check(max(gaps[k].values()) <= TELEMETRY_TOL,
              f"{where} {k} = {values[k]!r} parts from its plain or CPU run "
              f"by {gaps[k]} > rel {TELEMETRY_TOL}")
    return dict(name=name, kind=kind, route="mesh" if mesh else "device",
                shards=n_shards, values=values, gaps=gaps,
                fold_launches=launches["isla_fold"],
                footprint=[n for _, n in rec], fn=fn)


def telemetry_routes(t, mesh_devices, device):
    """``(x, mesh)`` for the device route and the mesh (``t`` cut on dim
    0 into a shard a mesh device)."""
    from repro_torch.launch.mesh import make_cell_mesh

    mesh = make_cell_mesh(devices=list(mesh_devices))
    dev = t.to(device)
    shards = [p.to(d) for p, d in zip(dev.tensor_split(len(mesh.devices)),
                                       mesh.devices)]
    return (dev, None), (shards, mesh)


def telemetry_path(device="cuda", shapes=TELEMETRY_SHAPES,
                   mesh_devices=MESH_DEVICES,
                   accuracy_shape=ACCURACY_SHAPE,
                   router_tokens=ROUTER_TOKENS) -> dict:
    """The telemetry phase (``telemetry_call`` checks every call): on
    seeded gamma(2, 2) per-token losses of each of ``shapes``, every call
    of ``telemetry_calls`` on the device route and on the mesh (the
    trimmed mean on the device route: it has no mesh form, a mesh gathers
    the whole tensor); each call's cross-shard sums must be the same at
    every size.  Then the accuracy tensor (``telemetry_bench.py``'s
    normal(5.5, 1.5)) and ``router_load_stats`` on softmax probabilities
    of seeded logits over ``ROUTER_ARCH``'s experts.  Records each
    ``|isla - exact|`` beside the rate's uniform-subsample error
    ``sigma / sqrt(m)``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    calls, panes = [], FoldPanes()
    accuracy = []

    def routes(arr, run):
        t = torch.from_numpy(arr)
        for (x, mesh), (cx, cmesh) in zip(
                telemetry_routes(t, mesh_devices, device),
                telemetry_routes(t, ["cpu"] * len(mesh_devices), "cpu")):
            run(x, mesh, cx, cmesh)

    with panes:
        for shape in shapes:
            losses = np.random.default_rng(0).gamma(
                2.0, 2.0, size=shape).astype(np.float32)
            sigma = float(losses.astype(np.float64).std())

            def run(x, mesh, cx, cmesh, shape=shape, sigma=sigma):
                for name, kind, kw in telemetry_calls():
                    if kind == "trimmed" and mesh is not None:
                        continue
                    panes.on = kind in ("isla_mean", "loss_stats")
                    r = telemetry_call(name, kind, kw, x, mesh, cx, cmesh,
                                       device)
                    panes.on = False
                    r.update(shape=list(shape), sigma=sigma)
                    calls.append(r)

            routes(losses, run)
        for shape in shapes[1:]:
            for a, b in zip([c for c in calls if c["shape"] == list(shape)],
                            [c for c in calls
                             if c["shape"] == list(shapes[0])]):
                check(a["footprint"] == b["footprint"],
                      f"{a['name']} reduces {a['footprint']} at {shape}, "
                      f"{b['footprint']} at {shapes[0]}")
        for c in calls:
            exact = [d["values"]["exact_mean"] for d in calls
                     if d["kind"] == "exact_mean"
                     and d["shape"] == c["shape"]
                     and d["route"] == c["route"]][0]
            isla = c["values"].get("isla_mean",
                                   c["values"].get("loss_mean_isla"))
            if isla is not None:
                rate = 0.05 if c["kind"] == "loss_stats" else TELEMETRY_RATE
                m = round(math.prod(c["shape"]) * rate)
                c.update(exact=exact, abs_err=abs(isla - exact),
                         uniform_err=c["sigma"] / math.sqrt(m))
        normal = np.random.default_rng(0).normal(
            5.5, 1.5, size=accuracy_shape).astype(np.float32)

        def run_accuracy(x, mesh, cx, cmesh):
            kw = dict(semantics="blocks", mode="calibrated", generator=False)
            got = telemetry_call("isla_mean (accuracy)", "isla_mean", kw, x,
                                 mesh, cx, cmesh, device)
            ex = telemetry_call("exact_mean (accuracy)", "exact_mean", {},
                                x, mesh, cx, cmesh, device)
            m = round(normal.size * TELEMETRY_RATE)
            accuracy.append(dict(
                route=got["route"], shape=list(accuracy_shape),
                launches=got["fold_launches"],
                isla=got["values"]["isla_mean"],
                exact=ex["values"]["exact_mean"],
                abs_err=abs(got["values"]["isla_mean"]
                            - ex["values"]["exact_mean"]),
                uniform_err=float(normal.astype(np.float64).std())
                / math.sqrt(m), e=0.01))

        routes(normal, run_accuracy)
        n_exp = get_config(ROUTER_ARCH).moe.n_experts
        logits = np.random.default_rng(1).normal(
            size=(*router_tokens, n_exp)).astype(np.float32)
        probs = torch.softmax(torch.from_numpy(logits).to(device), -1)
        router = []

        def run_router(x, mesh, cx, cmesh):
            router.append(telemetry_call("router_load_stats", "router", {},
                                         x, mesh, cx, cmesh, device))

        routes(probs.cpu().numpy(), run_router)
    return dict(calls=calls, accuracy=accuracy, router=router,
                router_experts=n_exp, panes=panes.panes)


def grad_telemetry(params, device="cuda", mesh_devices=MESH_DEVICES
                   ) -> "list[dict]":
    """``grad_abs_stats`` over the LM phase's parameter tree (standing in
    for a gradient tree of its shape), on the device route and on the
    mesh (every leaf cut on dim 0 into a shard a mesh device), checked as
    ``telemetry_call`` checks; the CPU run takes a host copy of the
    tree."""
    from repro_torch.launch.mesh import make_cell_mesh

    def split(tree, n, s):
        if isinstance(tree, dict):
            return {k: split(v, n, s) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(split(v, n, s) for v in tree)
        return tree.tensor_split(n)[s] if hasattr(tree, "tensor_split") \
            else tree

    host = to_device(params)
    n = len(mesh_devices)
    mesh, cmesh = (make_cell_mesh(devices=list(mesh_devices)),
                   make_cell_mesh(devices=["cpu"] * n))
    out = [telemetry_call("grad_abs_stats", "grad", {}, params, None, host,
                          None, device),
           telemetry_call("grad_abs_stats", "grad", {},
                          [split(params, n, s) for s in range(n)], mesh,
                          [split(host, n, s) for s in range(n)], cmesh,
                          device)]
    del host
    return out


def wall_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds a call by CUDA events around ``reps`` calls
    issued back to back: the card waits on the host between launches, so
    this is the call's wall time, host work included."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def telemetry_fold_bound_ms(m: int) -> "tuple[float, float]":
    """Least time for the fold of an m-sample pane: each fp32 sample read
    once (4 B), the cuts read and the two (count, s1, s2, s3) rows read
    and written once; against 17 operations a sample at the fp32 peak."""
    t_bytes = (4 * m + 16 + 2 * 2 * 16) / HBM_BYTES_PER_S * 1e3
    return t_bytes, 17 * m / FP32_FLOP_PER_S * 1e3


def check_telemetry_folds(panes) -> "list[dict]":
    """Replays each kept pane's fold: the kernel twice (identical bits)
    against its plain version on the card within rel 1e-5, then the
    kernel timed by the profiler and by CUDA events, the plain version by
    CUDA events, beside the bound."""
    import torch
    from repro_torch.kernels import ops

    out = []
    for m, (values, bounds) in sorted(panes.items()):
        got, again = (ops.isla_moments(values, bounds) for _ in range(2))
        with PlainVersions():
            want = ops.isla_moments(values, bounds)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "isla_fold is not deterministic on "
                                       "a telemetry pane")
        rel = float(((got.double() - want.double()).abs()
                     / want.double().abs().clamp_min(1.0)).max())
        check(rel <= TELEMETRY_TOL,
              f"isla_fold parts from its plain version on the {m}-sample "
              f"telemetry pane: max rel err {rel:.3g}")
        fn = functools.partial(ops.isla_moments, values, bounds)
        dev_ms, events = kernel_events(fn, ("isla_fold",))
        event_ms = time_ms(fn)
        with PlainVersions():
            plain_ms = time_ms(fn)
        t_bytes, t_ops = telemetry_fold_bound_ms(m)
        out.append(dict(samples=m, kernel_ms=dev_ms,
                        kernels_a_call=events, event_ms=event_ms,
                        ms=event_ms if dev_ms is None else dev_ms,
                        plain_ms=plain_ms, max_abs_err=max_abs_err(got,
                                                                   want),
                        max_rel_err=rel, bytes_ms=t_bytes, ops_ms=t_ops,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations"))
    return out


def time_telemetry(calls) -> None:
    """Adds each call's times: ``wall_ms`` (CUDA events around calls
    issued back to back), ``device_ms`` (``time_ms``: the card held busy
    while the host enqueues) and, from the profiler, the device events a
    call and their summed time (``busy_ms``: the card's work without the
    gaps between launches)."""
    for c in calls:
        fn = c.pop("fn")
        reps = 5 if c["kind"] == "trimmed" else 20
        c["wall_ms"] = wall_ms(fn, reps=reps, warm=2)
        c["device_ms"] = time_ms(fn, reps=reps, warm=1)
        c["busy_ms"], c["events"] = kernel_events(fn, ("",), reps=5, warm=1)


# ---------------------------------------------------------------------------
# The LM serving path: olmo-1b at full width, every prefill's attention
# through the hand-written flash kernel.
# ---------------------------------------------------------------------------

LM_ARCH = "olmo-1b"
LM_REQUESTS = 6
LM_SLOTS = 4
LM_MAX_NEW = 16
LM_PROMPT_LENS = (384, 2048)   # seeded prompt lengths, both ends included
LM_MAX_SEQ = 2048 + LM_MAX_NEW + 16
# Profiled ticks of the LM re-run: two decode ticks of the four first
# requests, and the tick that admits (prefills) the last two.
LM_PROFILE_TICKS = (2, 3, 16)
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 dense tensor cores
# bf16 output: one to two bf16 ulps on O(1) values; fp32: the reference
# sweep's tolerance (tests/test_kernels_flash.py).  An element is held to
# max(tolerance, one ulp of the plain value in the output type): from
# |o| = 4 one bf16 ulp (2^-5) exceeds 2e-2, and two implementations that
# sum in different fp32 orders round an element there one ulp apart now
# and then (paligemma's values reach that range), which no bf16 kernel
# can avoid.  Below |o| = 4 the floor changes nothing.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def ulp_excess(got, want, tol: float) -> dict:
    """Each element of ``got`` against max(tol, one ulp of ``want`` in its
    type): the elements beyond that (``over``), those beyond ``tol`` that
    the one-ulp floor admits (``floor_only``), the largest difference as a
    share of what its element is allowed (``worst``), and max |want|."""
    import torch

    w = want.double()
    mag = w.abs()
    ulp = torch.finfo(want.dtype).eps * torch.exp2(torch.floor(torch.log2(
        mag.clamp_min(torch.finfo(want.dtype).tiny))))
    diff = (got.double() - w).abs()
    allowed = torch.clamp(ulp, min=tol)
    return dict(over=int((diff > allowed).sum()),
                floor_only=int(((diff > tol) & (diff <= allowed)).sum()),
                worst=float((diff / allowed).max()),
                max_abs_out=float(mag.max()))


def flash_err_text(fs) -> str:
    """The replays' agreement with the plain version, summed over ``fs``."""
    return (f"max abs err {max(f['max_abs_err'] for f in fs):.3g} at max "
            f"|o| {max(f['max_abs_out'] for f in fs):.3g}, "
            f"{sum(f['floor_only'] for f in fs)} elements past "
            f"{fs[0]['tolerance']} within one ulp, worst "
            f"{max(f['worst'] for f in fs):.2f} of max(tol, 1 ulp)")


class FlashCalls:
    """Keeps the arguments of every call the LM path makes to
    ``flash_attention`` (the (B*H, S, hd) q, k, v views of one layer's
    prefill), by wrapping the name ``models.attention`` calls while
    installed, and times every ``serve_prefill`` (host clock, synchronised
    on ``device``)."""

    def __init__(self, device="cuda"):
        self.device = device

    def __enter__(self):
        from repro_torch.models import attention as A
        from repro_torch.models import model as M

        self.calls, self.prefill_s, self.logits = [], [], []
        self._flash, self._prefill = A.flash_attention, M.serve_prefill
        flash, prefill = self._flash, self._prefill

        def spy_flash(q, k, v, *, groups=1):
            self.calls.append((q, k, v, groups))
            return flash(q, k, v, groups=groups)

        def spy_prefill(*args, **kw):
            sync(self.device)
            t0 = time.perf_counter()
            logits, cache = prefill(*args, **kw)
            sync(self.device)
            self.prefill_s.append(time.perf_counter() - t0)
            self.logits.append(logits)
            return logits, cache

        A.flash_attention, M.serve_prefill = spy_flash, spy_prefill
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        from repro_torch.models import model as M

        A.flash_attention, M.serve_prefill = self._flash, self._prefill
        return False


def flash_bound_ms(bh: int, bkv: int, s: int, hd: int, dtype
                   ) -> "tuple[float, float]":
    """Least time for one causal flash call: q, k, v read once and the
    output written once, against the 4 * hd flops of each (query, key <=
    query) pair of this call — S(S+1)/2 pairs a head — at the peak for the
    inputs' type (bf16 tensor cores; fp32 outside them).  The softmax's
    exponentials are not counted.  Returns (bytes ms, operations ms)."""
    import torch

    size = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (2 * bh + 2 * bkv) * s * hd * size / HBM_BYTES_PER_S * 1e3
    flops = 4.0 * bh * hd * s * (s + 1) / 2
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return t_bytes, flops / peak * 1e3


def check_flash(q, k, v, groups: int, reps: int = 10) -> dict:
    """The kernel (twice: identical bits) against its plain version on the
    same card tensors, then the kernel, the plain version and PyTorch's
    ``scaled_dot_product_attention`` (the library yardstick, used nowhere
    in the port) timed on them, with the call's bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    bh, s, hd = q.shape
    dt = str(q.dtype).replace("torch.", "")
    got = FA.flash_attention(q, k, v, groups=groups)
    again = FA.flash_attention(q, k, v, groups=groups)
    with PlainVersions():
        want = FA.flash_attention(q, k, v, groups=groups)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "flash_attention is not deterministic")
    err = max_abs_err(got, want)
    ulp = ulp_excess(got, want, FLASH_TOL[dt])
    check(ulp["over"] == 0, f"flash_attention disagrees with its plain "
                            f"version at {tuple(q.shape)} {dt}, groups "
                            f"{groups}: {ulp['over']} elements off by more "
                            f"than max({FLASH_TOL[dt]}, one ulp); max abs "
                            f"err {err:.3g}, max |o| "
                            f"{ulp['max_abs_out']:.3g}")
    ms = time_ms(lambda: FA.flash_attention(q, k, v, groups=groups),
                 reps=reps, warm=2)
    with PlainVersions():
        plain_ms = time_ms(lambda: FA.flash_attention(q, k, v, groups=groups),
                           reps=3, warm=1)
    q4, k4, v4 = (t[None] for t in (q, k, v))
    gqa = {"enable_gqa": True} if groups > 1 else {}
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, **gqa), reps=reps, warm=2)
    t_bytes, t_ops = flash_bound_ms(bh, k.shape[0], s, hd, q.dtype)
    return dict(shape=[bh, s, hd], kv_heads=k.shape[0], groups=groups,
                dtype=dt, max_abs_err=err, tolerance=FLASH_TOL[dt],
                floor_only=ulp["floor_only"], worst=ulp["worst"],
                max_abs_out=ulp["max_abs_out"], ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bytes_ms=t_bytes,
                ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_flash_synthetic(device) -> "list[dict]":
    """The kernel off the two LM paths: GQA (4 q heads per KV head; 56 q
    heads over 8 KV heads, arctic's odd group of 7, at a long length), MQA
    (8 q heads of 256 over one KV head, paligemma's layout), fp32 inputs
    (the CUDA-core body), and each head_dim it takes, at ragged prefill
    lengths."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    cases = [("gqa", 32, 4, 1000, 128, torch.bfloat16),
             ("gqa7_long", 56, 7, 1718, 128, torch.bfloat16),
             ("mqa", 16, 8, 1000, 256, torch.bfloat16),
             ("fp32", 16, 1, 777, 128, torch.float32),
             ("hd256_fp32", 16, 1, 777, 256, torch.float32),
             ("hd32", 16, 1, 1000, 32, torch.bfloat16),
             ("hd64", 16, 1, 1000, 64, torch.bfloat16),
             ("hd128", 16, 1, 1000, 128, torch.bfloat16),
             ("hd256", 16, 1, 1000, 256, torch.bfloat16)]
    out = []
    for name, bh, groups, s, hd, dtype in cases:
        def t(heads, scale):
            return torch.as_tensor(rng.normal(size=(heads, s, hd)) * scale,
                                   dtype=dtype, device=device)
        q, k, v = t(bh, 0.3), t(bh // groups, 0.3), t(bh // groups, 1.0)
        out.append(dict(check_flash(q, k, v, groups), name=name))
    return out


def check_lm_small(device) -> dict:
    """The slice on a small input against the same weights on the CPU
    (the kernels' plain versions): reduced olmo-1b with fp32 params, one
    prefill of 100 tokens (logits rel/abs 1e-4) and 4 decode steps
    (1e-3: an entry of the bf16 cache may round one ulp apart between the
    card's and the CPU's fp32 projections)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM

    cfg = get_config(LM_ARCH, reduced=True).replace(param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k_: to(v_, dev) for k_, v_ in tree.items()}
        if isinstance(tree, list):
            return [to(v_, dev) for v_ in tree]
        return tree.to(dev)

    toks = np.random.default_rng(12).integers(0, cfg.vocab, (1, 104))
    logits = {}
    for dev in ("cpu", device):
        p = to(params, dev)
        cache = TM.init_cache(cfg, 1, 104, device=dev)
        t = torch.as_tensor(toks, device=dev)
        out = [TM.serve_prefill(cfg, p, {"tokens": t[:, :100]}, cache)[0]]
        for i in range(100, 104):
            pos = torch.full((1,), i, device=dev)
            out.append(TM.serve_decode(cfg, p, t[:, i:i + 1], pos,
                                       cache)[0])
        logits[str(dev)] = [o.float().cpu() for o in out]
    errs = []
    for k_, (c, g) in enumerate(zip(logits["cpu"], logits[str(device)])):
        tol = 1e-4 if k_ == 0 else 1e-3
        check(bool(torch.isfinite(g).all()), "non-finite small-model logits")
        bad = (g - c).abs() > tol + tol * c.abs()
        check(not bool(bad.any()), f"the small model's step {k_} logits on "
                                   f"the card disagree with the CPU's")
        errs.append(float((g - c).abs().max()))
    return dict(arch=f"{LM_ARCH} (reduced, fp32 params)", prefill_tokens=100,
                decode_steps=4, max_abs_err=errs,
                tolerance="1e-4 prefill, 1e-3 decode (rel + abs)")


def lm_path(seed: int = 0) -> dict:
    """The LM main path: olmo-1b at full width and depth in bf16 from a
    seeded generator on the card, ``LM_REQUESTS`` seeded prompts through a
    ``BatchScheduler`` of ``LM_SLOTS`` slots until drained.  The launch
    counts are set to 0 just before the scheduler runs and read just
    after: ``flash_attention`` must have launched once per layer of every
    prefill, and no ISLA kernel.  Every call's q, k, v are kept for the
    replays, and the parameter tree for ``grad_telemetry``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K
    from repro_torch.models import model as TM
    from repro_torch.serve import BatchScheduler, Request

    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed + 1)
    lo, hi = LM_PROMPT_LENS
    lens = [int(n) for n in rng.integers(lo, hi + 1, LM_REQUESTS)]
    check(any(n % 64 for n in lens), "no prompt length off the 64-row tile")
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in lens]

    def scheduler():
        sched = BatchScheduler(cfg, params, batch_slots=LM_SLOTS,
                               max_seq=LM_MAX_SEQ, eos_id=-1)
        for rid, prompt in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=prompt,
                                 max_new=LM_MAX_NEW))
        return sched

    sched = scheduler()
    K.reset_launch_counts()
    with FlashCalls() as spy:
        t0 = time.perf_counter()
        done = sched.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(flash_attention=FA.flash_attention.launches,
                    isla_fold=K.isla_fold.launches,
                    pilot_stats=K.pilot_stats.launches,
                    isla_sketch=K.isla_sketch.launches)
    admitted = len(spy.prefill_s)
    check(admitted == LM_REQUESTS and len(done) == LM_REQUESTS,
          f"{len(done)} of {LM_REQUESTS} requests served")
    check(launches["flash_attention"] == admitted * cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"not once per layer of {admitted} prefills "
          f"({admitted * cfg.n_layers})")
    check(launches["isla_fold"] + launches["pilot_stats"]
          + launches["isla_sketch"] == 0, "the LM path ran an ISLA kernel")
    for r in done:
        check(len(r.generated) == LM_MAX_NEW + 1 and all(
            0 <= t < cfg.padded_vocab for t in r.generated),
              f"request {r.rid} generated {r.generated}")
    for lg in spy.logits:
        check(tuple(lg.shape) == (1, 1, cfg.padded_vocab)
              and bool(torch.isfinite(lg).all()),
              "prefill logits are not finite (1, 1, V)")
    prefill_s = sum(spy.prefill_s)
    decode_s = wall - prefill_s
    new_tokens = sum(len(r.generated) for r in done)
    decoded = new_tokens - admitted  # one token of each comes from prefill
    # Where the time goes, after the counts were read: a re-run of the same
    # traffic tick by tick (host clock, synchronised: the ticks that admit
    # carry their prefills), then a second one with LM_PROFILE_TICKS under
    # the profiler (device time by kernel and host time by operator; the
    # profiler inflates the host side, so those ticks' wall times come from
    # the first re-run).
    tick_s, _ = drive(scheduler())
    _, profiled = drive(scheduler(), LM_PROFILE_TICKS)
    return dict(arch=LM_ARCH, n_params=n_params, init_s=init_s,
                prompt_lens=lens, slots=LM_SLOTS, max_new=LM_MAX_NEW,
                max_seq=LM_MAX_SEQ, launches=launches, wall_s=wall,
                prefill_s=prefill_s, prefill_each_s=spy.prefill_s,
                decode_s=decode_s, new_tokens=new_tokens,
                tokens_per_s=new_tokens / wall,
                prefill_tokens_per_s=sum(lens) / prefill_s,
                decode_tokens_per_s=decoded / decode_s,
                finish_order=[r.rid for r in done], rerun_tick_s=tick_s,
                profiled_ticks=[dict(p, wall_s=tick_s[p["tick"]])
                                for p in profiled],
                calls=spy.calls, params=params)


# ---------------------------------------------------------------------------
# The VLM path: paligemma-3b at full width, its prefix prefill at head_dim
# 256 over one KV head through the flash kernel, then greedy decode.
# ---------------------------------------------------------------------------

VLM_ARCH = "paligemma-3b"
# (batch, prompt tokens) after the 256 patch rows: S = 1023 and 2047,
# neither a multiple of the 64-row tile.
VLM_BATCHES = ((2, 767), (1, 1791))
VLM_DECODE_STEPS = 8


def vlm_path(seed: int = 0) -> dict:
    """paligemma-3b at full width and depth in bf16 from a seeded generator
    on the card, served as the reference serves a frontend config (its
    slot scheduler cannot): for each of ``VLM_BATCHES``, ``serve_prefill``
    of seeded patch embeddings and tokens into a bf16 cache of S + 8 rows,
    then ``VLM_DECODE_STEPS`` greedy ``serve_decode`` steps (synchronised
    host clock each, the argmax included).  The launch counts are set to 0
    just before the first prefill and read just after the last step:
    ``flash_attention`` must have launched once per layer of each prefill,
    and no ISLA kernel.  Every flash call's q, k, v are kept for the
    replays."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K
    from repro_torch.models import model as TM
    from repro_torch.models.frontends import synth_frontend_embeds

    cfg = get_config(VLM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed + 2)
    inputs = [(synth_frontend_embeds(cfg, b, gen), torch.as_tensor(
        rng.integers(0, cfg.vocab, (b, n)), device="cuda"))
        for b, n in VLM_BATCHES]
    seqs = [cfg.frontend_len + n for _, n in VLM_BATCHES]
    check(all(s % 64 for s in seqs), "a VLM prefill length on the 64-row "
                                     "tile")
    steps_s, generated = [], []
    K.reset_launch_counts()
    with FlashCalls() as spy:
        for (prefix, toks), s in zip(inputs, seqs):
            b = toks.shape[0]
            cache = TM.init_cache(cfg, b, s + VLM_DECODE_STEPS,
                                  device="cuda")
            logits, cache = TM.serve_prefill(
                cfg, params, {"tokens": toks, "prefix_embeds": prefix},
                cache)
            check(tuple(logits.shape) == (b, 1, cfg.padded_vocab)
                  and bool(torch.isfinite(logits).all()),
                  f"paligemma prefill logits are not finite ({b}, 1, V)")
            tok = torch.argmax(logits[:, -1, :].float(), dim=-1)[:, None]
            gen_toks, walls = [tok], []
            for i in range(VLM_DECODE_STEPS):
                pos = torch.full((b,), s + i, dtype=torch.int64,
                                 device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = TM.serve_decode(cfg, params, tok, pos,
                                                cache)
                tok = torch.argmax(logits[:, -1, :].float(), dim=-1)[:, None]
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                check(bool(torch.isfinite(logits).all()),
                      f"paligemma decode step {i} logits are not finite")
                gen_toks.append(tok)
            steps_s.append(walls)
            generated.append(torch.cat(gen_toks, dim=1).tolist())
        torch.cuda.synchronize()
    launches = dict(flash_attention=FA.flash_attention.launches,
                    isla_fold=K.isla_fold.launches,
                    pilot_stats=K.pilot_stats.launches,
                    isla_sketch=K.isla_sketch.launches)
    n_prefills = len(VLM_BATCHES)
    check(len(spy.prefill_s) == n_prefills, "a VLM prefill was not run")
    check(launches["flash_attention"] == n_prefills * cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times "
          f"on the VLM path, not once per layer of {n_prefills} prefills "
          f"({n_prefills * cfg.n_layers})")
    check(launches["isla_fold"] + launches["pilot_stats"]
          + launches["isla_sketch"] == 0, "the VLM path ran an ISLA kernel")
    for q, k, v, g in spy.calls:
        check(q.shape[-1] == cfg.head_dim and g == cfg.n_heads
              // cfg.n_kv_heads, f"a VLM flash call at {tuple(q.shape)}, "
                                  f"groups {g}")
    for toks in generated:
        check(all(0 <= t < cfg.padded_vocab for row in toks for t in row),
              f"paligemma generated {toks}")
    return dict(arch=VLM_ARCH, n_params=n_params, init_s=init_s,
                batches=[dict(batch=b, prompt_tokens=n, seq=s)
                         for (b, n), s in zip(VLM_BATCHES, seqs)],
                launches=launches, prefill_s=spy.prefill_s,
                decode_step_s=steps_s, generated=generated,
                calls=spy.calls)


# ---------------------------------------------------------------------------
# The MoE path: grok-1-314b and arctic-480b at full width through the slot
# scheduler, every prefill's attention through the flash kernel and every
# layer's channel through ``models.moe``.
# ---------------------------------------------------------------------------

# (arch, n_layers): full width; the depth is cut to what one 80 GB card
# holds with room for the init's fp32 draw of the largest expert leaf
# (grok-1-314b: 2 layers, 11.45 B parameters, 22.9 GB in bf16, experts
# split in 16 virtual ones of (6144, 16384); arctic-480b: 1 layer of 128
# experts of (7168, 4864) x 3 and a dense residual, 14.07 B, 28.1 GB).
MOE_RUNS = (("grok-1-314b", 2), ("arctic-480b", 1))
MOE_REQUESTS = 6
MOE_SLOTS = 4
MOE_MAX_NEW = 8
MOE_PROMPT_LENS = (384, 2048)  # seeded lengths, both ends included
MOE_MAX_SEQ = 2048 + MOE_MAX_NEW + 16
# Profiled tick of the re-run: a decode tick of the four first requests.
MOE_PROFILE_TICK = 2
# The card's MoE output against the gather formulation, bf16: the LM
# tests' tolerance, relative to the output's largest element (the gates
# enter the main path's combine rounded to bf16 and the oracle's in fp32,
# and the oracle rounds each virtual slice's output before summing).
MOE_TOL = 2e-2
COMBINE_RTOL = 1e-6  # the card's gates against the CPU's, same logits


def moe_prompt_lens(rng, group: int, lo: int, hi: int) -> "list[int]":
    """``MOE_REQUESTS`` seeded prompt lengths in [lo, hi]; every other one
    is rounded down to the routing group (at least two groups), so that
    some prefills route in groups and the rest fall back to one group of
    all their tokens."""
    lens = [int(n) for n in rng.integers(lo, hi + 1, MOE_REQUESTS)]
    lens[::2] = [max(2 * group, n // group * group) for n in lens[::2]]
    check(any(n % group == 0 for n in lens)
          and any(n % group for n in lens),
          f"prompt lengths {lens} do not take both routing paths")
    return lens


class MoeCalls:
    """Keeps, for every call the stack makes to ``models.moe.apply_moe``
    while installed, its params, its input and the router logits its
    ``_route`` took (the tensors the main path made, where it made
    them), by wrapping the two names."""

    def __enter__(self):
        from repro_torch.models import moe as M

        self.calls = []
        self._apply, self._route = M.apply_moe, M._route
        apply, route = self._apply, self._route

        def spy_apply(cfg, params, x):
            self.calls.append(dict(params=params, x=x))
            return apply(cfg, params, x)

        def spy_route(cfg, logits):
            self.calls[-1]["logits"] = logits
            return route(cfg, logits)

        M.apply_moe, M._route = spy_apply, spy_route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as M
        M.apply_moe, M._route = self._apply, self._route
        return False


def top_choices(probs, k: int):
    """Each token's experts, pass by pass, as ``_route`` picks them (the
    first index on ties): (G, Tg, k)."""
    import torch

    p, out = probs.clone(), []
    for _ in range(k):
        idx = p.argmax(-1)
        out.append(idx)
        p.scatter_(-1, idx[..., None], 0.0)
    return torch.stack(out, -1)


def fp32_ulp(x):
    import torch
    return torch.finfo(torch.float32).eps * torch.exp2(torch.floor(
        torch.log2(x.abs().clamp_min(torch.finfo(torch.float32).tiny))))


def check_route(cfg, logits) -> dict:
    """``_route`` of the main path's router ``logits`` (G, Tg, E) where
    they lie, against ``_route`` run on the CPU on the same logits.
    ``dispatch`` must be identical, except for a token whose experts
    differ where its two competing gates lie within one fp32 ulp of each
    other (on either device: each computes its own softmax), and a token
    of such a token's group whose slots moved with it; both are counted.
    ``combine`` must lie within rel ``COMBINE_RTOL`` on every token whose
    dispatch agrees."""
    import torch
    from repro_torch.models import moe as M

    cpu = logits.detach().cpu()
    d_dev, c_dev, _ = M._route(cfg, logits)
    d_cpu, c_cpu, _ = M._route(cfg, cpu)
    d_dev, c_dev = d_dev.cpu(), c_dev.cpu()
    probs = [torch.softmax(t, -1).cpu() for t in (logits, cpu)]
    k = cfg.moe.top_k
    ch_dev, ch_cpu = (top_choices(p, k) for p in probs)
    flipped = (ch_dev != ch_cpu).any(-1)                         # (G, Tg)
    for g, t in flipped.nonzero().tolist():
        j = int((ch_dev[g, t] != ch_cpu[g, t]).nonzero()[0])
        a, b = int(ch_dev[g, t, j]), int(ch_cpu[g, t, j])
        near = [abs(float(p[g, t, a] - p[g, t, b])) <= float(fp32_ulp(
            torch.maximum(p[g, t, a], p[g, t, b]))) for p in probs]
        check(any(near), f"{cfg.name}: token ({g}, {t}) takes expert {a} "
                         f"on the card and {b} on the CPU, not a near-tie: "
                         f"card {float(probs[0][g, t, a]):.9g} / "
                         f"{float(probs[0][g, t, b]):.9g}, CPU "
                         f"{float(probs[1][g, t, a]):.9g} / "
                         f"{float(probs[1][g, t, b]):.9g}")
    same = (d_dev == d_cpu).all(-1).all(-1)                      # (G, Tg)
    moved = ~same & ~flipped
    check(not bool((moved & ~flipped.any(-1, keepdim=True)).any()),
          f"{cfg.name}: dispatch differs from the CPU's in a group where "
          f"every token took the same experts")
    rows = same[..., None, None].expand_as(c_cpu)
    err = (c_dev - c_cpu).abs()[rows]
    ref = c_cpu.abs()[rows]
    rel = float((err / ref.clamp_min(torch.finfo(torch.float32).tiny))
                [ref > 0].max()) if bool((ref > 0).any()) else 0.0
    check(bool((err <= COMBINE_RTOL * ref).all()),
          f"{cfg.name}: combine off the CPU's by rel {rel:.3g} "
          f"(> {COMBINE_RTOL})")
    G, tg = logits.shape[:2]
    return dict(groups=G, group_tokens=tg, capacity=int(d_cpu.shape[-1]),
                tokens=G * tg, kept=int(d_cpu.sum()),
                near_ties=int(flipped.sum()), moved=int(moved.sum()),
                combine_max_rel=rel)


def moe_gather_oracle(cfg, params, x, logits):
    """The expert part of ``apply_moe`` as a per-token gather: the kept
    (token, expert, gate) triples of ``_route`` on the call's router
    ``logits`` (G, Tg, E), each expert's FFN applied to its tokens slice
    by slice (the virtual experts' f-slices), the slices' outputs summed
    in fp32 and added to the tokens weighted by their fp32 gates.  The
    smoke's oracle only; the main path never runs it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe as M

    B, S, d = x.shape
    T = B * S
    tg = logits.shape[1]
    dispatch, combine, _ = M._route(cfg, logits)
    g, t, e, c = dispatch.nonzero(as_tuple=True)
    gate = combine[g, t, e, c]
    tok = g * tg + t
    xf = x.reshape(T, d)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    fac = M.virtual_expert_factor(cfg)
    for ex in torch.unique(e).tolist():
        sel = e == ex
        rows, w = tok[sel], gate[sel]
        xs = xf[rows]
        out = torch.zeros((xs.shape[0], d), dtype=torch.float32,
                          device=x.device)
        for j in range(fac):
            v = ex * fac + j
            if cfg.mlp == "swiglu":
                h = F.silu((xs @ params["w_gate"][v]).float()).to(x.dtype) \
                    * (xs @ params["w_up"][v])
                out += (h @ params["w_down"][v]).float()
            else:
                h = F.gelu((xs @ params["w_in"][v]).float(),
                           approximate="tanh").to(x.dtype)
                out += (h @ params["w_out"][v]).float()
        y.index_add_(0, rows, out * w[:, None])
    return y.to(x.dtype).reshape(B, S, d)


def check_moe_oracle(cfg, params, x) -> dict:
    """The card's ``apply_moe`` on a call's input against the gather
    oracle: its expert part (the config without the dense residual) within
    ``MOE_TOL`` of the oracle's largest element, and the whole output
    (arctic: the residual FFN added) within ``MOE_TOL`` of the oracle plus
    the residual."""
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.models import moe as M

    experts_only = cfg.replace(moe=dataclasses.replace(
        cfg.moe, dense_residual=False))
    with MoeCalls() as spy:
        got = M.apply_moe(experts_only, params, x)[0]
    want = moe_gather_oracle(cfg, params, x, spy.calls[0]["logits"])
    full = M.apply_moe(cfg, params, x)[0]
    want_full = want.float()
    if cfg.moe.dense_residual:
        want_full = want_full + L.apply_mlp(cfg, params["residual"],
                                            x).float()
    out = {}
    for name, a, b in (("experts", got, want), ("output", full, want_full)):
        check(bool(a.isfinite().all()) and a.shape == x.shape,
              f"{cfg.name}: apply_moe's {name} is not finite {tuple(x.shape)}")
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        check(err <= MOE_TOL * scale,
              f"{cfg.name}: apply_moe's {name} at {tuple(x.shape)} is "
              f"{err:.3g} off the gather oracle (> {MOE_TOL} x {scale:.3g})")
        out[name] = dict(max_abs_err=err, scale=scale)
    return dict(shape=list(x.shape), **out)


def moe_path(arch: str, n_layers: int, seed: int = 0, device="cuda",
             reduced: bool = False, prompt_lens=MOE_PROMPT_LENS,
             max_seq: int = MOE_MAX_SEQ) -> dict:
    """One MoE model on the LM main path: ``arch`` at full width with
    ``n_layers`` layers, bf16 weights from a seeded generator on
    ``device``, ``MOE_REQUESTS`` seeded prompts (some on the routing
    group, some not) through a ``BatchScheduler`` of ``MOE_SLOTS`` slots,
    ``MOE_MAX_NEW`` new tokens each.  The launch counts are set to 0 just
    before the scheduler runs and read just after: ``flash_attention``
    must have launched once per layer of every prefill, and no ISLA
    kernel.  Every MoE layer must have run ``apply_moe``, each decode
    step on every slot.  Then, with the weights still there: every
    prefill's and the first decode tick's routing held against the CPU's
    (``check_route``), the MoE output of one grouped prefill, one that
    fell back and one decode step against the gather oracle, and a re-run
    tick by tick with one decode tick profiled.  ``reduced`` (with short
    prompts) rehearses the phase on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K
    from repro_torch.models import model as TM
    from repro_torch.serve import BatchScheduler, Request

    on_card = torch.device(device).type == "cuda"
    cfg = get_config(arch, reduced=reduced).replace(n_layers=n_layers)
    held = None  # bytes held on the card before the model is built
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, gen)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    init_peak = torch.cuda.max_memory_allocated() if on_card else None
    rng = np.random.default_rng(seed + 3)
    lens = moe_prompt_lens(rng, cfg.moe.group_size, *prompt_lens)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in lens]

    def scheduler():
        sched = BatchScheduler(cfg, params, batch_slots=MOE_SLOTS,
                               max_seq=max_seq, eos_id=-1)
        for rid, prompt in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=prompt,
                                 max_new=MOE_MAX_NEW))
        return sched

    sched = scheduler()
    K.reset_launch_counts()
    with FlashCalls(device) as spy, MoeCalls() as moe_spy:
        t0 = time.perf_counter()
        done = sched.run_until_drained()
        sync(device)
        wall = time.perf_counter() - t0
    launches = dict(flash_attention=FA.flash_attention.launches,
                    isla_fold=K.isla_fold.launches,
                    pilot_stats=K.pilot_stats.launches,
                    isla_sketch=K.isla_sketch.launches)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    admitted = len(spy.prefill_s)
    check(admitted == MOE_REQUESTS and len(done) == MOE_REQUESTS,
          f"{arch}: {len(done)} of {MOE_REQUESTS} requests served")
    want_flash = admitted * cfg.n_layers if on_card else 0
    check(launches["flash_attention"] == want_flash,
          f"{arch}: flash_attention launched "
          f"{launches['flash_attention']} times, not once per layer of "
          f"{admitted} prefills ({want_flash})")
    check(len(spy.calls) == admitted * cfg.n_layers,
          f"{arch}: {len(spy.calls)} flash calls for {admitted} prefills")
    check(launches["isla_fold"] + launches["pilot_stats"]
          + launches["isla_sketch"] == 0, f"{arch}: the MoE path ran an "
                                          f"ISLA kernel")
    for r in done:
        check(len(r.generated) == MOE_MAX_NEW + 1 and all(
            0 <= t < cfg.padded_vocab for t in r.generated),
              f"{arch}: request {r.rid} generated {r.generated}")
    for lg in spy.logits:
        check(tuple(lg.shape) == (1, 1, cfg.padded_vocab)
              and bool(torch.isfinite(lg).all()),
              f"{arch}: prefill logits are not finite (1, 1, V)")
    calls = moe_spy.calls
    prefills = [c for c in calls if c["x"].shape[1] > 1]
    decodes = [c for c in calls if c["x"].shape[1] == 1]
    check(len(prefills) == admitted * cfg.n_layers
          and len(decodes) % cfg.n_layers == 0 and decodes,
          f"{arch}: {len(prefills)} prefill and {len(decodes)} decode MoE "
          f"calls for {admitted} prefills of {cfg.n_layers} layers")
    check(all(c["x"].shape[0] == MOE_SLOTS for c in decodes),
          f"{arch}: a decode step did not route every slot")
    check([c["x"].shape[1] for c in prefills[::cfg.n_layers]] == lens,
          f"{arch}: prefills of {[c['x'].shape[1] for c in prefills]} "
          f"tokens for prompts of {lens}")
    routes = [dict(check_route(cfg, c["logits"]), call="prefill",
                   tokens_in=c["x"].shape[1], layer=i % cfg.n_layers)
              for i, c in enumerate(prefills)]
    routes += [dict(check_route(cfg, c["logits"]), call="decode",
                    tokens_in=c["x"].shape[0], layer=i)
               for i, c in enumerate(decodes[:cfg.n_layers])]
    grid = [i for i, n in enumerate(lens) if n % cfg.moe.group_size == 0]
    off = [i for i, n in enumerate(lens) if n % cfg.moe.group_size]
    picks = [("grouped prefill", prefills[grid[0] * cfg.n_layers]),
             ("fallback prefill", prefills[off[0] * cfg.n_layers]),
             ("decode step", decodes[0])]
    oracle = [dict(check_moe_oracle(cfg, c["params"], c["x"]), call=name)
              for name, c in picks]
    del calls, prefills, decodes, picks, moe_spy
    prefill_s = sum(spy.prefill_s)
    decode_s = wall - prefill_s
    new_tokens = sum(len(r.generated) for r in done)
    # Where the time goes, after the counts were read: a re-run of the
    # same traffic tick by tick (host clock, synchronised), then another
    # with MOE_PROFILE_TICK under the profiler (its wall from the first).
    tick_s, _ = drive(scheduler(), device=device)
    _, profiled = drive(scheduler(), (MOE_PROFILE_TICK,), device)
    prof = profiled[0]
    prof["wall_s"] = tick_s[MOE_PROFILE_TICK]
    if prof["device_events"]:
        prof["busy_share"] = prof["device_s"] / prof["wall_s"]
    else:
        check(not on_card, f"{arch}: the profiled decode tick holds no "
                           f"device event")
    return dict(arch=arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
                n_experts=cfg.moe.n_experts, n_params=n_params,
                init_s=init_s, held_bytes=held, init_peak_bytes=init_peak,
                peak_bytes=peak,
                prompt_lens=lens, slots=MOE_SLOTS, max_new=MOE_MAX_NEW,
                launches=launches, wall_s=wall, prefill_s=prefill_s,
                prefill_each_s=spy.prefill_s, decode_s=decode_s,
                ticks=len(tick_s), decode_tick_s=decode_s / len(tick_s),
                new_tokens=new_tokens, tokens_per_s=new_tokens / wall,
                finish_order=[r.rid for r in done], rerun_tick_s=tick_s,
                profiled_tick=prof, routes=routes, oracle=oracle,
                calls=spy.calls)


# ---------------------------------------------------------------------------
# The Mamba path ("lm mamba"): mamba2-130m at full width and depth, then
# jamba's hybrid stack (Mamba, attention, MoE) at its reduced config.
# ---------------------------------------------------------------------------

MAMBA_ARCH = "mamba2-130m"
JAMBA_ARCH = "jamba-1.5-large-398b"
MAMBA_REQUESTS = 6
MAMBA_SLOTS = 4
MAMBA_MAX_NEW = 16
MAMBA_PROMPT_HI = 2048  # the longest prompt, a multiple of the chunk (256)
JAMBA_PROMPT_HI = 256   # the reduced jamba's: a multiple of its chunk (32)
JAMBA_DTYPES = ("bfloat16", "float32")
# bf16 on the card against fp32 (the CPU's, or the O(S^2) oracle's on the
# same inputs), relative to the output's scale (its largest element).
MAMBA_TOL = 2e-2
# fp32 on the card against fp32 on the CPU, relative to the scale.
JAMBA_TOL = 1e-4
# mamba2-130m's weights in fp32 on the card against the CPU, 24 layers
# deep, relative to the scale.
MAMBA_F32_TOL = 1e-4
# Two fp32 gates summed in other orders on the two devices may swap where
# they lie within rel 1e-5 (tests/test_torch_cuda.py's MoE near-tie).
NEAR_TIE_RTOL = 1e-5
# Profiled tick of the re-run: a decode tick of the four first requests.
MAMBA_PROFILE_TICK = 2
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def check_prompt_lens(cfg, lens, group=None) -> None:
    """Every length meets the chunk contract (``mamba2.check_prefill``),
    one is longer than a chunk and one shorter, and with a routing
    ``group`` some lengths are on it and some are not."""
    from repro_torch.models import mamba2 as M

    for n in lens:
        try:
            M.check_prefill(cfg, n)
        except ValueError as exc:
            check(False, f"{cfg.name}: prompt length {n} is off the chunk "
                         f"contract: {exc}")
    chunk = cfg.mamba.chunk
    check(any(n > chunk for n in lens) and any(n < chunk for n in lens),
          f"{cfg.name}: prompt lengths {lens} do not take both more than "
          f"one chunk of {chunk} and one short chunk")
    if group is not None:
        check(any(n % group == 0 for n in lens)
              and any(n % group for n in lens),
              f"{cfg.name}: prompt lengths {lens} do not take both routing "
              f"paths of groups of {group}")


def mamba_prompt_lens(rng, cfg, hi: int, group=None) -> "list[int]":
    """``MAMBA_REQUESTS`` seeded prompt lengths: every other one a multiple
    of the chunk, two chunks to ``hi`` (with a routing ``group``, the
    first a multiple of it too); the rest shorter than a chunk, from 4
    tokens (past the conv tail of d_conv - 1 = 3)."""
    chunk = cfg.mamba.chunk
    lens = [int(chunk * rng.integers(2, hi // chunk + 1)) if i % 2 == 0
            else int(rng.integers(4, chunk)) for i in range(MAMBA_REQUESTS)]
    if group is not None:  # the first on the routing group
        step = math.lcm(chunk, group)
        lens[0] = max(step * -(-2 * chunk // step), lens[0] // step * step)
    check_prompt_lens(cfg, lens, group)
    return lens


class SsdCalls:
    """Keeps, for every prefill the stack runs while installed, the inputs
    and outputs of its layer-0 ``mamba2.ssd_chunked`` call (the tensors
    the main path made, where it made them); the stack calls it
    ``n_mamba`` times a prefill, once a Mamba layer, in order."""

    def __init__(self, n_mamba: int):
        self.n_mamba = n_mamba

    def __enter__(self):
        from repro_torch.models import mamba2 as M

        self.calls, self._seen = [], 0
        self._real = real = M.ssd_chunked

        def spy(x, da, dt, Bm, Cm, chunk, h0=None):
            y, h = real(x, da, dt, Bm, Cm, chunk, h0=h0)
            if x.shape[1] > 1:  # a prefill (a decode step is one token)
                if self._seen % self.n_mamba == 0:
                    self.calls.append(dict(
                        x=x, da=da, dt=dt, Bm=Bm, Cm=Cm, chunk=chunk,
                        h0=None if h0 is None else h0.clone(), y=y, h=h))
                self._seen += 1
            return y, h

        M.ssd_chunked = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mamba2 as M
        M.ssd_chunked = self._real
        return False


def ssd_state_oracle(x, da, dt, Bm, Cm, h0=None):
    """The SSD's final state and its output's h0 term in closed form, fp32:
    h_S = sum_s exp(cum_S - cum_s) dt_s B_s x_s^T + exp(cum_S) h0, and
    C_q . h0 exp(cum_q); the head map ``repeat_interleave``d here, not
    taken from the module."""
    import torch

    H, G = x.shape[2], Bm.shape[2]
    Br = torch.repeat_interleave(Bm, H // G, dim=2).float()
    Cr = torch.repeat_interleave(Cm, H // G, dim=2).float()
    cum = torch.cumsum(da.float(), dim=1)                      # (B,S,H)
    w = torch.exp(cum[:, -1:, :] - cum) * dt.float()
    h = torch.einsum("bsh,bshn,bshp->bhnp", w, Br, x.float())
    y0 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if h0 is not None:
        h = h + torch.exp(cum[:, -1])[..., None, None] * h0.float()
        y0 = torch.einsum("bshn,bhnp,bsh->bshp", Cr, h0.float(),
                          torch.exp(cum))
    return h, y0


def rel_err(got, want) -> "tuple[float, float]":
    """(max |got - want| / max |want|, max |want|)."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    return err / max(scale, 1e-30), scale


def check_ssd(name: str, call: dict, tol: float) -> dict:
    """The main path's ``ssd_chunked`` output on one prefill's layer-0
    inputs against ``ssd_reference`` (the O(S^2) oracle) on the same
    device tensors, and its final state against the closed form: each
    within ``tol`` of the oracle's scale."""
    from repro_torch.models import mamba2 as M

    args = [call[k] for k in ("x", "da", "dt", "Bm", "Cm")]
    h_ref, y0 = ssd_state_oracle(*args, call["h0"])
    y_ref = M.ssd_reference(*args).float() + y0
    y_err, y_scale = rel_err(call["y"], y_ref)
    h_err, h_scale = rel_err(call["h"], h_ref)
    S = call["x"].shape[1]
    check(bool(call["y"].isfinite().all()) and bool(call["h"].isfinite().all())
          and y_err <= tol and h_err <= tol,
          f"{name}: ssd_chunked at S = {S} (chunk {call['chunk']}) is off "
          f"the oracle: y rel {y_err:.3g} of {y_scale:.3g}, final state rel "
          f"{h_err:.3g} of {h_scale:.3g} (> {tol})")
    return dict(tokens=S, chunks=-(-S // call["chunk"]), y_rel=y_err,
                y_scale=y_scale, h_rel=h_err, h_scale=h_scale)


class MambaLayers:
    """Keeps every ``mamba2._mamba_forward`` call the stack makes while
    installed (its params, input, state and conv tail in and out) and
    every ``lm_logits`` call (the final hidden state and the logits)."""

    def __enter__(self):
        from repro_torch.models import mamba2 as M
        from repro_torch.models import model as TM

        self.layers, self.heads = [], []
        self._fwd, self._head = real_fwd, real_head = (M._mamba_forward,
                                                       TM.lm_logits)

        def spy_fwd(cfg, params, x, h0, conv0):
            ins = dict(params=params, x=x, h0=h0.clone(),
                       conv0=None if conv0 is None else conv0.clone())
            out, h, conv = real_fwd(cfg, params, x, h0, conv0)
            self.layers.append(dict(ins, out=out, h=h, conv=conv))
            return out, h, conv

        def spy_head(cfg, params, x):
            logits = real_head(cfg, params, x)
            self.heads.append(dict(x=x, logits=logits))
            return logits

        M._mamba_forward, TM.lm_logits = spy_fwd, spy_head
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mamba2 as M
        from repro_torch.models import model as TM
        M._mamba_forward, TM.lm_logits = self._fwd, self._head
        return False


def mamba_steps(cfg, params, toks, S: int, device, cache_dtype):
    """A prefill of the first ``S`` of ``toks`` (1, >S) and the next decode
    tick into a one-slot cache of ``cache_dtype`` on ``device``: (the two
    steps' logits, the cache)."""
    import torch
    from repro_torch.models import model as TM

    toks = toks.to(device)
    cache = TM.init_cache(cfg, 1, S + 1, dtype=cache_dtype, device=device)
    logits = [TM.serve_prefill(cfg, params, {"tokens": toks[:, :S]},
                               cache)[0]]
    logits.append(TM.serve_decode(cfg, params, toks[:, S:S + 1],
                                  torch.full((1,), S, device=device),
                                  cache)[0])
    sync(device)
    return logits, cache


def steps_rel(got, want) -> dict:
    """``rel_err`` of each step's logits and each Mamba position's h and
    conv rows, ``got``'s against ``want``'s (from ``mamba_steps``)."""
    (lg, cache), (lw, cw) = got, want
    out = {f"logits_{i}": rel_err(g.cpu(), w.cpu())[0]
           for i, (g, w) in enumerate(zip(lg, lw))}
    for pos, (c, w) in enumerate(zip(cache, cw)):
        for name in ("h", "conv"):
            if name in c:
                out[f"{name}_{pos}"] = rel_err(c[name].cpu(), w[name].cpu())[0]
    return out


def check_mamba_cpu(cfg, params, tokens, device) -> dict:
    """A prefill of ``2 * chunk`` tokens (512 at full width) and the next
    decode tick, on ``device`` and on the CPU in fp32 from the same
    weights (an fp32 cache).  Held:

    * the main path's bf16 (a bf16 cache), layer by layer: every Mamba
      call of the card, run again on the CPU in fp32 on the card's own
      inputs (hidden state, state, conv tail), its output, state and conv
      tail within ``MAMBA_TOL`` of scale; the LM head likewise on the
      card's final hidden state;
    * the same weights in fp32 on the card (an fp32 cache), end to end:
      logits, h and conv rows within ``MAMBA_F32_TOL`` of scale of the
      CPU's free-running fp32 run.

    The bf16 run's end-to-end gap to the CPU's fp32 run is measured and
    returned, not held: bf16 roundings that each stay within the
    layer-by-layer tolerance compound over the stack's depth (the
    reference's own bf16 forward drifts from its fp32 one alike,
    ``tests/test_torch_mamba.py``)."""
    import torch
    from repro_torch.models import mamba2 as M
    from repro_torch.models import model as TM

    S = 2 * cfg.mamba.chunk
    toks = torch.as_tensor(tokens[:S + 1])[None, :]
    with MambaLayers() as lay:
        bf16 = mamba_steps(cfg, params, toks, S, device, torch.bfloat16)
    cfg32 = cfg.replace(param_dtype="float32")
    p32 = to_device(params, "cpu", torch.float32)
    layerwise = dict(out=0.0, h=0.0, conv=0.0, head=0.0)
    for i, c in enumerate(lay.layers):
        out, h, conv = M._mamba_forward(
            cfg32, to_device(c["params"], "cpu", torch.float32),
            c["x"].float().cpu(), c["h0"].float().cpu(),
            None if c["conv0"] is None else c["conv0"].float().cpu())
        for name, want in (("out", out), ("h", h), ("conv", conv)):
            err, scale = rel_err(c[name].cpu(), want)
            check(err <= MAMBA_TOL, f"{cfg.name}: Mamba call {i} "
                                    f"(S = {c['x'].shape[1]}): {name} rel "
                                    f"{err:.3g} of {scale:.3g} off fp32 on "
                                    f"the CPU on the same input "
                                    f"(> {MAMBA_TOL})")
            layerwise[name] = max(layerwise[name], err)
    for c in lay.heads:
        want = TM.lm_logits(cfg32, p32, c["x"].float().cpu())
        err, scale = rel_err(c["logits"].cpu(), want)
        check(err <= MAMBA_TOL, f"{cfg.name}: LM head rel {err:.3g} of "
                                f"{scale:.3g} off fp32 on the CPU")
        layerwise["head"] = max(layerwise["head"], err)
    n_calls = len(lay.layers)
    del lay
    cpu = mamba_steps(cfg32, p32, toks, S, "cpu", torch.float32)
    f32 = mamba_steps(cfg32, to_device(params, device, torch.float32), toks,
                      S, device, torch.float32)
    for lg in bf16[0] + f32[0]:
        check(bool(lg.isfinite().all()), f"{cfg.name}: non-finite logits")
    f32_rel = steps_rel(f32, cpu)
    check(max(f32_rel.values()) <= MAMBA_F32_TOL,
          f"{cfg.name}: fp32 on the card, a prefill of {S} and a decode "
          f"tick, is off the CPU's: {json.dumps(f32_rel)} (> "
          f"{MAMBA_F32_TOL} of scale)")
    return dict(prefill_tokens=S, mamba_calls=n_calls,
                layerwise_rel=layerwise, tolerance=MAMBA_TOL,
                f32_rel=f32_rel, f32_tolerance=MAMBA_F32_TOL,
                bf16_rel=steps_rel(bf16, cpu))


def check_mamba_parity(cfg, params, tokens, device) -> dict:
    """The reference's own contract (tests/test_model_parity.py): a
    prefill of ``chunk - 4`` tokens (252 at full width) and 4 decode steps
    give the last logits of a prefill of ``chunk`` tokens, within rtol and
    atol 2e-2.  Held on ``device`` with the weights in fp32 (an fp32
    cache); measured, not held, in the main path's bf16, where the two
    paths' roundings compound over the depth as in ``check_mamba_cpu``."""
    import torch
    from repro_torch.models import model as TM

    S = cfg.mamba.chunk
    toks = torch.as_tensor(tokens[:S], device=device)[None, :]
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        c = cfg.replace(param_dtype=str(dt).replace("torch.", ""))
        p = to_device(params, device, dt)
        full = TM.serve_prefill(c, p, {"tokens": toks}, TM.init_cache(
            c, 1, S, dtype=dt, device=device))[0]
        cache = TM.init_cache(c, 1, S, dtype=dt, device=device)
        TM.serve_prefill(c, p, {"tokens": toks[:, :S - 4]}, cache)
        for t in range(S - 4, S):
            step = TM.serve_decode(c, p, toks[:, t:t + 1],
                                   torch.full((1,), t, device=device),
                                   cache)[0]
        g, w = step.float(), full.float()
        diff = (g - w).abs()
        ok = bool((diff <= 2e-2 + 2e-2 * w.abs()).all())
        check(bool(g.isfinite().all()) and (ok or dt == torch.bfloat16),
              f"{cfg.name} ({dt}): prefill({S - 4}) + 4 decode steps are "
              f"{float(diff.max()):.3g} off prefill({S})'s last logits "
              f"(rtol, atol 2e-2)")
        out[c.param_dtype] = dict(max_abs_err=float(diff.max()),
                                  scale=float(w.abs().max()),
                                  within_contract=ok)
    return dict(prefill=S - 4, decode_steps=4, full=S, **out)


def check_jamba_cpu(cfg, params, prompts, device) -> dict:
    """fp32: each prompt's prefill and the next decode step into a
    one-slot fp32 cache on ``device``, and on the CPU from the same
    weights: the logits within ``JAMBA_TOL`` of scale.  The router logits
    of every MoE call are compared too: a token whose experts differ must
    be a near-tie (its two gates within rel ``NEAR_TIE_RTOL`` on the CPU);
    such tokens are counted, and a step they touched, or one after it, is
    not held to ``JAMBA_TOL`` (its logits are printed)."""
    import torch
    from repro_torch.models import model as TM

    p_cpu = to_device(params, "cpu")
    out = []
    for prompt in prompts:
        S = len(prompt)
        runs = {}
        for dev, p in ((device, params), ("cpu", p_cpu)):
            toks = torch.as_tensor(prompt + [prompt[0]], device=dev)[None, :]
            cache = TM.init_cache(cfg, 1, S + 1, dtype=torch.float32,
                                  device=dev)
            with MoeCalls() as moe_spy:
                lg = [TM.serve_prefill(cfg, p, {"tokens": toks[:, :S]},
                                       cache)[0]]
                n_pre = len(moe_spy.calls)
                lg.append(TM.serve_decode(cfg, p, toks[:, S:],
                                          torch.full((1,), S, device=dev),
                                          cache)[0])
            sync(dev)
            runs[str(dev)] = (lg, [c["logits"] for c in moe_spy.calls],
                              n_pre)
        (lg_d, rt_d, n_pre), (lg_c, rt_c, _) = runs[str(device)], runs["cpu"]
        ties = [0, 0]
        for i, (a, b) in enumerate(zip(rt_d, rt_c)):
            ca, cb = (top_choices(torch.softmax(t.float().cpu(), -1),
                                  cfg.moe.top_k) for t in (a, b))
            probs = torch.softmax(b.float(), -1)
            for g, t in (ca != cb).any(-1).nonzero().tolist():
                j = int((ca[g, t] != cb[g, t]).nonzero()[0])
                x, y = int(ca[g, t, j]), int(cb[g, t, j])
                px, py = float(probs[g, t, x]), float(probs[g, t, y])
                check(abs(px - py) <= NEAR_TIE_RTOL * max(px, py),
                      f"{cfg.name}: S = {S}: token ({g}, {t}) takes expert "
                      f"{x} on the card and {y} on the CPU, not a near-tie "
                      f"({px:.9g} / {py:.9g})")
                ties[0 if i < n_pre else 1] += 1
        errs = []
        for step, (g, w) in enumerate(zip(lg_d, lg_c)):
            check(bool(g.isfinite().all()), f"{cfg.name}: non-finite logits")
            err, scale = rel_err(g.cpu(), w)
            check(sum(ties[:step + 1]) > 0 or err <= JAMBA_TOL,
                  f"{cfg.name}: S = {S}: step {step} logits rel {err:.3g} of "
                  f"{scale:.3g} off the CPU's (> {JAMBA_TOL})")
            errs.append(err)
        out.append(dict(tokens=S, rel_err=errs, near_ties=ties,
                        on_group=S % cfg.moe.group_size == 0))
    return dict(prompts=out, tolerance=JAMBA_TOL)


def decode_trace_whole(r: dict) -> bool:
    """Whether a profiled tick's trace (a ``drive`` record) holds the
    kernels it ran: at least one device event for every matrix product its
    host side recorded (each launches one or more)."""
    return (r["device_events"] or 0) >= r["products"] > 0


def mamba_path(arch: str, seed: int = 0, device="cuda",
               reduced: bool = False, dtype=None,
               prompt_hi: int = MAMBA_PROMPT_HI, checks=()) -> dict:
    """One Mamba config on the LM main path: ``arch`` (at the reduced
    config with ``reduced``, in ``dtype`` when given) with weights from a
    seeded generator on ``device``, ``MAMBA_REQUESTS`` seeded prompts
    (``mamba_prompt_lens``) through a ``BatchScheduler`` of
    ``MAMBA_SLOTS`` slots, ``MAMBA_MAX_NEW`` new tokens each.  The launch
    counts are set to 0 just before the scheduler runs and read just
    after: ``flash_attention`` must have launched once per attention layer
    of every prefill (none for mamba2-130m), and no ISLA kernel.  Every
    prefill's layer-0 SSD is held against the oracle on its own inputs
    (``check_ssd``).  Then a re-run tick by tick, re-runs with one decode
    tick profiled until its trace is whole (``decode_trace_whole``; its
    busy share over the unprofiled re-run's tick), and the ``checks``
    asked for: "cpu" (``check_mamba_cpu``,
    or for an MoE config ``check_jamba_cpu``) and "parity"
    (``check_mamba_parity``).  ``reduced`` with ``device="cpu"``
    rehearses the phase on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K
    from repro_torch.models import model as TM
    from repro_torch.serve import BatchScheduler, Request

    on_card = torch.device(device).type == "cuda"
    cfg = get_config(arch, reduced=reduced)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=dtype)
    n_attn = sum(cfg.block_is_attention(i) for i in range(cfg.n_layers))
    n_mamba = cfg.n_layers - n_attn
    held = None
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, gen)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed + 5)
    group = cfg.moe.group_size if cfg.moe is not None else None
    lens = mamba_prompt_lens(rng, cfg, prompt_hi, group)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in lens]
    max_seq = max(lens) + MAMBA_MAX_NEW + 16

    def scheduler():
        sched = BatchScheduler(cfg, params, batch_slots=MAMBA_SLOTS,
                               max_seq=max_seq, eos_id=-1)
        for rid, prompt in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=prompt,
                                 max_new=MAMBA_MAX_NEW))
        return sched

    sched = scheduler()
    K.reset_launch_counts()
    with FlashCalls(device) as spy, SsdCalls(n_mamba) as ssd:
        t0 = time.perf_counter()
        done = sched.run_until_drained()
        sync(device)
        wall = time.perf_counter() - t0
    launches = dict(flash_attention=FA.flash_attention.launches,
                    isla_fold=K.isla_fold.launches,
                    pilot_stats=K.pilot_stats.launches,
                    isla_sketch=K.isla_sketch.launches)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    admitted = len(spy.prefill_s)
    name = f"{arch} ({cfg.param_dtype})"
    check(admitted == MAMBA_REQUESTS and len(done) == MAMBA_REQUESTS,
          f"{name}: {len(done)} of {MAMBA_REQUESTS} requests served")
    want_flash = admitted * n_attn if on_card else 0
    check(launches["flash_attention"] == want_flash,
          f"{name}: flash_attention launched {launches['flash_attention']} "
          f"times, not once per attention layer of {admitted} prefills "
          f"({want_flash})")
    check(len(spy.calls) == admitted * n_attn,
          f"{name}: {len(spy.calls)} flash calls for {admitted} prefills")
    check(launches["isla_fold"] + launches["pilot_stats"]
          + launches["isla_sketch"] == 0, f"{name}: the Mamba path ran an "
                                          f"ISLA kernel")
    for r in done:
        check(len(r.generated) == MAMBA_MAX_NEW + 1 and all(
            0 <= t < cfg.padded_vocab for t in r.generated),
              f"{name}: request {r.rid} generated {r.generated}")
    for lg in spy.logits:
        check(tuple(lg.shape) == (1, 1, cfg.padded_vocab)
              and bool(torch.isfinite(lg).all()),
              f"{name}: prefill logits are not finite (1, 1, V)")
    check([c["x"].shape[1] for c in ssd.calls] == lens,
          f"{name}: layer-0 SSD calls of "
          f"{[c['x'].shape[1] for c in ssd.calls]} tokens for prompts of "
          f"{lens}")
    ssd_checks = [check_ssd(name, c, MAMBA_TOL) for c in ssd.calls]
    del ssd
    prefill_s = sum(spy.prefill_s)
    decode_s = wall - prefill_s
    new_tokens = sum(len(r.generated) for r in done)
    # Where the time goes, after the counts were read: a re-run of the
    # same traffic tick by tick, then runs with MAMBA_PROFILE_TICK under the
    # profiler (its wall from the first), until one's trace is whole.
    tick_s, _ = drive(scheduler(), device=device)
    for run in range(1, PROFILE_TRIES + 1):
        _, profiled = drive(scheduler(), (MAMBA_PROFILE_TICK,), device)
        prof = dict(profiled[0], runs=run, wall_s=tick_s[MAMBA_PROFILE_TICK])
        if not on_card or decode_trace_whole(prof):
            break
        print(f"{name}: profiled decode tick, run {run}: "
              f"{prof['device_events']} device events for "
              f"{prof['products']} matrix products; taken again")
    else:
        check(False, f"{name}: the profiled decode tick lost kernels in "
                     f"{PROFILE_TRIES} runs")
    if on_card:
        prof["busy_share"] = prof["device_s"] / prof["wall_s"]
    extra = {}
    if "cpu" in checks and cfg.moe is not None:
        # one prompt on the routing group and one off it
        picks = [next(p for p, n in zip(prompts, lens) if n % group == 0),
                 next(p for p, n in zip(prompts, lens) if n % group)]
        extra["cpu"] = check_jamba_cpu(cfg, params, picks, device)
    elif "cpu" in checks:
        extra["cpu"] = check_mamba_cpu(cfg, params, [int(t) for t in (
            rng.integers(0, cfg.vocab, 2 * cfg.mamba.chunk + 1))], device)
    if "parity" in checks:
        extra["parity"] = check_mamba_parity(
            cfg, params, [int(t) for t in rng.integers(
                0, cfg.vocab, cfg.mamba.chunk)], device)
    return dict(arch=arch, dtype=cfg.param_dtype, n_layers=cfg.n_layers,
                d_model=cfg.d_model, mamba_layers=n_mamba,
                attention_layers=n_attn, n_params=n_params, init_s=init_s,
                held_bytes=held, peak_bytes=peak, prompt_lens=lens,
                slots=MAMBA_SLOTS, max_new=MAMBA_MAX_NEW, max_seq=max_seq,
                launches=launches, wall_s=wall, prefill_s=prefill_s,
                prefill_each_s=spy.prefill_s, decode_s=decode_s,
                ticks=len(tick_s), decode_tick_s=decode_s / len(tick_s),
                new_tokens=new_tokens, tokens_per_s=new_tokens / wall,
                finish_order=[r.rid for r in done], rerun_tick_s=tick_s,
                profiled_tick=prof, ssd=ssd_checks, calls=spy.calls,
                **extra)


# ---------------------------------------------------------------------------
# The LM training path ("lm train").
# ---------------------------------------------------------------------------

TRAIN_ARCH = "olmo-1b"
TRAIN_SHAPE = (4, 1024)       # olmo-1b at full width: B x S, two CE chunks
TRAIN_STEPS = 8
TRAIN_LONG = (1, 8192)        # one step through _blocked_attention
TRAIN_LONG_BLOCK = 1024
TRAIN_CPU_SHAPE = (1, 256)    # the depth-cut step, card against the CPU
TRAIN_MICRO_SHAPE = (4, 64)   # reduced olmo-1b: microbatches vs one batch
TRAIN_MICROBATCHES = 2
BLOCKED_SHAPE = (1, 2048, 16, 128)   # _blocked_attention vs dense: B S H hd
BLOCKED_BLOCKS = (1024, 512)
TRAIN_MAMBA = ("mamba2-130m", (4, 512), 4)   # two SSD chunks of 256
TRAIN_MOE_ARCHS = ("jamba-1.5-large-398b", "grok-1-314b")
TRAIN_MOE_SHAPE = (2, 64)     # 128 tokens: two routing groups of 64
# The reference's integration run (tests/test_train_integration.py): 30
# steps, the mean of the last 5 losses below the first 5's by more than
# ``drop``; a checkpoint at ``save_at`` restored and replayed.
DESCENT = dict(shape=(8, 64), steps=30, lr=1e-2, warmup=5, total=200,
               save_at=5, replay=5, drop=0.2, isla_rate=0.25)
# fp32 card against the CPU: losses, metrics, moments (of each leaf's
# scale) 1e-5; the MoE steps and their aux losses 1e-4, as the card tests
# hold MoE models.
TRAIN_TOL = 1e-5
TRAIN_MOE_TOL = 1e-4
# Adam's first step moves an element by lr * g / (|g| + eps): where |g| is
# at most this share of its leaf's largest it lies within the two devices'
# rounding of g, and the two steps may differ by up to 2 * lr there.
TRAIN_SMALL_GRAD = 1e-4


def train_config(lr=3e-4, warmup=2, total=100, weight_decay=0.1,
                 **kw):
    """A ``TrainConfig`` with the default ISLA loss telemetry and the exact
    mean beside it."""
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import TrainConfig

    return TrainConfig(opt=OptimizerConfig(
        lr=lr, warmup_steps=warmup, total_steps=total,
        weight_decay=weight_decay), telemetry_exact=True, **kw)


def train_launches() -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K

    return dict(isla_fold=K.isla_fold.launches,
                flash_attention=FA.flash_attention.launches,
                other_isla=K.pilot_stats.launches + K.isla_sketch.launches
                + K.isla_tagged_fold.launches + K.isla_fold.launches_f64
                + K.isla_sketch_tagged.launches)


def train_run(cfg, tcfg, params, opt, stream, steps, device, start=0,
              name="lm train", step_fn=None):
    """``steps`` optimizer steps on ``stream`` from ``start``, each timed
    (synchronised host clock; the batch drawn and moved before the clock),
    through ``step_fn(params, opt, batch)`` (``train_step`` itself when
    None; the sharded step of ``launch.train.build_step``).
    The launch counts are set to 0 just before the first step and read
    just after the last.  Fails on a non-finite loss, ``grad_norm`` or
    telemetry, on an ``isla_fold`` count other than one a step, on any
    other kernel, and on a step whose loss telemetry parts from the same
    ``loss_stats`` call on its own per-token losses under
    ``PlainVersions`` by more than rel ``TELEMETRY_TOL``.  Returns
    (params, opt, records, launches, panes): ``panes`` the first pane of
    each length the telemetry folded, with its cuts."""
    from repro_torch.kernels import isla_moments as K
    from repro_torch.train import train_step as TS

    recs = []
    if step_fn is None:
        step_fn = functools.partial(TS.train_step, cfg, tcfg)
    K.reset_launch_counts()
    with Recorder("loss_stats", module=TS) as calls, FoldPanes() as panes:
        panes.on = True
        for step in range(start, start + steps):
            batch = stream.batch_at(step)
            sync(device)
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            sync(device)
            recs.append(dict(step=step, s=time.perf_counter() - t0,
                             **{k: float(v) for k, v in m.items()}))
    launches = train_launches()
    for r in recs:
        check(all(math.isfinite(v) for k, v in r.items() if k != "step"),
              f"{name}: step {r['step']} is not finite: {r}")
    check(launches["isla_fold"] == steps,
          f"{name}: {launches['isla_fold']} isla_fold launches in {steps} "
          f"steps, not one a step (the loss telemetry)")
    check(launches["flash_attention"] == launches["other_isla"] == 0,
          f"{name}: the training path launched {launches}")
    check(calls.count == steps, f"{name}: {calls.count} loss_stats calls "
                                f"in {steps} steps")
    for c, r in zip(calls.calls, recs):
        with PlainVersions():
            plain = TS.loss_stats(*c["args"], **c["kw"])
        gaps = {k: rel_gap(r[k], float(v)) for k, v in plain.items()}
        r["plain_gap"] = max(gaps.values())
        check(r["plain_gap"] <= TELEMETRY_TOL,
              f"{name}: step {r['step']}'s loss telemetry parts from its "
              f"plain replay on the same per-token losses by {gaps} > rel "
              f"{TELEMETRY_TOL}")
    return params, opt, recs, launches, panes.panes


def train_profile(cfg, tcfg, params, opt, batch, device, wall_s) -> dict:
    """One more step under the profiler, taken again up to
    ``PROFILE_TRIES`` times until its trace is whole: a device event for
    every matrix product its host side recorded, and the fold's kernel.
    Its busy share is over ``wall_s``, an unprofiled step's."""
    import torch
    from repro_torch.train.train_step import train_step

    on_card = torch.device(device).type == "cuda"
    for run in range(1, PROFILE_TRIES + 1):
        sync(device)
        time.sleep(PROFILE_GAP_S)
        with profile_tick(device, True) as prof:
            train_step(cfg, tcfg, params, opt, batch)
            sync(device)
        kernels_s = device_kernel_seconds(prof)
        r = dict(runs=run, device_events=device_event_count(prof),
                 products=matrix_products(prof),
                 device_s=sum(kernels_s.values()),
                 fold_kernels=sum(1 for n in kernels_s
                                  if "isla_fold_kernel" in n),
                 kernels_s=dict(sorted(kernels_s.items(),
                                       key=lambda kv: -kv[1])[:8]),
                 wall_s=wall_s)
        if not on_card or (decode_trace_whole(r) and r["fold_kernels"]):
            break
        print(f"lm train: profiled step, run {run}: {r['device_events']} "
              f"device events for {r['products']} matrix products, "
              f"{r['fold_kernels']} fold kernels; taken again")
    else:
        check(False, f"lm train: the profiled step lost kernels in "
                     f"{PROFILE_TRIES} runs")
    if on_card:
        r["busy_share"] = r["device_s"] / wall_s
    return r


def train_olmo(device="cuda", reduced=False, shape=TRAIN_SHAPE,
               steps=TRAIN_STEPS, long_shape=TRAIN_LONG, seed=0) -> dict:
    """olmo-1b (full width and depth, bf16, remat: the config's own; the
    reduced config with ``reduced``) from a seeded generator: ``steps``
    steps on the port's ``SyntheticStream`` at ``shape`` (``train_run``),
    one profiled step, then one step at ``long_shape`` that must take
    ``_blocked_attention`` at block ``TRAIN_LONG_BLOCK`` in every
    attention layer (and its recompute)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import isla_moments as K
    from repro_torch.models import attention as A
    from repro_torch.models import model as TM
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import train_step

    on_card = torch.device(device).type == "cuda"
    cfg = get_config(TRAIN_ARCH, reduced=reduced)
    held = None
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, gen)
    opt = init_opt_state(params)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    B, S = shape
    stream = SyntheticStream(cfg, batch=B, seq=S, device=device)
    tcfg = train_config()
    name = f"lm train {TRAIN_ARCH}"
    params, opt, recs, launches, panes = train_run(
        cfg, tcfg, params, opt, stream, steps, device, name=name)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    warm = sorted(r["s"] for r in recs[1:]) or [recs[0]["s"]]
    median_s = warm[len(warm) // 2]
    prof = train_profile(cfg, tcfg, params, opt, stream.batch_at(steps),
                         device, median_s)
    LB, LS = long_shape
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    batch = SyntheticStream(cfg, batch=LB, seq=LS,
                            device=device).batch_at(0)
    K.reset_launch_counts()
    with Recorder("_blocked_attention", module=A,
                  keep=lambda q, k, v, positions, block: block) as blocked:
        sync(device)
        t0 = time.perf_counter()
        _, _, lm = train_step(cfg, tcfg, params, opt, batch)
        sync(device)
        long_s = time.perf_counter() - t0
    long_launches = train_launches()
    long_peak = torch.cuda.max_memory_allocated() if on_card else None
    long_m = {k: float(v) for k, v in lm.items()}
    check(all(math.isfinite(v) for v in long_m.values()),
          f"{name}: the S = {LS} step is not finite: {long_m}")
    check(long_launches["isla_fold"] == 1 and long_launches[
        "flash_attention"] == long_launches["other_isla"] == 0,
          f"{name}: the S = {LS} step launched {long_launches}")
    # each attention layer's forward, and its recompute under remat
    want = cfg.n_layers * (2 if cfg.remat else 1)
    check(blocked.calls == [TRAIN_LONG_BLOCK] * want,
          f"{name}: the S = {LS} step made {blocked.count} blocked "
          f"attention calls of blocks {sorted(set(blocked.calls))}, not "
          f"{want} of {TRAIN_LONG_BLOCK}")
    del params, opt, batch, lm
    return dict(arch=TRAIN_ARCH, dtype=cfg.param_dtype, remat=cfg.remat,
                n_layers=cfg.n_layers, d_model=cfg.d_model,
                n_params=n_params, init_s=init_s, held_bytes=held,
                peak_bytes=peak, shape=list(shape), steps=recs,
                launches=launches, median_step_s=median_s,
                tokens_per_s=B * S / median_s,
                isla_gap=[abs(r["loss_mean_isla"] - r["loss_mean_exact"])
                          for r in recs],
                profiled_step=prof, long_shape=list(long_shape),
                long_s=long_s, long_peak_bytes=long_peak,
                long_metrics=long_m, long_launches=long_launches,
                long_blocked_calls=blocked.count, panes=panes)


def check_step_pair(name, lr, b1, got, want, tol) -> dict:
    """A step's (new params, opt state, metrics) on the card (``got``)
    against the same step on the CPU (``want``): every metric within rel
    ``tol``; ``m`` and ``v`` within ``tol`` of each leaf's scale; the new
    params within ``tol`` of each leaf's scale wherever |g| (read off the
    first step's ``m = (1 - b1) g``) exceeds ``TRAIN_SMALL_GRAD`` of the
    leaf's largest, and within ``2 * lr`` of each other elsewhere (Adam's
    first step there is g / (|g| + eps) of two roundings of a near-zero
    g).  Returns the largest gaps."""
    from repro_torch.core.tree import tree_leaves, tree_paths

    (gp, go, gm), (wp, wo, wm) = got, want
    check(sorted(gm) == sorted(wm), f"{name}: metrics {sorted(gm)} vs "
                                    f"{sorted(wm)}")
    gaps = {}
    for k in wm:
        a, b = float(gm[k]), float(wm[k])
        gaps[k] = abs(a - b) / max(abs(b), 1e-30)
        check(gaps[k] <= tol, f"{name}: {k} {a!r} on the card, {b!r} on the "
                              f"CPU (rel {gaps[k]:.3g} > {tol})")
    worst = dict(m=0.0, v=0.0, params=0.0, params_small=0.0)
    for part, g_tree, w_tree in (("m", go.m, wo.m), ("v", go.v, wo.v)):
        for (path, w), g in zip(tree_paths(w_tree), tree_leaves(g_tree)):
            err, scale = rel_err(g.cpu(), w)
            worst[part] = max(worst[part], err)
            check(err <= tol, f"{name}: {part}{path} off the CPU's by "
                              f"{err:.3g} of its scale {scale:.3g}")
    for (path, w), g, m in zip(tree_paths(wp), tree_leaves(gp),
                               tree_leaves(wo.m)):
        gabs = m.float().abs() / (1 - b1)
        big = gabs > TRAIN_SMALL_GRAD * gabs.max()
        gap = (g.cpu().float() - w.float()).abs()
        scale = float(w.float().abs().max())
        e_big = float(gap[big].max()) / scale if bool(big.any()) else 0.0
        e_small = float(gap[~big].max()) if bool((~big).any()) else 0.0
        worst["params"] = max(worst["params"], e_big)
        worst["params_small"] = max(worst["params_small"], e_small)
        check(e_big <= tol, f"{name}: params{path} off the CPU's by "
                            f"{e_big:.3g} of its scale {scale:.3g}")
        check(e_small <= 2 * lr * 1.0001,
              f"{name}: params{path} off the CPU's by {e_small:.3g} where "
              f"|g| is near zero (> 2 lr = {2 * lr:.3g})")
    return dict(metric_rel=gaps, **worst)


def train_cpu_pair(device="cuda", reduced=False, shape=TRAIN_CPU_SHAPE,
                   seed=1) -> dict:
    """olmo-1b at full width cut to one layer, in fp32 (reduced with
    ``reduced``): the same weights (a seeded CPU generator), optimizer
    state and batch, one ``train_step`` on ``device`` and one on the CPU,
    held by ``check_step_pair`` at ``TRAIN_TOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import train_step

    cfg = get_config(TRAIN_ARCH, reduced=reduced).replace(
        n_layers=1, param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(seed))
    opt = init_opt_state(params)
    B, S = shape
    batch = SyntheticStream(cfg, batch=B, seq=S, device="cpu").batch_at(0)
    tcfg = train_config(lr=1e-3)
    from repro_torch.kernels import isla_moments as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = train_step(cfg, tcfg, to_device(params, device),
                     to_device(opt, device), to_device(batch, device))
    sync(device)
    card_s = time.perf_counter() - t0
    launches = train_launches()
    check(launches["isla_fold"] == 1, f"lm train depth-cut step: "
                                      f"{launches}")
    t0 = time.perf_counter()
    want = train_step(cfg, tcfg, params, opt, batch)
    cpu_s = time.perf_counter() - t0
    gaps = check_step_pair(f"lm train {TRAIN_ARCH} (1 layer, fp32)",
                           tcfg.opt.lr, tcfg.opt.b1, to_device(got, "cpu"),
                           want, TRAIN_TOL)
    return dict(arch=TRAIN_ARCH, n_layers=1, d_model=cfg.d_model,
                dtype="float32", shape=list(shape), card_s=card_s,
                cpu_s=cpu_s, launches=launches, tolerance=TRAIN_TOL,
                loss=float(got[2]["loss"]), **gaps)


def train_microbatch(device="cuda", shape=TRAIN_MICRO_SHAPE, seed=5) -> dict:
    """Reduced olmo-1b in fp32 on ``device``: one step over
    ``TRAIN_MICROBATCHES`` microbatches against one step over the whole
    batch, from the same weights and batch (``check_step_pair`` at
    ``TRAIN_TOL``: the accumulated grads are divided by the count, so the
    two steps agree up to rounding)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import train_step

    cfg = get_config(TRAIN_ARCH, reduced=True).replace(param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    opt = init_opt_state(params)
    B, S = shape
    batch = SyntheticStream(cfg, batch=B, seq=S, device=device).batch_at(0)
    whole = train_config(lr=1e-3)
    split = dataclasses.replace(whole, microbatches=TRAIN_MICROBATCHES)
    from repro_torch.kernels import isla_moments as K

    K.reset_launch_counts()
    got = train_step(cfg, split, params, opt, batch)
    want = train_step(cfg, whole, params, opt, batch)
    sync(device)
    launches = train_launches()
    check(launches["isla_fold"] == 2, f"lm train microbatches: {launches}")
    gaps = check_step_pair(
        f"lm train {TRAIN_ARCH} (reduced, fp32) over "
        f"{TRAIN_MICROBATCHES} microbatches", whole.opt.lr, whole.opt.b1,
        to_device(got, "cpu"), to_device(want, "cpu"), TRAIN_TOL)
    return dict(arch=TRAIN_ARCH, shape=list(shape),
                microbatches=TRAIN_MICROBATCHES, launches=launches,
                tolerance=TRAIN_TOL, **gaps)


def check_blocked(device="cuda", shape=BLOCKED_SHAPE, blocks=BLOCKED_BLOCKS,
                  seed=2) -> list:
    """``_blocked_attention`` against the dense formula on ``device`` in
    fp32 (full heads, one KV head a q head), at each block: the outputs
    and the q, k, v grads within ``TRAIN_TOL`` of their scale."""
    import torch
    from repro_torch.models import attention as A

    B, S, H, hd = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((B, S, H, hd), generator=gen, device=device)
               for _ in range(3))
    ct = torch.randn((B, S, H * hd), generator=gen, device=device)
    pos = torch.arange(S, device=device).expand(B, S)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, ct))

    def dense(q_, k_, v_):
        causal = pos[:, None, :, None] >= pos[:, None, None, :]
        probs = torch.softmax(A._masked(A._gqa_scores(q_, k_), causal), -1)
        return A._gqa_out(probs, v_, q_.dtype)

    want = grads(dense)
    out = []
    for block in blocks:
        sync(device)
        t0 = time.perf_counter()
        got = grads(lambda a, b, c: A._blocked_attention(a, b, c, pos,
                                                          block))
        sync(device)
        s = time.perf_counter() - t0
        errs = {n: rel_err(g, w)[0] for n, g, w in zip(
            ("out", "q", "k", "v"), got, want)}
        check(max(errs.values()) <= TRAIN_TOL,
              f"_blocked_attention at block {block} off the dense formula "
              f"on the card: {errs} (tol {TRAIN_TOL} of scale)")
        out.append(dict(shape=list(shape), block=block, rel=errs, s=s))
    return out


def train_mamba(device="cuda", reduced=False, spec=TRAIN_MAMBA,
                seed=3) -> dict:
    """mamba2-130m at full width and depth in bf16 with remat (the
    reduced config with ``reduced``): ``train_run`` steps at its shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state

    arch, (B, S), steps = spec
    on_card = torch.device(device).type == "cuda"
    cfg = get_config(arch, reduced=reduced).replace(remat=True)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = TM.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    opt = init_opt_state(params)
    stream = SyntheticStream(cfg, batch=B, seq=S, device=device)
    params, opt, recs, launches, panes = train_run(
        cfg, train_config(), params, opt, stream, steps, device,
        name=f"lm train {arch}")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    return dict(arch=arch, dtype=cfg.param_dtype, remat=cfg.remat,
                n_layers=cfg.n_layers, d_model=cfg.d_model,
                n_params=sum(t.numel() for t in _leaves(params)),
                shape=[B, S], chunks=S // cfg.mamba.chunk, steps=recs,
                launches=launches, peak_bytes=peak, panes=panes)


def train_moe_pair(arch, device="cuda", shape=TRAIN_MOE_SHAPE,
                   seed=4) -> dict:
    """A reduced MoE config in fp32: one ``train_step`` on ``device``
    against the same on the CPU (``check_step_pair`` at
    ``TRAIN_MOE_TOL``), the aux losses of ``train_loss`` on both, and
    the card's routing of every MoE call held by ``check_route`` (its
    near-ties counted)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import train_step

    cfg = get_config(arch, reduced=True).replace(param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(seed))
    opt = init_opt_state(params)
    B, S = shape
    batch = SyntheticStream(cfg, batch=B, seq=S, device="cpu").batch_at(0)
    tcfg = train_config(lr=1e-3)
    dp, do, db = (to_device(t, device) for t in (params, opt, batch))
    from repro_torch.kernels import isla_moments as K

    K.reset_launch_counts()
    with MoeCalls() as routes:
        got = train_step(cfg, tcfg, dp, do, db)
        sync(device)
    launches = train_launches()
    check(launches["isla_fold"] == 1 and launches["flash_attention"] == 0,
          f"lm train {arch}: {launches}")
    want = train_step(cfg, tcfg, params, opt, batch)
    name = f"lm train {arch} (reduced, fp32)"
    gaps = check_step_pair(name, tcfg.opt.lr, tcfg.opt.b1,
                           to_device(got, "cpu"), want, TRAIN_MOE_TOL)
    with torch.no_grad():
        aux = [TM.train_loss(cfg, p, b)[1] for p, b in ((dp, db),
                                                        (params, batch))]
    aux_rel = {}
    for k in ("moe_lb_loss", "moe_z_loss"):
        a, b = float(aux[0][k]), float(aux[1][k])
        aux_rel[k] = abs(a - b) / max(abs(b), 1e-30)
        check(aux_rel[k] <= TRAIN_MOE_TOL,
              f"{name}: {k} {a!r} on the card, {b!r} on the CPU")
    route = [check_route(cfg, c["logits"].detach()) for c in routes.calls]
    n_moe = sum(cfg.block_is_moe(i) for i in range(cfg.n_layers))
    check(len(route) == n_moe, f"{name}: {len(route)} routed calls for "
                               f"{n_moe} MoE layers")
    return dict(arch=arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
                shape=list(shape), launches=launches, aux_rel=aux_rel,
                moe_calls=len(route),
                near_ties=sum(r["near_ties"] for r in route),
                tokens=sum(r["tokens"] for r in route),
                tolerance=TRAIN_MOE_TOL, **gaps)


def train_descent(device="cuda", ckpt_dir=None, seed=0,
                  spec=DESCENT) -> dict:
    """The reference's integration run on ``device``: reduced olmo-1b from
    a seeded generator, ``spec["steps"]`` steps (ISLA telemetry at rate
    0.25 with the exact mean beside it); the mean of the last 5 losses
    below the first 5's by more than ``spec["drop"]``.  A checkpoint of
    params and optimizer state at ``spec["save_at"]`` (``checkpoint.save``
    into ``ckpt_dir``, a temporary directory when None) is restored into
    the abstract shapes and steps ``save_at`` .. ``save_at + replay - 1``
    replayed: their losses within rtol 1e-5 of the first run's."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.train import checkpoint
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import abstract_opt_state, init_opt_state

    cfg = get_config(TRAIN_ARCH, reduced=True)
    params = TM.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    opt = init_opt_state(params)
    B, S = spec["shape"]
    stream = SyntheticStream(cfg, batch=B, seq=S, device=device)
    tcfg = train_config(lr=spec["lr"], warmup=spec["warmup"],
                        total=spec["total"], weight_decay=0.0,
                        isla_rate=spec["isla_rate"])
    at = spec["save_at"]
    name = f"lm train {TRAIN_ARCH} (reduced) descent"
    with tempfile.TemporaryDirectory() as tmp:
        d = ckpt_dir or tmp
        params, opt, first, l1, panes = train_run(
            cfg, tcfg, params, opt, stream, at, device, name=name)
        checkpoint.save(d, at, {"params": params, "opt": opt},
                        fingerprint=cfg.name)
        params, opt, rest, l2, _ = train_run(
            cfg, tcfg, params, opt, stream, spec["steps"] - at, device,
            start=at, name=name)
        like = {"params": TM.abstract_params(cfg),
                "opt": abstract_opt_state(TM.abstract_params(cfg))}
        try:
            back, _ = checkpoint.restore(d, at, like, device=device,
                                         fingerprint=cfg.name)
        except (KeyError, ValueError) as exc:
            check(False, f"{name}: the step-{at} checkpoint does not "
                         f"restore: {exc}")
    _, _, replay, l3, _ = train_run(cfg, tcfg, back["params"], back["opt"],
                                    stream, spec["replay"], device, start=at,
                                    name=name + " replay")
    losses = [r["loss"] for r in first + rest]
    drop = (sum(losses[:5]) - sum(losses[-5:])) / 5
    check(drop > spec["drop"], f"{name}: no learning: first 5 "
                               f"{losses[:5]}, last 5 {losses[-5:]}")
    again = [r["loss"] for r in replay]
    want = losses[at:at + spec["replay"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(again, want))
    check(rel <= 1e-5, f"{name}: the replay after restore gave {again}, "
                       f"the run {want}")
    gaps = sorted(abs(r["loss_mean_isla"] - r["loss_mean_exact"])
                  for r in first + rest)
    return dict(arch=TRAIN_ARCH, shape=[B, S], steps=spec["steps"],
                losses=losses, drop=drop, replay_losses=again,
                replay_rel=rel, isla_median_gap=gaps[len(gaps) // 2],
                plain_gap=max(r["plain_gap"] for r in first + rest + replay),
                panes=panes,
                launches=dict(isla_fold=l1["isla_fold"] + l2["isla_fold"]
                              + l3["isla_fold"]))


def train_path(device="cuda", reduced=False, **over) -> dict:
    """The "lm train" phase: ``train_olmo``, ``train_cpu_pair``,
    ``train_microbatch``, ``check_blocked``, ``train_mamba``,
    ``train_moe_pair`` for each of
    ``TRAIN_MOE_ARCHS`` and ``train_descent``; ``reduced`` with
    ``device="cpu"`` rehearses it on the CPU (``over`` sets the shapes).
    ``panes`` holds the first pane of each length that the loss telemetry
    of the olmo-1b, mamba2-130m and descent runs folded, for
    ``check_telemetry_folds``."""
    out = dict(olmo=train_olmo(device, reduced, **over.get("olmo", {})))
    out["cpu_pair"] = train_cpu_pair(device, reduced,
                                     **over.get("cpu_pair", {}))
    out["microbatch"] = train_microbatch(device)
    out["blocked"] = check_blocked(device, **over.get("blocked", {}))
    out["mamba"] = train_mamba(device, reduced, **over.get("mamba", {}))
    out["moe"] = [train_moe_pair(a, device) for a in TRAIN_MOE_ARCHS]
    out["descent"] = train_descent(device)
    out["fold_launches"] = (
        out["olmo"]["launches"]["isla_fold"]
        + out["olmo"]["long_launches"]["isla_fold"]
        + out["cpu_pair"]["launches"]["isla_fold"]
        + out["microbatch"]["launches"]["isla_fold"]
        + out["mamba"]["launches"]["isla_fold"]
        + sum(m["launches"]["isla_fold"] for m in out["moe"])
        + out["descent"]["launches"]["isla_fold"])
    out["panes"] = {}
    for run in (out["olmo"], out["mamba"], out["descent"]):
        for n, pane in run.pop("panes").items():
            out["panes"].setdefault(n, pane)
    return out


def print_train(t: dict, total_bytes: int) -> None:
    """The "lm train" phase's figures."""
    o = t["olmo"]
    p = o["profiled_step"]
    steps = o["steps"]
    print(f"Train path, {o['arch']} ({o['n_layers']} layers, d_model "
          f"{o['d_model']}, {o['n_params'] / 1e9:.4f} B "
          f"params, {o['dtype']}, remat {o['remat']}; init "
          f"{o['init_s']:.2f} s; {o['held_bytes'] / 2**30:.3f} GiB held "
          f"before it, peak {o['peak_bytes'] / 2**30:.2f} GiB of "
          f"{total_bytes / 2**30:.2f}): {len(steps)} steps at B x S = "
          f"{o['shape'][0]} x {o['shape'][1]}: {json.dumps(o['launches'])} "
          f"launches")
    print("  loss " + ", ".join(f"{r['loss']:.4f}" for r in steps)
          + "; grad_norm " + ", ".join(f"{r['grad_norm']:.3f}"
                                       for r in steps))
    print("  step s " + ", ".join(f"{r['s']:.4f}" for r in steps)
          + f"; median after the first {o['median_step_s']:.4f} s = "
          f"{o['tokens_per_s']:.0f} tok/s")
    print("  loss_mean_isla vs loss_mean_exact " + ", ".join(
        f"{r['loss_mean_isla']:.4f}/{r['loss_mean_exact']:.4f}"
        for r in steps) + "; the telemetry against its plain replay max "
        f"rel {max(r['plain_gap'] for r in steps):.3g} (tol rel "
        f"{TELEMETRY_TOL})")
    top = list(p["kernels_s"].items())[:3]
    print(f"  profiled step (run {p['runs']}): {p['device_events']} device "
          f"events for {p['products']} matrix products, {p['fold_kernels']} "
          f"isla_fold kernel(s), busy {p['device_s'] * 1e3:.2f} ms of "
          f"{p['wall_s'] * 1e3:.2f} ms unprofiled ({p['busy_share']:.1%}); "
          f"top kernels " + ", ".join(f"{n[:48]} {s * 1e3:.2f} ms"
                                      for n, s in top))
    lm = o["long_metrics"]
    print(f"  one step at B x S = {o['long_shape'][0]} x "
          f"{o['long_shape'][1]} ({o['long_blocked_calls']} blocked "
          f"attention calls at block {TRAIN_LONG_BLOCK}): {o['long_s']:.3f} "
          f"s, peak {o['long_peak_bytes'] / 2**30:.2f} GiB, loss "
          f"{lm['loss']:.4f}, grad_norm {lm['grad_norm']:.3f}")
    c = t["cpu_pair"]
    print(f"  {c['arch']} cut to 1 layer, fp32, B x S = {c['shape'][0]} x "
          f"{c['shape'][1]}, one step on the card ({c['card_s']:.3f} s) vs "
          f"the CPU ({c['cpu_s']:.2f} s): metrics max rel "
          f"{max(c['metric_rel'].values()):.3g}, m {c['m']:.3g}, v "
          f"{c['v']:.3g}, params {c['params']:.3g} of scale (|g| near 0: "
          f"{c['params_small']:.3g} abs) (tol {c['tolerance']})")
    u = t["microbatch"]
    print(f"  reduced {u['arch']}, fp32, B x S = {u['shape'][0]} x "
          f"{u['shape'][1]}: one step over {u['microbatches']} microbatches "
          f"vs one over the batch: metrics max rel "
          f"{max(u['metric_rel'].values()):.3g}, m {u['m']:.3g}, v "
          f"{u['v']:.3g}, params {u['params']:.3g} (tol {u['tolerance']})")
    print("  _blocked_attention vs the dense formula, fp32 " + "; ".join(
        f"{tuple(b['shape'])} block {b['block']}: max rel "
        f"{max(b['rel'].values()):.3g} ({b['s']:.3f} s with grads)"
        for b in t["blocked"]))
    m = t["mamba"]
    print(f"  {m['arch']} ({m['n_layers']} layers, d_model {m['d_model']}, "
          f"{m['n_params'] / 1e9:.4f} B params, {m['dtype']}, remat): "
          f"{len(m['steps'])} steps at "
          f"B x S = {m['shape'][0]} x {m['shape'][1]} ({m['chunks']} SSD "
          f"chunks): loss " + ", ".join(f"{r['loss']:.4f}"
                                        for r in m["steps"])
          + "; step s " + ", ".join(f"{r['s']:.3f}" for r in m["steps"])
          + f"; peak {m['peak_bytes'] / 2**30:.2f} GiB; "
          f"{json.dumps(m['launches'])} launches; the telemetry against its "
          f"plain replay max rel "
          f"{max(r['plain_gap'] for r in m['steps']):.3g}")
    for x in t["moe"]:
        print(f"  {x['arch']} (reduced, fp32) one step card vs CPU: "
              f"metrics max rel {max(x['metric_rel'].values()):.3g}, "
              f"moe_lb_loss {x['aux_rel']['moe_lb_loss']:.3g}, moe_z_loss "
              f"{x['aux_rel']['moe_z_loss']:.3g}, m {x['m']:.3g}, v "
              f"{x['v']:.3g}, params {x['params']:.3g} (tol "
              f"{x['tolerance']}); {x['moe_calls']} routed calls, "
              f"{x['near_ties']} near-tie tokens of {x['tokens']}")
    d = t["descent"]
    print(f"  reduced {d['arch']}, {d['steps']} steps at B x S = "
          f"{d['shape'][0]} x {d['shape'][1]}: loss "
          f"{d['losses'][0]:.4f} -> {d['losses'][-1]:.4f} (first-5 minus "
          f"last-5 mean {d['drop']:.3f}); replay after restore max rel "
          f"{d['replay_rel']:.3g}; median |isla - exact| "
          f"{d['isla_median_gap']:.4g}; the telemetry against its plain "
          f"replay max rel {d['plain_gap']:.3g}")
    for f in t["folds"]:
        print(f"  isla_fold on a {f['samples']}-sample training telemetry "
              f"pane: {f['ms']:.4f} ms on the card (profiler, "
              f"{f['kernels_a_call']:g} kernels a call; CUDA events "
              f"{f['event_ms']:.4f} ms; plain {f['plain_ms']:.4f} ms), bound "
              f"{f['bound_ms']:.5f} ms by {f['bound_by']}, max rel err "
              f"{f['max_rel_err']:.3g} (tol rel {TELEMETRY_TOL}), two "
              f"launches identical")
    print(f"  isla_fold launches in the phase: {t['fold_launches']}")


# ---------------------------------------------------------------------------
# The training CLI ("lm train cli"): python -m repro_torch.launch.train on
# olmo-1b at full width, a crash between two checkpoints, a resume.
# ---------------------------------------------------------------------------

CLI_ARCH = "olmo-1b"
CLI_SHAPE = TRAIN_SHAPE       # the "lm train" phase's olmo-1b steps
CLI_STEPS = 6
CLI_EVERY = 4                 # run A commits steps 4 and 6
CLI_RESUME = 4                # the step run B resumes from
# Run B's steps and its step-6 checkpoint against run A's: two
# uninterrupted runs of the CLI on the card agreed bit for bit
# (tools/train_cli_repeat.py), so they are held bit for bit.
CLI_TOL = 0.0
CLI_DIR = ROOT / "_train_cli"  # git-ignored; removed when the phase ends
CLI_TIMEOUT_S = 900
CLI_LOG = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) \((\d+\.\d{2})s\) "
                     r"isla_loss (\d+\.\d{4})$")


def cli_argv(ckpt_dir, out=None, resume=False, device="cuda", reduced=False,
             shape=CLI_SHAPE, steps=CLI_STEPS) -> "list[str]":
    """The CLI's arguments for the phase's runs."""
    B, S = shape
    argv = ["--arch", CLI_ARCH, "--steps", str(steps), "--batch", str(B),
            "--seq", str(S), "--ckpt-every", str(CLI_EVERY), "--ckpt-dir",
            str(ckpt_dir), "--log-every", "1", "--telemetry-exact",
            "--device", device]
    if out is not None:
        argv += ["--out", str(out)]
    if resume:
        argv.append("--resume")
    if reduced:
        argv.append("--reduced")
    return argv


def tree_bytes(cfg) -> int:
    """Bytes of the trainer's checkpoint tree: the params in their dtype,
    AdamW's fp32 ``m`` and ``v``, the int32 step."""
    from repro_torch.models import model as TM

    leaves = _leaves(TM.abstract_params(cfg))
    return sum(t.numel() * (t.element_size() + 8) for t in leaves) + 4


def own_card() -> str:
    """The smoke's card as ``CUDA_VISIBLE_DEVICES`` names it, so a child
    process sees that card alone."""
    import os

    import torch

    idx = torch.cuda.current_device()
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    return vis.split(",")[idx] if vis else str(idx)


def run_cli(argv, device) -> "tuple[str, float]":
    """``python -m repro_torch.launch.train`` in a child process (on the
    card, with the smoke's card its only visible one): (its standard
    output, its wall seconds).  Fails on a nonzero exit."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if device == "cuda":
        env["CUDA_VISIBLE_DEVICES"] = own_card()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"lm train cli: the CLI exited "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, wall


class Timed:
    """Keeps the seconds of each call of ``<owner>.<name>`` (the card
    synchronised after it) while installed."""

    def __init__(self, owner, name: str, device):
        self.owner, self.name, self.device = owner, name, device
        self.seconds = []

    def __enter__(self):
        self._real = real = getattr(self.owner, self.name)

        def spy(*args, **kw):
            t0 = time.perf_counter()
            out = real(*args, **kw)
            sync(self.device)
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._real)
        return False


def ckpt_leaves(d: Path) -> "tuple[dict, list]":
    """A committed checkpoint's manifest and its leaves as raw arrays
    (memory-mapped; a bf16 leaf as its uint16 bits)."""
    import numpy as np

    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, [np.load(d / leaf["file"], mmap_mode="r")
                      for leaf in manifest["leaves"]]


def as_f32(a):
    """A stored leaf as float32 (uint16-stored bf16 bits widened)."""
    import numpy as np

    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, np.float32)


def compare_ckpts(got: Path, want: Path, tol: float) -> dict:
    """Two committed checkpoints leaf by leaf: the same step, fingerprint,
    paths, shapes and dtypes, and each leaf's values the same bits (``tol``
    0) or within ``tol`` of the leaf's largest magnitude."""
    import numpy as np

    mg, lg = ckpt_leaves(got)
    mw, lw = ckpt_leaves(want)
    meta = lambda m: [(x["path"], x["shape"], x["dtype"])
                      for x in m["leaves"]]
    check(meta(mg) == meta(mw) and mg["step"] == mw["step"]
          and mg["fingerprint"] == mw["fingerprint"],
          f"lm train cli: the step-{mw['step']} checkpoints differ in their "
          f"manifests")
    worst, nbytes = 0.0, 0
    for leaf, a, b in zip(mw["leaves"], lg, lw):
        nbytes += b.nbytes
        if np.array_equal(a, b):
            continue
        a, b = as_f32(a), as_f32(b)
        gap = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                               1e-30)
        worst = max(worst, gap)
        check(gap <= tol, f"lm train cli: leaf {leaf['path']} of the "
                          f"step-{mw['step']} checkpoints parts by {gap:.3g} "
                          f"of its scale (tol {tol})")
    return dict(leaves=len(lw), bytes=nbytes, max_rel_gap=worst,
                step=mw["step"], fingerprint=mw["fingerprint"])


def close_metrics(got: dict, want: dict, tol: float) -> float:
    """The largest relative gap between two history rows (every key but
    ``dt_s``), held to ``tol``."""
    check(sorted(got) == sorted(want), f"lm train cli: run B's row keys "
                                       f"{sorted(got)} != run A's")
    worst = 0.0
    for k, w in want.items():
        if k == "dt_s":
            continue
        gap = abs(got[k] - w) / max(abs(w), 1e-30)
        worst = max(worst, gap)
        check(gap <= tol, f"lm train cli: step {want['step']}'s {k} is "
                          f"{got[k]} after the resume, {w} in run A")
    return worst


def train_cli_path(device="cuda", reduced=False, shape=CLI_SHAPE,
                   root=None) -> dict:
    """The "lm train cli" phase.  Run A: ``python -m
    repro_torch.launch.train`` on olmo-1b (full width and depth unless
    ``reduced``) for ``CLI_STEPS`` steps at ``shape`` with checkpoints
    every ``CLI_EVERY`` steps, in a child process that sees the smoke's
    card alone.  Then a crash after step 4's commit, mid-write of step 6:
    run A's ``step_00000006`` moved aside and a partial
    ``step_00000006.tmp`` left.  Run B: the CLI's ``run`` in this process
    with ``--resume``; it must print ``[resume] from step 4``, remove the
    ``.tmp``, run steps 4 and 5 with one ``isla_fold`` launch each and no
    other kernel (counts set to 0 just before, read just after) and
    commit step 6; its rows and its step-6 checkpoint must equal run A's
    within ``CLI_TOL``.  The checkpoint directory lies under ``root``
    (``CLI_DIR``), whose free space must hold three trees; it is removed
    when the phase ends."""
    import contextlib
    import io
    import os
    import shutil

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import isla_moments as K
    from repro_torch.launch import train as TT

    on_card = torch.device(device).type == "cuda"
    cfg = get_config(CLI_ARCH, reduced=reduced)
    base = Path(root) if root is not None else CLI_DIR
    d = base / "ckpt"
    shutil.rmtree(base, ignore_errors=True)
    d.mkdir(parents=True)
    tb = tree_bytes(cfg)
    B, S = shape
    try:
        free = shutil.disk_usage(d).free
        check(free >= 3 * tb, f"lm train cli: {free} bytes free under {d}, "
                              f"fewer than three checkpoints of {tb} bytes")
        if on_card:
            torch.cuda.empty_cache()
        out_a = base / "run_a.json"
        log_a, a_s = run_cli(cli_argv(d, out=out_a, device=device,
                                      reduced=reduced, shape=shape), device)
        a = json.loads(out_a.read_text())["history"]
        lines = [ln for ln in log_a.splitlines() if ln.startswith("step")]
        check([r["step"] for r in a] == list(range(CLI_STEPS))
              and len(lines) == CLI_STEPS
              and all(CLI_LOG.match(ln) for ln in lines),
              f"lm train cli: run A logged {lines}, history "
              f"{[r['step'] for r in a]}")
        check(sorted(os.listdir(d)) == ["step_00000004", "step_00000006"],
              f"lm train cli: run A left {sorted(os.listdir(d))}")
        kept = base / "run_a_step_00000006"
        os.rename(d / "step_00000006", kept)
        tmp = d / "step_00000006.tmp"
        tmp.mkdir()
        (tmp / "leaf_00000.npy").write_bytes(b"\x93NUMPY\x01\x00")

        args = TT.parser().parse_args(cli_argv(
            d, resume=True, device=device, reduced=reduced, shape=shape))
        first = {}

        def at_first_step(real):
            """The step, noting before the first one the peak memory so
            far and whether the crash's ``.tmp`` is still there (the
            step-6 write would remove it later)."""
            def step(*a, **kw):
                if not first:
                    first["tmp"] = tmp.exists()
                    first["peak"] = (torch.cuda.max_memory_allocated()
                                     if on_card else None)
                return real(*a, **kw)
            return step

        buf = io.StringIO()
        real_step = TT.train_step
        TT.train_step = at_first_step(real_step)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() if on_card else None
        K.reset_launch_counts()
        try:
            with Timed(TT.ckpt.AsyncCheckpointer, "submit", device) as subs, \
                    Timed(TT.ckpt.AsyncCheckpointer, "close", device) as \
                    closes, Timed(TT.ckpt, "restore", device) as restores, \
                    contextlib.redirect_stdout(buf):
                t0 = time.perf_counter()
                b = TT.run(args)["history"]
                b_s = time.perf_counter() - t0
        finally:
            TT.train_step = real_step
        launches = train_launches()
        peak = torch.cuda.max_memory_allocated() if on_card else None
        log_b = buf.getvalue()
        print(log_b, end="")
        check(log_b.splitlines()[:1] == [f"[resume] from step {CLI_RESUME}"],
              f"lm train cli: run B began {log_b.splitlines()[:1]}, not "
              f"[resume] from step {CLI_RESUME}")
        check(not first.get("tmp", True), "lm train cli: run B's stray .tmp "
                                          "was still there at its first step")
        check([r["step"] for r in b] == list(range(CLI_RESUME, CLI_STEPS)),
              f"lm train cli: run B ran steps {[r['step'] for r in b]}")
        check(all(math.isfinite(v) for r in a + b for v in r.values()),
              "lm train cli: a step is not finite")
        n_b = CLI_STEPS - CLI_RESUME
        check(launches["isla_fold"] == n_b and launches["flash_attention"]
              == launches["other_isla"] == 0,
              f"lm train cli: run B's {n_b} steps launched {launches}, not "
              f"one isla_fold a step")
        check(sorted(os.listdir(d)) == ["step_00000004", "step_00000006"],
              f"lm train cli: run B left {sorted(os.listdir(d))}")
        rows_gap = max(close_metrics(g, w, CLI_TOL)
                       for g, w in zip(b, a[CLI_RESUME:]))
        cmp = compare_ckpts(d / "step_00000006", kept, CLI_TOL)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return dict(arch=CLI_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
                dtype=cfg.param_dtype, shape=[B, S], free_bytes=free,
                tree_bytes=tb, a_wall_s=a_s, a_steps=a, b_wall_s=b_s,
                b_steps=b, launches=launches, held_bytes=held,
                first_step_peak_bytes=first.get("peak"),
                peak_bytes=peak, submit_s=subs.seconds, close_s=closes.seconds,
                restore_s=restores.seconds, rows_max_rel_gap=rows_gap,
                checkpoint=cmp, tolerance=CLI_TOL,
                fold_launches=launches["isla_fold"])


def print_train_cli(c: dict) -> None:
    """The "lm train cli" phase's figures."""
    B, S = c["shape"]
    gib = 2 ** 30
    print(f"Train CLI, {c['arch']} ({c['n_layers']} layers, d_model "
          f"{c['d_model']}, {c['dtype']}) at B x S = {B} x {S}: run A "
          f"(python -m repro_torch.launch.train, {CLI_STEPS} steps, "
          f"checkpoints every {CLI_EVERY}) {c['a_wall_s']:.2f} s of "
          f"process; run B (--resume after a crash mid-write of step 6) "
          f"{c['b_wall_s']:.2f} s; {c['free_bytes'] / 1e9:.1f} GB free for "
          f"checkpoints of {c['tree_bytes'] / 1e9:.3f} GB")
    for name, rows in (("A", c["a_steps"]), ("B", c["b_steps"])):
        print(f"  run {name} step s " + ", ".join(
            f"{r['step']}: {r['dt_s']:.3f}" for r in rows) + "; tok/s "
            + ", ".join(f"{B * S / r['dt_s']:.0f}" for r in rows
                        if r["dt_s"] > 0) + "; loss "
            + ", ".join(f"{r['loss']:.4f}" for r in rows))
    ck = c["checkpoint"]
    peak = c["peak_bytes"]
    print(f"  run B: restore {', '.join(f'{s:.2f}' for s in c['restore_s'])}"
          f" s, submit (host copy) "
          f"{', '.join(f'{s:.2f}' for s in c['submit_s'])} s, close (the "
          f"write) {', '.join(f'{s:.2f}' for s in c['close_s'])} s; "
          f"checkpoint {ck['bytes'] / 1e9:.3f} GB in {ck['leaves']} leaves; "
          + (f"{c['held_bytes'] / gib:.3f} GiB held before it, peak "
             f"{c['first_step_peak_bytes'] / gib:.2f} GiB before the first "
             f"step, {peak / gib:.2f} GiB in all; " if peak is not None
             else "")
          + f"{json.dumps(c['launches'])} launches")
    print(f"  run B against run A: rows at steps "
          f"{CLI_RESUME}-{CLI_STEPS - 1} max rel {c['rows_max_rel_gap']:.3g}, "
          f"step-{ck['step']} checkpoints max rel {ck['max_rel_gap']:.3g} "
          f"(tol {c['tolerance']}"
          + (": bit for bit)" if c["tolerance"] == 0 else ")"))


# The sharded train step ("lm train mesh"): launch.train.build_step over a
# DeviceMesh, the port's DTensor path.  On every run: olmo-1b at full width
# through a one-rank ("data", "model") mesh held to the meshless steps of
# the same init and batches; on a machine with MESH_CARDS cards, also a
# (2, 2) mesh over them and the elastic drill.
MESH_ARCH = TRAIN_ARCH
MESH_SHAPE = TRAIN_SHAPE
MESH_STEPS = 3
MESH_CKPT_STEP = 2            # the step whose checkpoint is restored
MESH_AXES = ("data", "model")
MESH_CARDS = 4
MESH_GRID = (2, 2)            # the four-card mesh
MESH_DRILL_STEPS = 4          # the drill: --fail 2:1 from (2, 2) to (1, 2)
MESH_DIR = ROOT / "_train_mesh"  # git-ignored; removed when the phase ends
COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d")
COLLECTIVE_OPS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all",
                  "broadcast")


class CollectiveCounter:
    """While installed, counts each collective the process issues (the
    functional collectives DTensor redistributes through) by name, with
    the bytes of its input tensors.  A DTensor op is handed on to DTensor
    (``NotImplemented``) with the mode still installed, so the collectives
    DTensor issues inside an op's dispatch are counted too."""

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        counts = self.counts = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                import torch
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                name = func.__name__.split(".")[0]
                if func.namespace in COLLECTIVE_NS and any(
                        k in name for k in COLLECTIVE_OPS):
                    c = counts.setdefault(name, {"count": 0, "bytes": 0})
                    c["count"] += 1
                    c["bytes"] += sum(
                        a.numel() * a.element_size() for a in args
                        if isinstance(a, torch.Tensor))
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False


class OneRankGroup:
    """A one-rank process group (``nccl`` on the card, ``gloo`` on the
    CPU) through a ``FileStore`` in a temporary directory, destroyed on
    exit."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import tempfile

        import torch
        import torch.distributed as dist

        self._dir = tempfile.TemporaryDirectory()
        store = dist.FileStore(str(Path(self._dir.name) / "store"), 1)
        backend = "nccl" if torch.device(self.device).type == "cuda" \
            else "gloo"
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        self._dir.cleanup()
        return False


def trees_gap(got, want) -> dict:
    """Leaf by leaf (the sharded trees gathered whole): how many leaves
    differ in any bit, and the largest gap over the leaf's largest
    magnitude."""
    import torch
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.train.train_step import local_value

    differ, worst, where = 0, 0.0, None
    for (path, w), g in zip(tree_paths(want), tree_leaves(got)):
        g, w = local_value(g), local_value(w)
        if torch.equal(g, w):
            continue
        differ += 1
        gap = float((g.float() - w.float()).abs().max()) / max(
            float(w.float().abs().max()), 1e-30)
        if gap >= worst:
            worst, where = gap, path
    return dict(leaves=len(tree_leaves(want)), differ=differ,
                max_rel_gap=worst, worst_leaf=where)


def mesh_fp32_pair(device, reduced, shape, mesh, seed=1) -> dict:
    """Where the bf16 steps are not bit for bit: olmo-1b at full width cut
    to one layer in fp32, one sharded step on ``mesh`` against one
    meshless step from the same weights and batch, held by
    ``check_step_pair`` at ``TRAIN_TOL`` (the "lm train" phase's card
    tolerance)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TT
    from repro_torch.models import model as TM
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import local_value, train_step
    from repro_torch.core.tree import tree_map

    cfg = get_config(MESH_ARCH, reduced=reduced).replace(
        n_layers=1, param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    B, S = shape
    batch = SyntheticStream(cfg, batch=B, seq=S, device=device).batch_at(0)
    tcfg = train_config(lr=1e-3)
    step_fn, _ = TT.build_step(cfg, tcfg, mesh)
    got = tree_map(local_value, step_fn(params, init_opt_state(params),
                                        batch))
    want = train_step(cfg, tcfg, params, init_opt_state(params), batch)
    return check_step_pair(f"lm train mesh {MESH_ARCH} (1 layer, fp32)",
                           tcfg.opt.lr, tcfg.opt.b1, to_device(got, "cpu"),
                           to_device(want, "cpu"), TRAIN_TOL)


def train_mesh_path(device="cuda", reduced=False, shape=MESH_SHAPE,
                    steps=MESH_STEPS, root=None, seed=0) -> dict:
    """The "lm train mesh" phase on one card.  olmo-1b (full width and
    depth, bf16, remat; TP on, as it has at least ``TP_THRESHOLD``
    parameters) from one seeded init: ``steps`` meshless steps
    (``train_run``), then the same init and batches through
    ``launch.train.build_step`` over a one-rank ``MESH_AXES`` mesh (an
    ``nccl`` group through a ``FileStore``; destroyed at the end), each
    step's loss telemetry one ``isla_fold`` launch replayed against its
    plain version.  The sharded steps' rows and final params and moments
    must equal the meshless ones bit for bit; where they do not, the
    reason is printed and ``mesh_fp32_pair`` must hold at ``TRAIN_TOL``.
    The sharded run commits its step-``MESH_CKPT_STEP`` state
    (``checkpoint.save`` of the DTensors), which is restored with
    ``shardings=`` and stepped again to the same bits."""
    import shutil

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TT
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.core.tree import tree_leaves
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import abstract_opt_state, init_opt_state

    on_card = torch.device(device).type == "cuda"
    cfg = get_config(MESH_ARCH, reduced=reduced)
    B, S = shape
    stream = SyntheticStream(cfg, batch=B, seq=S, device=device)
    tcfg = train_config()
    name = "lm train mesh"

    def peak_reset():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else None

    p0 = TM.init_params(cfg, torch.Generator(device=device)
                        .manual_seed(seed))
    peak_reset()
    want_p, want_o, want_recs, want_launches, _ = train_run(
        cfg, tcfg, p0, init_opt_state(p0), stream, steps, device,
        name=f"{name}: meshless")
    want_peak = peak()
    base = Path(root) if root is not None else MESH_DIR
    shutil.rmtree(base, ignore_errors=True)
    d = base / "ckpt"
    d.mkdir(parents=True)
    try:
        with OneRankGroup(device):
            mesh = make_host_mesh((1, 1), MESH_AXES)
            step_fn, plc = TT.build_step(cfg, tcfg, mesh)
            peak_reset()
            k = MESH_CKPT_STEP
            q, r, recs, launches, panes = train_run(
                cfg, tcfg, p0, init_opt_state(p0), stream, k, device,
                name=name, step_fn=step_fn)
            t0 = time.perf_counter()
            ckpt.save(str(d), k, {"params": q, "opt": r}, fingerprint=name)
            save_s = time.perf_counter() - t0
            q, r, more, more_launches, more_panes = train_run(
                cfg, tcfg, q, r, stream, steps - k, device, start=k,
                name=name, step_fn=step_fn)
            got_peak = peak()
            recs += more
            for key in launches:
                launches[key] += more_launches[key]
            panes = {**more_panes, **panes}
            rows = [{key: (g[key], w[key]) for key in w
                     if key not in ("s", "step", "plain_gap")}
                    for g, w in zip(recs, want_recs)]
            rows_same = all(a == b for row in rows for a, b in row.values())
            gap = trees_gap({"params": q, "opt": r},
                            {"params": want_p, "opt": want_o})
            del want_p, want_o
            fallback = None
            if not rows_same or gap["differ"]:
                print(f"{name}: the one-rank mesh steps are not the meshless "
                      f"steps bit for bit (rows equal: {rows_same}; "
                      f"{gap['differ']} of {gap['leaves']} leaves differ, "
                      f"worst {gap['max_rel_gap']:.3g} of scale at "
                      f"{gap['worst_leaf']}); holding a one-layer fp32 step "
                      f"pair to {TRAIN_TOL}")
                fallback = mesh_fp32_pair(device, reduced, TRAIN_CPU_SHAPE,
                                          mesh)
            # the committed step, restored onto the mesh and stepped again
            ap = TM.abstract_params(cfg)
            like = {"params": ap, "opt": abstract_opt_state(ap)}
            t0 = time.perf_counter()
            back, _ = ckpt.restore(str(d), k, like, fingerprint=name,
                                   shardings={"params": plc.params,
                                              "opt": plc.opt})
            restore_s = time.perf_counter() - t0
            again_p, again_o, again, again_launches, _ = train_run(
                cfg, tcfg, back["params"], back["opt"], stream, 1, device,
                start=k, name=f"{name}: restored", step_fn=step_fn)
            del back
            if steps == k + 1:
                replay = trees_gap({"params": again_p, "opt": again_o},
                                   {"params": q, "opt": r})
                check(replay["differ"] == 0 and all(
                    again[0][key] == recs[k][key] for key in again[0]
                    if key not in ("s", "plain_gap")),
                      f"{name}: the step-{k} checkpoint restored with "
                      f"shardings= stepped to other bits: {replay}")
            del q, r, again_p, again_o
            placements = sorted({str(s.placements) for s in
                                 tree_leaves(plc.params)})
    finally:
        shutil.rmtree(base, ignore_errors=True)
    fold_launches = (want_launches["isla_fold"] + launches["isla_fold"]
                     + again_launches["isla_fold"])
    return dict(arch=MESH_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
                dtype=cfg.param_dtype, shape=[B, S], mesh=[1, 1],
                placements=placements, steps=recs, meshless_steps=want_recs,
                rows_bit_equal=rows_same, trees=gap, fp32_pair=fallback,
                launches=launches, peak_bytes=got_peak,
                meshless_peak_bytes=want_peak, save_s=save_s,
                restore_s=restore_s, restored_step=again[0],
                panes=panes, fold_launches=fold_launches)


def mesh_card_rank(rank, world, store, out, reduced, shape, steps,
                   device="cuda"):
    """One rank of ``train_mesh_cards``: card ``rank``, an ``nccl`` group
    through the file store.  olmo-1b over a ``MESH_GRID`` mesh for
    ``steps`` sharded steps (each timed, its collectives counted), rank 0
    beside them the meshless steps on its card and a one-layer fp32 step
    pair (``mesh_fp32_pair``); then every rank runs the CLI's ``run``
    with ``--fail 2:1 --model-parallel 2`` (the elastic drill to (1, 2)
    at step 2).  Rank 0 writes the JSON ``out``; every rank its peak.
    ``device="cpu"`` rehearses it on gloo ranks of the CPU."""
    sys.path.insert(0, str(ROOT / "src"))
    import contextlib
    import io

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import isla_moments as K
    from repro_torch.launch import train as TT
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import train_step

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    res = {}
    try:
        mesh = make_host_mesh(MESH_GRID, MESH_AXES)
        cfg = get_config(MESH_ARCH, reduced=reduced)
        B, S = shape
        stream = SyntheticStream(cfg, batch=B, seq=S, device=device)
        tcfg = train_config()
        step_fn, plc = TT.build_step(cfg, tcfg, mesh)
        p0 = TM.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(0))
        params, opt = p0, init_opt_state(p0)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        rows = []
        K.reset_launch_counts()
        for st in range(steps):
            batch = stream.batch_at(st)
            sync(device)
            t0 = time.perf_counter()
            with CollectiveCounter() as cc:
                params, opt, m = step_fn(params, opt, batch)
            sync(device)
            rows.append(dict(step=st, s=time.perf_counter() - t0,
                             collectives=cc.counts,
                             **{k: float(v) for k, v in m.items()}))
        peak = torch.cuda.max_memory_allocated() if on_card else None
        folds = K.isla_fold.launches
        del params, opt
        peaks, launches = [None] * world, [None] * world
        dist.all_gather_object(peaks, peak)
        dist.all_gather_object(launches, folds)
        res.update(grid=list(MESH_GRID), steps=rows, peaks=peaks,
                   fold_launches=launches)
        if rank == 0:
            p, o = p0, init_opt_state(p0)
            want = []
            for st in range(steps):
                p, o, m = train_step(cfg, tcfg, p, o, stream.batch_at(st))
                want.append({k: float(v) for k, v in m.items()})
            res["meshless_steps"] = want
            del p, o
        del p0
        if on_card:
            torch.cuda.empty_cache()
        res["fp32_pair"] = mesh_fp32_pair(device, reduced, TRAIN_CPU_SHAPE,
                                          mesh)
        drill = Path(out).with_name("drill")
        argv = ["--arch", MESH_ARCH, "--steps", str(MESH_DRILL_STEPS),
                "--batch", str(B), "--seq", str(S), "--log-every", "1",
                "--model-parallel", str(MESH_GRID[1]), "--ckpt-dir",
                str(drill), "--ckpt-every", "2", "--fail", "2:1",
                "--telemetry-exact", "--device", device.type] + (
                    ["--reduced"] if reduced else [])
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            hist = TT.run(TT.parser().parse_args(argv))["history"]
        res["drill"] = dict(history=hist, log=buf.getvalue().splitlines(),
                            s=time.perf_counter() - t0,
                            files=sorted(p.name for p in drill.iterdir())
                            if rank == 0 else None)
        if rank == 0:
            Path(out).write_text(json.dumps(res, default=str))
        dist.barrier()        # the ranks the drill dropped wait for the rest
    finally:
        dist.destroy_process_group()


def train_mesh_cards(reduced=False, shape=MESH_SHAPE, steps=MESH_STEPS,
                     root=None, device="cuda") -> dict:
    """``MESH_CARDS`` ranks, one a card (``mesh_card_rank``), over a
    ``MESH_GRID`` mesh; the results checked: finite steps with one
    ``isla_fold`` launch a rank a step (each rank's count), the meshless
    steps' losses beside them (bf16, printed; the fp32 pair held at
    ``TRAIN_TOL`` in the rank), the drill's rows for steps 0-3 with its
    elastic line and its checkpoints.  ``device="cpu"`` (with
    ``reduced``) rehearses it on four gloo ranks."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    base = Path(root) if root is not None else MESH_DIR
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    out = base / "cards.json"
    if device == "cuda":
        torch.cuda.empty_cache()
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            mp.spawn(mesh_card_rank, args=(
                MESH_CARDS, str(Path(d) / "store"), str(out), reduced,
                tuple(shape), steps, device), nprocs=MESH_CARDS)
            wall = time.perf_counter() - t0
        res = json.loads(out.read_text())
    finally:
        shutil.rmtree(base, ignore_errors=True)
    res["wall_s"] = wall
    name = "lm train mesh (4 cards)"
    for r in res["steps"]:
        check(all(math.isfinite(v) for k, v in r.items()
                  if k not in ("step", "collectives")),
              f"{name}: step {r['step']} is not finite: {r}")
    # the CPU's plain fold launches (and counts) nothing
    want = steps if device == "cuda" else 0
    check(res["fold_launches"] == [want] * MESH_CARDS,
          f"{name}: isla_fold launches a rank {res['fold_launches']} in "
          f"{steps} steps")
    dr = res["drill"]
    check([r["step"] for r in dr["history"]] == list(range(
        MESH_DRILL_STEPS)), f"{name}: the drill ran steps "
                            f"{[r['step'] for r in dr['history']]}")
    check("[elastic] step 2: data axis 2 -> 1 after 1 failures" in dr["log"],
          f"{name}: the drill printed {dr['log'][:3]}")
    check(dr["files"] == ["step_00000002", "step_00000004"],
          f"{name}: the drill left {dr['files']}")
    return res


def gib_text(n) -> str:
    return "not measured" if n is None else f"{n / 2 ** 30:.2f}"


def print_train_mesh(t: dict) -> None:
    """The "lm train mesh" phase's figures."""
    B, S = t["shape"]
    gib = 2 ** 30
    ms = [r["s"] for r in t["steps"]]
    ws = [r["s"] for r in t["meshless_steps"]]
    print(f"Train mesh, {t['arch']} ({t['n_layers']} layers, d_model "
          f"{t['d_model']}, {t['dtype']}) at B x S = {B} x {S} over a "
          f"one-rank ('data', 'model') nccl mesh: step s "
          + ", ".join(f"{x:.3f}" for x in ms) + " (meshless "
          + ", ".join(f"{x:.3f}" for x in ws) + f"); peak "
          f"{gib_text(t['peak_bytes'])} GiB (meshless "
          f"{gib_text(t['meshless_peak_bytes'])}); rows bit for bit: "
          f"{t['rows_bit_equal']}; trees: {t['trees']['differ']} of "
          f"{t['trees']['leaves']} leaves differ; isla_fold launches "
          f"{t['launches']['isla_fold']} in {len(ms)} sharded steps; "
          f"step-{MESH_CKPT_STEP} checkpoint save {t['save_s']:.2f} s, "
          f"restore with shardings= {t['restore_s']:.2f} s, stepped again "
          f"to the same bits; placements {t['placements']}")
    if t["fp32_pair"] is not None:
        print(f"  one-layer fp32 pair: {json.dumps(t['fp32_pair'])}")
    c = t.get("cards")
    if c is None:
        print(f"  four-card {MESH_GRID} mesh: not run (fewer than "
              f"{MESH_CARDS} cards visible)")
        return
    print(f"  four cards, {tuple(c['grid'])} mesh: step s "
          + ", ".join(f"{r['s']:.3f}" for r in c["steps"]) + "; losses "
          + ", ".join(f"{r['loss']:.6f}" for r in c["steps"])
          + " (meshless on card 0: " + ", ".join(
              f"{r['loss']:.6f}" for r in c["meshless_steps"])
          + "); peak GiB a card " + ", ".join(
              gib_text(p) for p in c["peaks"])
          + f"; isla_fold launches a rank {c['fold_launches']}")
    for r in c["steps"]:
        print(f"    step {r['step']} collectives (rank 0): " + ", ".join(
            f"{k} {v['count']} x, {v['bytes'] / 1e6:.1f} MB"
            for k, v in sorted(r["collectives"].items())))
    print(f"  one-layer fp32 (2, 2) pair: {json.dumps(c['fp32_pair'])}")
    dr = c["drill"]
    print(f"  elastic drill (2, 2) -> (1, 2) at step 2: {dr['s']:.1f} s; "
          + "; ".join(dr["log"]))


# The dry run and the roofline ("dryrun"): ``python -m
# repro_torch.launch.dryrun`` in child processes (rank 0 of a fake process
# group of the production mesh, fake tensors: nothing allocated on the card,
# nothing launched), then the counter (``roofline.op_cost.CostCounter``)
# held on the card: one real olmo-1b training step and one real prefill
# against their fake traces, and the sharded serving forward on a
# one-rank mesh against the meshless one.
DRY_CELLS = (("olmo-1b", None, "single"),        # every applicable shape
             ("olmo-1b", "train_4k", "multi"),
             ("mamba2-130m", "long_500k", "single"))
DRY_ARCH = TRAIN_ARCH
DRY_SHAPE = TRAIN_SHAPE          # the "lm train" phase's step
DRY_PROMPT = 1966                # the LM phase's longest prompt
DRY_DECODE_STEPS = 2
DRY_DIR = ROOT / "chiprun_out" / "dryrun_out_torch"
DRY_TIMEOUT_S = 300
MEM_LINE = re.compile(r"max_memory_allocated\(\) = (\d+), held after them "
                      r"(\d+)")
CELL_LINE = re.compile(r"^(\S+)\s+(\S+)\s+(single|multi)\s+-> (\w+)", re.M)


def dryrun_cells(cells=DRY_CELLS, out_dir=DRY_DIR, on_card=True) -> dict:
    """Each ``(arch, shape or None for every shape, mesh)`` of ``cells``
    through ``python -m repro_torch.launch.dryrun`` in a child process of
    its own, all started together.  Fails unless every child exits 0,
    every cell is ``ok`` or a ``skip`` of the arch's own, and (``on_card``)
    every child allocated 0 bytes on the card.  Returns the cells' JSON,
    keyed ``arch/shape/mesh``, and the children's card bytes and wall."""
    import os
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               DRYRUN_OUT=str(out_dir))
    t0 = time.perf_counter()
    procs = []
    for arch, shape, mesh in cells:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--mesh", mesh, "--force"]
        if shape is not None:
            argv += ["--shape", shape]
        procs.append(subprocess.Popen(argv, env=env, cwd=ROOT, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DRY_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    result, card_bytes = {}, []
    for (arch, shape, mesh), p, (out, err) in zip(cells, procs, outs):
        check(p.returncode == 0, f"dryrun {arch} {shape} {mesh}: exit "
                                 f"{p.returncode}: {out[-1500:]} "
                                 f"{err[-1500:]}")
        m = MEM_LINE.search(out)
        if on_card:
            check(m is not None and int(m.group(1)) == int(m.group(2)) == 0,
                  f"dryrun {arch} {shape} {mesh}: the child allocated on "
                  f"the card: {m.group(0) if m else 'no report'}")
            card_bytes.append(int(m.group(1)))
        for a, s, me, status in CELL_LINE.findall(out):
            with open(Path(out_dir) / f"{a}__{s}__{me}.json") as f:
                cell = json.load(f)
            check(cell["status"] == status and status in ("ok", "skip"),
                  f"dryrun {a} {s} {me}: {status}: "
                  f"{cell.get('error', '')}")
            result[f"{a}/{s}/{me}"] = cell
        check(any(k.startswith(f"{arch}/") for k in result),
              f"dryrun {arch} {shape} {mesh}: no cell in {out[-800:]}")
    return dict(cells=result, card_bytes=card_bytes, wall_s=wall_s)


def _fake_like(tree, fake_mode):
    """``tree``'s tensors as fake tensors of the same shapes, dtypes and
    devices (no data)."""
    import torch
    from repro_torch.core.tree import tree_map

    def one(t):
        with fake_mode:
            return torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return tree_map(one, tree)


def count_pair(name, fn, args, device) -> dict:
    """``fn(*args)`` once for real and once traced on fake copies of
    ``args``, each under a ``CostCounter``: their flops, bytes, per-op
    tables and kernel records must be equal."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.roofline.op_cost import CostCounter

    with CostCounter() as real:
        fn(*args)
    sync(device)
    fm = FakeTensorMode()
    fake_args = _fake_like(args, fm)
    t0 = time.perf_counter()
    with fm, CostCounter() as fake:
        fn(*fake_args)
    trace_s = time.perf_counter() - t0

    def records(c):
        return [(k["name"], k["flops"], k["bytes"], k["dtype"])
                for k in c.kernels]

    diff = sorted(k for k in set(real.ops) | set(fake.ops)
                  if real.ops.get(k) != fake.ops.get(k))
    check(real.cost == fake.cost and records(real) == records(fake)
          and not diff,
          f"{name}: the real run's count parts from the fake trace's: "
          f"flops {real.cost.flops} / {fake.cost.flops}, bytes "
          f"{real.cost.hbm_bytes} / {fake.cost.hbm_bytes}, ops that "
          f"differ {[(k, real.ops.get(k), fake.ops.get(k)) for k in diff]}"
          f", kernels {records(real)} / {records(fake)}")
    return dict(flops=real.cost.flops, bytes=real.cost.hbm_bytes,
                flops_by_dtype=real.cost.flops_by_dtype,
                kernels=records(real), ops=len(real.ops),
                fake_trace_s=trace_s, cost=real.cost)


def serve_pair(cfg, params, toks, device) -> dict:
    """olmo-1b's prefill of ``toks`` and ``DRY_DECODE_STEPS`` decode
    steps, meshless and through a one-rank ``MESH_AXES`` mesh (the
    params, batch and cache placed by their specs): logits and cache bit
    for bit, the same flash_attention launches (on the card) and kernel
    records."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.roofline.op_cost import CostCounter
    from repro_torch.sharding import (batch_specs, cache_specs, param_specs,
                                      shardings)
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train.train_step import local_value, place

    B, S = toks.shape
    S0 = S - DRY_DECODE_STEPS

    def run(mesh):
        p = params
        cache = TM.init_cache(cfg, B, S, device=device)
        batch = {"tokens": toks[:, :S0]}
        if mesh is not None:
            p = place(p, shardings(mesh, param_specs(cfg, mesh, p)))
            cache = place(cache, shardings(mesh, cache_specs(cfg, mesh,
                                                             cache)))
            batch = place(batch, shardings(mesh, batch_specs(cfg, mesh,
                                                             batch)))
        before = FA.flash_attention.launches
        logits = []
        sync(device)
        t0 = time.perf_counter()
        with use_mesh(mesh), CostCounter() as c:
            lg, cache = TM.serve_prefill(cfg, p, batch, cache)
            logits.append(local_value(lg))
            for i in range(DRY_DECODE_STEPS):
                tok, pos = toks[:, S0 + i:S0 + i + 1], torch.full(
                    (B,), S0 + i, dtype=torch.int64, device=device)
                if mesh is not None:
                    inp = place({"token": tok, "pos": pos}, shardings(
                        mesh, batch_specs(cfg, mesh, {"token": tok,
                                                      "pos": pos})))
                    tok, pos = inp["token"], inp["pos"]
                lg, cache = TM.serve_decode(cfg, p, tok, pos, cache)
                logits.append(local_value(lg))
        sync(device)
        return (logits, [local_value(t) for t in tree_leaves(cache)],
                FA.flash_attention.launches - before,
                [k["name"] for k in c.kernels], time.perf_counter() - t0)

    want = run(None)
    with OneRankGroup(device):
        got = run(make_host_mesh((1, 1), MESH_AXES))
    same = all(torch.equal(a, b) for a, b in zip(got[0], want[0])) and all(
        torch.equal(a, b) for a, b in zip(got[1], want[1]))
    check(same, "dryrun: the one-rank sharded serving forward parts from "
                "the meshless one")
    check(got[2] == want[2] and got[3] == want[3],
          f"dryrun: sharded serving launched {got[2]} flash kernels "
          f"({len(got[3])} records), meshless {want[2]} ({len(want[3])})")
    return dict(prompt=S0, decode_steps=DRY_DECODE_STEPS, bit_equal=same,
                flash_launches=[got[2], want[2]], records=len(got[3]),
                sharded_s=got[4], meshless_s=want[4])


def dryrun_path(device="cuda", reduced=False, cells=DRY_CELLS,
                shape=DRY_SHAPE, prompt=DRY_PROMPT, out_dir=DRY_DIR,
                seed=0) -> dict:
    """The "dryrun" phase: ``dryrun_cells``; then olmo-1b (full width and
    depth, bf16, remat) from a seeded init: one real training step at
    ``shape`` and one real prefill of ``prompt`` tokens, each under the
    counter, against the same calls traced on fake tensors with no mesh
    (``count_pair``: one ``isla_fold`` record for the step, one
    ``flash_attention`` record a layer for the prefill, each at its bound
    of ``PERF.md``'s kernel table); then ``serve_pair``.  The launch
    counts are set to 0 before the real calls and read after them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K
    from repro_torch.models import model as TM
    from repro_torch.roofline.analysis import analyze_cost, model_flops
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import train_step

    on_card = torch.device(device).type == "cuda"
    out = dict(dry=dryrun_cells(cells, out_dir, on_card))
    cfg = get_config(DRY_ARCH, reduced=reduced)
    params = TM.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    B, S = shape
    batch = SyntheticStream(cfg, batch=B, seq=S, device=device).batch_at(0)
    tcfg = train_config()
    K.reset_launch_counts()
    step = count_pair(f"dryrun {DRY_ARCH} train step", functools.partial(
        train_step, cfg, tcfg), (params, init_opt_state(params), batch),
        device)
    check([k[0] for k in step["kernels"]] == ["isla_fold"],
          f"dryrun: the step's kernel records are {step['kernels']}")
    tshape = ShapeConfig("train", S, B, "train")
    step["roofline"] = analyze_cost(step.pop("cost"), cfg, tshape, 1)
    step["model_flops"] = model_flops(cfg, tshape)
    toks = torch.randint(0, cfg.vocab, (1, prompt + DRY_DECODE_STEPS),
                         generator=torch.Generator().manual_seed(seed + 1)
                         ).to(device)
    cache = TM.init_cache(cfg, 1, prompt, device=device)
    pre = count_pair(f"dryrun {DRY_ARCH} prefill", functools.partial(
        TM.serve_prefill, cfg), (params, {"tokens": toks[:, :prompt]},
                                 cache), device)
    hd, H = cfg.head_dim, cfg.n_heads
    row8 = 4.0 * H * hd * prompt * (prompt + 1) / 2
    check([k[:2] for k in pre["kernels"]] == [("flash_attention", row8)]
          * cfg.n_layers,
          f"dryrun: the prefill's kernel records are {pre['kernels']}")
    pshape = ShapeConfig("prefill", prompt, 1, "prefill")
    pre["roofline"] = analyze_cost(pre.pop("cost"), cfg, pshape, 1)
    out["serve"] = serve_pair(cfg, params, toks, device)
    out["launches"] = dict(isla_fold=K.isla_fold.launches,
                           flash_attention=FA.flash_attention.launches)
    if on_card:
        check(out["launches"] == dict(
            isla_fold=1, flash_attention=cfg.n_layers * 3),
              f"dryrun: the real calls launched {out['launches']}")
    del params
    out.update(arch=DRY_ARCH, shape=list(shape), step=step, prefill=pre)
    return out


def print_dryrun(d: dict, warm_step_s=None) -> None:
    dry = d["dry"]
    print(f"dryrun: {len(dry['cells'])} cells in child processes, "
          f"{dry['wall_s']:.1f} s wall; card bytes allocated by the "
          f"children: {dry['card_bytes']}")
    for key, c in dry["cells"].items():
        if c["status"] == "skip":
            print(f"  {key}: skip ({c['reason']})")
            continue
        rf = c["roofline"]
        print(f"  {key}: flops/dev {rf['hlo_flops_per_dev']:.4e} (model "
              f"{rf['model_flops_per_dev']:.4e}), bytes/dev "
              f"{rf['hlo_bytes_per_dev']:.4e}, collectives/dev "
              f"{rf['collective_bytes_per_dev']:.4e} B in "
              f"{sum(rf['collective_counts'].values())} ops; "
              f"{rf['dominant']}-bound, bound {rf['step_time_bound_s']:.4g} "
              f"s (compute {rf['compute_s']:.4g}, memory "
              f"{rf['memory_s']:.4g}, collective {rf['collective_s']:.4g}, "
              f"NVLink {rf['collective_s_nvlink']:.4g}); temp "
              f"{c['memory_analysis']['temp_size_in_bytes'] / 2**30:.2f} "
              f"GiB; trace {c['t_trace_s']} s on {c['trace_device']}")
    for what, r in (("train step", d["step"]), ("prefill", d["prefill"])):
        rf = r["roofline"]
        print(f"dryrun anchor, {d['arch']} {what}: real run and fake trace "
              f"count alike: {r['flops']:.6e} flops "
              f"({json.dumps(r['flops_by_dtype'])}), {r['bytes']:.6e} B, "
              f"{r['ops']} op kinds, kernel records "
              f"{[k[0] for k in r['kernels']]} (fake trace "
              f"{r['fake_trace_s']:.2f} s); bound "
              f"{rf['step_time_bound_s']:.4f} s, {rf['dominant']}-bound "
              f"(compute {rf['compute_s']:.4f}, memory {rf['memory_s']:.4f})")
    rf = d["step"]["roofline"]
    mf = d["step"]["model_flops"]
    line = (f"dryrun: {d['arch']} at {d['shape'][0]} x {d['shape'][1]}: "
            f"model_flops {mf:.4e} = {mf / 989e12:.4f} s at 989 TFLOP/s; "
            f"step_time_bound_s {rf['step_time_bound_s']:.4f}")
    if warm_step_s:
        line += (f"; the \"lm train\" phase's warm step "
                 f"{warm_step_s:.4f} s: roofline fraction "
                 f"{mf / 989e12 / warm_step_s:.2%}, the bound's "
                 f"{rf['step_time_bound_s'] / warm_step_s:.2%} of it")
    print(line)
    s = d["serve"]
    print(f"dryrun: sharded serving on a one-rank mesh, prefill "
          f"{s['prompt']} + {s['decode_steps']} decode steps: bit for bit "
          f"the meshless run ({s['bit_equal']}), flash launches "
          f"{s['flash_launches'][0]} / {s['flash_launches'][1]}, "
          f"{s['sharded_s']:.2f} s sharded, {s['meshless_s']:.2f} s "
          f"meshless; launches {json.dumps(d['launches'])}")


def ptxas_figures(log: str) -> dict:
    """Each function's registers, spill bytes and static shared memory
    from a ``-Xptxas -v`` log."""
    figs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            figs[cur] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            figs[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            figs[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            figs[cur]["smem_bytes"] = int(m.group(1)) if m else 0
    return figs


def isla_ptxas(log: str) -> dict:
    """The ISLA kernels' ``-Xptxas -v`` figures by readable name
    (``isla_fold_kernel<float>``, ``isla_fold_kernel<double>``,
    ``isla_sketch_kernel``, ...)."""
    out = {}
    for fn, fig in ptxas_figures(log).items():
        for k in ISLA_KERNELS:
            if k in fn:
                t = ("<bf16>" if "bfloat16" in fn else
                     "<double>" if "IdE" in fn else
                     "<float>" if "IfE" in fn else
                     "<one_warp>" if "ILb1E" in fn else
                     "<grid>" if "ILb0E" in fn else "")
                out[k + t] = fig
    return out


FLASH_FN = re.compile(r"(flash_fwd_[a-z0-9]+)ILi(\d+)E")


def flash_sass() -> dict:
    """Per instantiation of the flash kernels (``flash_fwd_wgmma<hd>``, the
    bf16 body; ``flash_fwd_f32<hd>``): its count of tensor-core (HMMA:
    ``mma.sync``; HGMMA: ``wgmma``), TMA load (UTMALDG) and fp32 FMA
    instructions in the built library's SASS (``cuobjdump -sass``)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K

    tool = Path(K.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass",
                          str(K._library_path(FA.SOURCE))],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts = {}
    for chunk in out.split("Function : ")[1:]:
        m = FLASH_FN.search(chunk.split("\n", 1)[0])
        if m:
            counts[f"{m.group(1)}<{m.group(2)}>"] = {
                op: len(re.findall(rf"\b{op}\b", chunk))
                for op in ("HMMA", "HGMMA", "UTMALDG", "FFMA")}
    return counts


def drive(sched, profile_ticks=(), device="cuda"):
    """Run a scheduler to the end one tick at a time, synchronised; the
    ticks in ``profile_ticks`` (0-based) under the profiler.  Returns the
    ticks' wall seconds and, for each profiled tick, its device seconds by
    kernel, its count of device events and its top host operators."""
    walls, profiled = [], []
    while sched.queue or any(x is not None for x in sched.slots):
        k = len(walls)
        with profile_tick(device, k in profile_ticks) as prof:
            t0 = time.perf_counter()
            active = sched.tick()
            sync(device)
            walls.append(time.perf_counter() - t0)
        if k in profile_ticks:
            kernels_s = device_kernel_seconds(prof)
            profiled.append(dict(
                tick=k, active=active,
                device_s=sum(kernels_s.values()),
                device_events=device_event_count(prof),
                products=matrix_products(prof),
                kernels_s=dict(sorted(kernels_s.items(),
                                      key=lambda kv: -kv[1])[:8]),
                host_ops_s=host_op_seconds(prof, top=8)))
    return walls, profiled


def matrix_products(prof) -> int:
    """How many matrix products (``GEMM_OPS``) the host side of a profiled
    window recorded, 0 when not profiled."""
    if not hasattr(prof, "key_averages"):
        return 0
    return sum(r.count for r in prof.key_averages() if r.key in GEMM_OPS)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import isla_moments as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    logs = K.build()
    for src in K.SOURCES:
        K.library(src)
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s ({len(logs)} source(s) compiled)")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    from repro_torch.kernels import flash_attention as FA
    ptxas = {}
    if FA.SOURCE in logs:
        for fn, fig in ptxas_figures(logs[FA.SOURCE]).items():
            m = FLASH_FN.search(fn)
            if m:
                ptxas[f"{m.group(1)}<{m.group(2)}>"] = fig
        check(len(ptxas) == 8 and all(
            f.get("spill_bytes") == 0 for f in ptxas.values()),
              f"flash_attention.cu: a kernel spills or is missing: {ptxas}")
        print("flash_attention.cu -Xptxas -v: " + ", ".join(
            f"{n} {f['registers']} regs" for n, f in sorted(ptxas.items()))
              + "; no spills")
    else:
        print("flash_attention.cu was built before this run: its ptxas "
              "figures are not checked")
    islaptx = {}
    if K.SOURCES[0] in logs:
        islaptx = isla_ptxas(logs[K.SOURCES[0]])
        check(len(islaptx) == 12 and all(
            f.get("spill_bytes", 0) == 0 for n, f in islaptx.items()
            if n.startswith("isla_tagged_runs")),
              f"isla_kernels.cu: a kernel is missing from the ptxas log or "
              f"the run kernel spills: {islaptx}")
        print("isla_kernels.cu -Xptxas -v: " + "; ".join(
            f"{n} {f['registers']} regs, {f['smem_bytes']} B static smem, "
            f"{f.get('spill_bytes', 0)} B spilled"
            for n, f in sorted(islaptx.items())))
    else:
        print("isla_kernels.cu was built before this run: its ptxas "
              "figures are not printed")
    sass = flash_sass()
    bf16_sass = {n: c for n, c in sass.items()
                 if n.startswith("flash_fwd_wgmma")}
    check(len(sass) == 8 and len(bf16_sass) == 4 and all(
        c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0
        for c in bf16_sass.values()),
          f"a bf16 flash kernel issues no wgmma or no TMA load, or an "
          f"mma.sync: {sass}")
    print("flash_attention SASS (cuobjdump): " + ", ".join(
        f"{n} HMMA {c['HMMA']} HGMMA {c['HGMMA']} UTMALDG {c['UTMALDG']} "
        f"FFMA {c['FFMA']}" for n, c in sorted(sass.items())))

    phase_s = {"build": build_s}
    stamp = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - stamp[0]
        stamp[0] = now

    runs = [main_path(name, distinct) for name, distinct in MAIN_RUNS]
    lap("isla main path runs")
    for path in runs:
        rp = path["phase2"]
        print(f"main path, {path['name']} run: "
              f"{json.dumps(path['launches'])} launches, "
              f"{path['agreement']}, {path['wall_s']:.2f} s; partials: "
              f"{rp['differ_from_cpu']} of {rp['cells']} differ from Phase 2 "
              f"on the CPU over the card's state (max "
              f"{rp['max_ulps_from_cpu']:g} fp32 ulp), the division repair "
              f"moved {rp['moved_by_repair']}; profiled re-runs taken "
              f"{path['traced_runs']}")
        for k, (r, q) in enumerate(zip(path["ticks"],
                                       path["profiled_ticks"])):
            stages = ", ".join(f"{n} {t:.4f}"
                               for n, t in r["stages_s"].items())
            busy = q["device_busy_s"]
            print(f"  tick {k + 1} (e={r['e']}): {r['new_samples']} new "
                  f"samples, {r['fold_calls']} fold_panes / "
                  f"{r['sketch_calls']} sketch_panes calls, "
                  f"{r['fold_launches']} fold / "
                  f"{r['sketch_launches']} sketch launches, stages s: "
                  f"{stages}"
                  + ("" if busy is None else
                     f"; profiled re-run: device busy {busy * 1e3:.3f} ms "
                     f"of {q['wall_s']:.3f} s wall")
                  + ("" if q["kernel_events"] is None else
                     f", ISLA kernels {json.dumps(q['kernel_events'])}"))
    dev = torch.device("cuda")
    served = []
    for path in runs:
        for f in check_main_path_folds(path.pop("fold_calls")):
            served.append(dict(f, run=path["name"]))
    check(len(served) > 0, "the main path folded no pane")
    for f in served:
        print(f"isla_fold on the {f['run']} run's pane {tuple(f['pane'])} "
              f"({f['keys']} keys, {f['real_samples']} samples): "
              f"{f['ms']:.4f} ms on the card (CUDA events "
              f"{f['event_ms']:.4f} ms; plain {f['plain_ms']:.3f} ms, bound "
              f"{f['bound_ms']:.4f} ms by {f['bound_by']}), max abs err "
              f"{f['max_abs_err']:.3g}, max rel err {f['max_rel_err']:.3g} "
              f"(tol rel 1e-5), one launch, "
              f"{f['dynamic_smem_bytes']} B of staged row a block")
    merged = []
    for path in runs:
        for f in check_main_path_sketches(path.pop("sketch_calls")):
            merged.append(dict(f, run=path["name"]))
    check(len(merged) > 0, "the main path merged no hash pane")
    for f in merged:
        print(f"isla_sketch on the {f['run']} run's hash pane "
              f"{tuple(f['pane'])} ({f['keys']} keys, {f['live_lanes']} "
              f"live lanes, {f['touched_cells']} cells changed): "
              f"{f['ms']:.4f} ms on the card from the tick's plane (a "
              f"repeat on the merged plane {f['repeat_event_ms']:.4f} ms "
              f"by CUDA events; plain {f['plain_ms']:.3f} ms over "
              f"{f['plain_reps']} reps, bound {f['bound_ms']:.4f} ms by "
              f"{f['bound_by']}), bit-identical to its plain version")
    lap("isla main path replays")
    f64_runs = [main_path_f64(name, distinct)
                for name, distinct in F64_RUNS]
    lap("isla float64 runs")
    for path, fp32 in zip(f64_runs, runs):
        st = path["state"]
        print(f"main path, {path['name']} run: "
              f"{json.dumps(path['launches'])} launches, "
              f"{path['agreement']}, {path['wall_s']:.2f} s; "
              f"{st['keys']} keys, {st['cells']} cells: moment rows, "
              f"totals, draw ledger"
              + (" and register planes" if path["name"].startswith("dist")
                 else "")
              + " bit-identical to the host route's; partials: "
              f"{st['partials_differing_from_host_solve']} differ from the "
              f"host solve (max {st['max_ulps_from_host_solve']:g} ulp), "
              f"{st['phase2']['differ_from_cpu']} from Phase 2 on the CPU "
              f"over the card's state; the division repair moved "
              f"{st['phase2']['moved_by_repair']} of {st['cells']}; "
              f"profiled re-runs taken {path['traced_runs']}")
        for k, (r, q) in enumerate(zip(path["ticks"], fp32["ticks"])):
            stages = ", ".join(f"{n} {t:.4f}"
                               for n, t in r["stages_s"].items())
            print(f"  tick {k + 1} (e={r['e']}): {r['new_samples']} new "
                  f"samples, {r['tagged_calls']} tagged folds, "
                  f"{r['tagged_launches']} isla_tagged_fold / "
                  f"{r['tagged_sketch_launches']} isla_sketch_tagged "
                  f"launches, stages s: {stages}; run tables "
                  f"{r['run_table_host_s'] * 1e3:.3f} ms of host time; "
                  f"fp32 run's tick {q['wall_s']:.4f} s wall (h2d "
                  f"{q['stages_s'].get('h2d', 0.0):.4f}), this tick "
                  f"{r['wall_s']:.4f} s; profiled re-run: ISLA kernels "
                  f"{json.dumps(path['profiled_ticks'][k]['kernel_events'])}")
    tagged = []
    for path in f64_runs:
        for f in check_main_path_tagged(path.pop("tagged_calls")):
            tagged.append(dict(f, run=path["name"]))
    check(len(tagged) > 0, "the float64 runs folded no tagged stream")
    for f in tagged:
        rs, sd = f["runs"], f["sorted"]
        print(f"isla_tagged_fold on the {f['run']} run's stream "
              f"({f['samples']} samples, {f['cells']} cells"
              + (", per-cell cuts" if f["per_cell_cuts"] else "") + "), "
              f"bound {f['bound_ms']:.4f} ms by {f['bound_by']}: run table "
              f"{rs['ms']:.4f} ms a call ({rs['kernels_a_call']:g} device "
              f"events, the run kernel {rs['kernel_ms']:.4f} ms, "
              f"{rs['over_bound']:.1f}x the bound); stable sort "
              f"{sd['ms']:.4f} ms ({sd['kernels_a_call']:g} events, the fold "
              f"kernel {sd['kernel_ms']:.4f} ms, the sort's share "
              f"{f['sort_share']:.2f}, {sd['over_bound']:.1f}x); fp32 by the "
              f"run table {f['fp32_ms']:.4f} ms (bound "
              f"{f['fp32_bound_ms']:.4f}); plain {f['plain_ms']:.3f} ms; "
              f"both paths bit-identical to the plain version on the CPU, "
              f"two runs identical")
    tagged_merges = []
    for path in f64_runs:
        for f in check_main_path_tagged_sketches(path.pop("sketch_calls")):
            tagged_merges.append(dict(f, run=path["name"]))
    check(len(tagged_merges) > 0,
          "the float64 distinct run merged no tagged lane stream")
    for f in tagged_merges:
        print(f"isla_sketch_tagged on the {f['run']} run's stream "
              f"({f['lanes']} lanes, {f['changed_registers']} registers "
              f"raised): {f['ms']:.4f} ms on the card from the tick's plane "
              + ("(profiler" if f["kernel_ms"] is not None
                 else "(the profiler saw no event: CUDA events")
              + f"; a repeat on the merged plane {f['repeat_event_ms']:.4f} "
              f"ms by CUDA events; "
              f"plain {f['plain_ms']:.3f} ms, bound {f['bound_ms']:.4f} ms "
              f"by {f['bound_by']}), bit-identical to its plain version on "
              f"the CPU")
    lap("isla float64 replays")
    folds = [check_fold(dev, 1000, q) for q in (64, 4096)]
    for f in folds:
        print(f"isla_fold synthetic quota {f['quota']}: {f['ms']:.4f} ms "
              f"in one launch ({f['per_key_ms']:.4f} ms as a launch per "
              f"key; plain {f['plain_ms']:.3f} ms, bound "
              f"{f['bound_ms']:.4f} ms by {f['bound_by']}), max abs err "
              f"{f['max_abs_err']:.3g}, max rel err {f['max_rel_err']:.3g} "
              f"(tol rel 1e-5)")
    batched = check_batched(dev)
    print(f"isla_moments_batched stride {batched['stride']} per-cell cuts: "
          f"{batched['ms']:.4f} ms (plain {batched['plain_ms']:.3f} ms, "
          f"bound {batched['bound_ms']:.4f} ms), "
          f"max rel err {batched['max_rel_err']:.3g} (tol rel 1e-5)")
    wrappers = check_wrappers(dev)
    for w in wrappers:
        print(f"wrapper {w['name']} {tuple(w['shape'])}: {w['ms']:.4f} ms "
              f"(plain {w['plain_ms']:.3f} ms, bound {w['bound_ms']:.4f} "
              f"ms by bytes), max rel err {w['max_rel_err']:.3g} "
              f"({w['tolerance']})")
    pilots = check_pilot(dev, runs[0]["pilot_size"])
    pilot = pilots[0]  # the loop's own pilot size
    for r in pilots:
        h = r["host_ms"]
        print(f"pilot_stats n={r['n']}: {r['ms']:.4f} ms on the card as "
              f"after the upload, {r['cold_ms']:.4f} ms with L2 flushed "
              f"by a 64 MB read "
              f"(profiler; CUDA events {r['event_ms']:.4f} ms), "
              f"{r['launches_per_call']:g} launch a call, bound "
              f"{r['bound_ms']:.6f} ms by {r['bound_by']}"
              + (f", the card's smallest launch (one-element fill_) "
                 f"{r['smallest_launch_ms']:.4f} ms"
                 if "smallest_launch_ms" in r else "")
              + f"; plain {r['plain_ms']:.4f} ms, torch.std_mean + "
              f"torch.min {r['std_mean_min_ms']:.4f} ms; max rel err "
              f"{r['max_rel_err']:.3g} ({r['tolerance']}), two runs "
              f"identical; profiled windows taken: "
              f"{r['windows_taken']['hot']} (after the upload), "
              f"{r['windows_taken']['cold']} (L2 flushed)")
        print(f"  pilot_stats_device n={r['n']}: {h['whole']:.4f} ms of "
              f"host time (stages one by one: scale {h['scale']:.4f}, "
              f"upload {h['upload']:.4f}, launch {h['launch']:.4f}, "
              f"readback {h['readback']:.4f} ms)")
    tight = tight_plan()
    print(f"tight device-route plan (e={tight['e']}): pilot of "
          f"{tight['pilot_size']} samples in {tight['pilot_s']:.4f} s, "
          f"plan {tight['plan_s']:.4f} s, {tight['pilot_launches']} "
          f"pilot_stats launch")

    lap("isla synthetic checks")
    mesh_runs = [main_path_mesh(name, distinct, f64)
                 for name, distinct, f64, _ in MESH_RUNS]
    lap("isla mesh runs")
    device_runs = {p["name"]: p for p in runs + f64_runs}
    for path, (_, _, _, dev_name) in zip(mesh_runs, MESH_RUNS):
        st = path["state"]
        print(f"mesh path, {path['name']} run ({path['shards']} shards on "
              f"{path['devices'][0]}): {json.dumps(path['launches'])} "
              f"launches, {path['reduces']['calls']} reduces of "
              f"{path['reduces']['elements']} elements in all, "
              f"{path['agreement']}, {path['wall_s']:.2f} s"
              + ("" if st is None else
                 f"; {st['keys']} keys, {st['cells']} cells: state, ledgers"
                 f", register planes and partials bit-identical to the "
                 f"device route's"))
        dev_ticks = path["device_ticks"] or device_runs[dev_name]["ticks"]
        for k, (r, q) in enumerate(zip(path["ticks"], dev_ticks)):
            stages = ", ".join(f"{n} {t:.4f}"
                               for n, t in r["stages_s"].items())
            dev_stages = ", ".join(f"{n} {t:.4f}"
                                   for n, t in q["stages_s"].items())
            print(f"  tick {k + 1} (e={r['e']}): {r['new_samples']} new "
                  f"samples, reduces {r['collectives']}, "
                  f"{r['fold_launches']} isla_fold / {r['sketch_launches']} "
                  f"isla_sketch / {r['tagged_launches']} isla_tagged_fold / "
                  f"{r['tagged_sketch_launches']} isla_sketch_tagged "
                  f"launches; wall {r['wall_s']:.4f} s, stages s: {stages}; "
                  f"device route ({dev_name} run) wall {q['wall_s']:.4f} s, "
                  f"stages s: {dev_stages}")
    pipe_runs = [pipe_path(name, distinct, f64, mesh)
                 for name, distinct, f64, mesh in PIPE_RUNS]
    lap("isla pipelined runs")
    for path in pipe_runs:
        tw = path["twin"]
        print(f"pipelined path, {path['name']} run ({path['route']} route"
              + (f", {path['shards']} shards on {MESH_DEVICES[0]}"
                 if path["route"] == "mesh" else "")
              + f"; modes {'/'.join(PIPE_MODES)}, chunk_blocks "
              f"{PIPE_CHUNK_BLOCKS}): {json.dumps(path['launches'])} "
              f"launches, {path['wall_s']:.2f} s; against its serial twin: "
              f"{tw['answers']} answers and {tw['arrays']} state arrays, "
              f"{tw['pipe_gap']} answers and {len(tw['pipe_gap_arrays'])} "
              f"arrays differ"
              + ("" if "f64" in path["name"] else
                 f" (two serial runs: {tw['serial_gap']} answers and "
                 f"{len(tw['serial_gap_arrays'])} arrays differ)")
              + "; launches tick by tick equal")
        for k, (r, q) in enumerate(zip(path["ticks"], path["serial_ticks"])):
            stages = ", ".join(f"{n} {t:.4f}"
                               for n, t in r["stages_s"].items())
            s_stages = ", ".join(f"{n} {t:.4f}"
                                 for n, t in q["stages_s"].items())
            print(f"  tick {k + 1} (e={r['e']}): {r['new_samples']} new "
                  f"samples, launches {json.dumps(r['launches'])}; "
                  f"pipelined wall {r['wall_s']:.4f} s, stages s: {stages}; "
                  f"serial wall {q['wall_s']:.4f} s, stages s: {s_stages}")
    pipe_prof, pipe_prof_runs = profiled_pipe()
    lap("isla pipelined profile")
    pp = pipe_prof["profile"]
    print(f"profiled pipelined tick {PIPE_PROFILED_TICK + 1} (moments, "
          f"device route): {pp['worker_launches']} isla:launch ranges on "
          f"the isla-launch thread ({pp['launch_us'] / 1e3:.3f} ms), "
          f"{pp['main_draws']} isla:draw ranges on the main thread "
          f"({pp['draw_us'] / 1e3:.3f} ms), overlapping "
          f"{pp['overlap_us'] / 1e3:.3f} ms; ISLA kernels "
          f"{json.dumps(pipe_prof['kernel_events'])}; profiled runs taken "
          f"{pipe_prof_runs}")
    fold64 = [check_fold64(dev, n, q) for n, q in DENSE64_SHAPES]
    dense64 = [dense64_path(name, distinct)
               for name, distinct in DENSE64_RUNS]
    lap("isla float64 dense runs")
    regs64 = islaptx.get("isla_fold_kernel<double>")
    print("isla_fold float64 form -Xptxas -v: " + (
        "not printed (built before this run)" if regs64 is None else
        f"{regs64['registers']} registers, {regs64['smem_bytes']} B static "
        f"smem, {regs64.get('spill_bytes', 0)} B spilled (fp32 form: "
        f"{islaptx['isla_fold_kernel<float>']['registers']} registers, "
        f"{islaptx['isla_fold_kernel<float>'].get('spill_bytes', 0)} B "
        f"spilled)"))
    for f in fold64:
        print(f"isla_fold float64 at {tuple(f['pane'])} (4 keys, "
              f"{f['cells']} cells): {f['ms']:.4f} ms on the card "
              f"(profiler; CUDA events {f['event_ms']:.4f} ms), the fp32 "
              f"form on the same panes {f['fp32_ms']:.4f} ms, plain on the "
              f"CPU {f['plain_ms']:.1f} ms, bound {f['bound_ms']:.4f} ms by "
              f"{f['bound_by']}; max rel err {f['max_rel_err']:.3g} "
              f"({f['tolerance']}), two launches identical")
    for path in dense64:
        tr = path["profiled_tick"]
        print(f"float64 dense path, {path['name']} run "
              f"({path['shape']['cells']} cells, {DENSE64_RATE} samples a "
              f"drawn block, half the blocks a tick): device route "
              f"{json.dumps(path['launches'])} launches, the four-shard mesh "
              f"{json.dumps(path['mesh_launches'])}; compacted, full and "
              f"mesh runs bit-identical (state, ledgers, register planes, "
              f"partials); against the float64 tagged run: largest rel gaps "
              f"{json.dumps(path['tagged_gaps'])}; profiled tick "
              f"{DENSE64_PROFILED_TICK + 1}: {json.dumps(tr['kernel_events'])}"
              f", device busy {(tr['device_busy_s'] or 0.0) * 1e3:.3f} ms of "
              f"{tr['wall_s']:.4f} s wall ({path['traced_runs']} runs taken)")
        for k, (r, q, m, t) in enumerate(zip(
                path["ticks"], path["full_ticks"], path["mesh_ticks"],
                path["tagged_ticks"])):
            stages = ", ".join(f"{n} {v:.4f}"
                               for n, v in r["stages_s"].items())
            print(f"  tick {k + 1}: {r['new_samples']} new samples over "
                  f"{r['active_blocks']} blocks; compacted wall "
                  f"{r['wall_s']:.4f} s ({stages}), full {q['wall_s']:.4f} "
                  f"s, mesh {m['wall_s']:.4f} s, tagged {t['wall_s']:.4f} s")
    replays64 = []
    for path in dense64:
        for f in check_main_path_folds(path.pop("fold_calls")):
            replays64.append(dict(f, run=path["name"]))
    check(len(replays64) > 0, "the float64 dense runs folded no pane")
    for f in replays64:
        print(f"isla_fold float64 on the {f['run']} run's pane "
              f"{tuple(f['pane'])} ({f['real_samples']} samples"
              + (", compacted" if f["compacted"] else "") + "): "
              f"{f['ms']:.4f} ms on the card (CUDA events "
              f"{f['event_ms']:.4f} ms; plain on the CPU "
              f"{f['plain_ms']:.1f} ms, bound {f['bound_ms']:.4f} ms by "
              f"{f['bound_by']}), max rel err {f['max_rel_err']:.3g} "
              f"({f['tolerance']}), two launches identical")
    lap("isla float64 dense replays")
    tele = telemetry_path()
    lap("isla telemetry runs")
    tfolds = check_telemetry_folds(tele.pop("panes"))
    time_telemetry(tele["calls"])
    for r in tele["router"]:
        r.pop("fn")
    lap("isla telemetry replays")
    for c in tele["calls"]:
        vals = ", ".join(f"{k} {v:.6f}" for k, v in c["values"].items())
        print(f"telemetry {tuple(c['shape'])} {c['route']} route, {c['name']}"
              f": {vals}; wall {c['wall_ms']:.4f} ms, card "
              f"{c['device_ms']:.4f} ms (CUDA events), {c['events']:g} "
              f"device events a call, busy {c['busy_ms'] or 0.0:.4f} ms "
              f"(profiler); {c['fold_launches']} "
              f"isla_fold launches, reduces {c['footprint']}; rel gaps "
              f"{json.dumps(c['gaps'])}"
              + ("" if "abs_err" not in c else
                 f"; |isla - exact| {c['abs_err']:.5f} beside the rate's "
                 f"uniform-subsample error {c['uniform_err']:.5f}"))
    for a in tele["accuracy"]:
        print(f"telemetry accuracy, normal(5.5, 1.5) {tuple(a['shape'])} at "
              f"rate {TELEMETRY_RATE}, {a['route']} route: isla "
              f"{a['isla']:.5f}, exact {a['exact']:.5f}, |isla - exact| "
              f"{a['abs_err']:.5f} (e {a['e']}; uniform-subsample error "
              f"{a['uniform_err']:.5f})")
    for r in tele["router"]:
        print(f"router_load_stats ({ROUTER_ARCH}, {tele['router_experts']} "
              f"experts, {ROUTER_TOKENS} tokens), {r['route']} route: "
              f"{r['values']['router_top1_isla']:.6f}, "
              f"{r['fold_launches']} isla_fold launches, reduces "
              f"{r['footprint']}, rel gaps {json.dumps(r['gaps'])}")
    for f in tfolds:
        print(f"isla_fold on a {f['samples']}-sample telemetry pane: "
              f"{f['ms']:.4f} ms on the card (profiler, "
              f"{f['kernels_a_call']:g} kernels a call; CUDA events "
              f"{f['event_ms']:.4f} ms; plain {f['plain_ms']:.4f} ms), bound "
              f"{f['bound_ms']:.5f} ms by {f['bound_by']}, max rel err "
              f"{f['max_rel_err']:.3g} (tol rel {TELEMETRY_TOL}), two "
              f"launches identical")
    lm = lm_path()
    lap("lm path runs")
    grads = grad_telemetry(lm.pop("params"))
    for g in grads:
        g.pop("fn")
        print(f"grad_abs_stats over the {LM_ARCH} parameter tree, "
              f"{g['route']} route: {g['values']['grad_absmean_isla']:.6g}, "
              f"{g['fold_launches']} isla_fold launches, reduces "
              f"{g['footprint']}, rel gaps {json.dumps(g['gaps'])}")
    lap("lm grad telemetry")
    print(f"LM path, {lm['arch']} at full width and depth "
          f"({lm['n_params'] / 1e9:.3f} B params, bf16, init "
          f"{lm['init_s']:.2f} s): {LM_REQUESTS} requests, prompt lengths "
          f"{lm['prompt_lens']}, {LM_SLOTS} slots, max_new {LM_MAX_NEW}: "
          f"{json.dumps(lm['launches'])} launches")
    print(f"  prefill {lm['prefill_s']:.3f} s "
          f"({lm['prefill_tokens_per_s']:.0f} prompt tok/s), decode "
          f"{lm['decode_s']:.3f} s ({lm['decode_tokens_per_s']:.1f} tok/s), "
          f"{lm['new_tokens']} new tokens in {lm['wall_s']:.3f} s = "
          f"{lm['tokens_per_s']:.1f} tok/s")
    ticks = lm["rerun_tick_s"]
    print(f"  re-run tick by tick: {len(ticks)} ticks, first "
          f"{ticks[0]:.3f} s, median {sorted(ticks)[len(ticks) // 2]:.4f} "
          f"s, sum {sum(ticks):.3f} s")
    for p in lm["profiled_ticks"]:
        top = list(p["kernels_s"].items())[:3]
        print(f"  tick {p['tick']} ({p['active']} slots): device busy "
              f"{p['device_s'] * 1e3:.2f} ms of {p['wall_s'] * 1e3:.2f} ms "
              f"wall (profiled re-run); top kernels "
              + ", ".join(f"{n[:48]} {t * 1e3:.2f} ms" for n, t in top))
    calls = lm.pop("calls")
    flash = [check_flash(q, k, v, g) for q, k, v, g in calls]
    del calls
    n_layers = len(flash) // len(lm["prompt_lens"])
    for i, s_len in enumerate(lm["prompt_lens"]):
        layer = flash[i * n_layers:(i + 1) * n_layers]
        print(f"flash_attention on prefill {i} (S={s_len}, "
              f"{tuple(layer[0]['shape'])}, {n_layers} layers): "
              f"{sum(f['ms'] for f in layer):.3f} ms (plain "
              f"{sum(f['plain_ms'] for f in layer):.3f} ms, SDPA "
              f"{sum(f['library_ms'] for f in layer):.3f} ms, bound "
              f"{sum(f['bound_ms'] for f in layer):.4f} ms by "
              f"{layer[0]['bound_by']}); a call "
              f"{sum(f['ms'] for f in layer) / n_layers:.4f} ms (SDPA "
              f"{sum(f['library_ms'] for f in layer) / n_layers:.4f}, bound "
              f"{layer[0]['bound_ms']:.4f}); " + flash_err_text(layer))
    lap("lm path replays")
    synth = check_flash_synthetic(dev)
    for f in synth:
        print(f"flash_attention synthetic {f['name']} {tuple(f['shape'])} "
              f"groups {f['groups']} {f['dtype']}: {f['ms']:.4f} ms (plain "
              f"{f['plain_ms']:.3f} ms, SDPA {f['library_ms']:.4f} ms, bound "
              f"{f['bound_ms']:.4f} ms by {f['bound_by']}); "
              + flash_err_text([f]))
    small = check_lm_small(dev)
    print(f"LM small-input check, {small['arch']}: card vs CPU logits max "
          f"abs err {max(small['max_abs_err']):.3g} ({small['tolerance']})")
    lap("lm synthetic checks")
    vlm = vlm_path()
    lap("vlm path runs")
    print(f"VLM path, {vlm['arch']} at full width and depth "
          f"({vlm['n_params']} params, bf16, init {vlm['init_s']:.2f} s): "
          f"{json.dumps(vlm['launches'])} launches")
    vcalls = vlm.pop("calls")
    vflash = [check_flash(q, k, v, g) for q, k, v, g in vcalls]
    del vcalls
    v_layers = len(vflash) // len(vlm["batches"])
    for i, bt in enumerate(vlm["batches"]):
        layer = vflash[i * v_layers:(i + 1) * v_layers]
        steps = vlm["decode_step_s"][i]
        n = len(layer)
        print(f"  batch {bt['batch']} x ({bt['prompt_tokens']} tokens + "
              f"256 patches, S={bt['seq']}): prefill "
              f"{vlm['prefill_s'][i]:.4f} s, decode steps "
              f"{', '.join(f'{t:.4f}' for t in steps)} s (median "
              f"{sorted(steps)[len(steps) // 2]:.4f})")
        print(f"  flash_attention per call at {tuple(layer[0]['shape'])} "
              f"over {layer[0]['kv_heads']} KV heads (groups "
              f"{layer[0]['groups']}), {n} layers: "
              f"{sum(f['ms'] for f in layer) / n:.4f} ms (min "
              f"{min(f['ms'] for f in layer):.4f}, max "
              f"{max(f['ms'] for f in layer):.4f}), bound "
              f"{layer[0]['bound_ms']:.4f} ms by {layer[0]['bound_by']}, "
              f"plain {sum(f['plain_ms'] for f in layer) / n:.3f} ms, SDPA "
              f"{sum(f['library_ms'] for f in layer) / n:.4f} ms; "
              + flash_err_text(layer))
    lap("vlm path replays")
    total_bytes = torch.cuda.get_device_properties(0).total_memory
    moe_runs = []
    for arch, n_layers in MOE_RUNS:
        m = moe_path(arch, n_layers)
        check(m["peak_bytes"] < total_bytes,
              f"{arch}: peak memory {m['peak_bytes']} B of {total_bytes}")
        mcalls = m.pop("calls")
        m["flash"] = [check_flash(q, k, v, g) for q, k, v, g in mcalls]
        del mcalls
        moe_runs.append(m)
        lap(f"lm moe {arch}")
        print(f"MoE path, {arch} at full width, {m['n_layers']} layer(s) "
              f"(d_model {m['d_model']}, {m['n_experts']} experts; "
              f"{m['n_params'] / 1e9:.3f} B params, bf16, init "
              f"{m['init_s']:.2f} s; {m['held_bytes'] / 2**30:.2f} GiB held "
              f"before it, peak {m['init_peak_bytes'] / 2**30:.2f} GiB at "
              f"init, {m['peak_bytes'] / 2**30:.2f} GiB in all, of "
              f"{total_bytes / 2**30:.2f}): {MOE_REQUESTS} requests, prompt "
              f"lengths {m['prompt_lens']}, {MOE_SLOTS} slots, max_new "
              f"{MOE_MAX_NEW}: {json.dumps(m['launches'])} launches")
        print(f"  prefill s a request "
              + ", ".join(f"{t:.4f}" for t in m["prefill_each_s"])
              + f"; decode {m['decode_s']:.3f} s over {m['ticks']} ticks "
              f"({m['decode_tick_s'] * 1e3:.2f} ms a tick, median re-run "
              f"tick {sorted(m['rerun_tick_s'])[m['ticks'] // 2] * 1e3:.2f}"
              f" ms); {m['new_tokens']} new tokens in {m['wall_s']:.3f} s "
              f"= {m['tokens_per_s']:.1f} tok/s")
        p = m["profiled_tick"]
        top = list(p["kernels_s"].items())[:3]
        print(f"  profiled decode tick {p['tick']} ({p['active']} slots): "
              f"{p['device_events']} device events, busy "
              f"{p['device_s'] * 1e3:.2f} ms of {p['wall_s'] * 1e3:.2f} ms "
              f"wall ({p['busy_share']:.1%}); top kernels "
              + ", ".join(f"{n[:48]} {t * 1e3:.2f} ms" for n, t in top))
        rt = m["routes"]
        print(f"  routing of {len(rt)} MoE calls on the card vs the CPU on "
              f"the same logits: dispatch identical but "
              f"{sum(r['near_ties'] for r in rt)} near-tie tokens (+"
              f"{sum(r['moved'] for r in rt)} moved with them) of "
              f"{sum(r['tokens'] for r in rt)}; combine max rel "
              f"{max(r['combine_max_rel'] for r in rt):.3g}; (G, Tg, C) "
              + ", ".join(sorted({f"({r['groups']}, {r['group_tokens']}, "
                                  f"{r['capacity']})" for r in rt})))
        print("  apply_moe vs the gather oracle: " + "; ".join(
            f"{o['call']} {tuple(o['shape'])}: experts "
            f"{o['experts']['max_abs_err']:.3g} of "
            f"{o['experts']['scale']:.3g}, output "
            f"{o['output']['max_abs_err']:.3g} of "
            f"{o['output']['scale']:.3g}" for o in m["oracle"]))
        fl = m["flash"]
        print(f"  flash_attention on its {len(fl)} prefill calls "
              f"({fl[0]['shape'][0]} q heads over {fl[0]['kv_heads']} KV "
              f"heads, groups {fl[0]['groups']}, hd {fl[0]['shape'][2]}): "
              f"{sum(f['ms'] for f in fl):.3f} ms (plain "
              f"{sum(f['plain_ms'] for f in fl):.3f} ms, SDPA "
              f"{sum(f['library_ms'] for f in fl):.3f} ms, bound "
              f"{sum(f['bound_ms'] for f in fl):.4f} ms); at S = "
              f"{max(m['prompt_lens'])} a call "
              f"{max(fl, key=lambda f: f['shape'][1])['ms']:.4f} ms (SDPA "
              f"{max(fl, key=lambda f: f['shape'][1])['library_ms']:.4f}); "
              + flash_err_text(fl))
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"lm mamba: {held / 2**30:.3f} GiB held on the card before the "
          f"phase (the MoE models freed)")
    mamba = mamba_path(MAMBA_ARCH, checks=("cpu", "parity"))
    check(mamba["peak_bytes"] < total_bytes,
          f"{MAMBA_ARCH}: peak memory {mamba['peak_bytes']} B")
    check(not mamba.pop("calls"), f"{MAMBA_ARCH} made a flash call")
    lap(f"lm mamba {MAMBA_ARCH}")
    jambas = []
    for dt in JAMBA_DTYPES:
        j = mamba_path(JAMBA_ARCH, reduced=True, dtype=dt,
                       prompt_hi=JAMBA_PROMPT_HI,
                       checks=("cpu",) if dt == "float32" else ())
        jcalls = j.pop("calls")
        j["flash"] = [check_flash(q, k, v, g) for q, k, v, g in jcalls]
        del jcalls
        jambas.append(j)
    lap(f"lm mamba {JAMBA_ARCH}")
    for m in [mamba] + jambas:
        p = m["profiled_tick"]
        top = list(p["kernels_s"].items())[:3]
        print(f"Mamba path, {m['arch']} ({m['dtype']}, {m['n_layers']} "
              f"layers: {m['mamba_layers']} Mamba, {m['attention_layers']} "
              f"attention; d_model {m['d_model']}; "
              f"{m['n_params'] / 1e9:.4f} B params, init {m['init_s']:.2f} "
              f"s; {m['held_bytes'] / 2**30:.3f} GiB held before it, peak "
              f"{m['peak_bytes'] / 2**30:.3f} GiB): {MAMBA_REQUESTS} "
              f"requests, prompt lengths {m['prompt_lens']}, {MAMBA_SLOTS} "
              f"slots, max_new {MAMBA_MAX_NEW}: {json.dumps(m['launches'])} "
              f"launches")
        print(f"  prefill s a request "
              + ", ".join(f"{t:.4f}" for t in m["prefill_each_s"])
              + f"; decode {m['decode_s']:.3f} s over {m['ticks']} ticks "
              f"({m['decode_tick_s'] * 1e3:.2f} ms a tick, median re-run "
              f"tick {sorted(m['rerun_tick_s'])[m['ticks'] // 2] * 1e3:.2f}"
              f" ms); {m['new_tokens']} new tokens in {m['wall_s']:.3f} s "
              f"= {m['tokens_per_s']:.1f} tok/s")
        print(f"  profiled decode tick {p['tick']} ({p['active']} slots, "
              f"run {p['runs']}): {p['device_events']} device events for "
              f"{p['products']} matrix products, busy "
              f"{p['device_s'] * 1e3:.2f} ms of {p['wall_s'] * 1e3:.2f} ms "
              f"wall unprofiled ({p['busy_share']:.1%}); top kernels "
              + ", ".join(f"{n[:48]} {t * 1e3:.2f} ms" for n, t in top))
        print("  layer-0 SSD vs the O(S^2) oracle: " + "; ".join(
            f"S={c['tokens']} ({c['chunks']} chunks): y rel "
            f"{c['y_rel']:.3g}, state rel {c['h_rel']:.3g}"
            for c in m["ssd"]) + f" (tol {MAMBA_TOL} of scale)")
        if "parity" in m:
            q = m["parity"]
            print(f"  prefill({q['prefill']}) + {q['decode_steps']} decode "
                  f"steps vs prefill({q['full']}) (rtol, atol 2e-2; held in "
                  f"fp32): " + "; ".join(
                      f"{d} max abs {q[d]['max_abs_err']:.3g} at scale "
                      f"{q[d]['scale']:.3g}, within: {q[d]['within_contract']}"
                      for d in ("float32", "bfloat16")))
        c = m.get("cpu")
        if c is not None and "layerwise_rel" in c:
            print(f"  vs fp32 on the CPU, prefill {c['prefill_tokens']} + a "
                  f"decode tick: bf16 layer by layer on the card's inputs "
                  f"({c['mamba_calls']} Mamba calls) max rel "
                  f"{json.dumps(c['layerwise_rel'])} (tol {MAMBA_TOL}); "
                  f"fp32 on the card end to end max rel "
                  f"{max(c['f32_rel'].values()):.3g} (tol {MAMBA_F32_TOL}); "
                  f"bf16 end to end (not held) "
                  f"{json.dumps(c['bf16_rel'])}")
        elif c is not None:
            print("  fp32 card vs CPU logits (prefill, decode): " + "; ".join(
                f"S={x['tokens']}{' on' if x['on_group'] else ' off'} the "
                f"routing group: rel {x['rel_err'][0]:.3g}, "
                f"{x['rel_err'][1]:.3g}, near-ties {x['near_ties']}"
                for x in c["prompts"]) + f" (tol {JAMBA_TOL} of scale)")
        fl = m.get("flash")
        if fl:
            print(f"  flash_attention on its {len(fl)} prefill calls "
                  f"({fl[0]['shape'][0]} q heads over {fl[0]['kv_heads']} "
                  f"KV heads, hd {fl[0]['shape'][2]}, {fl[0]['dtype']}): "
                  f"{sum(f['ms'] for f in fl):.3f} ms (plain "
                  f"{sum(f['plain_ms'] for f in fl):.3f} ms, SDPA "
                  f"{sum(f['library_ms'] for f in fl):.3f} ms, bound "
                  f"{sum(f['bound_ms'] for f in fl):.4f} ms); "
                  + flash_err_text(fl))
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"lm train: {held / 2**30:.3f} GiB held on the card before the "
          f"phase (the earlier models freed)")
    train = train_path()
    train["folds"] = check_telemetry_folds(train.pop("panes"))
    lap("lm train")
    print_train(train, total_bytes)
    cli = train_cli_path()
    lap("lm train cli")
    print_train_cli(cli)
    mesh_train = train_mesh_path()
    if torch.cuda.device_count() >= MESH_CARDS:
        mesh_train["cards"] = train_mesh_cards()
    mesh_train["folds"] = check_telemetry_folds(mesh_train.pop("panes"))
    lap("lm train mesh")
    print_train_mesh(mesh_train)
    dry = dryrun_path()
    lap("dryrun")
    print_dryrun(dry, train["olmo"]["median_step_s"])
    tries = [w["tries"] for w in WINDOW_LOG]
    lost = [PROFILE_LEAD_KERNELS - x["lead_spins"] for w in WINDOW_LOG
            for x in w["windows"]]
    print(f"profiled kernel windows: {len(tries)} measurements, "
          + ", ".join(f"{tries.count(n)} took {n} window(s)"
                      for n in range(1, PROFILE_TRIES + 1))
          + f" (each padded by {PROFILE_PAD_S * 1e3:g} ms at both ends and "
          f"opened by {PROFILE_LEAD_KERNELS} spins); lead spins lost a "
          f"window: {min(lost)}-{max(lost)}, {sum(1 for n in lost if n)} of "
          f"{len(lost)} windows lost some")
    print("phase seconds: " + ", ".join(f"{n} {t:.1f}"
                                         for n, t in phase_s.items()))

    # Each kernel's entry sums the main path's own calls (every drawing
    # tick's launches in both ISLA runs, replayed on their panes; every
    # prefill layer's attention in the olmo-1b, paligemma-3b, grok-1-314b,
    # arctic-480b and jamba runs, replayed on its q, k, v); its launches
    # are the runs' counts added, the mesh and pipelined runs' included
    # (and isla_fold's the telemetry and training phases' calls, the
    # training CLI's resumed run's and the sharded steps' too; and both
    # kernels' launches in the dryrun phase's real step, prefill and
    # serving runs).
    def launched(kernel):
        return sum(path["launches"][kernel]
                   for path in runs + mesh_runs + pipe_runs)

    # isla_fold's time sums one replay of each pane: the served ticks',
    # the telemetry phase's and the training and sharded steps' loss
    # telemetry's.
    fold_panes = served + tfolds + train["folds"] + mesh_train["folds"]
    f_bytes = sum(f["bytes_ms"] for f in fold_panes)
    f_ops = sum(f["ops_ms"] for f in fold_panes)
    s_bytes = sum(f["bytes_ms"] for f in merged)
    s_ops = sum(f["ops_ms"] for f in merged)
    t_bytes = sum(f["bytes_ms"] for f in tagged)
    t_ops = sum(f["ops_ms"] for f in tagged)
    g_bytes = sum(f["bytes_ms"] for f in tagged_merges)
    g_ops = sum(f["ops_ms"] for f in tagged_merges)
    d_bytes = sum(f["bytes_ms"] for f in replays64)
    d_ops = sum(f["ops_ms"] for f in replays64)

    def launched64(kernel):
        return sum(p["launches"][kernel] + p["mesh_launches"][kernel]
                   for p in dense64)

    tele_launches = sum(c["fold_launches"] for c in tele["calls"]
                        + tele["router"] + grads) + sum(
        a["launches"] for a in tele["accuracy"])
    lm_flash = flash + vflash + [f for m in moe_runs + jambas
                                 for f in m["flash"]]
    a_bytes = sum(f["bytes_ms"] for f in lm_flash)
    a_ops = sum(f["ops_ms"] for f in lm_flash)
    kernels = [
        dict(name="isla_fold", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:162",
             launches=(launched("isla_fold") + tele_launches
                       + train["fold_launches"] + cli["fold_launches"]
                       + mesh_train["fold_launches"]
                       + dry["launches"]["isla_fold"]),
             max_abs_err=max(f["max_abs_err"] for f in fold_panes + folds),
             ms=sum(f["ms"] for f in fold_panes),
             plain_ms=sum(f["plain_ms"] for f in fold_panes),
             bound_ms=max(f_bytes, f_ops),
             bound_by="bytes" if f_bytes >= f_ops else "operations",
             library_ms=None),
        dict(name="pilot_stats", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:463",
             launches=launched("pilot_stats"),
             max_abs_err=pilot["max_abs_err"], ms=pilot["ms"],
             plain_ms=pilot["plain_ms"], bound_ms=pilot["bound_ms"],
             bound_by=pilot["bound_by"], library_ms=None),
        dict(name="isla_sketch", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:362",
             launches=launched("isla_sketch") + launched64("isla_sketch"),
             max_abs_err=max(f["max_abs_err"] for f in merged),
             ms=sum(f["ms"] for f in merged),
             plain_ms=sum(f["plain_ms"] for f in merged),
             bound_ms=max(s_bytes, s_ops),
             bound_by="bytes" if s_bytes >= s_ops else "operations",
             library_ms=None),
        dict(name="isla_tagged_fold", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/core/distributed.py:269",
             launches=sum(p["launches"]["isla_tagged_fold"]
                          for p in f64_runs + mesh_runs + pipe_runs),
             max_abs_err=max(f["max_abs_err"] for f in tagged),
             ms=sum(f["ms"] for f in tagged),
             plain_ms=sum(f["plain_ms"] for f in tagged),
             bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             library_ms=None),
        dict(name="isla_sketch_tagged", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:362",
             launches=sum(p["launches"]["isla_sketch_tagged"]
                          for p in f64_runs + mesh_runs + pipe_runs),
             max_abs_err=max(f["max_abs_err"] for f in tagged_merges),
             ms=sum(f["ms"] for f in tagged_merges),
             plain_ms=sum(f["plain_ms"] for f in tagged_merges),
             bound_ms=max(g_bytes, g_ops),
             bound_by="bytes" if g_bytes >= g_ops else "operations",
             library_ms=None),
        dict(name="isla_fold_f64", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:162",
             launches=launched64("isla_fold_f64"),
             max_abs_err=max(f["max_abs_err"] for f in replays64 + fold64),
             ms=sum(f["ms"] for f in replays64),
             plain_ms=sum(f["plain_ms"] for f in replays64),
             bound_ms=max(d_bytes, d_ops),
             bound_by="bytes" if d_bytes >= d_ops else "operations",
             library_ms=None),
        dict(name="flash_attention", route="cuda", source=FLASH_SOURCE,
             replaces="src/repro/kernels/flash_attention.py:65",
             launches=(lm["launches"]["flash_attention"]
                       + vlm["launches"]["flash_attention"]
                       + sum(m["launches"]["flash_attention"]
                             for m in moe_runs + jambas)
                       + dry["launches"]["flash_attention"]),
             max_abs_err=max(f["max_abs_err"] for f in lm_flash + synth),
             ms=sum(f["ms"] for f in lm_flash),
             plain_ms=sum(f["plain_ms"] for f in lm_flash),
             bound_ms=max(a_bytes, a_ops),
             bound_by="bytes" if a_bytes >= a_ops else "operations",
             library_ms=sum(f["library_ms"] for f in lm_flash)),
    ]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, build_logs=logs, main_path=runs,
        main_path_folds=served, main_path_sketches=merged,
        main_path_f64=f64_runs, main_path_tagged=tagged,
        main_path_mesh=mesh_runs, main_path_pipelined=pipe_runs,
        pipelined_profile=pipe_prof, fold_f64=fold64,
        dense_f64=dense64, dense_f64_folds=replays64, telemetry=tele,
        telemetry_folds=tfolds, grad_telemetry=grads,
        main_path_tagged_sketches=tagged_merges, fold=folds,
        batched=batched, wrappers=wrappers, pilot=pilots, tight_plan=tight,
        lm_path=lm,
        phase_s=phase_s,
        lm_flash=flash, flash_synthetic=synth, lm_small=small,
        vlm_path=vlm, vlm_flash=vflash, moe_paths=moe_runs,
        mamba_path=mamba, jamba_paths=jambas, train_path=train,
        train_cli=cli, train_mesh=mesh_train, dryrun=dry,
        profiled_windows=WINDOW_LOG,
        flash_ptxas=ptxas, flash_sass=sass,
        isla_ptxas=islaptx,
        kernels=kernels),
        indent=1, default=str))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
