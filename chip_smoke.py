#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (raytracer_odin_tpu_torch).

Drives the port's paths on one NVIDIA GPU, one phase per line with its
wall time:

  1. card      name and power limit (nvidia-smi)
  2. build     the CUDA kernels K1-K5 and the shade kernel (nvcc, ptxas -v
               report: registers a thread; K2, K3 and K4 are instances of
               one sweep kernel; the shade kernel's stack and spills)
               and the host lib; SASS instructions a test in each
               kernel's inner loop (cuobjdump -sass, sass_counts; the SASS
               is written next to the renders as sass.txt)
  3. scene     the demo scene through the port's own assets, glTF reader
               and finish_scene(device="cuda")
  4. kernels   K1 (mask) and K2 (sweep) against their plain PyTorch
               versions, bit for bit, on the bounce-0 camera rays of the
               full frame and on the sorted, compacted bounce-1 batch of the
               calibration sample; CUDA-event times and bounds; the SM
               clock under each kernel's load, K2's warp-vote rates, and
               the issue floors they give
  5. render    the main path: render_scene on the demo at 1920x1080, depth
               8, 1 spp per step, intersector="pallas", compact="auto":
               calibration plus the timed steps; Mrays/s over live path
               segments, per-bounce alive counts, overflow (must be 0), peak
               memory, and the launch counts of every kernel (K1 and K2 8 per
               step and 8 in calibration, K3-K5 none; the shade kernel 8
               per step, replayed in the segment graphs, none in
               calibration; the draw kernel 9 per step and 9 in
               calibration: the jitter and one call a bounce)
  5b. shade    the shade kernel against the plain segment (the row
               layout's PyTorch, its engagement patched off) on the demo's
               bounce-0 segment of the full frame and its sorted,
               compacted bounce-1 segment, exactly (alive bit for bit,
               floats equal), one FUSED launch each; device ms a call of
               the kernel and of the plain segment in CUDA graphs, and the
               bound of the bytes a lane moves
  5c. draws    the draw kernel (csrc/prng_kernels.cu) against the plain
               chain of utils/prng on a frame's 2,073,600 lanes at n = 6
               and 2 and the demo's 1,899,008-lane bounce-1 budget at
               n = 6, bit for bit, rows and columns, one launch a call;
               device ms a launch, the plain chain's in a CUDA graph and
               its launches a call, host us a call of each, and the bound
               of the bytes a lane moves (28 B at n = 6, 12 B at n = 2)
  6. check     the render is finite and of the frame's shape, and the
               golden images of tests/golden/ reproduce on the card
  7. the paths of the second slice, each at 1920x1080, depth 8, seed 0,
     with its kernel checks, calibration and PATH_STEPS timed steps, the
     launch counts read at every step, overflow 0, peak memory:
       citynight  1,728 lights: K1, K2 and K5 (light-cluster pdf; checked
                  on the bounce-0 shading batch and on the second bounce's
                  batch of one more step, with its warp-vote rates and the
                  SM clock under its load; the culled pdf against the dense
                  sum on a slice of the first and on the whole second,
                  where lanes through a light's edge may differ: see
                  edge_flips); the shade kernel's HEAD and TAIL around K5
                  against the plain halves at bounces 0 and 1 as in 5b,
                  and 16 shade kernel launches a step
       city       811 clusters, two-level layout (g = 4): K1 and K2 over
                  chunk-major lists
       city24     city with blocks=24, 207,234 triangles, streamed: K1 and
                  K4 (streamed sweep over uncapped lists; at bounces 0 and
                  1, K4 over these lists against K4 over the capped lists
                  of the JAX package's rule, count -1 beyond 256 clusters,
                  on the whole batch, bit for bit, with both times; the
                  lists beyond the cap, and their lengths, are counted on
                  every bounce of one more step)
       brute      the demo with intersector="pallas_brute": K3 only,
                  uncompacted; the cube golden image through K3
     then the dense light pdf below 512 lights: citynight with one window
     a tower (288 lights), its full-frame bounce-0 shading batch:
     shading.light_pdf_sum's time and peak memory, and the culled pdf
     (K5) against it at rtol 2e-4 with its time
  8. twophase    the demo at 1920x1080, depth 8, with two-phase culling
                 (traverse.TWO_PHASE_K = 2): K1 with its tmax row against its
                 plain version on the sorted bounce-1 batch with phase A's t in
                 row 6, the index flips against the single sweep there, then
                 calibration plus STEPS timed steps with the launch counts of
                 every step (K1 8 + K1-tmax 7 and K2 15 a step; 8 and 8 in
                 calibration), overflow 0, and the frame against the
                 single-phase demo frame under the glossy-scene gate
  9. cli         the port's CLI in process, cli.main(..., device="cuda"), on
                 the demo glTF at 1920x1080, depth 8, 4 spp, 2 trials: exit
                 code 0, the performance summary and Throughput line, a PNG
                 under chiprun_out/ that decodes to 1080x1920x3, the launch
                 counts of the compacted main path; then --oracle on the cube
 10. debug       the debug surface on the demo at 1920x1080, depth 8,
                 DEBUG_STEPS steps of 1 spp, debug_features=True (ten AOV
                 layers, uncompacted, no calibration): K1 and K2 against
                 their plain versions, bit for bit, on the whole full-width
                 sorted bounce-1 batch of the uncompacted route (dead lanes
                 included, sorted last), with times and bounds; the launch
                 counts (K1 8 and K2 8 a step, none in calibration),
                 overflow 0, peak memory; the beauty layer bit-equal to a
                 beauty-only compact="off" render of the same seed; the AOVs'
                 ranges; the device ray log of one lane against the full
                 frame on a grid of pixels, one on the floor, one whose path
                 reaches an emitter, one whose path escapes, and a primary
                 miss (the cube at the same frame: the demo's camera sees no
                 sky): its first t bit-equal to the depth AOV, its segments
                 the bounces AOV; the preview's overlays and its HTTP server
                 on 127.0.0.1; one more step with --debug-nans' check,
                 bit-equal to one without; the CLI with --debug --layer depth
                 --preview-file; Mrays/s and step time beside the compacted
                 demo's
 11. mesh        the demo through parallel/mesh.py at 1920x1080, depth 8:
                 a 2 x 1 tile mesh over the cards there are (cuda:0 twice
                 on one card), compacted with each tile's own budgets, for
                 the demo's STEPS steps: frame and ray count bit-equal to
                 the single-card compacted render, overflow 0, launches
                 (K1 and K2 16 a step and 16 in calibration); K1 and K2
                 against their plain versions on shard 0's bounce-1 batch;
                 the host syncs of one sharded step and of one single-card
                 step (torch.cuda.set_sync_debug_mode("warn"), by file and
                 line); a 2 x 2 mesh at 2 spp a step against the
                 single-card frame at the spp tolerance of
                 tests/test_torch_parallel.py; with two cards, the 2 x 1
                 mesh over both, bit-equal, its Mrays/s beside one card's
 12. refill      the demo with compact="refill", REFILL_STEPS steps of
                 REFILL_SPP spp: overflow 0, the plan's iterations of K1 and
                 K2 a step and 8 each in calibration, the frame bit-equal to
                 the compacted render of the same samples but for the
                 pixels grouping_flips explains, Mrays/s beside
                 it and the demo's, K1 and K2 on an iteration of the steady
                 state against their plain versions
 13. cli         cli.main with --devices 2 (two shards on one card where
                 there is one card), --pool and --compact refill at
                 1920x1080, depth 8, SCHED_CLI_SPP spp: exit code 0, a PNG
                 under chiprun_out/ that decodes
 14. pool        the demo with wavefront_pool=True, pool_fraction=0.5,
                 POOL_STEPS steps of 1 spp: waves a step, one K1 and one
                 K2 a wave, the frame against the batched render's at the
                 tolerance of tests/test_torch_wavefront.py but for at
                 most MAX_FLIPS pixels, each explained by grouping_flips
                 (a ray whose own K1 mask rounds out a cluster it hits),
                 rays and live lanes within those pixels' paths, a second
                 run bit-equal, K1 and K2 on a wave of the steady state
                 against their plain versions
 15. cols        the demo through the columnar trace (integrator.COLS = 1),
                 its shading graphed as the row form's is,
                 calibration plus STEPS steps: overflow 0, K1 and K2 8 a
                 step and 8 in calibration, K1 and K2 against their plain
                 versions on the columnar route's sorted bounce-1 batch,
                 the frame against the row-form demo frame at the
                 glossy-scene gate's mean and pass fraction, with the
                 values that differ and the pixels beyond its MAX_ABS
                 counted and the MAX_FLIPS largest of them explained
                 (frame_vs, lane_flips), Mrays/s, step time, host syncs
                 and peak memory beside the demo's
 16. cols citynight  citynight through the columnar trace, PATH_STEPS
                 steps: K1, K2 and K5 8 a step and 8 in calibration, K5
                 against its plain version on the columnar bounce-0 shading
                 batch with the culled pdf against the dense sum there
                 (edge_flips), the frame against the row-form citynight
                 frame as in cols
 17. accuracy    the accuracy harness (raytracer_odin_tpu_torch/accuracy)
                 on the BASELINE configs at full size: K1 and K2 against
                 their plain versions on the sorted, compacted bounce-1
                 batches of cfg3_textured (800x600) and cfg4_envmap
                 (1024x768); then, launches counted from zero, the
                 same-seed half of cfg1-cfg5 (through the runtime's own
                 step, as a user renders), the proxy half of all six
                 rows at 1024 spp and cfg5's 16 draws of 512 spp, and the
                 report against out/rmse/ (the JAX package's CPU renders
                 and the numpy oracle; a missing reference raises): every
                 row held to same_seed_pass and distribution_agrees (cfg5's
                 image-mean test the empirical two-sample one), a line a
                 row with its seconds, the report under chiprun_out/; K1 and
                 K2 launched once a bounce of every trace, K3-K5 never;
                 peak memory and the phase's wall time
 18. with --profile: one more step of each path under torch.profiler,
     device time by kernel class, kernels a step and the device's busy
     share
 19. the kernels JSON line (K1-K5, K1 with its tmax row, the draw kernel
     with its three batches, and the shade kernel, whose launches are counted on the demo, citynight, city,
     city24 and brute paths; each with its design and registers, K1-K5
     with their SASS counts, SM clock and issue floors, K2-K5 with their
     warp-vote rates; K1 and K2 with their checks on the mesh
     shard's, the pool wave's, the refill iteration's, the columnar
     bounce-1 and the accuracy configs' bounce-1 batches, and their
     launches in the accuracy phase; K5 on the columnar citynight batch),
     then the {"ok": true, ...} line.

The smoke refuses to start with RT_TPU_TWO_PHASE or RT_TPU_COLS set: the
paths set those switches themselves.

The check phase renders the four golden images of tests/golden/ through
"pallas" (cube and cornell at rtol 1e-3, atol 1e-4; the glossy textured and
envmap scenes at the glossy-scene gate of tests/test_torch_render.py), and
the cube and cornell through "brute" and "bvh" as well.

Plain versions that would take minutes at full frame are compared on a
slice of the batch: the SLICE_BLOCKS 512-ray blocks in its middle (K3, and
K2/K4 on the two-level scenes city and city24); the kernel is timed on the
whole batch and on the slice.

Any failure exits non-zero before the last line is printed. Run it from the
repository root:

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny CPU run of the same
                                           # phases; never prints "ok"
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Render and profile table: in the port's gitignored build directory.
OUT_DIR = ROOT / "raytracer_odin_tpu_torch" / "build" / "smoke"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# fp32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# fp32 operations per ray-box slab test (K1): per axis 2 sub, 2 mul, 1 min,
# 1 max; near/far 2 max + 2 min; 2 compares; with the tmax row one more
# compare.
K1_OPS_PER_TEST = 24
K1_TMAX_OPS_PER_TEST = 25
# fp32 operations per ray-triangle test (K2, K3, K4): d x v 9, det 5,
# 1/det 1, o - p 3, bu 6, q 9, bv 6, t 6, inside 5, t > 0 and t < best 2,
# select 2.
K2_OPS_PER_TEST = 54
# fp32 operations per ray-light test (K5): the same 45 up to t, 6 for the
# hit test, 8 for t^2/|ng.d|, fac * w, the select, the NaN check and the
# partial sum's add 4.
K5_OPS_PER_TEST = 63
# Hopper issues at most one warp instruction a clock from each of an SM's
# four schedulers: the issue floor of a kernel is its SASS instructions a
# test times its tests, over 32 lanes, 4 schedulers, the SMs and the clock.
ISSUE_PER_SM_CLOCK = 4
WARP = 32
# The most paths of one loop iteration sass_loop walks; a loop with more
# gets no count.
SASS_MAX_PATHS = 4096
# Each kernel's symbol in the ptxas report and the SASS, and the SASS
# opcode that counts the tests an iteration of the kernel's inner loop
# holds: (opcode, times in every test, more times in a test that passes
# both warp votes). The slab test issues 6 products; the triangle test one
# reciprocal; the light test one reciprocal, and a second (the weight's
# division) past both votes.
# K2, K3 and K4 are instances of culled_kernel<rays a list, every cluster,
# triangles a step>; K5 is light_kernel<rays a block, lights a step>.
KERNEL_SYMBOLS = {"K1": "mask_kernelILb0E", "K1 tmax": "mask_kernelILb1E",
                  "K2": "culled_kernelILi256ELb0ELi4E",
                  "K3": "culled_kernelILi512ELb1ELi2E",
                  "K4": "culled_kernelILi512ELb0ELi4E",
                  "K5": "light_kernelILi128ELi2E"}
SASS_MARKERS = {"K1": ("FMUL", 6, 0), "K1 tmax": ("FMUL", 6, 0),
                "K2": ("MUFU.RCP", 1, 0), "K3": ("MUFU.RCP", 1, 0),
                "K4": ("MUFU.RCP", 1, 0), "K5": ("MUFU.RCP", 1, 1)}
# Each kernel's design, a label: every kernel has had its Hopper redesign
# (csrc/intersect_kernels.cu says what each design does).
DESIGN = {"K1": "hopper-redesign", "K1 tmax": "hopper-redesign",
          "K2": "hopper-redesign", "K3": "hopper-redesign",
          "K4": "hopper-redesign", "K5": "hopper-redesign"}
# The shade kernel's modes (csrc/shade_kernels.cu) by their symbols in the
# ptxas report, and the bytes a lane of each moves through HBM at bounce 0
# and at a later bounce: bounce 0 reads the camera ray, t, the triangle
# index and six draws (56 B), a later bounce its state, t, the index,
# alive and six draws (81 B); FUSED and TAIL write the state and alive
# (49 B); HEAD writes its [n, 20] buffer and hit (81 B), which TAIL reads
# with the light pdf (85 B). Shade rows, texels and lights come from L2.
SHADE_SYMBOLS = {"fused": "_Z12shade_kernelILi0E",
                 "head": "_Z12shade_kernelILi1E",
                 "tail": "_Z12shade_kernelILi2E"}
SHADE_LANE_BYTES = {("fused", 0): 56 + 49, ("fused", 1): 81 + 49,
                    ("head", 0): 56 + 81, ("head", 1): 81 + 81,
                    ("tail", 0): 85 + 49, ("tail", 1): 85 + 49}
# The draw kernel's batches (csrc/prng_kernels.cu): name, lanes, draws a
# lane and tag: a frame's bounce-0 draws and its camera jitter, and the
# demo's bounce-1 budget of lanes in a sorted order. A lane reads its
# stream id (4 B) and writes its draws (4 B each): 28 B at n = 6, 12 B at 2.
DRAW_CASES = (("frame bounce 0", 1920 * 1080, 6, 0),
              ("bounce-1 batch", 1_899_008, 6, 1),
              ("frame jitter", 1920 * 1080, 2, 0x7E11))
DRAW_SEED = 3_000_000_019
# The list cap of traverse.sweep_lists (its default): a streamed cast's
# lists beyond it are uncapped ascending ids, the JAX package's count -1.
LIST_CAP = 256
# The demo frame of bench.py, and the timed steps after calibration.
WIDTH, HEIGHT, DEPTH = 1920, 1080, 8
STEPS = 5
# Timed steps of each path of the second slice, and the 512-ray blocks of
# the slice on which a slow plain version is compared.
PATH_STEPS = 2
SLICE_BLOCKS = 128
# name, scene, W, H, depth, spp, gate: "exact" holds every value at rtol
# 1e-3, atol 1e-4; "glossy" is the glossy-scene gate of
# tests/test_torch_render.py (below).
GOLDEN = [("cube_16x16_d2_s4", "cube", 16, 16, 2, 4, "exact"),
          ("cornell_32x32_d4_s4", "cornell", 32, 32, 4, 4, "exact"),
          ("textured_32x32_d4_s4", "textured", 32, 32, 4, 4, "glossy"),
          ("envmap_32x32_d4_s4", "envmap", 32, 32, 4, 4, "glossy")]
# The glossy-scene gate (tests/test_torch_render.py): the image mean within
# MEAN_RTOL, at least PASS_FRACTION of the values within rtol 1e-4, atol
# 1e-5, none off by more than MAX_ABS.
MEAN_RTOL, PASS_FRACTION, MAX_ABS = 1e-3, 0.95, 0.1
# Two-phase culling's K, the value the JAX package was measured at
# (ARCHITECTURE.md).
TWO_PHASE_K = 2
# The CLI path's output image, under the gitignored chiprun_out/.
CLI_PNG = ROOT / "chiprun_out" / "cli_demo.png"
# Steps of the pool path, samples a step and steps of the refill path, and
# samples of the scheduler CLI runs.
POOL_STEPS = 2
REFILL_SPP, REFILL_STEPS = 4, 2
SCHED_CLI_SPP = 2
# Timed steps of the debug path, and its CLI's depth layer and snapshot.
DEBUG_STEPS = 2
DEBUG_PNG = ROOT / "chiprun_out" / "debug_depth.png"
DEBUG_SNAP = ROOT / "chiprun_out" / "debug_snapshot.png"


class Phases:
    def __init__(self):
        self.t0 = time.perf_counter()

    def done(self, name: str, start: float, detail: str = "") -> None:
        now = time.perf_counter()
        print(f"[{name}] {now - start:.3f} s (total {now - self.t0:.1f} s)"
              + (f": {detail}" if detail else ""), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync(dev):
    """Wait for every card (a mesh's shards may run on several)."""
    import torch

    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def time_ms(fn, dev, reps: int) -> float:
    """Mean milliseconds per call: CUDA events around `reps` calls after one
    warm-up call on the card, the host clock on the CPU."""
    import torch

    fn()
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_registers(report: str) -> dict:
    """Registers a thread of each kernel, from the ptxas -v report."""
    regs, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            for k, sym in KERNEL_SYMBOLS.items():
                if sym in cur:
                    regs[k] = int(m.group(1))
            cur = None
    return regs


def cuobjdump_path():
    """The CUDA toolkit's cuobjdump, else the one Triton ships, else None."""
    cands = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
             / "cuobjdump"]
    try:
        import triton

        cands.append(Path(triton.__file__).parent / "backends" / "nvidia"
                     / "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in cands:
        if c.exists():
            return str(c)
    return shutil.which("cuobjdump")


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass_functions(text: str) -> dict:
    """{function: ([(address, instruction)], {label: address})} from
    `cuobjdump -sass` text."""
    funcs, cur, pending = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = ([], {})
            pending = []
            continue
        if cur is None:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                funcs[cur][1][lab] = addr
            pending = []
            funcs[cur][0].append((addr, m.group(2).strip()))
    return funcs


def _opcode(ins: str) -> str:
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
    return ins.split()[0] if ins else ""


def _branch_target(ins: str, labels: dict):
    if _opcode(ins).split(".")[0] != "BRA":
        return None
    m = re.search(r"`\((\.L_x_\d+)\)", ins)
    if m:
        return labels.get(m.group(1))
    hexes = re.findall(r"0x[0-9a-f]+", ins)
    return int(hexes[-1], 16) if hexes else None


def _conditional(ins: str) -> bool:
    return ((ins.startswith("@") and not ins.startswith("@PT "))
            or re.search(r"BRA\S*\s+!?U?P\d", ins) is not None)


def sass_loop(insns, labels, marker: str, per_test: int, per_full: int = 0):
    """Instructions one iteration of a kernel's inner loop issues, per test.

    The inner loop is the backward branch whose range holds the most
    `marker` instructions (the smallest such range). Every path of one
    iteration is walked from the loop head to the back edge. A branch right
    after a VOTE is a warp skip, followed both ways; `@!P BRA` skips when
    taken. Any other conditional forward branch is followed both ways,
    except where one way alone leads to a CALL (the slow path of a
    correctly rounded reciprocal or division): that way is not followed. A
    conditional branch back into an inner loop is not taken. A path's
    tests are its markers less per_full for each test that passes both
    votes (a vote pair PP), over per_test. Of the paths that run the most
    tests (every test of the iteration, not a ragged remainder), returns
    the tests an iteration holds and, per test, the instructions of the
    path
    on which every warp passes every vote (full), passes each first vote
    and skips at the second (mid), and skips at every first vote (skip).
    None when no loop holds the marker, when the walk stopped at
    SASS_MAX_PATHS paths (its counts would be partial), or when a path
    that skips more issues more (full < mid, mid < skip or full < skip:
    a walk that went wrong)."""
    index = {a: i for i, (a, _) in enumerate(insns)}
    loops = []
    for a, ins in insns:
        t = _branch_target(ins, labels)
        if t is not None and t <= a:
            marks = sum(_opcode(x) == marker for b, x in insns if t <= b <= a)
            if marks:
                loops.append((-marks, a - t, t, a))
    if not loops:
        return None
    _, _, head, tail = min(loops)
    paths = []

    def calls(i, end):
        """Whether instructions i..end (at most 200) hold a CALL."""
        return any(_opcode(x).startswith("CALL")
                   for _, x in insns[i:min(end, i + 200)])

    def block_end(i):
        for j in range(i, min(len(insns), i + 60)):
            if _opcode(insns[j][1]).startswith(("BRA", "EXIT", "RET")):
                return j + 1
        return i + 60

    def walk(i, count, marks, votes):
        while i < len(insns) and len(paths) < SASS_MAX_PATHS:
            a, ins = insns[i]
            op = _opcode(ins)
            if op != "NOP":
                count += 1
            marks += op == marker
            t = _branch_target(ins, labels)
            if t is None:
                if op.startswith(("EXIT", "RET")):
                    break
                i += 1
                continue
            if t == head or t not in index:  # the back edge ends it
                break
            if not _conditional(ins):
                i = index[t]
                continue
            if t < a:
                i += 1
                continue
            j = index[t]
            if any(_opcode(x).startswith("VOTE")
                   for _, x in insns[max(0, i - 4):i]):
                # a warp skip: both ways, whatever the passing way holds
                skip_when_taken = ins.startswith("@!")
                walk(j, count, marks, votes + ("S" if skip_when_taken
                                               else "P"))
                votes += "P" if skip_when_taken else "S"
                i += 1
                continue
            # the fall-through up to the target (inside the loop), and the
            # block at the target
            fall = calls(i + 1, j if t <= tail else block_end(i + 1))
            jump = calls(j, block_end(j))
            if fall != jump:
                i = i + 1 if jump else j
                continue
            walk(j, count, marks, votes)
            i += 1
        paths.append((count, marks, votes))

    walk(index[head], 0, 0, "")
    if len(paths) >= SASS_MAX_PATHS:
        return None
    def tests_of(marks, votes):
        passed = re.findall(r"S|P[PS]?", votes).count("PP")
        return (marks - per_full * passed) / per_test

    tests = max(tests_of(m, v) for _, m, v in paths)
    main = [(c, v) for c, m, v in paths if tests_of(m, v) == tests]

    def per(pattern):
        got = [c for c, v in main if re.fullmatch(pattern, v)]
        return max(got) / tests if got else None

    full, mid, skip = per("P*"), per("(PS)*"), per("S*")
    for more, fewer in ((full, mid), (mid, skip), (full, skip)):
        if more is not None and fewer is not None and more < fewer:
            return None
    return {"tests_per_iteration": tests, "per_test_full": full,
            "per_test_mid": mid, "per_test_skip": skip, "paths": len(paths)}


def sass_counts(so_path, dump_to=None) -> dict:
    """SASS instructions a test in each kernel's inner loop (sass_loop),
    from `cuobjdump -sass` of the built library; the SASS is written to
    `dump_to` when given. {} when no cuobjdump is found."""
    tool = cuobjdump_path()
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    if dump_to is not None:
        Path(dump_to).write_text(text)
    funcs = sass_functions(text)
    out = {}
    for k, (marker, per_test, per_full) in SASS_MARKERS.items():
        for name, (insns, labels) in funcs.items():
            if KERNEL_SYMBOLS[k] in name:
                out[k] = sass_loop(insns, labels, marker, per_test, per_full)
    return out


def sm_clock_mhz(fn, ms_each: float, dev):
    """The SM clock (MHz) nvidia-smi reads while about a second of `fn`'s
    launches runs on the card."""
    for _ in range(max(1, min(4000, int(1000 / max(ms_each, 0.25))))):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60, check=True)
    sync(dev)
    return int(out.stdout.split()[0])


def issue_floor_ms(tests: float, per_test: float, mhz: float,
                   n_sm: int) -> float:
    """Least time `tests` tests take at `per_test` SASS instructions each
    when every scheduler issues one warp instruction every clock."""
    return (tests * per_test / WARP / (ISSUE_PER_SM_CLOCK * n_sm * mhz * 1e6)
            * 1e3)


def add_floors(m: dict, sass: dict, mhz, n_sm: int) -> dict:
    """m with the issue floors of its tests at the kernel's SASS counts:
    issue_floor_ms at the full path; for a kernel with warp skips also
    issue_floor_skip_ms (every warp skips at its first vote) and, where m
    holds the warps' vote rates, issue_floor_data_ms at this batch's
    rates."""
    if not sass or mhz is None:
        return dict(m, issue_floor_ms=None)
    tests = m.get("ray_triangle_tests", m.get("ray_light_tests",
                                               m.get("tests")))
    out = dict(m, issue_floor_ms=issue_floor_ms(
        tests, sass["per_test_full"], mhz, n_sm))
    if sass["per_test_skip"] != sass["per_test_full"]:
        out["issue_floor_skip_ms"] = issue_floor_ms(
            tests, sass["per_test_skip"], mhz, n_sm)
        if "vote_rates" in m and sass["per_test_mid"] is not None:
            p1, p2 = m["vote_rates"]
            per = (sass["per_test_skip"]
                   + p1 * (sass["per_test_mid"] - sass["per_test_skip"])
                   + p2 * (sass["per_test_full"] - sass["per_test_mid"]))
            out["issue_floor_data_ms"] = issue_floor_ms(tests, per, mhz,
                                                        n_sm)
    return out


def warp_vote_rates(counts, lists, rays, rows, block, terms, inside):
    """A kernel's warp skips on this batch of `block`-ray lists over
    clusters of `rows` [n_clusters, leaf, width]: the share of (warp,
    listed row) pairs in which some ray of the warp (32 lanes, a ray each)
    has 0 <= bu <= 1 (passes the first vote) and in which some ray is
    inside (passes the second), from the plain version's own terms:
    terms(cluster rows, *ray components) gives bu, bv; inside(bu, bv)."""
    import torch

    n_clusters, leaf = rows.shape[0], rows.shape[1]
    nsb = rays.shape[1] // block
    n_of = torch.where(counts < 0, n_clusters, counts)
    pairs = v1 = v2 = 0
    chunk = max(1, (1 << 23) // (leaf * block))
    for s0 in range(0, nsb, chunk):
        s1 = min(nsb, s0 + chunk)
        r = rays[:, s0 * block:s1 * block].reshape(8, s1 - s0, 1, block)
        comps = [r[i] for i in range(6)]
        n_c = n_of[s0:s1]
        for k in range(int(n_c.max()) if s1 > s0 else 0):
            active = (k < n_c)[:, None, None]
            listed = lists[s0:s1, min(k, lists.shape[1] - 1)]
            cid = torch.where(counts[s0:s1] < 0, k,
                              torch.where(k < n_c, listed, 0)).long()
            bu, bv = terms(rows[cid], *comps)
            shape = (s1 - s0, leaf, block // WARP, WARP)
            p1 = ((bu >= 0) & (bu <= 1)).reshape(shape).any(-1) & active
            p2 = inside(bu, bv).reshape(shape).any(-1) & active
            pairs += int(active.sum()) * leaf * (block // WARP)
            v1 += int(p1.sum())
            v2 += int(p2.sum())
    return [v1 / max(pairs, 1), v2 / max(pairs, 1)]


def sweep_vote_rates(pi, counts, lists, rays, tris, block):
    """warp_vote_rates of the triangle sweep (K2, K3, K4)."""
    tri9 = tris[:, :9].reshape(tris.shape[0] // pi.LEAF, pi.LEAF, 9)
    return warp_vote_rates(
        counts, lists, rays, tri9, block,
        lambda c, *comps: pi.moller_trumbore(c, *comps)[:2],
        pi.inside_triangle)


def light_vote_rates(lc, counts, lists, rays, light_rows):
    """warp_vote_rates of K5's light test, 512-ray lists."""
    lt = light_rows.reshape(-1, lc.LEAF_L, lc.ROW_WIDTH)
    return warp_vote_rates(
        counts, lists, rays, lt, lc.pi.RB,
        lambda c, *comps: lc.light_terms(c, *comps)[:2], lc.light_inside)


def measure_k1(pi, aabb8, rays, n_bits, dev, reps, tmax_row=False,
               clock=False):
    """K1 on (aabb8, rays), with or without its tmax row: bit equality with
    the plain version, times and bound; with `clock`, the SM clock under
    its load."""
    import torch

    got = pi.cluster_masks_rows(aabb8, rays, n_bits, tmax_row=tmax_row)
    want = pi._cluster_masks_plain(aabb8, rays, n_bits, tmax_row)
    sync(dev)
    if not torch.equal(got, want):
        raise AssertionError(
            f"K1{' tmax' if tmax_row else ''} differs from its plain version "
            f"in {int((got != want).sum())} words")
    n = rays.shape[1]
    ms = time_ms(lambda: pi.cluster_masks_rows(aabb8, rays, n_bits,
                                               tmax_row=tmax_row), dev, reps)
    plain_ms = time_ms(
        lambda: pi._cluster_masks_plain(aabb8, rays, n_bits, tmax_row), dev,
        1)
    # Only the n_bits real boxes need a test: the kernel clears the bits of
    # the pad boxes whatever their slab test gives.
    nbytes = ((7 if tmax_row else 6) * 4 * n + n_bits * 8 * 4
              + got.shape[0] * 4 * n)
    per_test = K1_TMAX_OPS_PER_TEST if tmax_row else K1_OPS_PER_TEST
    b_ms, b_by = bound_ms(nbytes, per_test * n * n_bits + 3 * n)
    out = {"rays": n, "tests": n * n_bits, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": float((got.long() - want.long()).abs().max())}
    if clock and dev.type == "cuda":
        out["sm_clock_mhz"] = sm_clock_mhz(
            lambda: pi.cluster_masks_rows(aabb8, rays, n_bits,
                                          tmax_row=tmax_row), ms, dev)
    return out


def measure_sweep(pi, trav, scene, words, rays, g, n_super, dev, reps,
                  slice_blocks=None, clock=False):
    """The list sweep of `scene` on the lists the main path builds for
    (words, rays): K4 for a streamed scene, K2 otherwise. Bit equality with
    the plain version (on the `slice_blocks` 512-ray blocks mid-batch when
    given), times, the bound from this batch's list lengths and the
    warp-vote rates (on the slice when given); with `clock`, the SM clock
    under its load. For a streamed scene also K4 over the capped lists of
    the JAX package's rule (count -1 beyond LIST_CAP clusters) on the whole
    batch: its hits bit-equal to those over the uncapped lists, its time,
    and its bound from its own inputs."""
    import torch

    counts, lists = trav.sweep_lists(scene, words, rays, g, n_super)
    tris = scene.ptri
    block = pi.list_block(scene)
    kernel = (pi.intersect_stream_rows if scene.stream
              else pi.intersect_culled_rows)
    got = kernel(tris, counts, lists, rays)
    n = rays.shape[1]
    a, b = slice_of(n, slice_blocks, pi.RB)
    s_counts = counts[a // block:b // block].contiguous()
    s_lists = lists[a // block:b // block].contiguous()
    s_rays = rays[:, a:b].contiguous()
    want = pi._culled_plain(s_counts, s_lists, s_rays, tris, block)
    sync(dev)
    name = "K4" if scene.stream else "K2"
    if not torch.equal(got[:, a:b].view(torch.int32),
                       want.view(torch.int32)):
        raise AssertionError(
            f"{name} differs from its plain version in "
            f"{int((got[:, a:b] != want).sum())} values")
    n_clusters = tris.shape[0] // pi.LEAF

    def work(c, lst):
        """(clusters swept, ray-triangle tests, bound ms, bound by) of a
        sweep of lists (c, lst)."""
        swept = int(torch.where(c < 0, n_clusters, c).sum())
        nbytes = (6 * 4 * n + 8 * 4 * n + c.numel() * 4 + lst.numel() * 4
                  + tris.numel() * 4)
        tests = swept * pi.LEAF * block
        return (swept, tests) + bound_ms(nbytes, K2_OPS_PER_TEST * tests)

    swept, tests, b_ms, b_by = work(counts, lists)
    ms = time_ms(lambda: kernel(tris, counts, lists, rays), dev, reps)
    plain_ms = time_ms(
        lambda: pi._culled_plain(s_counts, s_lists, s_rays, tris, block),
        dev, 1)
    # lists beyond the cap: count -1, or a streamed cast's uncapped list
    over = (counts < 0) | ((counts > LIST_CAP) & scene.stream)
    out = {"rays": n, "hits": int((got[1] >= 0).sum()),
           "ray_triangle_tests": tests, "list_rays": block,
           "lists": counts.numel(), "list_width": lists.shape[1],
           "overflow_lists": int(over.sum()),
           "mean_list": swept / counts.numel(), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           # t is BIG on both sides of a miss
           "max_abs_err": float((got[:2, a:b] - want[:2]).abs().max())}
    if clock and dev.type == "cuda":
        out["sm_clock_mhz"] = sm_clock_mhz(
            lambda: kernel(tris, counts, lists, rays), ms, dev)
    out["vote_rates"] = sweep_vote_rates(pi, s_counts, s_lists, s_rays,
                                         tris, block)
    if b - a < n:
        out["vote_rates_on"] = "plain_slice"
        out["plain_slice"] = [a, b]
        out["slice_hits"] = int((want[1] >= 0).sum())
        out["slice_ms"] = time_ms(
            lambda: kernel(tris, s_counts, s_lists, s_rays), dev, reps)
    if scene.stream:
        long_ = counts[counts > LIST_CAP].float()
        out["overflow_mean_list"] = (float(long_.mean()) if long_.numel()
                                     else None)
        out["overflow_max_list"] = (int(long_.max()) if long_.numel()
                                    else None)
        # the JAX package's rule: count -1 beyond the cap (the kernel reads
        # no list entry of such a row)
        c0 = torch.where(counts > LIST_CAP, -1, counts)
        l0 = lists[:, :LIST_CAP].contiguous()
        got0 = kernel(tris, c0, l0, rays)
        sync(dev)
        if not torch.equal(got.view(torch.int32), got0.view(torch.int32)):
            raise AssertionError(
                f"K4 over the uncapped lists differs from K4 over the "
                f"capped lists in {int((got != got0).sum())} values")
        swept0, tests0, b0_ms, b0_by = work(c0, l0)
        out["capped"] = {
            "bit_equal": True, "overflow_lists": int((c0 < 0).sum()),
            "mean_list": swept0 / c0.numel(), "ray_triangle_tests": tests0,
            "ms": time_ms(lambda: kernel(tris, c0, l0, rays), dev,
                          max(2, reps // 4)),
            "bound_ms": b0_ms, "bound_by": b0_by}
    return out


def slice_of(n, blocks, rb):
    """Lanes [a, b) of the `blocks` 512-ray blocks in the middle of an
    n-lane batch (all of it when blocks is None or covers it): the middle
    of a frame's tile order is the scene, its first rows sky."""
    if blocks is None or blocks * rb >= n:
        return 0, n
    a = (n // rb - blocks) // 2 * rb
    return a, a + blocks * rb


def measure_k3(pi, scene, rays, dev, reps, slice_blocks, clock=False):
    """K3 on `rays`: bit equality with the plain version on the
    `slice_blocks` blocks mid-batch, times, bound (every cluster for every
    ray) and the warp-vote rates on the slice; with `clock`, the SM clock
    under its load."""
    import torch

    tris = scene.ptri
    got = pi.intersect_brute_rows(tris, rays)
    a, b = slice_of(rays.shape[1], slice_blocks, pi.RB)
    s_rays = rays[:, a:b].contiguous()
    want = pi._brute_plain(s_rays, tris)
    sync(dev)
    if not torch.equal(got[:, a:b].view(torch.int32),
                       want.view(torch.int32)):
        raise AssertionError(
            f"K3 differs from its plain version in "
            f"{int((got[:, a:b] != want).sum())} values")
    n = rays.shape[1]
    ms = time_ms(lambda: pi.intersect_brute_rows(tris, rays), dev, reps)
    slice_ms = time_ms(lambda: pi.intersect_brute_rows(tris, s_rays), dev,
                       reps)
    plain_ms = time_ms(lambda: pi._brute_plain(s_rays, tris), dev, 1)
    tests = n * tris.shape[0]
    b_ms, b_by = bound_ms(6 * 4 * n + 8 * 4 * n + tris.numel() * 4,
                          K2_OPS_PER_TEST * tests)
    nb = s_rays.shape[1] // pi.RB
    every = torch.full((nb,), -1, dtype=torch.int32, device=rays.device)
    out = {"rays": n, "hits": int((got[1] >= 0).sum()),
           "ray_triangle_tests": tests, "ms": ms, "slice_ms": slice_ms,
           "plain_ms": plain_ms, "plain_slice": [a, b],
           "slice_hits": int((want[1] >= 0).sum()),
           "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": float((got[:2, a:b] - want[:2]).abs().max()),
           "vote_rates": sweep_vote_rates(pi, every, every[:, None],
                                          s_rays, tris, pi.RB),
           "vote_rates_on": "plain_slice"}
    if clock and dev.type == "cuda":
        out["sm_clock_mhz"] = sm_clock_mhz(
            lambda: pi.intersect_brute_rows(tris, rays), ms, dev)
    return out


def measure_k5(lc, scene, o, d, dev, reps, slice_blocks=None,
               clock=False):
    """K5 on the light lists of shading points o and directions d [N, 3]:
    bit equality with the plain version, times and bound from this batch's
    lists, the warps' vote rates, all on the whole batch; and the culled
    pdf against the dense sum (the reference semantics) on the read lanes
    of slice_blocks / 2 blocks mid-batch (equal finiteness, rtol 2e-4,
    atol 1e-6), or with no slice_blocks on the whole batch (edge_flips);
    with `clock`, the SM
    clock under its load."""
    import torch

    from raytracer_odin_tpu_torch.ops import shading

    counts, lists, rays, n = lc.light_lists(scene, o, d)
    lr = scene.light_rows
    got = lc.light_sums_rows(lr, counts, lists, rays)
    want = lc._light_sums_plain(counts, lists, rays, lr)
    sync(dev)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(
            f"K5 differs from its plain version in "
            f"{int((got != want).sum())} values")
    ms = time_ms(lambda: lc.light_sums_rows(lr, counts, lists, rays), dev,
                 reps)
    plain_ms = time_ms(
        lambda: lc._light_sums_plain(counts, lists, rays, lr), dev, 1)
    swept, tests, b_ms, b_by = k5_work(lc, counts, lists, rays, lr)
    rb = lc.pi.RB
    out = {"rays": n, "lists": counts.numel(),
           "overflow_lists": int((counts < 0).sum()),
           "mean_list": swept / counts.numel(), "ray_light_tests": tests,
           "nonzero": int((got[:n] > 0).sum()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": float((got - want).abs().max()),
           "vote_rates": light_vote_rates(lc, counts, lists, rays, lr),
           "vote_rates_on": "whole_batch"}
    if clock and dev.type == "cuda":
        out["sm_clock_mhz"] = sm_clock_mhz(
            lambda: lc.light_sums_rows(lr, counts, lists, rays), ms, dev)
    # reference: the dense sum over every light, on the lanes whose sum is
    # read (finite, not a missed ray's far point: light_lists' rule)
    a, b = slice_of(n, None if slice_blocks is None else slice_blocks // 2,
                    rb)
    so, sd = o[a:b], d[a:b]
    culled = lc.light_pdf_sum_culled(scene, so, sd)
    dense = shading.light_pdf_sum(scene, so, sd)
    c, r, read = read_lanes(lc, so, sd, culled, dense)
    if not bool((r > 0).any()):
        raise AssertionError("the dense-sum check saw no lit lane")
    if slice_blocks is not None:
        fin = torch.isfinite(r)
        if not (torch.equal(fin, torch.isfinite(c))
                and torch.allclose(c[fin], r[fin], rtol=2e-4, atol=1e-6)):
            raise AssertionError("culled light pdf differs from the dense "
                                 "sum")
    else:
        out["dense_check_edge_flips"] = edge_flips(lc, scene, so, sd,
                                                   culled, dense)
    return dict(out, dense_check_lanes=int(read.sum()),
                dense_check_nonzero=int((r > 0).sum()))


def k5_work(lc, counts, lists, rays, lr):
    """(clusters swept, ray-light tests, bound ms, bound by) of K5 on
    (counts, lists, rays) over light rows lr: each input read once, the sums
    written once, K5_OPS_PER_TEST a test of what these lists sweep."""
    import torch

    n_clusters = lr.shape[0] // lc.LEAF_L
    swept = int(torch.where(counts < 0, n_clusters, counts).sum())
    npad = rays.shape[1]
    tests = swept * lc.LEAF_L * lc.pi.RB
    nbytes = (6 * 4 * npad + 4 * npad + counts.numel() * 4
              + lists.numel() * 4 + lr.numel() * 4)
    return (swept, tests) + bound_ms(nbytes, K5_OPS_PER_TEST * tests)


def read_lanes(lc, o, d, *sums):
    """Each of `sums` on the lanes whose light pdf is read (finite, not a
    missed ray's far point: light_lists' rule), and the mask of them."""
    import torch

    read = (torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
            & (o.abs().amax(-1) < lc.FAR))
    return tuple(x[read] for x in sums) + (read,)


def light_pdf_inputs(lc, step, scene, stats, key, sample, dev):
    """One more render step with light_cull.light_pdf_sum_culled recording
    its inputs: (o, d) of each bounce's call, in order. Kernel wrappers
    and their counts are untouched."""
    real = lc.light_pdf_sum_culled
    seen = []

    def record(scene_, o, d, cap=lc.LIST_CAP):
        seen.append((o.clone(), d.clone()))
        return real(scene_, o, d, cap)

    lc.light_pdf_sum_culled = record
    try:
        step(scene, stats, key, sample)
        sync(dev)
    finally:
        lc.light_pdf_sum_culled = real
    return seen


# A light whose hit decision differs between the culled and the dense
# light pdf must sit on a triangle edge: a barycentric within EDGE of 0, or
# bu + bv within EDGE of 1, in both arithmetics.
EDGE = 1e-4


def edge_flips(lc, scene, o, d, culled, dense, limit=4096) -> int:
    """How many read lanes hold a culled pdf (K5's arithmetic, the JAX
    package's kernel order) and a dense sum (shading.light_pdf_sum, dots as
    reductions) that differ beyond rtol 2e-4, atol 1e-6; each must be
    explained by lights on a triangle edge, hit in one arithmetic and not
    in the other (a ray through the shared edge of a quad's two triangles
    counts for both, or for one): per such lane, every light whose hit
    decision differs lies within EDGE of an edge in both, the recomputed
    sums are the lane's, and the sums over the other lights agree within
    the tolerance. Raises for a lane not so explained."""
    import torch

    from raytracer_odin_tpu_torch.ops import shading
    from raytracer_odin_tpu_torch.ops.geometry import RAY_EPS

    c, r, read = read_lanes(lc, o, d, culled, dense)
    fin = torch.isfinite(r)
    if not torch.equal(fin, torch.isfinite(c)):
        raise AssertionError("culled and dense light pdf: finiteness differs")
    bad = torch.nonzero(~torch.isclose(c, r, rtol=2e-4, atol=1e-6)
                        & fin).flatten()
    if bad.numel() > limit:
        raise AssertionError(f"culled and dense light pdf differ on "
                             f"{bad.numel()} lanes")
    if bad.numel() == 0:
        return 0
    lanes = torch.nonzero(read).flatten()[bad]
    oo, dd = o[lanes] + d[lanes] * RAY_EPS, d[lanes]
    n_lights = scene.light_p.shape[0]
    bu_d, bv_d, con_d = shading.light_pdf_terms(scene, oo, dd, 0, n_lights)
    bu_k, bv_k, con_k = (x[:n_lights].T for x in lc.light_terms(
        scene.light_rows, *(x[None, :] for x in (*oo.T, *dd.T))))

    def on_edge(bu, bv):
        return ((bu.abs() <= EDGE) | (bv.abs() <= EDGE)
                | ((bu + bv - 1).abs() <= EDGE))

    flip = (con_k != 0) != (con_d != 0)
    k64, d64 = con_k.double(), con_d.double()

    def close(x, y):
        return bool(torch.isclose(x, y, rtol=2e-4, atol=1e-6 * n_lights)
                    .all())

    if not (bool(flip.any(-1).all())
            and bool((on_edge(bu_k, bv_k) & on_edge(bu_d, bv_d))[flip].all())
            and close(k64.sum(-1), c[bad].double() * n_lights)
            and close(d64.sum(-1), r[bad].double() * n_lights)
            and close(torch.where(flip, 0.0, k64).sum(-1),
                      torch.where(flip, 0.0, d64).sum(-1))):
        raise AssertionError(
            f"culled and dense light pdf differ on {bad.numel()} lanes, "
            "not all by lights on a triangle edge")
    return bad.numel()


def dense_pdf_check(lc, scene, o, d, dev, reps):
    """The dense light pdf (shading.light_pdf_sum, the path below
    light_cull.threshold() lights) on a full-frame shading batch, in its
    lane steps
    (shading.pdf_lanes) and all lanes at once: each one's time and peak
    device memory above what was allocated before it, the two bit-equal;
    the culled pdf (light lists and K5) on the same lanes: its time, K5's
    alone, and its values against the dense sum's on the read lanes
    (rtol 2e-4, but for the lanes edge_flips explains)."""
    import torch

    from raytracer_odin_tpu_torch.ops import shading

    cuda = dev.type == "cuda"

    def run(lanes):
        sync(dev)
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        out = shading.light_pdf_sum(scene, o, d, lanes=lanes)
        sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base if cuda else 0
        ms = time_ms(lambda: shading.light_pdf_sum(scene, o, d, lanes=lanes),
                     dev, 2)
        return out, peak / 2**30, ms

    step = shading.pdf_lanes(scene.light_p.shape[0])
    dense, peak, dense_ms = run(step)
    whole, whole_peak, whole_ms = run(o.shape[0])
    if not torch.equal(dense.view(torch.int32), whole.view(torch.int32)):
        raise AssertionError("dense pdf: the lane steps change the sums")
    del whole
    culled = lc.light_pdf_sum_culled(scene, o, d)
    c, r, read = read_lanes(lc, o, d, culled, dense)
    if not bool((r > 0).any()):
        raise AssertionError("dense pdf: no lit lane")
    flips = edge_flips(lc, scene, o, d, culled, dense)
    counts, lists, rays, _ = lc.light_lists(scene, o, d)
    lr = scene.light_rows
    _, k5_tests, k5_bound, k5_by = k5_work(lc, counts, lists, rays, lr)
    return {
        "lanes": o.shape[0], "lights": scene.light_p.shape[0],
        "read_lanes": int(read.sum()), "nonzero": int((r > 0).sum()),
        "edge_flip_lanes": flips, "dense_ms": dense_ms,
        "dense_peak_gib": peak, "dense_lane_step": step,
        "whole_batch_ms": whole_ms, "whole_batch_peak_gib": whole_peak,
        "card_gib": (torch.cuda.get_device_properties(dev).total_memory
                     / 2**30 if cuda else None),
        "culled_ms": time_ms(lambda: lc.light_pdf_sum_culled(scene, o, d),
                             dev, 2),
        "k5_ms": time_ms(lambda: lc.light_sums_rows(lr, counts, lists, rays),
                         dev, reps),
        "k5_ray_light_tests": k5_tests, "k5_bound_ms": k5_bound,
        "k5_bound_by": k5_by,
        "mean_list": float(torch.where(counts < 0, lr.shape[0] // lc.LEAF_L,
                                       counts).float().mean()),
        "lists": counts.numel()}


def ptxas_shade(report: str) -> dict:
    """Registers a thread, stack frame and spill bytes of each shade kernel
    mode, from the ptxas -v report."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = next((k for k, sym in SHADE_SYMBOLS.items()
                        if m.group(1).startswith(sym)), None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
            cur = None
    return out


def graph_ms(fn, dev, reps: int) -> float:
    """Device milliseconds a call of fn: `reps` calls captured into one
    CUDA graph after an eager warm-up, its replay timed by CUDA events, so
    the host's enqueue stays out, as it does for the main path's graphed
    segments; time_ms on the CPU."""
    import torch

    if dev.type != "cuda":
        return time_ms(fn, dev, reps)
    fn()
    sync(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def shade_batches(rt, integ, trav, prng, scene, cfg, fov_x, dev):
    """The shade kernel's inputs in the calibration sample of `cfg`, built
    by the main path's own functions: bounce 0's (the camera rays, their
    hits and draws) and bounce 1's (bounce 0's lane state sorted and cut
    to bounce 1's lane budget from auto_lane_schedule, as the compacted
    trace does, with the hits of its rays, its alive mask and draws)."""
    import torch

    key = prng.key_from_seed(cfg.seed)
    o, d = rt.camera_rays(scene, key, 0, fov_x, cfg.width, cfg.height)
    t, idx = trav.cast_rays(scene, o, d, intersector="pallas", sort=False)
    sids = torch.arange(o.shape[:-1].numel(), dtype=torch.int32,
                        device=dev).reshape(o.shape[:-1])
    first = (o, d, t, idx, prng.uniforms(key, 0, 0, sids, 6))
    state, alive = integ.first_segment(scene, *first, 256)
    budget = rt.auto_lane_schedule(scene, cfg, fov_x, device=dev)[0]
    _g, n_super, aabb8 = trav.exact_cull_layout(scene)
    n_alive = alive.sum()
    state, _perm, rays, words = integ.sort_lanes(state.clone(), alive,
                                                 aabb8, n_super, budget)
    width = rays.shape[1]
    state = state[:width].contiguous()
    t1, idx1 = trav.cast_presorted_rows(scene, rays, words)
    alive1 = torch.arange(width, device=dev) < n_alive
    u1 = prng.uniforms(key, 0, 1, torch.arange(width, dtype=torch.int32,
                                               device=dev), 6)
    return first, (state, t1, idx1, alive1, u1)


def shade_differ(got, want) -> tuple:
    """(elements that differ, largest finite difference) of two output
    tuples: floats by value (a NaN equal to a NaN), the rest exactly; a
    flat output is compared in the other's shape."""
    import torch

    n, err = 0, 0.0
    for g, w in zip(got, want, strict=True):
        g = g.reshape(w.shape)
        if g.dtype != w.dtype:
            raise AssertionError(f"shade: dtype {g.dtype} against {w.dtype}")
        if w.dtype.is_floating_point:
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            fin = torch.isfinite(g) & torch.isfinite(w)
            if bool(fin.any()):
                err = max(err, float((g[fin] - w[fin]).abs().max()))
        else:
            same = g == w
        n += int((~same).sum())
    return n, err


def measure_shade(integ, lc, sk, scene, bounce: int, ins, dev, reps):
    """The shade kernel against its plain version (the row layout's
    PyTorch, with the kernel's engagement patched off) on one batch of
    bounce 0 or a later bounce, exactly: alive bit for bit, floats equal.
    On the dense light path the segment is one FUSED launch; on the culled
    path HEAD against the plain head and TAIL against the plain tail, each
    given the same light pdf, then the whole segment. A mode's device ms a
    call and its plain version's (graph_ms), its bound (SHADE_LANE_BYTES
    at the HBM peak) and its launches a call."""
    seg = integ.first_segment if bounce == 0 else integ.later_segment
    head, tail = seg.halves
    lanes = ins[2].numel()

    def plain(fn):
        def call():
            with setting(sk, "engages", lambda device: False):
                return fn()
        return call

    if lc.serves(scene):
        h = head(scene, *ins, 256)
        hp = plain(lambda: head(scene, *ins, 256))()
        pl = lc.light_pdf_sum_culled(scene, h[0], h[1])
        pl_p = pl.reshape(hp[2].shape)
        modes = {"head": (lambda: head(scene, *ins, 256),
                          plain(lambda: head(scene, *ins, 256))),
                 "tail": (lambda: tail(scene, *h, pl, 256),
                          plain(lambda: tail(scene, *hp, pl_p, 256)))}
    else:
        modes = {"fused": (lambda: seg(scene, *ins, 256),
                           plain(lambda: seg(scene, *ins, 256)))}
    modes["segment"] = (lambda: seg(scene, *ins, 256),
                        plain(lambda: seg(scene, *ins, 256)))
    out = {"lanes": lanes}
    for mode, (kern, ref) in modes.items():
        before = sk.launch.launches
        got = kern()
        launches = sk.launch.launches - before
        n, err = shade_differ(got, ref())
        if n:
            raise AssertionError(f"shade kernel {mode}, bounce {bounce}: "
                                 f"{n} elements differ from the plain "
                                 f"version (largest {err})")
        m = {"launches": launches, "max_abs_err": err}
        if mode != "segment":
            bound, by = bound_ms(lanes * SHADE_LANE_BYTES[mode, min(bounce,
                                                                    1)], 0.0)
            m.update(ms=graph_ms(kern, dev, reps),
                     plain_ms=graph_ms(ref, dev, max(2, reps // 4)),
                     bound_ms=bound, bound_by=by,
                     lane_bytes=SHADE_LANE_BYTES[mode, min(bounce, 1)])
        out[mode] = m
    return out


def plain_launches(fn, dev) -> int:
    """Device kernels one call of fn launches, counted by torch.profiler
    (copies and memsets left out, as the benchmark counts kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return 0
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


def host_us(fn, dev, reps: int) -> float:
    """Host microseconds a call of fn: `reps` calls back to back after a
    warm-up, the card drained before and after (the enqueue alone while
    the card keeps up)."""
    fn()
    sync(dev)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) * 1e6 / reps
    sync(dev)
    return us


def measure_draws(prng, dk, dev, reps, scale: int = 1):
    """The draw kernel against the plain chain (utils/prng.plain_cols) on
    DRAW_CASES (lanes / scale), bit for bit: one launch a call; the
    kernel's device ms a launch (CUDA events over launches of prepared
    arguments), the plain chain's (graph_ms) and its launches a call, the
    host us a call of each, and the bound of the bytes a lane moves."""
    import torch

    key = prng.key_from_seed(DRAW_SEED)
    gen = torch.Generator().manual_seed(DRAW_SEED)
    out = {}
    for name, lanes, n, tag in DRAW_CASES:
        lanes //= scale
        if name.startswith("frame"):
            sids = torch.arange(lanes, dtype=torch.int32)
        else:
            sids = torch.randperm(2 * lanes, generator=gen)[:lanes].to(
                torch.int32)
        sids = sids.to(dev)

        def call():
            return prng.uniforms(key, 7, tag, sids, n)

        def plain():
            return torch.stack(prng.plain_cols(key, 7, tag, sids, n), -1)

        before = dk.launch.launches
        got = call()
        launches = dk.launch.launches - before
        cols = torch.stack(prng.uniforms_cols(key, 7, tag, sids, n), -1)
        want = plain()
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum()
                     + (cols.view(torch.int32)
                        != want.view(torch.int32)).sum())
        if differ or (dev.type == "cuda" and launches != 1):
            raise AssertionError(f"draw kernel, {name}: {differ} draws "
                                 f"differ from the plain chain, "
                                 f"{launches} launches")
        bound, by = bound_ms(lanes * (4 + 4 * n), 0.0)
        m = {"lanes": lanes, "n": n, "launches": launches, "differ": 0,
             "bound_ms": bound, "bound_by": by, "lane_bytes": 4 + 4 * n,
             "plain_ms": graph_ms(plain, dev, max(2, reps // 4)),
             "plain_launches": plain_launches(plain, dev),
             "host_us": host_us(call, dev, reps),
             "plain_host_us": host_us(plain, dev, max(2, reps // 4))}
        if dev.type == "cuda":
            args, _out, _keep = dk.prepare(key, 7, tag, sids, n, False)
            stream = torch.cuda.current_stream(dev).cuda_stream
            m["ms"] = time_ms(lambda: dk.launch(args, stream), dev, reps)
            m["share_of_bound"] = bound / m["ms"]
        out[name] = m
    return out


def kernel_batches(rt, integ, trav, prng, pi, scene, cfg, fov_x, dev):
    """The kernels' inputs in the calibration sample of `cfg`, built by the
    main path's own functions: the bounce-0 camera rays in tile order with
    their masks, the bounce-0 shading points and sampled directions (the
    light pdf's inputs), and the sorted bounce-1 batch cut to the lane
    budget that auto_lane_schedule gives it, with its masks."""
    budget = rt.auto_lane_schedule(scene, cfg, fov_x, device=dev)[0]
    key = prng.key_from_seed(cfg.seed)
    o, d = rt.camera_rays(scene, key, 0, fov_x, cfg.width, cfg.height)
    g, n_super, aabb8 = trav.exact_cull_layout(scene)
    rays0, _ = trav.tiled_rows(o + d * trav.RAY_EPS, d)
    words0 = pi.cluster_masks_rows(aabb8, rays0, n_super)
    state, alive = integ.first_bounce(scene, o, d, key, 0)
    n0 = cfg.width * cfg.height
    shade_o = state[:n0, 0:3].clone()
    shade_d = state[:n0, 3:6].clone()
    n_alive = int(alive.sum())
    _, _, rays1, words1 = integ.sort_lanes(state, alive, aabb8, n_super,
                                           budget)
    return {"rays0": rays0, "words0": words0, "rays1": rays1,
            "words1": words1, "aabb8": aabb8, "g": g, "n_super": n_super,
            "n_alive1": n_alive, "shade_o": shade_o, "shade_d": shade_d}


def launch_counters(pi, lc):
    """Each kernel's launch count: (wrapper, attribute). K1's launches with
    its tmax row are counted apart."""
    return {"K1": (pi.cluster_masks_rows, "launches"),
            "K1 tmax": (pi.cluster_masks_rows, "tmax_launches"),
            "K2": (pi.intersect_culled_rows, "launches"),
            "K3": (pi.intersect_brute_rows, "launches"),
            "K4": (pi.intersect_stream_rows, "launches"),
            "K5": (lc.light_sums_rows, "launches")}


def read_counts(counters):
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def reset_counts(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def render_path(rt, scene, cfg, fov_x, dev, counters, steps, make_step=None,
                make_stats=None):
    """render_scene with every kernel's launch count set to 0 just before
    and read after each step. Returns the result with the launches of each
    step (differences between steps), of calibration (the count after step
    1 less one step's), step times, Mrays/s and peak device memory.
    make_step: builds the render's step_fn after the counts are reset (a
    sharded step calibrates as it is built), with make_stats its
    accumulator; the step is returned under "step"."""
    import torch

    reset_counts(counters)
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)
    step_end = []
    # the launch counts after each step: calibration plus steps so far
    step_counts = []

    def on_step(_stats, _done):
        sync(dev)
        step_end.append(time.perf_counter())
        step_counts.append(read_counts(counters))

    t_cal = time.perf_counter()
    step = make_step() if make_step is not None else None
    res = rt.render_scene(scene, cfg, fov_x, device=dev, on_step=on_step,
                          step_fn=step, make_stats=make_stats)
    launches = read_counts(counters)
    if len(step_counts) != steps:
        raise AssertionError(f"{len(step_counts)} steps ran, not {steps}")
    per_step = {k: sorted({b[k] - a[k]
                           for a, b in zip(step_counts, step_counts[1:])})
                for k in counters}
    calibration = {k: step_counts[0][k] - (per_step[k] or [0])[0]
                   for k in counters}
    peak = (max(torch.cuda.max_memory_allocated(i)
                for i in range(torch.cuda.device_count()))
            if dev.type == "cuda" else 0)
    seconds = sum(res.trial_seconds)
    trial_start = step_end[-1] - seconds
    step_s = [b - a for a, b in zip([trial_start] + step_end[:-1], step_end)]
    return {"res": res, "launches": launches, "per_step": per_step,
            "calibration": calibration, "calibration_s": trial_start - t_cal,
            "step_s": step_s, "mrays": res.rays_cast / seconds / 1e6,
            "peak_gib": peak / 2**30, "step": step}


def print_render(r, steps, card):
    res = r["res"]
    print(f"  schedule {res.lane_schedule}", flush=True)
    print(f"  alive_counts (summed over {steps} samples) "
          f"{list(res.alive_counts)}", flush=True)
    print(f"  overflow {res.overflow}; rays_cast {res.rays_cast}; "
          f"calibration {r['calibration_s']:.4f} s; {steps} steps in "
          f"{sum(res.trial_seconds):.4f} s, each "
          f"{[round(x, 4) for x in r['step_s']]}", flush=True)
    print(f"  Mrays/s {r['mrays']:.3f} over the {steps} steps "
          f"({card}); peak device memory {r['peak_gib']:.3f} GiB",
          flush=True)
    print(f"  launches {r['launches']}; per step {r['per_step']}; in "
          f"calibration {r['calibration']}", flush=True)


def check_launches(name, r, want_step, want_cal, rehearsal):
    """Each kernel launched exactly want_step[k] times in every step and
    want_cal[k] times in calibration (0 for the kernels off the path)."""
    if rehearsal:
        return
    for k in r["per_step"]:
        step = r["per_step"][k] or [0]
        if step != [want_step.get(k, 0)] or (
                r["calibration"][k] != want_cal.get(k, 0)):
            raise AssertionError(
                f"{name}: {k} launched {r['per_step'][k]} times per step "
                f"and {r['calibration'][k]} in calibration, want "
                f"{want_step.get(k, 0)} and {want_cal.get(k, 0)}")


def check_frame(res, h, w):
    import torch

    img = res.stats.total[0] / res.stats.count[0][..., None]
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("render is not a finite frame of the right "
                             "shape")
    return float(img.mean())


def sweep_census(trav, step, scene, stats, key, sample, dev):
    """One more render step with traverse.sweep_lists recording the lists
    it builds: per cast, the lists, those beyond LIST_CAP clusters, the
    mean clusters a list sweeps, the mean and the longest uncapped length
    of the lists beyond the cap (None where there is none), and the mean a
    list would sweep under the capped rule (count -1: every cluster).
    Kernel wrappers and their counts are untouched."""
    import torch

    real = trav.sweep_lists
    seen = []

    def record(scene_, words, rays, g, n_super, cap=LIST_CAP):
        counts, lists = real(scene_, words, rays, g, n_super, cap)
        nc = scene_.cluster_lo.shape[0]
        over = (counts < 0) | (counts > cap)
        swept = torch.where(counts < 0, nc, counts).float()
        long_ = swept[over]
        seen.append((counts.numel(), int(over.sum()), float(swept.mean()),
                     float(long_.mean()) if long_.numel() else None,
                     int(long_.max()) if long_.numel() else None,
                     float(torch.where(over, nc, swept).mean())))
        return counts, lists

    trav.sweep_lists = record
    try:
        step(scene, stats, key, sample)
        sync(dev)
    finally:
        trav.sweep_lists = real
    return seen


def sweep_instance(name: str) -> str:
    """The profile bucket of a sweep kernel from its (lower-case) name:
    culled_kernel<256, false, ...> is K2, <512, false, ...> K4,
    <512, true, ...> K3."""
    m = (re.search(r"culled_kernel<(\d+), (true|false),", name)
         or re.search(r"culled_kernelili(\d+)elb([01])e", name))
    if m is None:
        return "sweep (other)"
    every = m.group(2) in ("true", "1")
    return ("K3 brute" if every else "K2 sweep" if m.group(1) == "256"
            else "K4 stream")


def profile_step(rt, stats, scene, cfg, fov_x, schedule, dev, name,
                 step=None):
    """Two more render steps into `stats`, the second under torch.profiler:
    device time by kernel (top rows printed, the whole table written next
    to the render as profile_<name>.txt) and the device's busy share of
    the step's wall time. step: the step to trace (default: the batched
    step with `schedule`)."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_odin_tpu_torch.utils import prng

    if step is None:
        step = rt.make_render_step(cfg, fov_x, lane_schedule=schedule,
                                   device=dev)
    key = prng.key_from_seed(cfg.seed)
    step(scene, stats, key, 1000)  # warm-up outside the trace
    sync(dev)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        step(scene, stats, key, 1001)
        sync(dev)
        wall = time.perf_counter() - t
    ka = prof.key_averages()
    (OUT_DIR / f"profile_{name}.txt").write_text(ka.table(
        sort_by="self_device_time_total" if dev.type == "cuda"
        else "self_cpu_time_total", row_limit=60))
    from torch.autograd import DeviceType

    kern = [e for e in ka
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kern)
    buckets = {}
    for e in kern:
        name = e.key.lower()
        b = ("K1 mask" if "mask_kernel" in name
             else sweep_instance(name) if "culled_kernel" in name
             else "K5 light" if "light_kernel" in name
             else "sort" if ("sort" in name or "radix" in name)
             else "gather/scatter" if ("index" in name or "gather" in name
                                       or "scatter" in name)
             else "reduce" if "reduce" in name
             else "copy" if ("copy" in name or "cat" in name)
             else "elementwise" if "elementwise" in name
             else "other")
        t, c = buckets.get(b, (0.0, 0))
        buckets[b] = (t + e.self_device_time_total, c + e.count)
    for b, (t, c) in sorted(buckets.items(), key=lambda kv: -kv[1][0]):
        print(f"  {b:15s} {t / 1e3:9.3f} ms  {c:6d} kernels  "
              f"{t / max(device_us, 1e-9):.3f} of device time", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{e.key[:110]}", flush=True)
    busy = device_us / 1e6 / wall if wall > 0 else 0.0
    print(f"  traced step wall {wall * 1e3:.3f} ms; "
          f"{sum(c for _, c in buckets.values())} device kernels; device time "
          f"{device_us / 1e3:.3f} ms ("
          + ("not measured on the CPU" if dev.type != "cuda"
             else f"device busy share {busy:.3f}") + ")", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at a tiny size; never "
                         "prints the ok line")
    ap.add_argument("--profile", action="store_true",
                    help="after each path's checks, trace one more render "
                         "step with torch.profiler and print where its "
                         "device time goes")
    args = ap.parse_args(argv)

    try:
        import torch

        import raytracer_odin_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    rehearsal = args.cpu_rehearsal
    if rehearsal:
        dev = torch.device("cpu")
        w, h, steps, path_steps, reps = 64, 36, 2, 2, 2
        slice_blocks = 2
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        dev = torch.device("cuda", 0)
        w, h, steps, path_steps, reps = WIDTH, HEIGHT, STEPS, PATH_STEPS, 20
        slice_blocks = SLICE_BLOCKS

    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.io import gltf, native
    from raytracer_odin_tpu_torch.models import assets, build
    from raytracer_odin_tpu_torch.ops import cuda_build
    from raytracer_odin_tpu_torch.ops import integrator as integ
    from raytracer_odin_tpu_torch.ops import light_cull as lc
    from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
    from raytracer_odin_tpu_torch.ops import prng_kernel as dk
    from raytracer_odin_tpu_torch.ops import shade_kernel as sk
    from raytracer_odin_tpu_torch.ops import traverse as trav
    from raytracer_odin_tpu_torch.render import output
    from raytracer_odin_tpu_torch.render import runtime as rt
    from raytracer_odin_tpu_torch.utils import prng

    if trav.TWO_PHASE_K or integ.COLS:
        raise AssertionError("run without RT_TPU_TWO_PHASE and RT_TPU_COLS: "
                             "the paths set two-phase culling and the "
                             "columnar trace themselves")

    ph = Phases()
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    # 1. card
    s = time.perf_counter()
    card = "cpu rehearsal" if rehearsal else card_line()
    print(card, flush=True)
    ph.done("card", s)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on after importing the port")

    # 2. build: nvcc and g++ start together
    s = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host_build = pool.submit(native.load)
        report = "skipped (no nvcc in a CPU rehearsal)"
        if not rehearsal:
            report = cuda_build.build()
            cuda_build.load()
        host_build.result()  # raises if g++ failed
    print(report.strip(), flush=True)
    regs = ptxas_registers(report)
    shade_ptxas = ptxas_shade(report)
    sass = {}
    if not rehearsal:
        sass = sass_counts(cuda_build._SO, OUT_DIR / "sass.txt")
    print(f"  registers a thread {json.dumps(regs)}", flush=True)
    print(f"  shade kernel modes {json.dumps(shade_ptxas)}", flush=True)
    print(f"  SASS inner loops {json.dumps(sass)}", flush=True)
    ph.done("build", s)

    # 3. scene
    s = time.perf_counter()
    scene_dir = tempfile.mkdtemp(prefix="chip_smoke_scenes_")
    demo_gltf = assets.generate("demo", scene_dir)["gltf"]
    host = gltf.read_gltf(demo_gltf)
    scene = build.finish_scene(host, device=dev)
    fov_x = host.cam.fov_x * (WIDTH / HEIGHT)  # as bench.py sets it
    sync(dev)
    ph.done("scene", s, f"{scene.num_triangles} triangles, "
            f"{scene.cluster_lo.shape[0]} clusters, {scene.num_lights} lights")

    cfg = RenderConfig(width=w, height=h, ray_depth=DEPTH, samples=steps,
                       samples_per_step=1, seed=0,
                       intersector="pallas", compact="auto")

    # 4. kernel checks at the main path's shapes
    s = time.perf_counter()
    kb = kernel_batches(rt, integ, trav, prng, pi, scene, cfg, fov_x, dev)
    rays0, rays1 = kb["rays0"], kb["rays1"]
    k1_b0 = measure_k1(pi, kb["aabb8"], rays0, kb["n_super"], dev, reps)
    k1_b1 = measure_k1(pi, kb["aabb8"], rays1, kb["n_super"], dev, reps,
                       clock=True)
    k2_b0 = measure_sweep(pi, trav, scene, kb["words0"], rays0, kb["g"],
                          kb["n_super"], dev, reps)
    k2_b1 = measure_sweep(pi, trav, scene, kb["words1"], rays1, kb["g"],
                          kb["n_super"], dev, reps, clock=True)
    for name, m in (("K1 bounce 0", k1_b0), ("K1 bounce 1", k1_b1),
                    ("K2 bounce 0", k2_b0), ("K2 bounce 1", k2_b1)):
        print(f"  {name}: {json.dumps(m)}", flush=True)
    if not rehearsal and rays1.shape[1] < 128 * 1024:
        raise AssertionError(f"bounce-1 batch has {rays1.shape[1]} rays")
    ph.done("kernels", s, f"bit-equal; bounce-1 batch {rays1.shape[1]} rays "
            f"({kb['n_alive1']} alive)")

    # 5. render: the main path, launches counted from zero; the shade
    # kernel's too (its replays in the segment graphs, one a bounce; none
    # in calibration, which shades uncompacted in PyTorch)
    s = time.perf_counter()
    counters = launch_counters(pi, lc)
    with_shade = dict(counters, shade=(sk.launch, "launches"),
                      draw=(dk.launch, "launches"))
    demo = render_path(rt, scene, cfg, fov_x, dev, with_shade, steps)
    res = demo["res"]
    print_render(demo, steps, card)
    if res.overflow != 0 or res.lane_schedule is None:
        raise AssertionError(f"compaction overflow {res.overflow}: the "
                             "render fell back to uncompacted")
    # the draw kernel: the jitter and one call a bounce, in every sample
    check_launches("demo", demo, {"K1": DEPTH, "K2": DEPTH, "shade": DEPTH,
                                  "draw": DEPTH + 1},
                   {"K1": DEPTH, "K2": DEPTH, "draw": DEPTH + 1}, rehearsal)
    ph.done("render", s, f"{demo['mrays']:.3f} Mrays/s")

    # 5b. the shade kernel against the plain segment at the main path's
    # shapes: the demo's bounce-0 and bounce-1 segments, one FUSED launch
    s = time.perf_counter()
    sb = shade_batches(rt, integ, trav, prng, scene, cfg, fov_x, dev)
    shade_demo = {b: measure_shade(integ, lc, sk, scene, b, sb[b], dev, reps)
                  for b in (0, 1)}
    del sb
    for b, m in shade_demo.items():
        print(f"  shade kernel, demo bounce {b}: {json.dumps(m)}", flush=True)
        if not rehearsal and (m["fused"]["launches"] != 1
                              or m["segment"]["launches"] != 1):
            raise AssertionError(f"shade kernel: demo bounce {b} launched "
                                 f"{m['fused']['launches']} times, want 1")
    ph.done("shade", s, "bit-equal; lanes "
            f"{[m['lanes'] for m in shade_demo.values()]}")

    # 5c. the draw kernel alone against the plain chain at the main path's
    # lane counts
    s = time.perf_counter()
    draws = measure_draws(prng, dk, dev, reps, 1 if not rehearsal else 1024)
    for name, m in draws.items():
        print(f"  draw kernel, {name}: {json.dumps(m)}", flush=True)
    ph.done("draws", s, "bit-equal, rows and columns; lanes "
            f"{[m['lanes'] for m in draws.values()]}")

    # 6. what came out is right
    s = time.perf_counter()
    check_frame(res, h, w)
    output.save_png(res.stats, OUT_DIR / "demo.png")
    goldens = [golden_check(scene_dir, dev, g, "pallas") for g in GOLDEN]
    goldens += [golden_check(scene_dir, dev, g, intersector)
                for intersector in ("brute", "bvh")
                for g in GOLDEN if g[-1] == "exact"]
    ph.done("check", s, f"finite demo frame; {len(goldens)} golden renders "
            "pass")

    # 7. the paths of the second slice
    city24 = Path(scene_dir) / "city24.gltf"
    paths = {}
    # each path's frame (the sum of its samples), which the columnar
    # route's frame is held against
    frames = {}
    for name, intersector in (("citynight", "pallas"), ("city", "pallas"),
                              ("city24", "pallas"),
                              ("brute", "pallas_brute")):
        s = time.perf_counter()
        if name == "brute":
            pscene, pfov = scene, fov_x
        else:
            if name == "city24":
                assets.make_city_scene(city24, blocks=24)
                phost = gltf.read_gltf(str(city24))
            else:
                phost = gltf.read_gltf(
                    assets.generate(name, scene_dir)["gltf"])
            pscene = build.finish_scene(phost, device=dev)
            pfov = phost.cam.fov_x * (WIDTH / HEIGHT)
        sync(dev)
        g_, n_super_, _ = trav.exact_cull_layout(pscene)
        info = {"triangles": pscene.num_triangles,
                "clusters": pscene.cluster_lo.shape[0],
                "lights": pscene.num_lights, "g": g_, "n_super": n_super_,
                "streamed": pscene.stream}
        pcfg = cfg.replace(samples=path_steps, intersector=intersector)
        checks = {}
        if name == "brute":
            checks["K3 bounce 0"] = measure_k3(pi, pscene, rays0, dev, reps,
                                               slice_blocks, clock=True)
        else:
            pk = kernel_batches(rt, integ, trav, prng, pi, pscene, pcfg,
                                pfov, dev)
            slice_ = slice_blocks if g_ > 1 else None
            checks["K1 bounce 1"] = measure_k1(pi, pk["aabb8"], pk["rays1"],
                                               n_super_, dev, reps)
            sweep = "K4" if pscene.stream else "K2"
            for b in (0, 1):
                checks[f"{sweep} bounce {b}"] = measure_sweep(
                    pi, trav, pscene, pk[f"words{b}"], pk[f"rays{b}"], g_,
                    n_super_, dev, reps, slice_,
                    clock=pscene.stream and b == 1)
            if pscene.num_lights >= lc.threshold():
                checks["K5 bounce 0"] = measure_k5(
                    lc, pscene, pk["shade_o"], pk["shade_d"], dev, reps,
                    slice_blocks, clock=True)
                # the shade kernel's halves around K5, HEAD then TAIL
                sb = shade_batches(rt, integ, trav, prng, pscene, pcfg,
                                   pfov, dev)
                for b in (0, 1):
                    m = measure_shade(integ, lc, sk, pscene, b, sb[b], dev,
                                      reps)
                    if not rehearsal and (
                            m["head"]["launches"], m["tail"]["launches"],
                            m["segment"]["launches"]) != (1, 1, 2):
                        raise AssertionError(f"shade kernel: {name} bounce "
                                             f"{b} launches {m}")
                    checks[f"shade bounce {b}"] = m
                del sb
            del pk
        for k, m in checks.items():
            print(f"  [{name}] {k}: {json.dumps(m)}", flush=True)
        r = render_path(rt, pscene, pcfg, pfov, dev, with_shade, path_steps)
        print_render(r, path_steps, card)
        pres = r["res"]
        if pres.overflow != 0:
            raise AssertionError(f"{name}: compaction overflow "
                                 f"{pres.overflow}")
        if intersector == "pallas":
            if pres.lane_schedule is None:
                raise AssertionError(f"{name}: no lane schedule")
            sweep = "K4" if pscene.stream else "K2"
            # the draw kernel: the jitter and one call a bounce
            want = {"K1": DEPTH, sweep: DEPTH, "draw": DEPTH + 1}
            if pscene.num_lights >= lc.threshold():
                want["K5"] = DEPTH
            # one shade kernel a bounce, two (HEAD, TAIL) around K5
            halves = 2 if pscene.num_lights >= lc.threshold() else 1
            check_launches(name, r, dict(want, shade=halves * DEPTH), want,
                           rehearsal)
        else:
            if pres.lane_schedule is not None:
                raise AssertionError("brute: compacted")
            check_launches(name, r, {"K3": DEPTH, "draw": DEPTH + 1}, {},
                           rehearsal)
        mean = check_frame(pres, h, w)
        frames[name] = pres.stats.total[0].cpu().clone()
        output.save_png(pres.stats, OUT_DIR / f"{name}.png")
        if intersector == "pallas" and (pscene.num_lights
                                        >= lc.threshold()):
            # K5 on the second bounce's light pdf inputs (the sorted,
            # compacted batch) of one more step
            step = rt.make_render_step(pcfg, pfov,
                                       lane_schedule=pres.lane_schedule,
                                       device=dev)
            seen = light_pdf_inputs(lc, step, pscene, pres.stats,
                                    prng.key_from_seed(pcfg.seed),
                                    path_steps, dev)
            checks["K5 bounce 1"] = measure_k5(lc, pscene, *seen[1], dev,
                                               reps)
            print(f"  [{name}] K5 bounce 1: "
                  f"{json.dumps(checks['K5 bounce 1'])}", flush=True)
            del seen
        if pscene.stream:
            step = rt.make_render_step(pcfg, pfov,
                                       lane_schedule=pres.lane_schedule,
                                       device=dev)
            census = sweep_census(trav, step, pscene, pres.stats,
                                  prng.key_from_seed(pcfg.seed),
                                  path_steps, dev)
            info["census"] = census
            print(f"  [{name}] lists per cast (lists, beyond the cap, mean "
                  f"swept, mean and longest length beyond the cap, mean "
                  f"swept under the capped rule) over one more step: "
                  f"{census}", flush=True)
        if args.profile:
            ps = time.perf_counter()
            profile_step(rt, pres.stats, pscene, pcfg, pfov,
                         pres.lane_schedule, dev, name)
            ph.done(f"profile {name}", ps)
        if name == "brute":
            info["golden"] = golden_check(scene_dir, dev, GOLDEN[0],
                                          "pallas_brute")
        paths[name] = dict(info, checks=checks, mrays=r["mrays"], fov_x=pfov,
                           launches=r["launches"], per_step=r["per_step"],
                           calibration=r["calibration"],
                           peak_gib=r["peak_gib"], image_mean=mean)
        del pscene
        ph.done(f"path {name}", s, f"{r['mrays']:.3f} Mrays/s; "
                + json.dumps(info))

    # 7b. the dense light pdf below lc.threshold() lights: citynight with
    # one window a tower (288 lights), its full-frame bounce-0 batch
    s = time.perf_counter()
    night1 = Path(scene_dir) / "citynight1.gltf"
    assets.make_citynight_scene(night1, windows_per_tower=1)
    nhost = gltf.read_gltf(str(night1))
    nscene = build.finish_scene(nhost, device=dev)
    if nscene.num_lights >= lc.threshold():
        raise AssertionError(f"citynight1 has {nscene.num_lights} lights")
    ncfg = cfg.replace(samples=1)
    no, nd = rt.camera_rays(nscene, prng.key_from_seed(ncfg.seed), 0,
                            nhost.cam.fov_x * (WIDTH / HEIGHT), w, h)
    nstate, _ = integ.first_bounce(nscene, no, nd,
                                   prng.key_from_seed(ncfg.seed), 0)
    del no, nd
    dense_pdf = dense_pdf_check(lc, nscene, nstate[:w * h, 0:3].clone(),
                                nstate[:w * h, 3:6].clone(), dev, reps)
    del nstate, nscene
    print(f"  [citynight1] dense light pdf: {json.dumps(dense_pdf)}",
          flush=True)
    ph.done("dense pdf", s, f"{dense_pdf['lights']} lights, dense "
            f"{dense_pdf['dense_ms']:.3f} ms, peak "
            f"{dense_pdf['dense_peak_gib']:.3f} GiB; culled "
            f"{dense_pdf['culled_ms']:.3f} ms")

    # 8. the demo with two-phase culling
    s = time.perf_counter()
    two = twophase_path(rt, trav, pi, scene, cfg, fov_x, dev, counters, kb,
                        reps, card, res, args.profile)
    paths["twophase"] = dict(two, launches=two["launches"],
                             triangles=scene.num_triangles,
                             clusters=scene.cluster_lo.shape[0],
                             lights=scene.num_lights, g=kb["g"],
                             streamed=False)
    ph.done("path twophase", s, f"{two['mrays']:.3f} Mrays/s (single-phase "
            f"demo {demo['mrays']:.3f} in this run)")

    # 9. the CLI, in process, on the demo glTF
    s = time.perf_counter()
    cli_r = cli_path(pi, lc, counters, dev, demo_gltf, scene_dir, w, h,
                     rehearsal)
    ph.done("path cli", s, f"{cli_r['mrays']:.2f} Mrays/s (the CLI's "
            f"Throughput line); {json.dumps(cli_r)}")

    # 10. the debug surface on the demo
    s = time.perf_counter()
    dbg = debug_path(rt, trav, pi, scene, cfg, fov_x, dev, counters, reps,
                     card, demo, demo_gltf, scene_dir, rehearsal,
                     args.profile)
    paths["debug"] = dict(dbg, triangles=scene.num_triangles,
                          clusters=scene.cluster_lo.shape[0],
                          lights=scene.num_lights, g=kb["g"],
                          streamed=False)
    ph.done("path debug", s, f"{dbg['mrays']:.3f} Mrays/s, step "
            f"{dbg['step_ms']:.3f} ms (compacted demo {demo['mrays']:.3f} "
            f"Mrays/s, step {dbg['demo_step_ms']:.3f} ms, in this run; "
            f"{card})")

    # 11-14. the mesh, refill, the CLI's new flags and the pool
    s = time.perf_counter()
    paths["mesh"] = mesh_path(rt, trav, pi, scene, cfg, fov_x, dev,
                              counters, reps, card, demo, kb["g"],
                              args.profile)
    ph.done("path mesh", s, f"{paths['mesh']['mrays']:.3f} Mrays/s, step "
            f"{paths['mesh']['step_ms']:.3f} ms ({paths['mesh']['where']}; "
            f"single card {demo['mrays']:.3f} Mrays/s; {card})")
    s = time.perf_counter()
    paths["refill"] = refill_path(rt, trav, pi, scene, cfg, fov_x, dev,
                                  counters, reps, card, demo, kb["g"],
                                  args.profile)
    ph.done("path refill", s, f"{paths['refill']['mrays']:.3f} Mrays/s, "
            f"step {paths['refill']['step_ms']:.3f} ms")
    # the CLI with the mesh and scheduler flags
    s = time.perf_counter()
    sched_cli = sched_cli_path(dev, demo_gltf, w, h, rehearsal)
    ph.done("path cli schedulers", s, json.dumps(sched_cli))
    s = time.perf_counter()
    paths["pool"] = pool_path(rt, trav, pi, scene, cfg, fov_x, dev,
                              counters, reps, card, kb["g"], args.profile)
    ph.done("path pool", s, f"{paths['pool']['mrays']:.3f} Mrays/s, step "
            f"{paths['pool']['step_ms']:.3f} ms, waves "
            f"{paths['pool']['waves']}")

    # 15-16. the columnar trace on the demo and on citynight
    s = time.perf_counter()
    paths["cols"] = cols_path(rt, integ, trav, pi, scene, cfg, fov_x, dev,
                              counters, reps, card, demo, kb["g"],
                              args.profile)
    ph.done("path cols", s, f"{paths['cols']['mrays']:.3f} Mrays/s, step "
            f"{paths['cols']['step_ms']:.3f} ms (row-form demo "
            f"{demo['mrays']:.3f} Mrays/s, step "
            f"{paths['cols']['demo_step_ms']:.3f} ms; {card})")
    s = time.perf_counter()
    night = build.finish_scene(gltf.read_gltf(
        assets.generate("citynight", scene_dir)["gltf"]), device=dev)
    paths["cols citynight"] = cols_citynight_path(
        rt, integ, trav, lc, night, cfg.replace(samples=path_steps),
        paths["citynight"]["fov_x"], dev, counters, reps, card,
        frames["citynight"], paths["citynight"]["mrays"], args.profile)
    del night
    ph.done("path cols citynight", s,
            f"{paths['cols citynight']['mrays']:.3f} Mrays/s (row form "
            f"{paths['citynight']['mrays']:.3f}; {card})")

    # 17. the accuracy harness on the BASELINE configs
    s = time.perf_counter()
    acc = accuracy_path(rt, integ, trav, pi, dev, counters, reps, card,
                        rehearsal)
    ph.done("accuracy", s, f"{acc['records']} rows pass; harness "
            f"{acc['render_s']:.3f} s, peak {acc['peak_gib']:.3f} GiB; "
            f"launches {json.dumps(acc['launches'])} ({card})")

    if args.profile:
        s = time.perf_counter()
        profile_step(rt, res.stats, scene, cfg, fov_x,
                     res.lane_schedule, dev, "demo")
        ph.done("profile demo", s)

    def entry(name, key, replaces, main, launches, extra):
        out = dict({
            "name": name, "route": "cuda",
            "source": "raytracer_odin_tpu_torch/csrc/intersect_kernels.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "plain_is_yardstick": False, "card": card,
            "design": DESIGN[key], "registers": regs.get(key)}, **extra)
        if key in SASS_MARKERS:
            # SASS a test, the SM clock under the kernel's load, and the
            # issue floors they give at the main shape
            out.update(sass=sass.get(key), sm_clock_mhz=main.get(
                "sm_clock_mhz"), **{f: main[f] for f in (
                    "vote_rates", "vote_rates_on", "issue_floor_ms",
                    "issue_floor_skip_ms", "issue_floor_data_ms")
                    if f in main})
        return out

    n_sm = (torch.cuda.get_device_properties(dev).multi_processor_count
            if dev.type == "cuda" else 0)

    def floored(key, m, mhz):
        return add_floors(m, sass.get(key), mhz, n_sm)

    def by_path(k):
        return dict({p: v["launches"][k] for p, v in paths.items()},
                    accuracy=acc["launches"][k])

    mhz1, mhz2 = k1_b1.get("sm_clock_mhz"), k2_b1.get("sm_clock_mhz")
    k1_tmax = floored("K1 tmax", two["k1_tmax"],
                      two["k1_tmax"].get("sm_clock_mhz"))
    k1_b0, k1_b1 = floored("K1", k1_b0, mhz1), floored("K1", k1_b1, mhz1)
    k2_b0, k2_b1 = floored("K2", k2_b0, mhz2), floored("K2", k2_b1, mhz2)
    k3 = paths["brute"]["checks"]["K3 bounce 0"]
    k3 = floored("K3", k3, k3.get("sm_clock_mhz"))
    k4_b1 = paths["city24"]["checks"]["K4 bounce 1"]
    mhz4 = k4_b1.get("sm_clock_mhz")
    k4_b1 = floored("K4", k4_b1, mhz4)
    k4_b0 = floored("K4", paths["city24"]["checks"]["K4 bounce 0"], mhz4)
    night = paths["citynight"]["checks"]
    mhz5 = night["K5 bounce 0"].get("sm_clock_mhz")
    k5_b0 = floored("K5", night["K5 bounce 0"], mhz5)
    k5_b1 = floored("K5", night["K5 bounce 1"], mhz5)

    kernels = [
        # main entries: the demo's sorted, compacted bounce-1 batch (7 of a
        # step's 8 launches are sorted batches); bounce0: the camera rays
        entry("K1 cluster_masks_rows", "K1",
              "raytracer_odin_tpu/ops/pallas_intersect.py:275", k1_b1,
              demo["launches"]["K1"],
              {"launches_per_step": demo["per_step"]["K1"][0],
               "launches_in_calibration": demo["calibration"]["K1"],
               "rays": k1_b1["rays"], "bounce0": k1_b0,
               "launches_by_path": by_path("K1"),
               "city24_bounce1": floored(
                   "K1", paths["city24"]["checks"]["K1 bounce 1"], mhz1),
               "debug_bounce1": paths["debug"]["k1"],
               "mesh_shard_bounce1": paths["mesh"]["k1"],
               "pool_wave": paths["pool"]["k1"],
               "refill_iteration": paths["refill"]["k1"],
               "cols_bounce1": paths["cols"]["k1"],
               **{f"accuracy_{n}_bounce1": floored("K1", c["K1"], mhz1)
                  for n, c in acc["checks"].items()}}),
        # K1 with its tmax row: the demo's sorted bounce-1 batch with
        # phase A's t in row 6, on the twophase path
        entry("K1 cluster_masks_rows tmax_row", "K1 tmax",
              "raytracer_odin_tpu/ops/pallas_intersect.py:275", k1_tmax,
              two["launches"]["K1 tmax"],
              {"launches_per_step": two["per_step"]["K1 tmax"][0],
               "launches_in_calibration": two["calibration"]["K1 tmax"],
               "rays": k1_tmax["rays"],
               "index_flips": k1_tmax["index_flips"],
               "launches_by_path": by_path("K1 tmax")}),
        entry("K2 intersect_culled_rows", "K2",
              "raytracer_odin_tpu/ops/pallas_intersect.py:162", k2_b1,
              demo["launches"]["K2"],
              {"launches_per_step": demo["per_step"]["K2"][0],
               "launches_in_calibration": demo["calibration"]["K2"],
               "rays": k2_b1["rays"], "bounce0": k2_b0,
               "launches_by_path": by_path("K2"),
               "city_bounce1": floored(
                   "K2", paths["city"]["checks"]["K2 bounce 1"], mhz2),
               "debug_bounce1": paths["debug"]["k2"],
               "mesh_shard_bounce1": paths["mesh"]["k2"],
               "pool_wave": paths["pool"]["k2"],
               "refill_iteration": paths["refill"]["k2"],
               "cols_bounce1": paths["cols"]["k2"],
               **{f"accuracy_{n}_bounce1": floored("K2", c["K2"], mhz2)
                  for n, c in acc["checks"].items()}}),
        # K3: the brute path's bounce-0 camera rays (every bounce sweeps
        # every cluster, uncompacted)
        entry("K3 intersect_brute_rows", "K3",
              "raytracer_odin_tpu/ops/pallas_intersect.py:140", k3,
              paths["brute"]["launches"]["K3"],
              {"launches_per_step": paths["brute"]["per_step"]["K3"][0],
               "launches_in_calibration":
                   paths["brute"]["calibration"]["K3"],
               "rays": k3["rays"]}),
        # K4: city24's sorted, compacted bounce-1 batch over its uncapped
        # lists; capped_lists: the same batch over the capped lists of the
        # JAX package's rule (bit-equal hits, its time and bound)
        entry("K4 intersect_stream_rows", "K4",
              "raytracer_odin_tpu/ops/pallas_intersect.py:217", k4_b1,
              paths["city24"]["launches"]["K4"],
              {"launches_per_step": paths["city24"]["per_step"]["K4"][0],
               "launches_in_calibration":
                   paths["city24"]["calibration"]["K4"],
               "rays": k4_b1["rays"],
               **{f: k4_b1[f] for f in (
                   "mean_list", "overflow_lists", "overflow_mean_list",
                   "overflow_max_list")},
               "capped_lists": k4_b1["capped"], "bounce0": k4_b0}),
        # K5: citynight's bounce-0 shading batch (full frame); bounce1:
        # the second bounce's batch of one more step; dense_pdf: the dense
        # sum K5 stands in for at 512 lights and more, on a 288-light
        # citynight's bounce-0 batch
        entry("K5 light_sums_rows", "K5",
              "raytracer_odin_tpu/ops/light_cull.py:103", k5_b0,
              paths["citynight"]["launches"]["K5"],
              {"launches_per_step":
                   paths["citynight"]["per_step"]["K5"][0],
               "launches_in_calibration":
                   paths["citynight"]["calibration"]["K5"],
               "rays": k5_b0["rays"], "mean_list": k5_b0["mean_list"],
               "bounce1": k5_b1, "dense_pdf": dense_pdf,
               "cols_citynight": paths["cols citynight"]["k5"],
               "launches_by_path": by_path("K5")}),
        # the shade kernel: the demo's sorted, compacted bounce-1 segment
        # (one FUSED launch; 7 of a step's 8 segments are later bounces);
        # bounce0: the camera rays' segment; citynight: HEAD and TAIL
        # around K5 at bounces 0 and 1. No TPU kernel is replaced: XLA
        # fused the chain for the JAX package. Its launches are the
        # replays of the segment graphs.
        dict({"name": "shade_kernel", "route": "cuda",
              "source": "raytracer_odin_tpu_torch/csrc/shade_kernels.cu",
              "replaces": None, "launches": demo["launches"]["shade"]},
             **{f: shade_demo[1]["fused"][f] for f in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None, plain_is_yardstick=False, card=card,
             design="hopper", registers=shade_ptxas.get("fused", {}).get(
                 "registers"), ptxas=shade_ptxas,
             launches_per_step=(demo["per_step"]["shade"] or [0])[0],
             launches_in_calibration=demo["calibration"]["shade"],
             lanes=shade_demo[1]["lanes"], bounce0=shade_demo[0],
             citynight_bounce0=night["shade bounce 0"],
             citynight_bounce1=night["shade bounce 1"],
             launches_by_path=dict(
                 {"demo": demo["launches"]["shade"]},
                 **{p: paths[p]["launches"]["shade"]
                    for p in ("citynight", "city", "city24", "brute")})),
        # the draw kernel: a frame's bounce-0 draws (n = 6); the demo's
        # bounce-1 batch and the camera jitter (n = 2) beside it. No TPU
        # kernel is replaced: XLA fused the chain for the JAX package.
        dict({"name": "draw_kernel", "route": "cuda",
              "source": "raytracer_odin_tpu_torch/csrc/prng_kernels.cu",
              "replaces": None, "launches": demo["launches"]["draw"]},
             **{f: draws["frame bounce 0"].get(f) for f in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "lanes",
                 "plain_launches", "host_us", "plain_host_us")},
             library_ms=None, plain_is_yardstick=False, card=card,
             design="hopper", max_abs_err=0.0,
             launches_per_step=(demo["per_step"]["draw"] or [0])[0],
             launches_in_calibration=demo["calibration"]["draw"],
             cases=draws),
    ]
    summary = {p: {k: v[k] for k in ("triangles", "clusters", "lights", "g",
                                     "streamed", "mrays", "peak_gib")}
               for p, v in paths.items()}
    summary["demo"] = {"mrays": demo["mrays"], "peak_gib": demo["peak_gib"]}
    summary["cli"] = {"mrays": cli_r["mrays"]}
    print(f"  paths {json.dumps(summary)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if rehearsal:
        print("chip_smoke: CPU rehearsal finished (no result)", flush=True)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def glossy_gate(got, want):
    """The glossy-scene gate of tests/test_torch_render.py (MEAN_RTOL,
    PASS_FRACTION, MAX_ABS); returns the reason it fails, or None."""
    import numpy as np

    if got.shape != want.shape or not np.isfinite(got).all():
        return "shape or finiteness"
    if abs(got.mean() - want.mean()) > MEAN_RTOL * abs(want.mean()):
        return f"mean {got.mean()} vs {want.mean()}"
    within = np.isclose(got, want, rtol=1e-4, atol=1e-5).mean()
    if within < PASS_FRACTION:
        return f"{within:.4f} of values within rtol 1e-4, atol 1e-5"
    if np.abs(got - want).max() > MAX_ABS:
        return f"max abs {np.abs(got - want).max()}"
    return None


def golden_check(scene_dir, dev, golden, intersector):
    """Render a golden configuration through `intersector` and compare it
    with tests/golden/ (made by the JAX package on the CPU). The card's
    sin/cos/pow/atan2 round differently from the CPU's: "exact" scenes are
    held at 1e-3 relative per value, ten times the CPU test's; "glossy"
    ones (textured, envmap), where the GGX lobe amplifies such differences
    bounce after bounce, at the glossy-scene gate."""
    import numpy as np

    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.io import gltf, images
    from raytracer_odin_tpu_torch.models import assets, build
    from raytracer_odin_tpu_torch.models.scene import HostTexture
    from raytracer_odin_tpu_torch.render import runtime as rt

    gname, sname, gw, gh, gd, gs, gate = golden
    info = assets.generate(sname, scene_dir)
    ghost = gltf.read_gltf(info["gltf"])
    env = None
    if "env" in info:
        li = images.load_image(info["env"])
        env = HostTexture(li.data, li.is_hdr)
    gscene = build.finish_scene(ghost, env_map=env, device=dev)
    gcfg = RenderConfig(width=gw, height=gh, ray_depth=gd, samples=gs,
                        samples_per_step=gs, seed=0, intersector=intersector,
                        compact="auto")
    sync(dev)
    t = time.perf_counter()
    res = rt.render_scene(gscene, gcfg, ghost.cam.fov_x, device=dev)
    sync(dev)
    render_s = time.perf_counter() - t
    got = res.stats.total[0].cpu().numpy()
    want = np.load(ROOT / "tests" / "golden" / f"{gname}.npy")
    err = np.abs(got - want)
    within = np.isclose(got, want, rtol=1e-4, atol=1e-5).mean()
    line = (f"{gname} ({intersector}, {gate} gate) max abs {err.max():.3g} "
            f"(mean {err.mean():.3g}; {within:.4f} of values within the CPU "
            f"test's rtol 1e-4, atol 1e-5; render {render_s:.3f} s)")
    if gate == "exact":
        fault = (None if np.allclose(got, want, rtol=1e-3, atol=1e-4)
                 else "beyond rtol 1e-3, atol 1e-4")
    else:
        fault = glossy_gate(got, want)
    if fault:
        raise AssertionError(f"golden {gname} differs ({fault}): {line}")
    print(f"  {line}", flush=True)
    return line


def twophase_path(rt, trav, pi, scene, cfg, fov_x, dev, counters, kb,
                  reps, card, demo_res, profile):
    """The demo with two-phase culling (trav.TWO_PHASE_K = TWO_PHASE_K):
    K1 with its tmax row on the sorted bounce-1 batch kb["rays1"] with
    phase A's t in row 6 (built by the calls trav._two_phase_exact makes),
    the mean list of each phase, the index flips of a two-phase cast
    against the single sweep there, then the render with its
    launch counts, overflow 0 and the frame against the single-phase demo
    frame (demo_res, the same seed and samples) under the glossy gate; with
    `profile`, one more step under torch.profiler."""
    import torch

    from raytracer_odin_tpu_torch.ops import culling

    rays1, words1 = kb["rays1"], kb["words1"]
    aabb8, n_super = kb["aabb8"], kb["n_super"]
    t_one, i_one = trav.cast_presorted_rows(scene, rays1, words1)
    lb = pi.list_block(scene)
    _, near = culling.cull_clusters(*culling.block_bounds_rows(rays1, lb),
                                    scene.cluster_lo, scene.cluster_hi)
    counts, lists = culling.build_lists(
        culling.unpack_mask(culling.or_blocks_packed(words1, lb), n_super),
        cap=256, near=near)
    k = TWO_PHASE_K
    counts_a = torch.where(counts < 0, k, torch.clamp(counts, max=k))
    rays_b = rays1.clone()
    rays_b[6] = pi.intersect_culled_rows(scene.ptri, counts_a, lists,
                                         rays1)[0]
    words_b = pi.cluster_masks_rows(aabb8, rays_b, n_super, tmax_row=True)
    words_b &= ~trav.swept_words(lists[:, :k], counts_a,
                                 words_b.shape[0]).repeat_interleave(lb, 1)
    counts_b, _ = culling.build_lists(
        culling.unpack_mask(culling.or_blocks_packed(words_b, lb), n_super),
        cap=256, near=near)
    trav.TWO_PHASE_K = TWO_PHASE_K
    try:
        t_two, i_two = trav.cast_presorted_rows(scene, rays1, words1)
        sync(dev)
        check = measure_k1(pi, aabb8, rays_b, n_super, dev, reps,
                           tmax_row=True, clock=True)
        # mean clusters a 256-ray list sweeps in phases A and B
        check["mean_list_a_b"] = [float(counts_a.float().mean()),
                                  float(counts_b.float().mean())]
        hit = i_one >= 0
        check["hits"] = int(hit.sum())
        check["t_differs"] = int((t_one != t_two).sum())
        check["index_flips"] = int((i_one != i_two).sum())
        check["hit_miss_differs"] = int((hit != (i_two >= 0)).sum())
        print(f"  [twophase] K1 tmax bounce 1: {json.dumps(check)}",
              flush=True)
        if check["hit_miss_differs"] or check["t_differs"]:
            raise AssertionError("twophase: the bounce-1 hits differ from "
                                 "the single sweep's")
        r = render_path(rt, scene, cfg, fov_x, dev, counters, cfg.samples)
        if profile:
            profile_step(rt, accum_copy(r["res"].stats), scene, cfg, fov_x,
                         r["res"].lane_schedule, dev, "twophase")
    finally:
        trav.TWO_PHASE_K = 0
    print_render(r, cfg.samples, card)
    res = r["res"]
    if res.overflow != 0 or res.lane_schedule is None:
        raise AssertionError(f"twophase: compaction overflow {res.overflow}")
    depth = cfg.ray_depth
    want = {"K1": depth, "K1 tmax": depth - 1, "K2": 1 + 2 * (depth - 1)}
    check_launches("twophase", r, want, {"K1": depth, "K2": depth},
                   dev.type != "cuda")
    got = res.stats.total[0].cpu().numpy()
    single = demo_res.stats.total[0].cpu().numpy()
    fault = glossy_gate(got, single)
    if fault:
        raise AssertionError(f"twophase frame differs from the single-phase "
                             f"demo frame: {fault}")
    within = float((torch.from_numpy(got).isclose(
        torch.from_numpy(single), rtol=1e-4, atol=1e-5)).float().mean())
    print(f"  [twophase] frame vs single-phase demo: max abs "
          f"{float(abs(got - single).max()):.3g}, {within:.6f} of values "
          "within rtol 1e-4, atol 1e-5", flush=True)
    return dict(r, k1_tmax=check)


def uncompacted_batch(rt, trav, pi, scene, cfg, fov_x, dev):
    """The inputs of K1 and of the list sweep at bounce 1 of the uncompacted
    trace (traverse.cast_rays_pallas(sort=True, alive=...)) in the first
    sample of `cfg`, recorded as the route builds them: K1's rows over every
    lane of the frame (dead lanes as far rays; the rows pack_rays packs in
    traverse.sort_exact, the second packing of the sample after bounce 0's
    tiled rows), and the sorted batch with its masks (dead lanes last).
    Kernel wrappers and their counts are untouched."""
    real_pack, real_sweep = pi.pack_rays, trav._sweep_exact
    seen = {"pack": [], "sweep": []}

    def pack(o, d):
        out = real_pack(o, d)
        if len(seen["pack"]) < 2:
            seen["pack"].append(out[0].clone())
        return out

    def sweep(scene_, words, rays, g, n_super, cap=256):
        if len(seen["sweep"]) < 2:
            seen["sweep"].append((words.clone(), rays.clone()))
        return real_sweep(scene_, words, rays, g, n_super, cap)

    from raytracer_odin_tpu_torch.utils import prng

    pi.pack_rays, trav._sweep_exact = pack, sweep
    try:
        _, aux = rt.sample_pass(scene, prng.key_from_seed(cfg.seed), 0,
                                fov_x, cfg.width, cfg.height,
                                rt._trace_options(cfg))
        sync(dev)
    finally:
        pi.pack_rays, trav._sweep_exact = real_pack, real_sweep
    g, n_super, aabb8 = trav.exact_cull_layout(scene)
    words, rays = seen["sweep"][1]
    k1_rays = seen["pack"][1]
    n = cfg.width * cfg.height
    n_alive = int(aux["alive_counts"][1])
    # sorted dead lanes are degenerate far +x rays with empty masks
    dead = rays[3, n_alive:n]
    if not (0 < n_alive < n and bool((dead == 1.0).all())
            and k1_rays.shape == rays.shape):
        raise AssertionError(f"uncompacted bounce-1 batch: {n_alive} of {n} "
                             "lanes alive, dead lanes not sorted last")
    return {"k1_rays": k1_rays, "aabb8": aabb8, "g": g,
            "n_super": n_super, "words": words, "rays": rays,
            "lanes": n, "alive": n_alive}


def light_hit(scene, point, eps=1e-3) -> bool:
    """Whether `point` [3] lies on one of the scene's light triangles."""
    import numpy as np

    p = scene.light_p.cpu().numpy()
    u = scene.light_u.cpu().numpy()
    v = scene.light_v.cpu().numpy()
    ng = scene.light_ng.cpu().numpy()
    q = np.asarray(point, np.float64) - p
    n = ng / np.linalg.norm(ng, axis=-1, keepdims=True)
    on_plane = np.abs((q * n).sum(-1)) < eps
    # barycentrics of q in (u, v)
    uu, vv, uv = (u * u).sum(-1), (v * v).sum(-1), (u * v).sum(-1)
    qu, qv = (q * u).sum(-1), (q * v).sum(-1)
    den = uu * vv - uv * uv
    a = (qu * vv - qv * uv) / den
    b = (qv * uu - qu * uv) / den
    inside = (a >= -1e-4) & (b >= -1e-4) & (a + b <= 1 + 1e-4)
    return bool((on_plane & inside).any())


def check_ray_log(debug_rays, scene, stats, fov_x, w, h, pixels,
                  depth_layer, bounces_layer):
    """The device ray log of one lane against the full frame's first sample
    (stats.first) at each (x, row) of `pixels`, traced through "pallas":
    its first t bit-equal to the depth AOV (0 and inf on a primary miss),
    its segment count the bounces AOV. Returns per pixel (x, row, first t,
    segments, whether the path ends in a miss, whether it reaches an
    emitter)."""
    import numpy as np

    depth = stats.first[depth_layer, ..., 0].cpu().numpy()
    bounces = stats.first[bounces_layer, ..., 0].cpu().numpy()
    out = []
    for x, row in pixels:
        segs = debug_rays.trace_pixel_paths_device(
            scene, w, h, fov_x, DEPTH, x, h - 1 - row, samples=1, seed=0,
            intersector="pallas")
        first = segs[0]
        want_t = depth[row, x]
        ok_t = ((np.isinf(first.t) and want_t == 0.0)
                or np.float32(first.t) == want_t)
        if not ok_t or len(segs) != int(bounces[row, x]):
            raise AssertionError(
                f"ray log at pixel ({x}, {row}): first t {first.t!r}, "
                f"{len(segs)} segments; the frame's depth AOV {want_t!r}, "
                f"bounces {bounces[row, x]!r}")
        out.append((x, row, float(first.t), len(segs),
                    bool(np.isinf(segs[-1].t)),
                    any(light_hit(scene, sg.end) for sg in segs
                        if np.isfinite(sg.t))))
    return out


def debug_path(rt, trav, pi, scene, cfg, fov_x, dev, counters, reps, card,
               demo, demo_gltf, scene_dir, rehearsal, profile):
    """The debug surface on the demo (phase 10 of the module docstring)."""
    import contextlib
    import io
    import urllib.request

    import numpy as np
    import torch

    from raytracer_odin_tpu_torch import cli
    from raytracer_odin_tpu_torch import config as C
    from raytracer_odin_tpu_torch.io import gltf, images, png
    from raytracer_odin_tpu_torch.models import assets, build
    from raytracer_odin_tpu_torch.ops import probes
    from raytracer_odin_tpu_torch.render import debug_rays, preview
    from raytracer_odin_tpu_torch.utils import prng

    w, h = cfg.width, cfg.height
    dcfg = cfg.replace(samples=DEBUG_STEPS, debug_features=True)
    names = probes.layer_names()
    if names.index("depth") != C.LAYER_DEPTH or len(names) != 10:
        raise AssertionError(f"layers {names}")

    # K1 and K2 on the uncompacted route's full-width sorted bounce-1 batch
    ub = uncompacted_batch(rt, trav, pi, scene, dcfg, fov_x, dev)
    k1 = measure_k1(pi, ub["aabb8"], ub["k1_rays"], ub["n_super"], dev, reps)
    k2 = measure_sweep(pi, trav, scene, ub["words"], ub["rays"], ub["g"],
                       ub["n_super"], dev, reps)
    for m in (k1, k2):
        m.update(lanes=ub["lanes"], alive=ub["alive"])
    print(f"  [debug] K1 bounce 1 (uncompacted, every lane): "
          f"{json.dumps(k1)}", flush=True)
    print(f"  [debug] K2 bounce 1 (uncompacted, sorted, dead lanes last): "
          f"{json.dumps(k2)}", flush=True)
    del ub

    # the render: launches from zero, no calibration, ten layers
    r = render_path(rt, scene, dcfg, fov_x, dev, counters, DEBUG_STEPS)
    print_render(r, DEBUG_STEPS, card)
    res = r["res"]
    if res.overflow != 0 or res.lane_schedule is not None:
        raise AssertionError("debug: compacted, or overflow")
    check_launches("debug", r, {"K1": DEPTH, "K2": DEPTH}, {}, rehearsal)
    stats = res.stats
    if tuple(stats.count.shape) != (10, h, w):
        raise AssertionError(f"debug: stats {tuple(stats.count.shape)}")
    check_frame(res, h, w)

    # beauty bit-equal to a beauty-only uncompacted render, same seed
    plain = rt.render_scene(scene, cfg.replace(samples=DEBUG_STEPS,
                                               compact="off"),
                            fov_x, device=dev).stats
    for f in ("first", "last", "total", "total_sq", "count"):
        if not torch.equal(getattr(stats, f)[0], getattr(plain, f)[0]):
            raise AssertionError(f"debug: beauty {f} differs from the "
                                 "beauty-only render")
    del plain

    # AOV ranges
    first, last = stats.first, stats.last
    for layer in (C.LAYER_MISS, C.LAYER_ANOMALY):
        v = torch.cat([first[layer], last[layer]])
        if not bool(((v == 0) | (v == 1)).all()):
            raise AssertionError(f"debug: {names[layer]} outside {{0, 1}}")
    for v in (first[C.LAYER_BOUNCES], last[C.LAYER_BOUNCES]):
        if not bool(((v >= 1) & (v <= DEPTH)).all()):
            raise AssertionError("debug: bounces outside [1, depth]")
    hit0 = first[C.LAYER_MISS, ..., 0] == 0
    if not bool((first[C.LAYER_DEPTH, ..., 0][hit0] > 0).all()):
        raise AssertionError("debug: depth 0 on a primary hit")
    aov = {names[i]: [float(first[i].min()), float(first[i].max())]
           for i in range(1, 10)}
    print(f"  [debug] AOV ranges at sample 0: {json.dumps(aov)}", flush=True)

    # the device ray log: a grid, the floor, an escape, an emitter
    t = time.perf_counter()
    grid = [(int(w * (i + 0.5) / 8), int(h * (j + 0.5) / 6))
            for j in range(6) for i in range(8)]
    floor = (w // 2, h - 1 - h // 20)
    logs = check_ray_log(debug_rays, scene, stats, fov_x, w, h,
                         grid + [floor], C.LAYER_DEPTH, C.LAYER_BOUNCES)
    escapes = [lg for lg in logs if lg[4]]
    emitters = [lg for lg in logs if lg[5]]
    if not escapes or not emitters:
        raise AssertionError(f"debug: of {len(logs)} pixels {len(escapes)} "
                             f"paths escape, {len(emitters)} reach an "
                             "emitter")
    if bool(first[C.LAYER_MISS].any()):
        raise AssertionError("the demo's camera sees sky")
    # a primary miss: the cube at the same frame
    chost = gltf.read_gltf(assets.generate("cube", scene_dir)["gltf"])
    cube = build.finish_scene(chost, device=dev)
    cfov = chost.cam.fov_x * (WIDTH / HEIGHT)
    cres = rt.render_scene(cube, dcfg.replace(samples=1), cfov, device=dev)
    miss = torch.nonzero(cres.stats.first[C.LAYER_MISS, ..., 0] == 1)
    hits = torch.nonzero(cres.stats.first[C.LAYER_MISS, ..., 0] == 0)
    if miss.shape[0] == 0 or hits.shape[0] == 0:
        raise AssertionError("debug: the cube frame has no primary miss")
    cube_px = [(int(miss[0, 1]), int(miss[0, 0])),
               (int(hits[hits.shape[0] // 2, 1]),
                int(hits[hits.shape[0] // 2, 0]))]
    cube_logs = check_ray_log(debug_rays, cube, cres.stats, cfov, w, h,
                              cube_px, C.LAYER_DEPTH, C.LAYER_BOUNCES)
    if not np.isinf(cube_logs[0][2]):
        raise AssertionError("debug: the cube's miss pixel hit")
    del cres, cube
    ray_log_s = time.perf_counter() - t
    print(f"  [debug] ray log == frame on {len(logs)} demo pixels "
          f"({len(escapes)} escape, {len(emitters)} reach an emitter; the "
          f"floor {logs[-1]}) and {len(cube_logs)} cube pixels (a primary "
          f"miss {cube_logs[0]}); {ray_log_s:.3f} s", flush=True)

    # the preview: overlays, then HTTP on 127.0.0.1
    t = time.perf_counter()
    pv = preview.Preview(scene.cam_pos.cpu().numpy(),
                         scene.cam_basis.cpu().numpy(), fov_x, (w, h),
                         flat_bvh=scene.bvh, scene=scene, ray_depth=DEPTH,
                         seed=dcfg.seed, intersector="pallas")
    pv.update(stats, DEBUG_STEPS)
    px = emitters[0][:2]
    base = pv.frame(C.LAYER_NORMAL, "mean")
    over = pv.frame(C.LAYER_NORMAL, "mean", lines_level=2, pixel=px)
    if base.shape != (h, w, 3) or np.array_equal(base, over):
        raise AssertionError("debug: the preview's overlays drew nothing")
    port = pv.serve(0)
    try:
        url = f"http://127.0.0.1:{port}"
        page = urllib.request.urlopen(f"{url}/", timeout=60).read()
        if b"9: miss" not in page:
            raise AssertionError("debug: the preview's page lists no layers")
        data = urllib.request.urlopen(
            f"{url}/frame.png?layer=2&mode=first&lines=1&pixel="
            f"{px[0]},{px[1]}", timeout=120).read()
    finally:
        pv.stop()
    img = png.decode(data)
    if img.shape != (h, w, 3):
        raise AssertionError(f"debug: the preview's PNG is {img.shape}")
    preview_s = time.perf_counter() - t

    # --debug-nans: one more step with the check, bit-equal to one without
    key = prng.key_from_seed(dcfg.seed)
    steps = {}
    for name, on in (("plain", False), ("checked", True)):
        st = accum_copy(stats)
        step = rt.make_render_step(dcfg, fov_x, device=dev, debug_nans=on)
        sync(dev)
        t = time.perf_counter()
        step(scene, st, key, DEBUG_STEPS)
        sync(dev)
        steps[name] = (st, (time.perf_counter() - t) * 1e3)
    for f in ("first", "last", "total", "total_sq", "count"):
        if not torch.equal(getattr(steps["plain"][0], f),
                           getattr(steps["checked"][0], f)):
            raise AssertionError(f"debug: --debug-nans changed {f}")
    nan_ms = {k: v[1] for k, v in steps.items()}
    del steps
    if profile:
        ps = time.perf_counter()
        profile_step(rt, accum_copy(stats), scene, dcfg, fov_x, None, dev,
                     "debug")
        print(f"  [debug] profile {time.perf_counter() - ps:.3f} s",
              flush=True)

    # the CLI in process
    DEBUG_PNG.parent.mkdir(parents=True, exist_ok=True)
    argv = [str(demo_gltf), str(DEBUG_PNG), "--debug", "--layer", "depth",
            "--mode", "first", "--preview-file", str(DEBUG_SNAP), "--width",
            str(w), "--height", str(h), "--ray-depth", str(DEPTH),
            "--num-samples", str(DEBUG_STEPS)]
    if rehearsal:
        argv += ["--intersector", "pallas"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv, device=dev)
    sync(dev)
    text = out.getvalue()
    print("  [debug] cli: " + " | ".join(
        ln for ln in text.splitlines() if "Throughput" in ln or "Trial" in ln),
        flush=True)
    if rc != 0:
        raise AssertionError(f"debug: cli exit code {rc}")
    for path in (DEBUG_PNG, DEBUG_SNAP):
        if images.load_image(path).data.shape != (h, w, 3):
            raise AssertionError(f"debug: {path.name} does not decode")

    step_ms = sum(r["step_s"]) / len(r["step_s"]) * 1e3
    demo_step_ms = sum(demo["step_s"]) / len(demo["step_s"]) * 1e3
    print(f"  [debug] {r['mrays']:.3f} Mrays/s, step {step_ms:.3f} ms, peak "
          f"{r['peak_gib']:.3f} GiB; compacted demo {demo['mrays']:.3f} "
          f"Mrays/s, step {demo_step_ms:.3f} ms; --debug-nans step "
          f"{nan_ms['checked']:.3f} ms against {nan_ms['plain']:.3f} "
          f"without; preview {preview_s:.3f} s ({card})", flush=True)
    return {"k1": k1, "k2": k2, "mrays": r["mrays"], "step_ms": step_ms,
            "demo_step_ms": demo_step_ms, "peak_gib": r["peak_gib"],
            "launches": r["launches"], "per_step": r["per_step"],
            "calibration": r["calibration"], "nan_check_ms": nan_ms,
            "ray_log_pixels": len(logs) + len(cube_logs),
            "preview_s": preview_s}


def accum_copy(stats):
    """A copy of render statistics, for steps that must not touch the
    render's own."""
    import dataclasses

    return dataclasses.replace(stats, **{
        f.name: getattr(stats, f.name).clone()
        for f in dataclasses.fields(stats)})


def cli_path(pi, lc, counters, dev, demo_gltf, scene_dir, w, h,
             rehearsal):
    """The port's CLI in process on the demo glTF: exit code, summary and
    Throughput lines, the PNG, and the compacted main path's launch counts
    (8 K1 and 8 K2 a sample, 8 each in calibration); then --oracle on the
    cube."""
    import contextlib
    import io

    import numpy as np

    from raytracer_odin_tpu_torch import cli
    from raytracer_odin_tpu_torch.io import images
    from raytracer_odin_tpu_torch.models import assets

    spp, trials = 4, 2
    CLI_PNG.parent.mkdir(parents=True, exist_ok=True)
    argv = [str(demo_gltf), str(CLI_PNG), "--width", str(w), "--height",
            str(h), "--ray-depth", str(DEPTH), "--num-samples", str(spp),
            "--times", str(trials)]
    if rehearsal:
        # "auto" means "pallas" on the card; on the CPU it would walk the BVH
        argv += ["--intersector", "pallas"]

    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    reset_counts(counters)
    out = Tee()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv, device=dev)
    sync(dev)
    launches = read_counts(counters)
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"cli: exit code {rc}")
    if "Performance Summary" not in text or "Throughput:" not in text:
        raise AssertionError("cli: no performance summary or Throughput")
    mrays = float(text.split("Throughput:")[1].split()[0])
    img = images.load_image(CLI_PNG)
    if img.data.shape != (h, w, 3):
        raise AssertionError(f"cli: the PNG is {img.data.shape}")
    per_sample = DEPTH
    want = {"K1": per_sample * (1 + spp * trials),
            "K2": per_sample * (1 + spp * trials)}
    if not rehearsal and any(launches[k] != want.get(k, 0)
                             for k in launches):
        raise AssertionError(f"cli: launches {launches}, want {want}")
    cube = assets.generate("cube", scene_dir)["gltf"]
    oracle_png = CLI_PNG.with_name("cli_oracle_cube.png")
    t = time.perf_counter()
    rc = cli.main([str(cube), str(oracle_png), "--width", "16", "--height",
                   "16", "--num-samples", "2", "--oracle", "--quiet"],
                  device=dev)
    oracle_s = time.perf_counter() - t
    orc = images.load_image(oracle_png).data
    if rc != 0 or orc.shape != (16, 16, 3) or not np.isfinite(orc).all():
        raise AssertionError("cli: --oracle wrote no image")
    return {"mrays": mrays, "launches": launches, "want": want,
            "png": str(CLI_PNG.relative_to(ROOT)), "oracle_s": oracle_s,
            "oracle_mean": float(orc.mean())}


def record_sweeps(trav, fn):
    """fn() with traverse._sweep_exact recording the (mask words, kernel
    rows) of every sweep it is given, in call order; the kernel wrappers
    and their counts are untouched. Returns (fn's result, the batches)."""
    real = trav._sweep_exact
    seen = []

    def sweep(scene_, words, rays, g, n_super, cap=LIST_CAP):
        seen.append((words.clone(), rays.clone()))
        return real(scene_, words, rays, g, n_super, cap)

    trav._sweep_exact = sweep
    try:
        out = fn()
    finally:
        trav._sweep_exact = real
    return out, seen


def batch_checks(pi, trav, scene, batch, dev, reps):
    """K1 and K2 against their plain versions on a recorded sorted batch
    (K1 on the batch's rows, as the demo's bounce-1 check takes them)."""
    words, rays = batch
    g, n_super, aabb8 = trav.exact_cull_layout(scene)
    return (measure_k1(pi, aabb8, rays, n_super, dev, reps),
            measure_sweep(pi, trav, scene, words, rays, g, n_super, dev,
                          reps))


def sync_sites(fn, dev) -> dict:
    """fn() under torch.cuda.set_sync_debug_mode("warn"): the host syncs it
    makes, counted by the file:line of the Python frame that made each
    ("not measured on the CPU" there)."""
    import warnings

    import torch

    if dev.type != "cuda":
        fn()
        return {"not measured on the CPU": 0}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        sites[where] = sites.get(where, 0) + 1
    return sites


def same_stats(a, b, name, tol=None):
    """Every field of stats `a` equal to `b` (with tol, a dict field ->
    (rtol, atol), those fields within it). Returns the largest absolute
    difference a field."""
    import torch

    diffs = {}
    for f in ("first", "last", "total", "total_sq", "count"):
        x, y = getattr(a, f), getattr(b, f)
        diffs[f] = float((x - y).abs().max())
        if tol and f in tol:
            rtol, atol = tol[f]
            ok = torch.allclose(x, y, rtol=rtol, atol=atol)
        else:
            ok = torch.equal(x, y)
        if not ok:
            raise AssertionError(f"{name}: {f} differs (max {diffs[f]})")
    return diffs


# The most pixels two schedulers' frames may differ in, each explained by
# grouping_flips.
MAX_FLIPS = 16


def grouping_flips(rt, integ, scene, cfg, fov_x, pixels, n_samples,
                   first_sample=0):
    """Explain the pixels (row, x) where two schedulers' frames differ.
    Exact culling lists for each block of rays the clusters their own K1
    masks hold, so a ray whose slab test rounds out the box of a cluster it
    hits finds that hit only where another ray of its block lists the
    cluster (ROADMAP.md queue C item 4): its hit depends on which rays
    share its block, and the pool and refill group rays otherwise than the
    batched render. A pixel is explained when one of its samples, traced
    alone with its stream id through "pallas" (lists from its own masks)
    and through "pallas_brute" (K3: every cluster), meets a bounce whose
    hit distances differ (samples first_sample .. n_samples - 1 are
    tried). Returns (x, row, sample, bounce, t from its own
    lists, t over every cluster) a pixel; raises for a pixel it cannot
    explain."""
    import torch

    from raytracer_odin_tpu_torch.utils import prng

    key = prng.key_from_seed(cfg.seed)
    w, h = cfg.width, cfg.height
    out = []
    for row, x in pixels:
        found = None
        for s in range(first_sample, n_samples):
            o, d = rt.camera_rays(scene, key, s, fov_x, w, h, row, 1)
            o, d = o[0, x:x + 1], d[0, x:x + 1]
            sid = torch.full((1,), row * w + x, dtype=torch.int32,
                             device=o.device)
            ts = [integ.trace(scene, o, d, key, s, integ.TraceOptions(
                depth=cfg.ray_depth, intersector=name, log_paths=True),
                stream_ids=sid)[1]["ray_log"]["t"][:, 0]
                for name in ("pallas", "pallas_brute")]
            diff = torch.nonzero(ts[0] != ts[1])
            if diff.numel():
                b = int(diff[0, 0])
                found = (x, row, s, b, float(ts[0][b]), float(ts[1][b]))
                break
        if found is None:
            raise AssertionError(
                f"pixel ({x}, {row}) differs between the schedulers, and no "
                "sample of it meets a triangle its own K1 mask rounds out")
        out.append(found)
    return out


def schedulers_agree(rt, integ, scene, cfg, fov_x, got, want, name, tol,
                     n_samples, lanes=0):
    """`got` (a RenderResult of the pool or refill) against `want` (the
    batched render of the same samples): every pixel within `tol` (exact
    where a field has none) but at most MAX_FLIPS, each explained by
    grouping_flips; ray and live-lane counts within a path a differing
    (pixel, sample), and a path of each of `lanes` lanes explained apart
    (lanes whose path changed but not their pixel). Returns (the largest
    difference a field over the agreeing pixels, the flips)."""
    import torch

    a, b = got.stats, want.stats
    bad = torch.zeros(a.count.shape[1:], dtype=torch.bool,
                      device=a.count.device)
    for f in ("first", "last", "total", "total_sq"):
        x, y = getattr(a, f)[0], getattr(b, f)[0]
        rtol, atol = (tol or {}).get(f, (0.0, 0.0))
        bad |= ((x - y).abs() > atol + rtol * y.abs()).any(-1)
    bad |= a.count[0] != b.count[0]
    pixels = torch.nonzero(bad).tolist()
    if len(pixels) > MAX_FLIPS:
        raise AssertionError(f"{name}: {len(pixels)} pixels differ from the "
                             f"batched render (at most {MAX_FLIPS})")
    flips = grouping_flips(rt, integ, scene, cfg, fov_x, pixels, n_samples)
    paths = len(pixels) * n_samples + lanes
    if (abs(got.rays_cast - want.rays_cast) > DEPTH * paths
            or any(abs(u - v) > paths for u, v in zip(got.alive_counts,
                                                    want.alive_counts))):
        raise AssertionError(
            f"{name}: rays {got.rays_cast} and live lanes "
            f"{got.alive_counts} against the batched render's "
            f"{want.rays_cast} and {want.alive_counts}, beyond "
            f"{len(pixels)} differing pixels' paths")
    keep = ~bad[..., None]
    diffs = {f: float(torch.where(keep, getattr(a, f)[0] - getattr(b, f)[0],
                                  0.0).abs().max())
             for f in ("first", "last", "total", "total_sq")}
    return diffs, flips


# The spp mesh's tolerance (tests/test_torch_parallel.py) and the pool's
# against the batched render (tests/test_torch_wavefront.py).
SPP_TOL = {"total": (1e-4, 1e-5), "total_sq": (1e-4, 1e-5),
           "first": (1e-5, 1e-6), "last": (1e-5, 1e-6)}
POOL_TOL = {"total": (1e-5, 1e-6), "total_sq": (1e-5, 1e-6)}


def path_info(scene, g):
    return {"triangles": scene.num_triangles,
            "clusters": scene.cluster_lo.shape[0],
            "lights": scene.num_lights, "g": g, "streamed": False}


def mesh_path(rt, trav, pi, scene, cfg, fov_x, dev, counters, reps, card,
              demo, g, profile):
    """Phase 11: the tile mesh and the spp mesh (module docstring)."""
    import torch

    from raytracer_odin_tpu_torch.parallel import mesh as pmesh
    from raytracer_odin_tpu_torch.render import accum
    from raytracer_odin_tpu_torch.utils import prng

    w, h, steps = cfg.width, cfg.height, cfg.samples
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    key = prng.key_from_seed(cfg.seed)

    def run(n_tile, n_spp, devices, mcfg):
        mesh = pmesh.make_mesh(n_tile, n_spp, devices=devices)
        rs = pmesh.replicate_scene(scene, mesh)
        h_pad = pmesh.padded_height(h, n_tile)

        def fresh():
            return pmesh.shard_stats(accum.init_stats(
                1, h_pad, w, device=mesh.devices[0][0]), mesh)

        r = render_path(
            rt, rs, mcfg, fov_x, dev, counters, mcfg.samples //
            mcfg.samples_per_step,
            make_step=lambda: pmesh.make_sharded_render_step(
                mcfg, fov_x, mesh, rs),
            make_stats=fresh)
        res = r["res"]
        if res.overflow != 0 or r["step"].lane_schedule is None:
            raise AssertionError(f"mesh {n_tile} x {n_spp}: overflow "
                                 f"{res.overflow}, or uncompacted")
        shards = n_tile * n_spp
        per = mcfg.samples_per_step // n_spp * shards
        check_launches(f"mesh {n_tile} x {n_spp}", r,
                       {"K1": per * DEPTH, "K2": per * DEPTH},
                       {"K1": n_tile * DEPTH, "K2": n_tile * DEPTH},
                       dev.type != "cuda")
        r["where"] = (f"{shards} shards on one card"
                      if len(mesh.distinct) == 1 else
                      f"{shards} shards on {len(mesh.distinct)} cards")
        r["step_ms"] = sum(r["step_s"]) / len(r["step_s"]) * 1e3
        r["cropped"] = accum.crop(res.stats, h, w)
        return r, mesh, rs, fresh

    # the tile mesh: bit-equal to the single-card compacted demo render
    tile, mesh, rs, fresh = run(2, 1, [dev, dev], cfg)
    print_render(tile, steps, card)
    tres = tile["res"]
    if tres.rays_cast != demo["res"].rays_cast:
        raise AssertionError(f"mesh 2 x 1: {tres.rays_cast} rays, the "
                             f"single card {demo['res'].rays_cast}")
    same_stats(tile["cropped"], demo["res"].stats, "mesh 2 x 1")
    step = tile["step"]
    print(f"  [mesh] 2 x 1 ({tile['where']}): bit-equal to the single-card "
          f"frame; step {tile['step_ms']:.3f} ms, {tile['mrays']:.3f} "
          f"Mrays/s (single card {demo['mrays']:.3f}); lane budgets a "
          f"tile {step.lane_schedule} ({card})", flush=True)

    # K1 and K2 on shard 0's bounce-1 batch (the second sweep of its
    # first sample; the first is bounce 0's tiled cast)
    opts = rt._trace_options(cfg, step.lane_schedule[0])
    _, seen = record_sweeps(trav, lambda: rt.sample_pass(
        scene, key, 0, fov_x, w, h, opts, row_offset=0,
        n_rows=step.h_local))
    k1, k2 = batch_checks(pi, trav, scene, seen[1], dev, reps)
    del seen
    print(f"  [mesh] K1 on shard 0's bounce-1 batch: {json.dumps(k1)}",
          flush=True)
    print(f"  [mesh] K2 on shard 0's bounce-1 batch: {json.dumps(k2)}",
          flush=True)

    # host syncs of one sharded step, and of one single-card compacted
    # step, by the line that makes them
    st = fresh()
    syncs = sync_sites(lambda: step(rs, st, key, steps), dev)
    sync(dev)
    single = rt.make_render_step(cfg, fov_x,
                                 lane_schedule=demo["res"].lane_schedule,
                                 device=dev)
    st1 = accum.init_stats(1, h, w, device=dev)
    syncs1 = sync_sites(lambda: single(scene, st1, key, steps), dev)
    sync(dev)
    del st, st1
    print(f"  [mesh] host syncs of one 2 x 1 step: {json.dumps(syncs)}; of "
          f"one single-card compacted step: {json.dumps(syncs1)}",
          flush=True)
    if profile:
        profile_step(rt, fresh(), rs, cfg, fov_x, None, dev, "mesh",
                     step=step)
    del tile["cropped"]

    # the spp mesh: 2 x 2 at 2 spp a step against the single card
    scfg = cfg.replace(samples=4, samples_per_step=2)
    quad = [torch.device("cuda", i) for i in range(4)] if n_cards >= 4 \
        else [dev] * 4
    spp, *_ = run(2, 2, quad, scfg)
    print_render(spp, 2, card)
    ref = rt.render_scene(scene, scfg, fov_x, device=dev)
    if spp["res"].rays_cast != ref.rays_cast:
        raise AssertionError("mesh 2 x 2: ray count differs")
    spp_diff = same_stats(spp["cropped"], ref.stats, "mesh 2 x 2", SPP_TOL)
    del ref, spp["cropped"]
    print(f"  [mesh] 2 x 2 ({spp['where']}) at 2 spp a step: within the "
          f"spp tolerance of the single card (max differences "
          f"{json.dumps(spp_diff)}); step {spp['step_ms']:.3f} ms, "
          f"{spp['mrays']:.3f} Mrays/s ({card})", flush=True)

    two_cards = None
    if n_cards >= 2:
        pair = [torch.device("cuda", 0), torch.device("cuda", 1)]
        two, *_ = run(2, 1, pair, cfg)
        same_stats(two["cropped"], demo["res"].stats, "mesh on two cards")
        two_cards = {"mrays": two["mrays"], "step_ms": two["step_ms"],
                     "launches": two["launches"]}
        del two
        print(f"  [mesh] 2 x 1 on two cards: {two_cards['mrays']:.3f} "
              f"Mrays/s against one card's {demo['mrays']:.3f} ({card})",
              flush=True)
    else:
        print("  [mesh] one card here: the mesh over two cards is not "
              "measured", flush=True)
    launches = {k: tile["launches"][k] + spp["launches"][k]
                for k in tile["launches"]}
    return dict(path_info(scene, g), k1=k1, k2=k2, mrays=tile["mrays"],
                step_ms=tile["step_ms"], where=tile["where"],
                peak_gib=max(tile["peak_gib"], spp["peak_gib"]),
                launches=launches, per_step=tile["per_step"],
                calibration=tile["calibration"],
                lane_schedule=step.lane_schedule, syncs=syncs,
                syncs_single=syncs1,
                spp={"mrays": spp["mrays"], "step_ms": spp["step_ms"],
                     "where": spp["where"], "max_diff": spp_diff},
                two_cards=two_cards)


def pool_path(rt, trav, pi, scene, cfg, fov_x, dev, counters, reps, card,
              g, profile):
    """Phase 14: the persistent pool (module docstring)."""
    from raytracer_odin_tpu_torch.ops import integrator as integ
    from raytracer_odin_tpu_torch.render import accum
    from raytracer_odin_tpu_torch.utils import prng

    w, h = cfg.width, cfg.height
    pcfg = cfg.replace(samples=POOL_STEPS, wavefront_pool=True,
                       pool_fraction=0.5)
    r = render_path(rt, scene, pcfg, fov_x, dev, counters, POOL_STEPS)
    print_render(r, POOL_STEPS, card)
    res = r["res"]
    waves = list(res.pool_waves)
    if len(waves) != POOL_STEPS or res.overflow != 0:
        raise AssertionError(f"pool: waves {waves}, overflow {res.overflow}")
    want = {"K1": sum(waves), "K2": sum(waves)}
    got = r["launches"]
    if dev.type == "cuda" and any(got[k] != want.get(k, 0) for k in got):
        raise AssertionError(f"pool: launches {got}, want {want} (one K1 "
                             "and one K2 a wave)")
    # against the batched render of the same samples
    ref = rt.render_scene(scene, cfg.replace(samples=POOL_STEPS), fov_x,
                          device=dev)
    diff, flips = schedulers_agree(rt, integ, scene, cfg, fov_x, res, ref,
                                   "pool", POOL_TOL, POOL_STEPS)
    print(f"  [pool] against the batched render: pixels that differ, each "
          f"explained (x, row, sample, bounce, t over its own lists, t over "
          f"every cluster): {flips}; rays {res.rays_cast} against "
          f"{ref.rays_cast}", flush=True)
    del ref
    # reproducible: a second run gives the same bits
    again = rt.render_scene(scene, pcfg, fov_x, device=dev)
    same_stats(again.stats, res.stats, "pool run twice")
    del again
    # K1 and K2 on a wave of the steady state (lanes of several bounces)
    key = prng.key_from_seed(cfg.seed)
    step = rt.make_pool_render_step(pcfg, fov_x, device=dev)
    st = accum.init_stats(1, h, w, device=dev)
    _, seen = record_sweeps(trav, lambda: step(scene, st, key, 0))
    wave = len(seen) // 2
    k1, k2 = batch_checks(pi, trav, scene, seen[wave], dev, reps)
    del seen, st
    for name, m in (("K1", k1), ("K2", k2)):
        m["wave"] = wave
        print(f"  [pool] {name} on wave {wave}: {json.dumps(m)}", flush=True)
    if profile:
        profile_step(rt, accum_copy(res.stats), scene, pcfg, fov_x, None,
                     dev, "pool")
    step_ms = sum(r["step_s"]) / len(r["step_s"]) * 1e3
    print(f"  [pool] pool {step.pool_size} lanes; waves a step {waves}; "
          f"step {step_ms:.3f} ms, "
          f"{r['mrays']:.3f} Mrays/s, peak {r['peak_gib']:.3f} GiB; "
          f"against the batched render max differences {json.dumps(diff)} "
          f"but for {len(flips)} explained pixels; "
          f"reproducible ({card})", flush=True)
    return dict(path_info(scene, g), k1=k1, k2=k2, mrays=r["mrays"],
                step_ms=step_ms, waves=waves, peak_gib=r["peak_gib"],
                launches=r["launches"], max_diff=diff, flips=flips,
                reproducible=True)


def refill_path(rt, trav, pi, scene, cfg, fov_x, dev, counters, reps, card,
                demo, g, profile):
    """Phase 12: cross-sample refill (module docstring)."""
    from raytracer_odin_tpu_torch.ops import integrator as integ
    from raytracer_odin_tpu_torch.render import accum
    from raytracer_odin_tpu_torch.utils import prng

    w, h = cfg.width, cfg.height
    fcfg = cfg.replace(samples=REFILL_SPP * REFILL_STEPS,
                       samples_per_step=REFILL_SPP, compact="refill")
    r = render_path(rt, scene, fcfg, fov_x, dev, counters, REFILL_STEPS)
    print_render(r, REFILL_STEPS, card)
    res = r["res"]
    plan = res.refill_plan
    if res.overflow != 0 or plan is None:
        raise AssertionError(f"refill: overflow {res.overflow}, plan {plan}")
    iters = len(plan.fresh)
    check_launches("refill", r, {"K1": iters, "K2": iters},
                   {"K1": DEPTH, "K2": DEPTH}, dev.type != "cuda")
    # against the compacted render of the same samples, 4 spp a step
    sync(dev)
    t = time.perf_counter()
    ref = rt.render_scene(scene, fcfg.replace(compact="auto"), fov_x,
                          device=dev)
    ref_mrays = ref.rays_cast / sum(ref.trial_seconds) / 1e6
    diff, flips = schedulers_agree(rt, integ, scene, fcfg, fov_x, res, ref,
                                   "refill", None, fcfg.samples)
    print(f"  [refill] against the compacted render: pixels that differ, "
          f"each explained (x, row, sample, bounce, t over its own lists, t "
          f"over every cluster): {flips}; rays {res.rays_cast} against "
          f"{ref.rays_cast}", flush=True)
    del ref
    # K1 and K2 on an iteration of the steady state
    step = rt.make_refill_render_step(fcfg, fov_x, plan, device=dev)
    st = accum.init_stats(1, h, w, device=dev)
    key = prng.key_from_seed(cfg.seed)
    _, seen = record_sweeps(trav, lambda: step(scene, st, key, 0))
    it = len(seen) // 2
    k1, k2 = batch_checks(pi, trav, scene, seen[it], dev, reps)
    del seen, st
    for name, m in (("K1", k1), ("K2", k2)):
        m["iteration"] = it
        print(f"  [refill] {name} on iteration {it}: {json.dumps(m)}",
              flush=True)
    if profile:
        profile_step(rt, accum_copy(res.stats), scene, fcfg, fov_x, None,
                     dev, "refill", step=step)
    step_ms = sum(r["step_s"]) / len(r["step_s"]) * 1e3
    print(f"  [refill] {iters} iterations a step of {REFILL_SPP} spp, "
          f"widths {max(plan.keep)} at most; step {step_ms:.3f} ms, "
          f"{r['mrays']:.3f} Mrays/s against the compacted render's "
          f"{ref_mrays:.3f} at {REFILL_SPP} spp a step and the demo's "
          f"{demo['mrays']:.3f} at 1 ({len(flips)} pixels differ, each "
          f"explained; {card})", flush=True)
    return dict(path_info(scene, g), k1=k1, k2=k2, mrays=r["mrays"],
                step_ms=step_ms, iterations=iters, peak_gib=r["peak_gib"],
                launches=r["launches"], per_step=r["per_step"],
                calibration=r["calibration"], compacted_mrays=ref_mrays,
                max_diff=diff, flips=flips)


@contextlib.contextmanager
def setting(module, name, value):
    """module.name = value inside the block, restored after it."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def frame_vs(rt, integ, scene, cfg, fov_x, got, want, name):
    """The columnar frame `got` against the row-form frame `want` (sums of
    the same samples of `cfg`) at the glossy-scene gate's mean (MEAN_RTOL)
    and pass fraction (PASS_FRACTION of the values within rtol 1e-4, atol
    1e-5). Its MAX_ABS rule does not hold at 1080p: a lane whose direction
    or continuation test flips on an ulp takes another path (lane_flips),
    and a few thousand of 10 M paths do. So the pixels beyond MAX_ABS are
    counted, and the MAX_FLIPS of them that differ most are each explained
    by lane_flips. Returns the count of values that differ at all, of the
    pixels beyond MAX_ABS, the largest difference, and the explained
    pixels."""
    import numpy as np

    g, w = np.asarray(got), np.asarray(want)
    if g.shape != w.shape or not np.isfinite(g).all():
        raise AssertionError(f"{name}: the frame is not finite or of the "
                             "reference's shape")
    within = float(np.isclose(g, w, rtol=1e-4, atol=1e-5).mean())
    if (abs(g.mean() - w.mean()) > MEAN_RTOL * abs(w.mean())
            or within < PASS_FRACTION):
        raise AssertionError(f"{name}: the frame differs beyond the glossy "
                             f"gate: mean {g.mean()} vs {w.mean()}, "
                             f"{within:.4f} of values within rtol 1e-4")
    diff = np.abs(g - w).max(-1)
    far = np.argwhere(diff > MAX_ABS)
    worst = far[np.argsort(-diff[tuple(far.T)], kind="stable")][:MAX_FLIPS]
    return {"values": int(w.size), "values_differ": int((g != w).sum()),
            "within_rtol_1e-4": within, "max_abs": float(diff.max()),
            "pixels_beyond_max_abs": int(len(far)),
            "explained": lane_flips(rt, integ, scene, cfg, fov_x,
                                    worst.tolist(), g, w)}


def lane_flips(rt, integ, scene, cfg, fov_x, pixels, got, want):
    """Explain the pixels (row, x) where the columnar frame `got` and the
    row-form frame `want` differ by more than MAX_ABS. The two forms round
    the shade's three-term reductions apart, so a lane's continuation test
    or its sampled direction can flip on an ulp and its path go elsewhere.
    A pixel is explained when its samples, each traced alone (one lane, its
    stream id) through the row-form and the columnar compacted trace, give
    the frame's difference: it is then the lane's own arithmetic, not its
    batch, its sort or the merge. Returns (x, row, the frame's difference,
    the sample whose lanes differ most, the live lanes entering each bounce
    of its path in each form) a pixel; raises for a pixel not so
    explained."""
    import numpy as np
    import torch

    from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
    from raytracer_odin_tpu_torch.utils import prng

    key = prng.key_from_seed(cfg.seed)
    w, h, depth = cfg.width, cfg.height, cfg.ray_depth
    opts = integ.TraceOptions(depth=depth, intersector="pallas",
                              lane_schedule=(pi.RB,) * (depth - 1))
    out = []
    for row, x in pixels:
        lanes = {}
        for cols in (0, 1):
            with setting(integ, "COLS", cols):
                for s in range(cfg.samples):
                    o, d = rt.camera_rays(scene, key, s, fov_x, w, h, row, 1)
                    sid = torch.full((1,), row * w + x, dtype=torch.int32,
                                     device=o.device)
                    r, aux = integ.trace(scene, o[0, x:x + 1], d[0, x:x + 1],
                                         key, s, opts, stream_ids=sid)
                    lanes[cols, s] = (r[0].cpu().numpy(),
                                      aux["alive_counts"].tolist())
        alone = sum(lanes[1, s][0] - lanes[0, s][0]
                    for s in range(cfg.samples))
        frame = got[row, x] - want[row, x]
        if not np.allclose(alone, frame, rtol=1e-3, atol=1e-4):
            raise AssertionError(
                f"pixel ({x}, {row}): the frames differ by {frame.tolist()}, "
                f"its lanes traced alone by {alone.tolist()}")
        s = max(range(cfg.samples), key=lambda k: float(np.abs(
            lanes[1, k][0] - lanes[0, k][0]).max()))
        out.append((x, row, frame.tolist(), s, lanes[0, s][1],
                    lanes[1, s][1]))
    return out


def cols_path(rt, integ, trav, pi, scene, cfg, fov_x, dev, counters, reps,
              card, demo, g, profile):
    """Phase 15: the demo through the columnar trace (integ.COLS = 1),
    calibration plus the demo's steps: overflow 0, K1 and K2 8 a step and
    8 in calibration, K1 and K2 against their plain versions on the
    columnar route's sorted bounce-1 batch, the frame against the row-form
    demo frame of this run at the glossy-scene gate with the count of
    values that differ, Mrays/s, step time and peak memory beside the
    demo's."""
    from raytracer_odin_tpu_torch.render import accum
    from raytracer_odin_tpu_torch.utils import prng

    steps = cfg.samples
    with setting(integ, "COLS", 1):
        r = render_path(rt, scene, cfg, fov_x, dev, counters, steps)
        print_render(r, steps, card)
        res = r["res"]
        if res.overflow != 0 or res.lane_schedule is None:
            raise AssertionError(f"cols: overflow {res.overflow}")
        check_launches("cols", r, {"K1": DEPTH, "K2": DEPTH},
                       {"K1": DEPTH, "K2": DEPTH}, dev.type != "cuda")
        step = rt.make_render_step(cfg, fov_x,
                                   lane_schedule=res.lane_schedule,
                                   device=dev)
        st = accum.init_stats(1, cfg.height, cfg.width, device=dev)
        _, seen = record_sweeps(trav, lambda: step(
            scene, st, prng.key_from_seed(cfg.seed), 0))
        k1, k2 = batch_checks(pi, trav, scene, seen[1], dev, reps)
        del seen
        syncs = sync_sites(lambda: step(
            scene, st, prng.key_from_seed(cfg.seed), 1), dev)
        del st
        if profile:
            profile_step(rt, accum_copy(res.stats), scene, cfg, fov_x, None,
                         dev, "cols", step=step)
    for name, m in (("K1", k1), ("K2", k2)):
        print(f"  [cols] {name} on the sorted bounce-1 batch: "
              f"{json.dumps(m)}", flush=True)
    frame = frame_vs(rt, integ, scene, cfg, fov_x, res.stats.total[0].cpu(),
                     demo["res"].stats.total[0].cpu(), "cols")
    step_ms = sum(r["step_s"]) / len(r["step_s"]) * 1e3
    demo_ms = sum(demo["step_s"]) / len(demo["step_s"]) * 1e3
    print(f"  [cols] step {step_ms:.3f} ms, {r['mrays']:.3f} Mrays/s, peak "
          f"{r['peak_gib']:.3f} GiB; row-form demo {demo_ms:.3f} ms, "
          f"{demo['mrays']:.3f} Mrays/s, peak {demo['peak_gib']:.3f} GiB; "
          f"host syncs of one step {json.dumps(syncs)}; frame against the "
          f"demo's {json.dumps(frame)} ({card})", flush=True)
    return dict(path_info(scene, g), k1=k1, k2=k2, mrays=r["mrays"],
                step_ms=step_ms, demo_step_ms=demo_ms, peak_gib=r["peak_gib"],
                launches=r["launches"], per_step=r["per_step"],
                calibration=r["calibration"], frame=frame, syncs=syncs)


def cols_citynight_path(rt, integ, trav, lc, scene, cfg, fov_x, dev,
                        counters, reps, card, row_frame, row_mrays, profile):
    """Phase 16: citynight through the columnar trace, PATH_STEPS steps:
    overflow 0, K1, K2 and K5 8 a step and 8 in calibration (the row
    route's), K5 against its plain version on the columnar bounce-0 shading
    batch (the stack boundary of shading_cols.mixture_pdf) and the culled
    pdf against the dense sum there, lanes through a light's edge
    explained (edge_flips), the frame against the row-form citynight frame
    at the glossy-scene gate."""
    from raytracer_odin_tpu_torch.utils import prng

    steps = cfg.samples
    g, _, _ = trav.exact_cull_layout(scene)
    with setting(integ, "COLS", 1):
        r = render_path(rt, scene, cfg, fov_x, dev, counters, steps)
        print_render(r, steps, card)
        res = r["res"]
        if res.overflow != 0 or res.lane_schedule is None:
            raise AssertionError(f"cols citynight: overflow {res.overflow}")
        want = {"K1": DEPTH, "K2": DEPTH, "K5": DEPTH}
        check_launches("cols citynight", r, want, want, dev.type != "cuda")
        step = rt.make_render_step(cfg, fov_x,
                                   lane_schedule=res.lane_schedule,
                                   device=dev)
        seen = light_pdf_inputs(lc, step, scene, accum_copy(res.stats),
                                prng.key_from_seed(cfg.seed), steps, dev)
        k5 = measure_k5(lc, scene, *seen[0], dev, reps)
        del seen
        if profile:
            profile_step(rt, accum_copy(res.stats), scene, cfg, fov_x, None,
                         dev, "cols_citynight", step=step)
    print(f"  [cols citynight] K5 on the bounce-0 shading batch: "
          f"{json.dumps(k5)}", flush=True)
    frame = frame_vs(rt, integ, scene, cfg, fov_x, res.stats.total[0].cpu(),
                     row_frame, "cols citynight")
    step_ms = sum(r["step_s"]) / len(r["step_s"]) * 1e3
    print(f"  [cols citynight] step {step_ms:.3f} ms, {r['mrays']:.3f} "
          f"Mrays/s (row form {row_mrays:.3f}), peak {r['peak_gib']:.3f} "
          f"GiB; frame against the row form's {json.dumps(frame)} ({card})",
          flush=True)
    return dict(path_info(scene, g), k5=k5, mrays=r["mrays"],
                step_ms=step_ms, peak_gib=r["peak_gib"],
                launches=r["launches"], per_step=r["per_step"],
                calibration=r["calibration"], frame=frame)


# The configs of the accuracy phase whose sorted, compacted bounce-1
# batches K1 and K2 are held against their plain versions: textured
# glossy paths and the env map's escaping lanes.
ACCURACY_BATCHES = ("cfg3_textured", "cfg4_envmap")
# The report of the accuracy phase, under the gitignored chiprun_out/.
ACCURACY_REPORT = ROOT / "chiprun_out" / "accuracy_report.jsonl"
# The report's keys each row of the accuracy phase prints.
ACCURACY_KEYS = ("same_seed_rmse", "same_seed_over_indep_floor",
                 "same_seed_mean_shift_z", "oracle_mean_shift_z",
                 "rmse_over_floor", "frac_z_gt4", "mean_test",
                 "same_seed_pass", "distribution_agrees")


def accuracy_launches(configs, render, rows, draws, chunk) -> int:
    """K1 (and K2) launches the harness makes over `rows` on the card: one
    a bounce of every trace. The same-seed half goes through the runtime's
    own step with RenderConfig's default compact "off", a trace a sample;
    the proxy and the draws trace a step of render.step_samples samples
    at once (render.batched_step)."""
    n = 0
    for name, _s, w, h, depth, _c, ss_spp, (pw, ph, _p) in rows:
        if name not in configs.NO_SAME_SEED:
            n += depth * ss_spp
        spp = configs.PROXY_SPP
        n += depth * spp // render.step_samples(spp, pw * ph)
        if name in configs.DRAW_CONFIGS:
            n += depth * draws * chunk // render.step_samples(chunk, pw * ph)
    return n


def accuracy_path(rt, integ, trav, pi, dev, counters, reps, card,
                  rehearsal):
    """Phase 17: the accuracy harness (raytracer_odin_tpu_torch/accuracy)
    on the five BASELINE configs at full size: K1 and K2 against their
    plain versions on the sorted, compacted bounce-1 batches of
    ACCURACY_BATCHES; then, launches counted from zero, the same-seed half
    of cfg1-cfg5 (through the runtime's own step), the
    proxy half of all six rows and cfg5's 16 draws of
    512 spp, and the report against out/rmse/ (the JAX package's CPU
    renders and the oracle; a missing reference raises, naming the file):
    every row held to same_seed_pass and distribution_agrees, one line a
    row; K1 and K2 launched accuracy_launches times each, K3-K5 never;
    peak memory. A CPU rehearsal runs cfg1_cube alone, its kernel batches
    at its own small frame."""
    import torch

    from raytracer_odin_tpu_torch.accuracy import configs, render, report
    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.utils import prng

    rows = ([configs.row("cfg1_cube")] if rehearsal
            else list(configs.CONFIGS))
    configs.require_references(rows)
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_rmse_"))
    harness = render.Harness(dev, out_dir, log=lambda s: print(
        f"  [accuracy] {s}", flush=True))
    checks = {}
    for name in ACCURACY_BATCHES:
        _, sname, w, h, depth, _c, _ss, _p = configs.row(name)
        if rehearsal:
            w, h = 64, 36
        host, scene = harness.scene(sname)
        cfg = RenderConfig(width=w, height=h, ray_depth=depth, samples=1,
                           samples_per_step=1, seed=0,
                           intersector="pallas", compact="auto")
        kb = kernel_batches(rt, integ, trav, prng, pi, scene, cfg,
                            host.cam.fov_x * (w / h), dev)
        checks[name] = {
            "K1": measure_k1(pi, kb["aabb8"], kb["rays1"], kb["n_super"],
                             dev, reps),
            "K2": measure_sweep(pi, trav, scene, kb["words1"], kb["rays1"],
                                kb["g"], kb["n_super"], dev, reps)}
        del kb
        for k in ("K1", "K2"):
            print(f"  [accuracy] {name} {k} bounce 1: "
                  f"{json.dumps(checks[name][k])}", flush=True)

    reset_counts(counters)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    draws, chunk = 16, 512
    t0 = time.perf_counter()
    for name, *_ in rows:
        harness.same_seed(name)
        harness.proxy(name)
        if name in configs.DRAW_CONFIGS:
            harness.draws(name, draws, chunk, var_sweep=False)
    sync(dev)
    render_s = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0)
    records = report.report(out_dir, None, rows, card, log=lambda s: None)
    ACCURACY_REPORT.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(out_dir / "report.jsonl", ACCURACY_REPORT)
    for rec in records:
        line = {k: rec[k] for k in ACCURACY_KEYS if k in rec}
        if "oracle_emp" in rec:
            line["mean_shift_z_emp"] = rec["oracle_emp"]["mean_shift_z_emp"]
        line["seconds"] = round(harness.seconds.get(rec["config"], 0.0), 3)
        print(f"  [accuracy] {rec['config']}: {json.dumps(line)}",
              flush=True)
    bad = report.failures(records)
    if bad:
        raise AssertionError(f"accuracy: rows fail their gates: {bad}")
    for rec in records:
        if (rec["config"] in configs.DRAW_CONFIGS
                and rec.get("mean_test") != "empirical_two_sample"):
            raise AssertionError(f"accuracy: {rec['config']}'s mean test is "
                                 "not the empirical two-sample test")
    want = accuracy_launches(configs, render, rows, draws, chunk)
    print(f"  [accuracy] launches {json.dumps(launches)} (K1 and K2 "
          f"{want} each wanted); harness {render_s:.3f} s; peak device "
          f"memory {peak:.3f} GiB ({card})", flush=True)
    if not rehearsal and (launches["K1"] != want or launches["K2"] != want
                          or any(launches[k] for k in ("K1 tmax", "K3",
                                                       "K4", "K5"))):
        raise AssertionError(f"accuracy: launches {launches}, want K1 and "
                             f"K2 {want} each and no other kernel")
    shutil.rmtree(out_dir)
    return {"launches": launches, "checks": checks, "render_s": render_s,
            "peak_gib": peak, "records": len(records)}


def sched_cli_path(dev, demo_gltf, w, h, rehearsal):
    """Phase 13: the CLI in process with --devices 2 (two shards on one
    card where there is one), --pool and --compact refill: each exits 0 and
    writes a PNG that decodes."""
    import contextlib
    import io

    import torch

    from raytracer_odin_tpu_torch import cli
    from raytracer_odin_tpu_torch.io import images

    two_cards = dev.type == "cuda" and torch.cuda.device_count() >= 2
    out = {}
    for name, flags in (("mesh", ["--devices", "2"]), ("pool", ["--pool"]),
                        ("refill", ["--compact", "refill"])):
        png_path = CLI_PNG.with_name(f"cli_{name}.png")
        argv = [str(demo_gltf), str(png_path), "--width", str(w),
                "--height", str(h), "--ray-depth", str(DEPTH),
                "--num-samples", str(SCHED_CLI_SPP), *flags]
        if rehearsal:
            argv += ["--intersector", "pallas"]
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main(argv, device="cuda" if (two_cards and
                                                  name == "mesh") else dev)
        sync(dev)
        lines = [ln for ln in text.getvalue().splitlines()
                 if "Throughput" in ln or "Mesh:" in ln]
        if rc != 0:
            raise AssertionError(f"cli {flags}: exit code {rc}")
        if images.load_image(png_path).data.shape != (h, w, 3):
            raise AssertionError(f"cli {flags}: the PNG does not decode")
        out[name] = lines
        print(f"  [cli {' '.join(flags)}] " + " | ".join(lines), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
