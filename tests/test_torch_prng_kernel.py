"""The draw kernel (ops/prng_kernel.py, csrc/prng_kernels.cu): utils/prng's
uniforms and uniforms_cols launch it for stream ids on a CUDA device and
run their plain chain of int32 torch ops on the CPU.

On the CPU: a numpy uint32 model of the kernel's arithmetic, written as the
.cu writes it (wrapping multiply-adds, logical shifts, `(w >> 8) * 2^-24`),
run on the launch arguments that the wrapper prepares (ops/prng_kernel.py's
`prepare`: counters by value or as per-lane arrays, the output's strides,
rows or columns), is bit-equal to the plain chain: on samples 0, 2^31 - 1,
2^31 and 2^32 - 1, tags 0-7 and JITTER_TAG, keys of seeds 0, 2^31 and
2^32 - 1, stream ids 0 and 2^31 - 1 among others, n = 1, 2, 5, 6 and 8,
scalar and per-lane counters, and zero lanes. A CPU call runs the chain:
it launches nothing, moves no `draw_kernel` count, and is one `draw` span.
The benchmark's readers of the span and the counter read them.

With the `gpu` marker, on the card: the kernel against the plain chain on
the card and on the CPU, rows and columns, over the same cases; one
launch and one `draw_kernel` count a call; a call during a CUDA graph
capture raises. Imports no jax, so the card tests run on a machine
without it:

    python -m pytest --noconftest tests/test_torch_prng_kernel.py -m gpu
"""

import ctypes
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raytracer_odin_tpu_torch.ops import prng_kernel
from raytracer_odin_tpu_torch.utils import prng, profiling

ROOT = Path(__file__).resolve().parents[1]
SAMPLES = (0, 2**31 - 1, 2**31, 2**32 - 1)
TAGS = tuple(range(8)) + (prng.JITTER_TAG,)
SEEDS = (0, 2**31, 2**32 - 1)
NS = (1, 2, 5, 6, 8)
# Stream ids: 0 and 2^31 - 1 (the largest an int32 holds) among others.
SIDS = (0, 2**31 - 1, 1, 7, 1919, 2_073_599, 2**31 - 2, 65_536)


def _i32(values):
    """uint32 values as int32 bits."""
    return np.asarray(values, dtype=np.uint64).astype(np.uint32).view(
        np.int32)


# ---------------------------------------------------------------------------
# The kernel's arithmetic in numpy uint32, as csrc/prng_kernels.cu writes it.
# ---------------------------------------------------------------------------

_MUL, _ADD = np.uint32(1664525), np.uint32(1013904223)


def _pcg4d(a, b, c, d):
    a = a * _MUL + _ADD
    b = b * _MUL + _ADD
    c = c * _MUL + _ADD
    d = d * _MUL + _ADD
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a = a ^ (a >> np.uint32(16))
    b = b ^ (b >> np.uint32(16))
    c = c ^ (c >> np.uint32(16))
    d = d ^ (d >> np.uint32(16))
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def _to_unit(w):
    return (w >> np.uint32(8)).astype(np.float32) * np.float32(
        1.0 / 16777216.0)


def _model_launch(args):
    """rt_draw_launch on the arguments `prepare` made, in numpy: each
    lane's counters from its pointer or the value, its n draws stored at
    lane * lane_stride + j * draw_stride of the output."""
    lanes, n = args.lanes, args.n
    if lanes == 0:
        return

    def per_lane(ptr, value):
        if ptr:
            return np.ctypeslib.as_array(
                (ctypes.c_uint32 * lanes).from_address(ptr)).copy()
        return np.full(lanes, value, dtype=np.uint32)

    a0 = per_lane(args.samples, args.sample) ^ np.uint32(args.k0)
    b0 = per_lane(args.tags, args.tag) ^ np.uint32(args.k1)
    c0 = per_lane(args.sids, 0)
    out = np.ctypeslib.as_array(
        (ctypes.c_float * (lanes * n)).from_address(args.out))
    lane = np.arange(lanes, dtype=np.int64)
    for blk in range((n + 3) // 4):
        d0 = np.full(lanes, blk, dtype=np.uint32)
        w = _pcg4d(a0.copy(), b0.copy(), c0.copy(), d0)
        for k in range(4):
            j = 4 * blk + k
            if j >= n:
                break
            out[lane * args.lane_stride + j * args.draw_stride] = _to_unit(
                w[k])


def _model(key, samples, tags, sids, n, cols):
    """The draws as the kernel would return them (a tuple of columns with
    `cols`, else [..., n] rows), from the wrapper's prepared arguments."""
    args, out, _keep = prng_kernel.prepare(key, samples, tags, sids, n,
                                           cols)
    _model_launch(args)
    return out.unbind(0) if cols else out


def _plain(key, samples, tags, sids, n, cols):
    cols_ = prng.plain_cols(key, samples, tags, sids, n)
    return cols_ if cols else torch.stack(cols_, dim=-1)


def _bits(x):
    if isinstance(x, tuple):
        x = torch.stack(x, dim=0)
    return x.cpu().contiguous().view(torch.int32)


def _cases(counters, device="cpu"):
    """(samples, tags, sids) calls covering SAMPLES x TAGS x SIDS: one call
    a (sample, tag) pair with Python ints, or one call whose per-lane
    tensors hold every triple."""
    if counters == "scalar":
        sids = torch.from_numpy(_i32(SIDS)).to(device)
        return [(s, t, sids) for s in SAMPLES for t in TAGS]
    grid = np.array(np.meshgrid(SAMPLES, TAGS, SIDS, indexing="ij"),
                    dtype=np.uint64).reshape(3, -1)
    s, t, i = (torch.from_numpy(_i32(g)).to(device) for g in grid)
    return [(s, t, i)]


# ---------------------------------------------------------------------------
# The CPU: the kernel's model against the plain chain.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("counters", ["scalar", "per_lane"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", NS)
def test_model_is_the_plain_chain(n, seed, counters, layout):
    key = prng.key_from_seed(seed)
    cols = layout == "cols"
    for samples, tags, sids in _cases(counters):
        want = _plain(key, samples, tags, sids, n, cols)
        got = _model(key, samples, tags, sids, n, cols)
        if cols:
            assert len(got) == n
            assert all(g.shape == sids.shape for g in got)
        else:
            assert got.shape == sids.shape + (n,)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("counters", ["scalar", "per_lane"])
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_model_zero_lanes(counters, layout):
    key = prng.key_from_seed(2**31)
    sids = torch.zeros(0, dtype=torch.int32)
    samples = sids + 3 if counters == "per_lane" else 3
    cols = layout == "cols"
    args, out, _ = prng_kernel.prepare(key, samples, 5, sids, 6, cols)
    assert args.lanes == 0
    got = _model(key, samples, 5, sids, 6, cols)
    want = _plain(key, samples, 5, sids, 6, cols)
    assert torch.equal(_bits(got), _bits(want))
    assert _bits(got).numel() == 0


@pytest.mark.parametrize("shapes", [
    ((3, 4), None, None),          # a frame's [rows, W] ids, int counters
    ((3, 4), (4,), None),          # per-column samples broadcast over rows
    ((4,), (3, 1), (4,)),          # counters widen the draws' shape
    ((5,), (5,), (5,)),            # the pool's per-lane counters
    ((), None, (6,)),              # one stream id, per-lane tags
])
def test_prepare_broadcasts_as_the_chain(shapes):
    """Tensor counters are broadcast with the stream ids to the plain
    chain's shape and go per lane; int counters go by value."""
    gen = np.random.default_rng(7)
    s_shape, samp_shape, tag_shape = shapes

    def tensor(shape, dtype):
        return torch.from_numpy(gen.integers(0, 2**32, size=shape,
                                             dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dtype)

    sids = tensor(s_shape, torch.int32)
    samples = 2**31 + 5 if samp_shape is None else tensor(samp_shape,
                                                          torch.int64)
    tags = 3 if tag_shape is None else tensor(tag_shape, torch.int32)
    key = prng.key_from_seed(2**32 - 1)
    args, out, _ = prng_kernel.prepare(key, samples, tags, sids, 6, False)
    assert bool(args.samples) == (samp_shape is not None)
    assert bool(args.tags) == (tag_shape is not None)
    if samp_shape is None:
        assert args.sample == 2**31 + 5
    if tag_shape is None:
        assert args.tag == 3
    assert (args.k0, args.k1) == key
    for cols in (False, True):
        want = _plain(key, samples, tags, sids, 6, cols)
        got = _model(key, samples, tags, sids, 6, cols)
        assert torch.equal(_bits(got), _bits(want))


def test_prepare_layouts():
    """Rows are [lanes, n] with unit draw stride (the kernel's staged
    tile); columns are [n, lanes] with a lane stride of 1."""
    sids = torch.arange(10, dtype=torch.int32).reshape(2, 5)
    rows, out_r, _ = prng_kernel.prepare((0, 1), 0, 0, sids, 6, False)
    assert (rows.lane_stride, rows.draw_stride, rows.lanes) == (6, 1, 10)
    assert out_r.shape == (2, 5, 6)
    cols, out_c, _ = prng_kernel.prepare((0, 1), 0, 0, sids, 6, True)
    assert (cols.lane_stride, cols.draw_stride) == (1, 10)
    assert out_c.shape == (6, 2, 5)
    with pytest.raises(ValueError):
        prng_kernel.prepare((0, 1), 0, 0, sids, 0, False)


def test_kernel_refuses_the_cpu():
    with pytest.raises(ValueError):
        prng_kernel.draws((0, 0), 0, 0, torch.zeros(4, dtype=torch.int32),
                          6)


@pytest.mark.parametrize("fn", [prng.uniforms, prng.uniforms_cols])
def test_cpu_call_runs_the_chain(fn):
    """A CPU call is the plain chain: no launch, no draw_kernel count, one
    draw span."""
    key = prng.key_from_seed(11)
    sids = torch.arange(64, dtype=torch.int32)
    before = profiling.PROCESS.snapshot()
    launches = prng_kernel.launch.launches
    got = fn(key, 3, 1, sids, 6)
    ph = profiling.PROCESS.since(before)
    assert prng_kernel.launch.launches == launches
    assert prng_kernel.COUNTER not in ph.counters
    assert ph.spans[prng.SPAN].calls == 1
    want = _plain(key, 3, 1, sids, 6, fn is prng.uniforms_cols)
    assert torch.equal(_bits(got), _bits(want))


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(steps, draws, counted, draw_s=0.0):
    ph = profiling.PhaseTimer()
    if steps:
        ph.step_spans["step"] = profiling.SpanStat(steps, 0, 0)
    if draws:
        ph.step_spans["draw"] = profiling.SpanStat(
            draws, int(draw_s * 1e9), int(draw_s * 1e9))
    if counted:
        ph.step_counters[prng_kernel.COUNTER] = counted
    return SimpleNamespace(result=SimpleNamespace(phases=ph))


def test_readers_of_the_span_and_counter(monkeypatch):
    """draw_kernel_share: draw_kernel counts over draw spans inside steps,
    nothing without the kernel's module or a step; draw_host_ms: the draw
    spans' inclusive host ms a step, nothing without the span."""
    share, host = _reader("draw_kernel_share"), _reader("draw_host_ms")
    assert share.read(_ctx(5, 45, 45)) == 1.0
    assert share.read(_ctx(5, 45, 0)) == 0.0
    assert share.read(_ctx(0, 45, 45)) is None
    assert share.read(_ctx(5, 0, 0)) is None
    assert share.read(SimpleNamespace(result=None)) is None
    assert host.read(_ctx(4, 36, 36, draw_s=0.002)) == pytest.approx(0.5)
    assert host.read(_ctx(4, 0, 0)) is None
    assert host.read(SimpleNamespace(result=None)) is None
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name.endswith("prng_kernel") else real(
            name, *a))
    assert share.read(_ctx(5, 45, 45)) is None


def test_render_counts_a_draw_span_each_call(tmp_path):
    """A small CPU render: every draw is a draw span inside the step (one
    jitter and `depth` bounces a sample), and the kernel serves none."""
    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.io import gltf
    from raytracer_odin_tpu_torch.models import assets, build
    from raytracer_odin_tpu_torch.render import runtime

    host = gltf.read_gltf(assets.generate("cube", tmp_path)["gltf"])
    scene = build.finish_scene(host, device="cpu")
    cfg = RenderConfig(width=16, height=8, ray_depth=3, samples=2,
                       samples_per_step=1, seed=1, intersector="pallas",
                       compact="auto")
    res = runtime.render_scene(scene, cfg, host.cam.fov_x * 2,
                               device="cpu")
    ph = res.phases
    steps = ph.step_spans["step"].calls
    assert steps == 2
    assert ph.step_spans[prng.SPAN].calls == steps * (1 + cfg.ray_depth)
    assert prng_kernel.COUNTER not in ph.step_counters
    assert _reader("draw_kernel_share").read(
        SimpleNamespace(result=res)) == 0.0


# ---------------------------------------------------------------------------
# The card: the kernel against the plain chain.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (this machine has none)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("counters", ["scalar", "per_lane"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", NS)
def test_kernel_is_the_plain_chain(cuda, n, seed, counters, layout):
    """Bit-equal to the plain chain on the card and on the CPU; one launch
    and one draw_kernel count a call."""
    key = prng.key_from_seed(seed)
    fn = prng.uniforms_cols if layout == "cols" else prng.uniforms
    for samples, tags, sids in _cases(counters, cuda):
        before = profiling.PROCESS.snapshot()
        launches = prng_kernel.launch.launches
        got = fn(key, samples, tags, sids, n)
        ph = profiling.PROCESS.since(before)
        assert prng_kernel.launch.launches - launches == 1
        assert ph.counters[prng_kernel.COUNTER] == 1
        assert ph.spans[prng.SPAN].calls == 1
        want = _plain(key, samples, tags, sids, n, layout == "cols")
        cpu = _plain(key, *(x.cpu() if isinstance(x, torch.Tensor) else x
                            for x in (samples, tags, sids)), n,
                     layout == "cols")
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(got), _bits(cpu))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [0, 1, 255, 257, 2_073_600])
def test_kernel_lane_counts(cuda, lanes):
    """Ragged last blocks and an empty call (no launch) at n = 6 and 2."""
    key = prng.key_from_seed(2**32 - 1)
    sids = torch.arange(lanes, dtype=torch.int32, device=cuda) * 7919
    for n in (6, 2):
        launches = prng_kernel.launch.launches
        got = prng.uniforms(key, 2**31, prng.JITTER_TAG, sids, n)
        assert prng_kernel.launch.launches - launches == (1 if lanes else 0)
        want = _plain(key, 2**31, prng.JITTER_TAG, sids, n, False)
        assert got.shape == (lanes, n)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
def test_kernel_raises_during_graph_capture(cuda):
    key = prng.key_from_seed(0)
    sids = torch.arange(1024, dtype=torch.int32, device=cuda)
    prng.uniforms(key, 0, 0, sids, 6)
    torch.cuda.synchronize(cuda)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(cuda)
    launches = prng_kernel.launch.launches
    with pytest.raises(RuntimeError, match="graph capture"):
        with torch.cuda.stream(stream):
            with torch.cuda.graph(graph, stream=stream):
                prng.uniforms(key, 0, 0, sids, 6)
    assert prng_kernel.launch.launches == launches


@pytest.mark.gpu
def test_kernel_on_any_card(cuda):
    """Each card's draws, launched while cuda:0 is the current device (a
    mesh's tiles on cuda:1..), equal the plain chain there."""
    key = prng.key_from_seed(3)
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        sids = torch.arange(4096, dtype=torch.int32, device=dev)
        with torch.cuda.device(cuda):
            got = prng.uniforms(key, 5, 2, sids, 6)
        assert got.device == dev
        want = _plain(key, 5, 2, sids, 6, False)
        assert torch.equal(_bits(got), _bits(want))
