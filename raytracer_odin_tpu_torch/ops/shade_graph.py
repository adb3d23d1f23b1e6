"""CUDA graphs of the compacted sample's shading segments.

A segment is one bounce's shade and the packing of its outputs into the
lane state: bounce 0's (integrator.first_segment) and each later bounce's
(integrator.later_segment) of the compacted trace, or their forms for the
column layout (first_segment_cols, later_segment_cols). Its shapes are static
(bounce 0 shades the padded frame, a later bounce exactly its lane
budget), it makes no host sync, its constants are filled on the device and
its Python branches read only static facts of the scene (env_tex, the
light count against light_cull.threshold(), row_spec, tex_kinds) and the
light chunk. So a CUDA graph captured once replays the very kernels of
the eager call, and a graphed render is bit-equal to an eager one; the
host enqueues a graph launch and a few input copies where it enqueued
hundreds of kernels. On the card the row layout's segments are launches of
the shade kernel (ops/shade_kernel.py): a graph holds one launch of it, the
column layout's graphs their torch ops.

`run` decides from its input how the segment is served. On the CPU
(`engages` false) it is called. On a CUDA device, a scene on the dense
light sum (fewer lights than light_cull.threshold(), or none) replays the
whole segment as one graph. A scene on the culled sum (light_cull.serves)
replays the segment's halves (integrator's head and tail) as two graphs
with the culled light pdf eager between them: K5 and its lists stay
kernel entries called through light_cull's module attributes, each
launch issued by the host inside its "light" span, and nothing of theirs
is a graph's static buffer. The tail graph takes the head graph's outputs
as its own inputs, so only the light pdf is copied in. The caller runs
segments only on the compacted trace, in either lane layout, which
excludes the NaN check; every other path (the CPU, the full-width trace,
the pool, refill) shades eagerly through the same physics.

The cache (`GRAPHS`): one `_Tile` for each (device, scene, tile), where a
tile is a sample's place in the frame (trace's stream_base: each tile of
a mesh has its own), holding one graph per `graph_key` and one private
memory pool that its graphs share, captured in the order they replay.
Segments replay on the current stream in the order the sample runs them,
and everything that reads a graph's outputs is enqueued before the next
replay of that graph (the next bounce reads them through a sort's gather
or a copy into the next graph's inputs; the light pdf and the tail graph
read the head's; the merge reads the last before the sample returns). A
tile's graphs are dropped when its lane budgets (`widths`) change or its
scene is collected, and at most MAX_TILES tiles are kept, the least
recently used dropped first.
"""

from __future__ import annotations

import collections
import weakref
from typing import NamedTuple

import torch

from raytracer_odin_tpu_torch.ops import light_cull, shade_kernel
from raytracer_odin_tpu_torch.utils import profiling

# Tiles kept across the process (a tile is a sample's place in the frame
# on one device, for one scene).
MAX_TILES = 8
# Counters of the program's tally (utils/profiling.py).
REPLAYS = "shade_graph_replays"
CAPTURES = "shade_graph_captures"


def engages(scene, device) -> bool:
    """Whether CUDA graphs serve a segment of `scene`'s lanes on `device`:
    on any CUDA device, for the dense and the culled light path alike."""
    return torch.device(device).type == "cuda"


def graph_key(segment, scene, tensors, light_chunk: int, tile=None):
    """(tile key, segment key): the tile key is (device, scene, tile); the
    segment key holds the segment, every input's shape and dtype (the
    width), whether the scene has lights, its env map, the light path
    (dense or culled) and the light chunk: everything the segment's Python
    reads besides the scene's fixed row layout and texture kinds."""
    n_lights = scene.light_p.shape[0]
    return ((tensors[0].device, id(scene), tile),
            (segment.__name__,
             tuple((tuple(x.shape), x.dtype) for x in tensors),
             n_lights > 0, scene.env_tex,
             light_cull.serves(scene), int(light_chunk)))


def run(segment, scene, tensors: tuple, light_chunk: int, tile=None,
        widths=None):
    """segment(scene, *tensors, light_chunk), replayed from CUDA graphs
    where `engages`, else called; tallied as one "shade" span either way,
    one replay where graphs served it, and one `shade_kernel` count where
    the shade kernel ran in it (its launches, shade_kernel.launch, grew:
    launched eagerly or repeated by a replayed graph). `tile` and `widths`
    (the sample's lane budgets) place the call in the cache. On the card
    the returned tensors are a graph's outputs, rewritten by its next
    replay."""
    graphed = engages(scene, tensors[0].device)
    with profiling.span("shade"):
        launched = shade_kernel.launch.launches
        if not graphed:
            out = segment(scene, *tensors, light_chunk)
        elif light_cull.serves(scene):
            head, tail = segment.halves
            h = GRAPHS.replay(head, scene, tensors, light_chunk, tile,
                              widths)
            p_light = light_cull.light_pdf_sum_culled(scene, h[0], h[1])
            out = GRAPHS.replay(tail, scene, (*h, p_light), light_chunk,
                                tile, widths)
        else:
            out = GRAPHS.replay(segment, scene, tensors, light_chunk, tile,
                                widths)
        if graphed:
            profiling.count(REPLAYS)
        if shade_kernel.launch.launches > launched:
            profiling.count(shade_kernel.COUNTER)
        return out


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: tuple
    # launches of the shade kernel its capture recorded
    kernels: int


class _Tile:
    """One tile's graphs, their shared pool and capture stream."""

    __slots__ = ("scene", "widths", "pool", "stream", "graphs")

    def __init__(self, scene_ref, widths, device):
        self.scene, self.widths = scene_ref, widths
        with torch.cuda.device(device):
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream()
        self.graphs = {}


class ShadeGraphs:
    """The process's segment graphs, by tile (module docstring)."""

    def __init__(self):
        self._tiles = collections.OrderedDict()

    def __len__(self) -> int:
        return sum(len(t.graphs) for t in self._tiles.values())

    def clear(self) -> None:
        self._tiles.clear()

    def _tile(self, key, scene, widths) -> _Tile:
        tile = self._tiles.get(key)
        if tile is not None and (tile.scene() is not scene
                                 or tile.widths != widths):
            del self._tiles[key]
            tile = None
        if tile is None:
            tiles = self._tiles

            def forget(_ref, key=key):
                t = tiles.get(key)
                if t is not None and t.scene is _ref:
                    del tiles[key]

            tile = _Tile(weakref.ref(scene, forget), widths, key[0])
            self._tiles[key] = tile
            while len(self._tiles) > MAX_TILES:
                self._tiles.popitem(last=False)
        self._tiles.move_to_end(key)
        return tile

    def replay(self, segment, scene, tensors, light_chunk, tile, widths):
        tile_key, key = graph_key(segment, scene, tensors, light_chunk, tile)
        t = self._tile(tile_key, scene, widths)
        dev = tile_key[0]
        with torch.cuda.device(dev):
            g = t.graphs.get(key)
            if g is None:
                g = t.graphs[key] = _capture(t, segment, scene, tensors,
                                             light_chunk)
            else:
                for dst, src in zip(g.inputs, tensors):
                    if dst is not src:
                        dst.copy_(src)
            g.graph.replay()
        shade_kernel.launch.launches += g.kernels
        return g.outputs


def _capture(tile: _Tile, segment, scene, tensors, light_chunk) -> _Graph:
    """Capture segment on the tile's stream into its pool, after one eager
    warm-up run there. Its inputs are `tensors`, each taken as it is where
    it is an output of one of the tile's graphs (a tail's head outputs),
    else a static copy. The shade kernel's launches in the warm-up and the
    capture are taken back out of its count: only replays add them."""
    held = {id(x) for g in tile.graphs.values() for x in g.outputs}
    inputs = tuple(x if id(x) in held else torch.empty_like(x).copy_(x)
                   for x in tensors)
    launched = shade_kernel.launch.launches
    current = torch.cuda.current_stream()
    tile.stream.wait_stream(current)
    with torch.cuda.stream(tile.stream):
        segment(scene, *inputs, light_chunk)
    current.wait_stream(tile.stream)
    graph = torch.cuda.CUDAGraph()
    # torch.cuda.graph synchronises the device before it captures
    profiling.count("host_syncs")
    with torch.cuda.graph(graph, pool=tile.pool, stream=tile.stream,
                          capture_error_mode="thread_local"):
        warm = shade_kernel.launch.launches
        outputs = segment(scene, *inputs, light_chunk)
    kernels = shade_kernel.launch.launches - warm
    shade_kernel.launch.launches = launched
    profiling.count(CAPTURES)
    return _Graph(graph, inputs, outputs, kernels)


GRAPHS = ShadeGraphs()
