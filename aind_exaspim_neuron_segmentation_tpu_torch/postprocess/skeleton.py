"""Skeleton container, TEASAR entry point and SWC serialization.

Plays the role of kimimaro's ``Skeleton`` at the reference call sites:
``.vertices`` (N, 3) in physical units (index * anisotropy, so voxel
coordinates when anisotropy is (1, 1, 1), which ``voxelize_skeletons``
assumes) and ``.to_swc()`` giving the text written into the ZIP archive.
The TEASAR engine is the port's C++ (``native/src/teasar.cpp``).
"""

import ctypes
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from aind_exaspim_neuron_segmentation_tpu_torch.native import build


@dataclass
class Skeleton:
    """A skeleton graph: vertices in physical (z, y, x), radii, edges."""

    id: int
    vertices: np.ndarray  # (N, 3) float64
    radii: np.ndarray  # (N,) float64
    edges: np.ndarray  # (E, 2) int64
    swc_header: str = field(default="", repr=False)

    def to_swc(self):
        """SWC text: ``n T x y z R parent`` rows, 1-indexed.

        The vertex graph (a forest of trace trees) is rooted at vertex 0
        by BFS; disconnected pieces get parent -1. Column order mirrors
        the vertex axis order so ``voxelize_skeletons`` round-trips.
        """
        n = len(self.radii)
        adj = [[] for _ in range(n)]
        for a, b in self.edges:
            adj[a].append(b)
            adj[b].append(a)
        parent = np.full(n, -2, np.int64)
        order = []
        for seed in range(n):
            if parent[seed] != -2:
                continue
            parent[seed] = -1
            queue = deque([seed])
            while queue:
                u = queue.popleft()
                order.append(u)
                for v in adj[u]:
                    if parent[v] == -2:
                        parent[v] = u
                        queue.append(v)
        new_id = np.empty(n, np.int64)
        for i, u in enumerate(order):
            new_id[u] = i + 1
        lines = [self.swc_header] if self.swc_header else []
        for u in order:
            p = -1 if parent[u] < 0 else int(new_id[parent[u]])
            x, y, z = self.vertices[u]
            lines.append(
                f"{int(new_id[u])} 0 {x:g} {y:g} {z:g} "
                f"{self.radii[u]:g} {p}"
            )
        return "\n".join(lines) + "\n"

    @classmethod
    def from_swc(cls, text, id=0):
        """Parse SWC text back into a Skeleton (round-trip oracle)."""
        verts, radii, edges, ids = [], [], [], {}
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            f = line.split()
            ids[int(f[0])] = len(verts)
            verts.append((float(f[2]), float(f[3]), float(f[4])))
            radii.append(float(f[5]))
            parent = int(f[6])
            if parent != -1:
                edges.append((ids[parent], ids[int(f[0])]))
        return cls(
            id=id,
            vertices=np.asarray(verts, np.float64).reshape(-1, 3),
            radii=np.asarray(radii, np.float64),
            edges=np.asarray(edges, np.int64).reshape(-1, 2),
        )


def _bind(lib):
    if getattr(lib, "_exa_skel_bound", False):
        return lib
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.exa_skeletonize.restype = ctypes.c_void_p
    lib.exa_skeletonize.argtypes = [
        u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f64p,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.exa_skel_count.restype = ctypes.c_int64
    lib.exa_skel_count.argtypes = [ctypes.c_void_p]
    lib.exa_skel_label.restype = ctypes.c_uint32
    lib.exa_skel_label.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.exa_skel_nverts.restype = ctypes.c_int64
    lib.exa_skel_nverts.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.exa_skel_nedges.restype = ctypes.c_int64
    lib.exa_skel_nedges.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.exa_skel_copy.restype = None
    lib.exa_skel_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, f64p, f64p, i64p,
    ]
    lib.exa_skel_free.restype = None
    lib.exa_skel_free.argtypes = [ctypes.c_void_p]
    lib._exa_skel_bound = True
    return lib


def skeletonize(
    segmentation,
    scale=1.25,
    const=450,
    pdrf_exponent=4,
    pdrf_scale=100000,
    soma_detection_threshold=1000,
    soma_acceptance_threshold=3500,
    soma_invalidation_scale=1.0,
    soma_invalidation_const=300,
    anisotropy=(1.0, 1.0, 1.0),
    fix_borders=True,
    fill_holes=True,
):
    """TEASAR-skeletonize every labeled segment of a dense volume.

    Parameter names and defaults mirror the kimimaro call of the
    reference, which runs one thread (``parallel=1``). Returns
    ``{segment_id: Skeleton}``; a segment with several connected components
    gives one merged Skeleton (vertices concatenated), as kimimaro does.
    ``segmentation`` is an array-like (numpy, a CPU tensor, a list); a
    lazy chunked handle raises ``NotImplementedError``.
    """
    if not isinstance(
        segmentation, (np.ndarray, list, tuple)
    ) and not hasattr(segmentation, "__array__"):
        raise NotImplementedError(
            "lazy (chunked) label handles need the port's io/ and "
            "skeletonize_lazy (ROADMAP.md, slice 4); pass a dense array"
        )
    seg = np.ascontiguousarray(segmentation, dtype=np.uint32)
    if seg.ndim != 3:
        raise ValueError(f"expected 3D segmentation, got {seg.shape}")
    lib = _bind(build.load())
    params = _params_array(
        scale, const, pdrf_exponent, pdrf_scale,
        soma_detection_threshold, soma_acceptance_threshold,
        soma_invalidation_scale, soma_invalidation_const, anisotropy,
        # kimimaro black_border semantics: volume faces count as
        # background only for single-label volumes.
        black_border=(seg.min() == seg.max()),
    )
    handle = lib.exa_skeletonize(
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        *seg.shape,
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        1 if fix_borders else 0,
        1 if fill_holes else 0,
    )
    return _merge_pieces(_collect_pieces(lib, handle))


def _params_array(scale, const, pdrf_exponent, pdrf_scale,
                  soma_detection_threshold, soma_acceptance_threshold,
                  soma_invalidation_scale, soma_invalidation_const,
                  anisotropy, black_border):
    return np.asarray(
        [
            scale, const, pdrf_exponent, pdrf_scale,
            soma_detection_threshold, soma_acceptance_threshold,
            soma_invalidation_scale, soma_invalidation_const,
            anisotropy[0], anisotropy[1], anisotropy[2],
            1,  # worker threads, as the reference's kimimaro call
            1.0 if black_border else 0.0,
        ],
        dtype=np.float64,
    )


def _collect_pieces(lib, handle):
    if not handle:
        raise RuntimeError("skeletonization failed")
    pieces = {}
    try:
        for i in range(lib.exa_skel_count(handle)):
            label = int(lib.exa_skel_label(handle, i))
            nv = lib.exa_skel_nverts(handle, i)
            ne = lib.exa_skel_nedges(handle, i)
            verts = np.empty((nv, 3), np.float64)
            radii = np.empty(nv, np.float64)
            edges = np.empty((ne, 2), np.int64)
            lib.exa_skel_copy(
                handle, i,
                verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                radii.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            pieces.setdefault(label, []).append((verts, radii, edges))
    finally:
        lib.exa_skel_free(handle)
    return pieces


def _merge_pieces(pieces):
    skeletons = {}
    for label, parts in pieces.items():
        offset = 0
        verts, radii, edges = [], [], []
        for v, r, e in parts:
            verts.append(v)
            radii.append(r)
            edges.append(e + offset)
            offset += len(r)
        skeletons[label] = Skeleton(
            id=label,
            vertices=np.concatenate(verts),
            radii=np.concatenate(radii),
            edges=np.concatenate(edges),
        )
    return skeletons
