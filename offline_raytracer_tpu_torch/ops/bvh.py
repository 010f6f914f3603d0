"""Host-side packed LBVH (counterpart of ``offline_raytracer_tpu/ops/bvh.py``).

The same Morton-ordered LBVH with 128-triangle leaves, built by the same
numpy code path as the JAX package's pure-Python builder, so slot order
(``tri_index``), leaf bounds and coefficient planes agree:

- each triangle is 12 affine-barycentric coefficients (s1, c1, s2, c2, n,
  cw): for a ray (o, d), t = -(n.o + cw) / (n.d), u = (s1.o + c1) +
  t (s1.d), v = (s2.o + c2) + t (s2.d), hit iff u, v >= 0 and u + v <= 1;
- internal nodes form an implicit heap (children of i at 2i+1, 2i+2,
  leaves from ``n_leaves - 1`` on); ``child_rows`` row i holds both
  children's AABBs in lanes 0-11;
- padded slots have n = 0 (never hit), padded leaves inverted AABBs;
- each leaf also has ``SUB`` sub-boxes, the AABBs of its runs of
  ``SUB_TRIS`` consecutive slots (the segment kernel's cull inside a leaf),
  built from the same vertices as the leaf bounds and the planes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from offline_raytracer_tpu_torch.scene.types import TensorTable

LEAF = 128  # triangles per leaf; planes rows: s1 xyz, c1, s2 xyz, c2, n xyz, cw
SUB = 16    # sub-boxes per leaf
SUB_TRIS = LEAF // SUB


@dataclasses.dataclass(frozen=True)
class TriBVH(TensorTable):
    child_rows: torch.Tensor  # (max(P-1,1), 128) lanes 0-11 = child AABBs
    planes: torch.Tensor      # (12, M_pad, 128) coefficient planes
    tri_index: torch.Tensor   # (M_pad*128,) int32 original tri id, -1 pad
    mat: torch.Tensor         # (M_pad*128,) int32 material per slot
    leaf_bounds: torch.Tensor = None  # (6, L_lane) leaf AABB rows
    sub_bounds: torch.Tensor = None   # (M_pad, SUB, 6) sub-box min xyz, max xyz
    n_leaves: int = 1         # P, power of two
    m_occ: int = 1            # occupied leaves


def heap_leaf_count(m_occ: int) -> int:
    """Leaves of the implicit heap for ``m_occ`` occupied leaves (pow2)."""
    return 1 << max(0, (m_occ - 1).bit_length())


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes from centroid positions."""
    lo = centroids.min(0)
    hi = centroids.max(0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / ext) * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return ((spread(q[:, 0]) << np.uint64(2))
            | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2]))


def triangle_coefficients(v0, v1, v2):
    """(N,3) x3 -> (N, 12) affine-barycentric coefficient rows."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    e2xn = np.cross(e2, n)
    e1xn = np.cross(e1, n)
    d1 = np.sum(e1 * e2xn, -1)
    d2 = np.sum(e2 * e1xn, -1)
    ok = (np.abs(d1) > 1e-30) & (np.abs(d2) > 1e-30)
    safe1 = np.where(ok, d1, 1.0)[:, None]
    safe2 = np.where(ok, d2, 1.0)[:, None]
    s1 = np.where(ok[:, None], e2xn / safe1, 0.0)
    s2 = np.where(ok[:, None], e1xn / safe2, 0.0)
    n = np.where(ok[:, None], n, 0.0)
    c1 = -np.sum(s1 * v0, -1)
    c2 = -np.sum(s2 * v0, -1)
    cw = -np.sum(n * v0, -1)
    out = np.concatenate(
        [s1, c1[:, None], s2, c2[:, None], n, cw[:, None]], axis=1)
    return out.astype(np.float32)


def leaf_bounds_rows(tri_index, m_occ: int, v0, v1, v2) -> np.ndarray:
    """(6, L_lane) leaf AABB rows (minx..maxz) from leaf-ordered slot ids;
    the leaf axis is padded to a multiple of 128 with inverted boxes."""
    slots = np.asarray(tri_index[: m_occ * LEAF]).reshape(m_occ, LEAF)
    valid = (slots >= 0)[..., None]
    idx = np.maximum(slots, 0)
    tmin = np.minimum(np.minimum(v0[idx], v1[idx]), v2[idx])
    tmax = np.maximum(np.maximum(v0[idx], v1[idx]), v2[idx])
    lmin = np.where(valid, tmin, np.float32(np.inf)).min(1)
    lmax = np.where(valid, tmax, np.float32(-np.inf)).max(1)
    l_lane = -(-m_occ // LEAF) * LEAF
    out = np.empty((6, l_lane), np.float32)
    out[0:3] = np.float32(np.inf)
    out[3:6] = np.float32(-np.inf)
    out[0:3, :m_occ] = lmin.T
    out[3:6, :m_occ] = lmax.T
    return out


def sub_bounds_rows(tri_index, v0, v1, v2) -> np.ndarray:
    """(M_pad, SUB, 6) AABBs (min xyz, max xyz) of each leaf's runs of
    SUB_TRIS consecutive slots, from leaf-ordered slot ids (M_pad * 128);
    a run of padding slots gets an inverted box."""
    slots = np.asarray(tri_index)
    valid = (slots >= 0)[:, None]
    idx = np.maximum(slots, 0)
    tmin = np.minimum(np.minimum(v0[idx], v1[idx]), v2[idx])
    tmax = np.maximum(np.maximum(v0[idx], v1[idx]), v2[idx])
    lo = np.where(valid, tmin, np.float32(np.inf))
    hi = np.where(valid, tmax, np.float32(-np.inf))
    lo = lo.reshape(-1, SUB, SUB_TRIS, 3).min(2)
    hi = hi.reshape(-1, SUB, SUB_TRIS, 3).max(2)
    return np.concatenate([lo, hi], -1).astype(np.float32)


def build_tri_bvh(v0, v1, v2, mat, leaf_size: int = LEAF) -> TriBVH:
    """Build the packed LBVH from (N,3)/(N,) numpy arrays (CPU tensors)."""
    if leaf_size != LEAF:
        raise ValueError("packed BVH uses 128-triangle leaves")
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    mat = np.asarray(mat, np.int32)
    n = v0.shape[0]
    if n == 0:
        raise ValueError("empty triangle set")

    centroids = (v0 + v1 + v2) / 3.0
    order = np.argsort(morton_codes(centroids), kind="stable").astype(np.int32)

    m_occ = -(-n // LEAF)
    p = heap_leaf_count(m_occ)
    m_pad = -(-m_occ // 8) * 8
    slots = m_occ * LEAF
    pad = slots - n

    def padv(a, fill):
        return np.concatenate(
            [a[order], np.full((pad,) + a.shape[1:], fill, a.dtype)])

    pv0 = padv(v0, 0.0)
    pv1 = padv(v1, 0.0)
    pv2 = padv(v2, 0.0)
    pmat = np.concatenate([mat[order], np.zeros(pad, np.int32)])
    ptri = np.concatenate([order, np.full(pad, -1, np.int32)])

    coeff = triangle_coefficients(pv0, pv1, pv2)
    coeff[n:] = 0.0                       # padding slots can never hit
    planes = np.zeros((12, m_pad, LEAF), np.float32)
    planes[:, :m_occ, :] = coeff.reshape(m_occ, LEAF, 12).transpose(2, 0, 1)

    tmin = np.minimum(np.minimum(pv0, pv1), pv2).reshape(m_occ, LEAF, 3)
    tmax = np.maximum(np.maximum(pv0, pv1), pv2).reshape(m_occ, LEAF, 3)
    valid = (ptri >= 0).reshape(m_occ, LEAF, 1)
    leaf_min = np.where(valid, tmin, np.float32(np.inf)).min(1)
    leaf_max = np.where(valid, tmax, np.float32(-np.inf)).max(1)

    # heap AABBs: leaves at [p-1, 2p-2], empties inverted
    node_min = np.full((2 * p - 1, 3), np.inf, np.float32)
    node_max = np.full((2 * p - 1, 3), -np.inf, np.float32)
    node_min[p - 1: p - 1 + m_occ] = leaf_min
    node_max[p - 1: p - 1 + m_occ] = leaf_max
    level_start = p - 1
    while level_start > 0:
        parent_start = (level_start - 1) // 2
        n_parents = level_start - parent_start
        c = np.arange(2 * n_parents) + level_start
        node_min[parent_start:level_start] = (
            node_min[c].reshape(n_parents, 2, 3).min(1))
        node_max[parent_start:level_start] = (
            node_max[c].reshape(n_parents, 2, 3).max(1))
        level_start = parent_start

    n_internal = max(p - 1, 1)
    child_rows = np.zeros((n_internal, LEAF), np.float32)
    if p > 1:
        i = np.arange(p - 1)
        child_rows[i, 0:3] = node_min[2 * i + 1]
        child_rows[i, 3:6] = node_max[2 * i + 1]
        child_rows[i, 6:9] = node_min[2 * i + 2]
        child_rows[i, 9:12] = node_max[2 * i + 2]
    else:
        # single-leaf tree: a root row whose child1 is the leaf
        child_rows[0, 0:3] = leaf_min[0]
        child_rows[0, 3:6] = leaf_max[0]
        child_rows[0, 6:9] = np.inf
        child_rows[0, 9:12] = -np.inf

    tri_index_full = np.concatenate(
        [ptri, np.full((m_pad - m_occ) * LEAF, -1, np.int32)])
    return TriBVH(
        child_rows=torch.from_numpy(child_rows),
        planes=torch.from_numpy(planes),
        tri_index=torch.from_numpy(tri_index_full),
        mat=torch.from_numpy(np.concatenate(
            [pmat, np.zeros((m_pad - m_occ) * LEAF, np.int32)])),
        leaf_bounds=torch.from_numpy(
            leaf_bounds_rows(tri_index_full, m_occ, v0, v1, v2)),
        sub_bounds=torch.from_numpy(
            sub_bounds_rows(tri_index_full, v0, v1, v2)),
        n_leaves=int(p), m_occ=int(m_occ),
    )
