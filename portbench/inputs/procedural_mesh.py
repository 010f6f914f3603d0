"""The stand-in mesh of the benchmark's scenes.

Frozen copy of ``tests/torch_port_cases.procedural_mesh`` at commit
7999567 (last changed in c7b6d06). The benchmark makes its inputs with
this copy so that an edit to the repository's tests cannot move them.
"""

import numpy as np


def procedural_mesh(n_tris: int, seed: int = 0):
    """A bumpy closed sphere cut to exactly ``n_tris`` triangles:
    (vertices (V, 3) float32, faces (F, 3) int32), unit-ish radius."""
    nv = max(4, int(np.sqrt(n_tris / 4.0)) + 2)
    nu = max(3, -(-n_tris // (2 * (nv - 1))))
    rs = np.random.RandomState(seed)
    th = np.linspace(0.0, np.pi, nv + 1)[1:-1]
    ph = np.linspace(0.0, 2.0 * np.pi, nu, endpoint=False)
    r = 1.0 + 0.08 * rs.standard_normal((th.size, nu))
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)) * r,
                     np.outer(np.sin(th), np.sin(ph)) * r,
                     np.outer(np.cos(th), np.ones(nu)) * r], -1).reshape(-1, 3)
    v = np.concatenate([ring, [[0, 0, 1.0]], [[0, 0, -1.0]]]).astype(
        np.float32)
    top, bot = ring.shape[0], ring.shape[0] + 1
    f = []
    for j in range(nu):
        f.append([top, j, (j + 1) % nu])
    for i in range(th.size - 1):
        for j in range(nu):
            a, b = i * nu + j, i * nu + (j + 1) % nu
            c, d = a + nu, b + nu
            f += [[a, c, b], [b, c, d]]
    last = (th.size - 1) * nu
    for j in range(nu):
        f.append([bot, last + (j + 1) % nu, last + j])
    f = np.asarray(f, np.int32)
    if f.shape[0] < n_tris:
        raise ValueError("mesh generator made too few triangles")
    return v, f[:n_tris]
